"""qwen2-72b [dense] — GQA + QKV bias (arXiv:2407.10671; hf).
80L d8192 64H (GQA kv=8) d_ff 29568 vocab 152064.
Copy of ``repro/configs/qwen2_72b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="qwen2-72b", family="dense", vocab=152_064,
    d_model=8192, n_layers=80, pattern=(LayerSpec("attn", "dense"),),
    n_heads=64, n_kv=8, head_dim=128, d_ff=29_568,
    qkv_bias=True, rope_theta=1_000_000.0,
).validate()

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense", vocab=128,
    d_model=32, n_layers=3, pattern=(LayerSpec("attn", "dense"),),
    n_heads=4, n_kv=2, head_dim=8, d_ff=64,
    qkv_bias=True, rope_theta=1_000_000.0, vocab_pad_multiple=16,
).validate()
