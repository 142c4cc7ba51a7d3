"""starcoder2-7b [dense] — GQA, RoPE (arXiv:2402.19173; hf).
32L d4608 36H (GQA kv=4) d_ff 18432 vocab 49152.
Copy of ``repro/configs/starcoder2_7b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="starcoder2-7b", family="dense", vocab=49_152,
    d_model=4608, n_layers=32, pattern=(LayerSpec("attn", "dense"),),
    n_heads=36, n_kv=4, head_dim=128, d_ff=18_432,
    norm="layernorm", act="gelu", gated_mlp=False,
    rope_theta=100_000.0, qkv_bias=True,
).validate()

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense", vocab=128,
    d_model=36, n_layers=3, pattern=(LayerSpec("attn", "dense"),),
    n_heads=6, n_kv=2, head_dim=8, d_ff=64,
    norm="layernorm", act="gelu", gated_mlp=False,
    rope_theta=100_000.0, qkv_bias=True, vocab_pad_multiple=16,
).validate()
