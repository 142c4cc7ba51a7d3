"""granite-3-8b [dense] — GQA (hf:ibm-granite/granite-3.0-2b-base).
40L d4096 32H (GQA kv=8) d_ff 12800 vocab 49155.
Copy of ``repro/configs/granite_3_8b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="granite-3-8b", family="dense", vocab=49_155,
    d_model=4096, n_layers=40, pattern=(LayerSpec("attn", "dense"),),
    n_heads=32, n_kv=8, head_dim=128, d_ff=12_800,
    rope_theta=10_000.0,
).validate()

SMOKE = ModelConfig(
    name="granite3-smoke", family="dense", vocab=130,  # odd vocab: pad path
    d_model=32, n_layers=2, pattern=(LayerSpec("attn", "dense"),),
    n_heads=4, n_kv=2, head_dim=8, d_ff=64,
    rope_theta=10_000.0, vocab_pad_multiple=16,
).validate()
