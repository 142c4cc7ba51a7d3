"""granite-moe-1b-a400m [moe] — 32 experts top-8
(hf:ibm-granite/granite-3.0-1b-a400m-base).
24L d1024 16H (GQA kv=8) expert d_ff 512 vocab 49155.
Copy of ``repro/configs/granite_moe_1b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", vocab=49_155,
    d_model=1024, n_layers=24, pattern=(LayerSpec("attn", "moe"),),
    n_heads=16, n_kv=8, head_dim=64, d_ff=512,
    n_experts=32, top_k=8, capacity_factor=1.25, moe_group_size=4096,
    rope_theta=10_000.0,
).validate()

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe", vocab=128,
    d_model=32, n_layers=2, pattern=(LayerSpec("attn", "moe"),),
    n_heads=4, n_kv=2, head_dim=8, d_ff=16,
    n_experts=4, top_k=2, capacity_factor=2.0, moe_group_size=64,
    rope_theta=10_000.0, vocab_pad_multiple=16,
).validate()
