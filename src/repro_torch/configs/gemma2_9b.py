"""gemma2-9b [dense] — local+global alternating, logit softcap
(arXiv:2408.00118; hf).  42L d3584 16H (GQA kv=8) d_ff 14336 vocab 256000.
Copy of ``repro/configs/gemma2_9b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="gemma2-9b", family="dense", vocab=256_000,
    d_model=3584, n_layers=42,
    pattern=(LayerSpec("local", "dense"), LayerSpec("attn", "dense")),
    n_heads=16, n_kv=8, head_dim=256, d_ff=14_336,
    window=4096, softcap_attn=50.0, softcap_final=30.0,
    post_norm=True, embed_scale=True, act="gelu",
    rope_theta=10_000.0,
).validate()

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense", vocab=128,
    d_model=32, n_layers=4,
    pattern=(LayerSpec("local", "dense"), LayerSpec("attn", "dense")),
    n_heads=4, n_kv=2, head_dim=8, d_ff=64,
    window=8, softcap_attn=50.0, softcap_final=30.0,
    post_norm=True, embed_scale=True, act="gelu",
    vocab_pad_multiple=16,
).validate()
