"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 LRU
(arXiv:2402.19427).  38L d4096 16H (MQA kv=1) d_ff 12288 vocab 256000,
window 2048.  38 = 12×(lru,lru,local) + (lru,lru) remainder.
Sub-quadratic (windowed attention) ⇒ runs the long_500k cell.
Copy of ``repro/configs/recurrentgemma_9b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", vocab=256_000,
    d_model=4096, n_layers=38,
    pattern=(LayerSpec("lru", "dense"), LayerSpec("lru", "dense"),
             LayerSpec("local", "dense")),
    remainder=(LayerSpec("lru", "dense"), LayerSpec("lru", "dense")),
    n_heads=16, n_kv=1, head_dim=256, d_ff=12_288,
    lru_width=4096, window=2048,
    embed_scale=True, act="gelu",
    supports_long_context=True,
).validate()

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", vocab=128,
    d_model=32, n_layers=5,
    pattern=(LayerSpec("lru", "dense"), LayerSpec("lru", "dense"),
             LayerSpec("local", "dense")),
    remainder=(LayerSpec("lru", "dense"), LayerSpec("lru", "dense")),
    n_heads=4, n_kv=1, head_dim=8, d_ff=64,
    lru_width=32, window=8,
    embed_scale=True, act="gelu",
    supports_long_context=True, vocab_pad_multiple=16,
).validate()
