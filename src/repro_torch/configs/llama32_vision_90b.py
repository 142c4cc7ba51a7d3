"""llama-3.2-vision-90b [vlm] — cross-attn image layers
(hf:meta-llama/Llama-3.2-11B-Vision).  100L d8192 64H (GQA kv=8)
d_ff 28672 vocab 128256.  Every 5th layer cross-attends to image patch
embeddings; the vision tower is a stub: the caller provides precomputed
[B, 1600, d_model] patch embeddings.
Copy of ``repro/configs/llama32_vision_90b.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

_PATTERN = (LayerSpec("attn", "dense"),) * 4 + (LayerSpec("cross", "dense"),)

FULL = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", vocab=128_256,
    d_model=8192, n_layers=100, pattern=_PATTERN,
    n_heads=64, n_kv=8, head_dim=128, d_ff=28_672,
    rope_theta=500_000.0,
    n_frontend_tokens=1600, frontend_dim=8192,
).validate()

SMOKE = ModelConfig(
    name="llama32v-smoke", family="vlm", vocab=128,
    d_model=32, n_layers=5, pattern=_PATTERN,
    n_heads=4, n_kv=2, head_dim=8, d_ff=64,
    rope_theta=500_000.0,
    n_frontend_tokens=8, frontend_dim=32, vocab_pad_multiple=16,
).validate()
