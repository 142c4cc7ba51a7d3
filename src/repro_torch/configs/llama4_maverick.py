"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
early-fusion multimodal (hf:meta-llama/Llama-4-Scout-17B-16E).
48L d5120 40H (GQA kv=8) expert d_ff 8192 vocab 202048.
The early-fusion frontend is a stub (vision patches would be interleaved as
ordinary tokens).  Copy of ``repro/configs/llama4_maverick.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", vocab=202_048,
    d_model=5120, n_layers=48, pattern=(LayerSpec("attn", "moe"),),
    n_heads=40, n_kv=8, head_dim=128, d_ff=8192,
    n_experts=128, top_k=1, capacity_factor=1.25, moe_group_size=4096,
    shared_expert=True, rope_theta=500_000.0,
).validate()

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe", vocab=128,
    d_model=40, n_layers=2, pattern=(LayerSpec("attn", "moe"),),
    n_heads=5, n_kv=5, head_dim=8, d_ff=16,
    n_experts=4, top_k=1, capacity_factor=2.0, moe_group_size=64,
    shared_expert=True, rope_theta=500_000.0, vocab_pad_multiple=16,
).validate()
