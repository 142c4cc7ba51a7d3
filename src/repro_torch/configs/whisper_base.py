"""whisper-base [audio] — enc-dec, conv frontend stubbed (arXiv:2212.04356).

6 encoder layers + 6 decoder layers (each decoder layer = self-attn +
cross-attn + MLP, expressed as a 2-spec pattern).  The audio conv frontend is
a stub: the caller provides precomputed [B, 1500, 512] frame embeddings.
Copy of ``repro/configs/whisper_base.py``.
"""
from repro_torch.configs.common import LayerSpec, ModelConfig

_ENC = ModelConfig(
    name="whisper-base-encoder", family="audio", vocab=2,  # unused (embeds in)
    d_model=512, n_layers=6, pattern=(LayerSpec("attn", "dense"),),
    n_heads=8, n_kv=8, head_dim=64, d_ff=2048,
    causal=False, pos_embed="sinusoidal", rope_theta=None,
    norm="layernorm", act="gelu", gated_mlp=False, vocab_pad_multiple=16,
).validate()

FULL = ModelConfig(
    name="whisper-base", family="audio", vocab=51_865,
    d_model=512, n_layers=12,
    pattern=(LayerSpec("attn", "none"), LayerSpec("cross", "dense")),
    n_heads=8, n_kv=8, head_dim=64, d_ff=2048,
    pos_embed="sinusoidal", rope_theta=None,
    norm="layernorm", act="gelu", gated_mlp=False,
    encoder=_ENC, n_frontend_tokens=1500, frontend_dim=512,
    vocab_pad_multiple=256,
).validate()

_SMOKE_ENC = ModelConfig(
    name="whisper-smoke-encoder", family="audio", vocab=2,
    d_model=32, n_layers=2, pattern=(LayerSpec("attn", "dense"),),
    n_heads=4, n_kv=4, head_dim=8, d_ff=64,
    causal=False, pos_embed="sinusoidal", rope_theta=None,
    norm="layernorm", act="gelu", gated_mlp=False, vocab_pad_multiple=16,
).validate()

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", vocab=128,
    d_model=32, n_layers=4,
    pattern=(LayerSpec("attn", "none"), LayerSpec("cross", "dense")),
    n_heads=4, n_kv=4, head_dim=8, d_ff=64,
    pos_embed="sinusoidal", rope_theta=None,
    norm="layernorm", act="gelu", gated_mlp=False,
    encoder=_SMOKE_ENC, n_frontend_tokens=12, frontend_dim=32,
    vocab_pad_multiple=16,
).validate()
