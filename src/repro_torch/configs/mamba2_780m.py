"""mamba2-780m [ssm] — SSD, attention-free (arXiv:2405.21060).
48L d1536 ssm_state=128 vocab 50280; d_inner 3072 ⇒ 48 SSD heads of 64.
Copy of ``repro/configs/mamba2_780m.py``."""
from repro_torch.configs.common import LayerSpec, ModelConfig

FULL = ModelConfig(
    name="mamba2-780m", family="ssm", vocab=50_280,
    d_model=1536, n_layers=48, pattern=(LayerSpec("ssd", "none"),),
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    supports_long_context=True,
).validate()

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", vocab=128,
    d_model=32, n_layers=3, pattern=(LayerSpec("ssd", "none"),),
    ssm_state=16, ssm_headdim=8, ssm_expand=2, ssm_chunk=8,
    supports_long_context=True, vocab_pad_multiple=16,
).validate()
