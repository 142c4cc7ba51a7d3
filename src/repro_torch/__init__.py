"""PyTorch/CUDA port of the CAMEL reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.models.layers`` ↔ ``repro.models.layers`` and so on)
and imports nothing of it.  Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a hand-written Hopper kernel under
``repro_torch.kernels`` with a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
