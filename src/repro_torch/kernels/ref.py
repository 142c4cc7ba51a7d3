"""Oracles for the BFP kernels, built on ``repro_torch.core.bfp``.

Counterpart of ``repro/kernels/ref.py``: global square-group quantization,
then an f32 product.  Valid as oracles because the kernels' tiles are
multiples of the group and start at the origin, so in-tile groups coincide
with the global group grid and zero padding never raises a group max.
"""
from __future__ import annotations

import torch

from repro_torch.core import bfp


def _qdq(x, group, mbits, ebits):
    return bfp.bfp_dequantize(bfp.bfp_quantize(
        x.to(torch.float32), group=(group, group), ebits=ebits, mbits=mbits))


def ref_bfp_matmul(a, b, *, group=32, mbits=5, ebits=4):
    """Oracle for ``kernels.bfp_matmul.bfp_matmul``."""
    return torch.matmul(_qdq(a, group, mbits, ebits),
                        _qdq(b, group, mbits, ebits))


def ref_bfp_quantize(x, *, group=32, mbits=5, ebits=4):
    """Oracle for ``kernels.bfp_quant.bfp_quantize`` (packed layout)."""
    t = bfp.bfp_quantize(x.to(torch.float32), group=(group, group),
                         ebits=ebits, mbits=mbits)
    return t.mant, t.exp


def ref_bfp_matmul_packed(a_mant, a_exp, b_mant, b_exp, *, group=32, mbits=5):
    """Oracle for ``kernels.bfp_quant.bfp_matmul_packed``."""
    def deq(mant, exp):
        t = bfp.BFPTensor(mant=mant, exp=exp, shape=tuple(mant.shape),
                          group=(group, group), mbits=mbits)
        return bfp.bfp_dequantize(t)
    return torch.matmul(deq(a_mant, a_exp), deq(b_mant, b_exp))
