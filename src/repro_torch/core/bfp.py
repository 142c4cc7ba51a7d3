"""2D Block Floating-Point (BFP) quantization — CAMEL §III-E.

Counterpart of ``repro/core/bfp.py``.  A matrix is tiled into *square* 2D
groups; each group shares one exponent and keeps per-element signed
mantissas, so quantization commutes with transposition, ``Q(Wᵀ) = Q(W)ᵀ``.

The integer mantissas and exponents are bit-identical to the JAX package:
``torch.frexp`` gives the same exponent as ``jnp.frexp`` and both
``torch.round`` and ``jnp.round`` round half to even.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx as dist_ctx
from repro_torch.utils import ceil_to

# Paper constants (Section III-E).
PAPER_GROUP: Tuple[int, int] = (3, 3)
PAPER_EBITS: int = 4
PAPER_MBITS: int = 5  # magnitude bits; sign is separate.


@dataclasses.dataclass
class BFPTensor:
    """A 2D-BFP-quantized matrix (last two dims grouped).

    ``mant``  int8  — signed mantissas, shape ``padded_shape``.
    ``exp``   int8  — shared exponents, one per group:
                      ``padded_shape[:-2] + (Mp/g1, Np/g2)``.
    """

    mant: torch.Tensor
    exp: torch.Tensor
    shape: Tuple[int, ...]        # logical (unpadded) shape
    group: Tuple[int, int]
    mbits: int

    @property
    def transpose(self) -> "BFPTensor":
        """Q(Wᵀ) = Q(W)ᵀ — the paper's transpose invariance (Fig 11)."""
        g1, g2 = self.group
        return BFPTensor(
            mant=self.mant.transpose(-1, -2),
            exp=self.exp.transpose(-1, -2),
            shape=tuple(self.shape[:-2]) + (self.shape[-1], self.shape[-2]),
            group=(g2, g1),
            mbits=self.mbits,
        )

    @property
    def bits_per_value(self) -> float:
        g1, g2 = self.group
        return (g1 * g2 * (1 + self.mbits) + PAPER_EBITS) / (g1 * g2)


def _floor_exponent(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2(amax)) as int32; 0 → -127 (group of zeros)."""
    _, e = torch.frexp(amax)         # amax = m * 2^e with m in [0.5, 1)
    e = e.to(torch.int32) - 1        # floor(log2 amax)
    return torch.where(amax > 0, e, torch.full_like(e, -127))


def _pad2d(x: torch.Tensor, group: Tuple[int, int]) -> torch.Tensor:
    g1, g2 = group
    m, n = x.shape[-2:]
    mp, np_ = ceil_to(m, g1), ceil_to(n, g2)
    if (mp, np_) == (m, n):
        return x
    return F.pad(x, (0, np_ - n, 0, mp - m))


def bfp_quantize(
    x: torch.Tensor,
    group: Tuple[int, int] = PAPER_GROUP,
    ebits: int = PAPER_EBITS,
    mbits: int = PAPER_MBITS,
) -> BFPTensor:
    """Quantize the last two dims of ``x`` into 2D BFP groups (Fig 10)."""
    if x.dim() < 2:
        raise ValueError(f"BFP needs >=2 dims, got shape {tuple(x.shape)}")
    g1, g2 = group
    orig_shape = tuple(x.shape)
    xp = _pad2d(x.to(torch.float32), group)
    *lead, mp, np_ = xp.shape
    xg = xp.reshape(*lead, mp // g1, g1, np_ // g2, g2)

    amax = torch.amax(xg.abs(), dim=(-3, -1), keepdim=True)
    e = _floor_exponent(amax)
    emin, emax = -(2 ** (ebits - 1)), 2 ** (ebits - 1) - 1
    e = torch.clamp(e, emin, emax)

    # exact power of two: the division below is exact up to rounding of x/scale
    scale = torch.exp2((e - (mbits - 1)).to(torch.float32))
    lim = 2 ** mbits - 1
    m = torch.clamp(torch.round(xg / scale), -lim, lim).to(torch.int8)

    mant = m.reshape(*lead, mp, np_)
    exp = e.squeeze(-1).squeeze(-2).to(torch.int8)
    return BFPTensor(mant=mant, exp=exp, shape=orig_shape, group=group,
                     mbits=mbits)


def bfp_dequantize(t: BFPTensor, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    g1, g2 = t.group
    *lead, mp, np_ = t.mant.shape
    mg = t.mant.reshape(*lead, mp // g1, g1, np_ // g2, g2).to(torch.float32)
    e = t.exp.to(torch.float32)[..., :, None, :, None]
    scale = torch.exp2(e - (t.mbits - 1))
    x = (mg * scale).reshape(*lead, mp, np_)
    m, n = t.shape[-2:]
    return x[..., :m, :n].to(dtype)


def _qdq(x, group, ebits, mbits):
    return bfp_dequantize(bfp_quantize(x, group, ebits, mbits), dtype=x.dtype)


def _qdq_rows(x, group, ebits, mbits):
    """``_qdq`` of ``x`` with its leading dims flattened into rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]) if x.dim() != 2 else x
    return _qdq(x2, group, ebits, mbits).reshape(shape)


class _QDQ(torch.autograd.Function):
    """Quantize→dequantize forward, identity backward (the STE).  With
    ``rows``, the leading dims flatten into rows, and a DTensor is
    quantized on each rank's block (``distributed.ctx.tiled``)."""

    @staticmethod
    def forward(ctx, x, group, ebits, mbits, rows=False):
        if not rows:
            return _qdq(x, group, ebits, mbits)
        return dist_ctx.tiled(
            lambda t: _qdq_rows(t, group, ebits, mbits), x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


def bfp_qdq(x: torch.Tensor,
            group: Tuple[int, int] = PAPER_GROUP,
            ebits: int = PAPER_EBITS,
            mbits: int = PAPER_MBITS) -> torch.Tensor:
    """Fake-quantize (quantize→dequantize) with a straight-through gradient.

    Operands pass through ``bfp_qdq`` in the forward pass; the backward pass
    sees identity (the ``custom_vjp`` of the JAX package).
    """
    return _QDQ.apply(x, tuple(group), ebits, mbits)


def bfp_qdq_rows(x: torch.Tensor,
                 group: Tuple[int, int] = PAPER_GROUP,
                 ebits: int = PAPER_EBITS,
                 mbits: int = PAPER_MBITS) -> torch.Tensor:
    """``bfp_qdq`` of ``x`` with its leading dims flattened into rows (so
    groups straddle sequences), in ``x``'s shape.  On a DTensor each rank
    quantizes its own block where it holds whole groups
    (``distributed.ctx.tiled``)."""
    return _QDQ.apply(x, tuple(group), ebits, mbits, True)


def bfp_matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    group: Tuple[int, int] = PAPER_GROUP,
    ebits: int = PAPER_EBITS,
    mbits: int = PAPER_MBITS,
) -> torch.Tensor:
    """Reference BFP matmul: quantize both operands, multiply in f32."""
    aq = _qdq(a.to(torch.float32), group, ebits, mbits)
    bq = _qdq(b.to(torch.float32), group, ebits, mbits)
    return torch.matmul(aq, bq)


def quantization_rmse(x: torch.Tensor, **kw) -> torch.Tensor:
    """RMS error of the BFP round-trip — used by fidelity benchmarks."""
    y = _qdq(x.to(torch.float32), kw.get("group", PAPER_GROUP),
             kw.get("ebits", PAPER_EBITS), kw.get("mbits", PAPER_MBITS))
    return torch.sqrt(torch.mean((x - y) ** 2))
