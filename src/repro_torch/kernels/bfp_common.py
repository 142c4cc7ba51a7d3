"""Plain PyTorch versions of the in-tile 2D-BFP helpers.

Counterpart of ``repro/kernels/bfp_common.py``.  The same arithmetic runs in
the device functions of ``csrc/bfp.cu``: the exponent comes from the f32 bit
pattern (``floor(log2|x|)`` = biased exponent − 127, and −127 for zeros and
subnormals), mantissas round half to even (``torch.round``, ``rintf`` on the
card), and every scale is an exact power of two.  Below them: what the
kernels accept, and the ctypes binding of ``csrc/bfp.cu`` that the wrappers
of ``bfp_matmul.py`` and ``bfp_quant.py`` share.
"""
from __future__ import annotations

import ctypes

import torch

F32_EXP_BIAS = 127


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x >= 0 (f32), elementwise; x == 0 → -127."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - F32_EXP_BIAS
    return torch.where(x > 0, e, torch.full_like(e, -F32_EXP_BIAS))


def group_exponent(x: torch.Tensor, g: int, ebits: int) -> torch.Tensor:
    """Shared exponent per (g×g) group of a 2D block; shape (M/g, 1, N/g, 1)."""
    bm, bn = x.shape
    xg = x.reshape(bm // g, g, bn // g, g)
    amax = torch.amax(xg.abs(), dim=(1, 3), keepdim=True)
    e = floor_log2(amax)
    lo, hi = -(2 ** (ebits - 1)), 2 ** (ebits - 1) - 1
    return torch.clamp(e, lo, hi)


def _mantissas(x: torch.Tensor, g: int, mbits: int, ebits: int):
    bm, bn = x.shape
    x = x.to(torch.float32)
    e = group_exponent(x, g, ebits)
    xg = x.reshape(bm // g, g, bn // g, g)
    scale = torch.exp2((e - (mbits - 1)).to(torch.float32))
    lim = float(2 ** mbits - 1)
    return torch.clamp(torch.round(xg / scale), -lim, lim), scale, e


def qdq_block(x: torch.Tensor, g: int, mbits: int, ebits: int) -> torch.Tensor:
    """Quantize→dequantize a 2D f32 block with square (g×g) BFP groups."""
    m, scale, _ = _mantissas(x, g, mbits, ebits)
    return (m * scale).reshape(x.shape)


def quant_block(x: torch.Tensor, g: int, mbits: int, ebits: int):
    """Quantize a 2D block → (mant int8 [bm,bn], exp int8 [bm/g,bn/g])."""
    bm, bn = x.shape
    m, _, e = _mantissas(x, g, mbits, ebits)
    mant = m.reshape(bm, bn).to(torch.int8)
    exp = e.reshape(bm // g, bn // g).to(torch.int8)
    return mant, exp


def dequant_block(mant: torch.Tensor, exp: torch.Tensor, g: int,
                  mbits: int) -> torch.Tensor:
    bm, bn = mant.shape
    mg = mant.reshape(bm // g, g, bn // g, g).to(torch.float32)
    e = exp.to(torch.float32)[:, None, :, None]
    return (mg * torch.exp2(e - (mbits - 1))).reshape(bm, bn)


# What the CUDA kernels of csrc/bfp.cu take: their 96-wide tiles hold whole
# groups of these sizes, and with at most 7 mantissa and exponent bits every
# scale is a normal f32 and every mantissa fits int8.
SUPPORTED_GROUPS = (3, 8, 16, 32)


def check_kernel_args(name: str, group: int, mbits: int, ebits: int = 1):
    """Raise ``ValueError`` for what the CUDA kernels do not take."""
    if group not in SUPPORTED_GROUPS:
        raise ValueError(f"{name} kernel supports groups {SUPPORTED_GROUPS}, "
                         f"got {group}")
    if not (1 <= mbits <= 7 and 1 <= ebits <= 7):
        raise ValueError(f"{name} kernel takes 1..7 mantissa and exponent "
                         f"bits, got mbits={mbits}, ebits={ebits}")


# The kernels' dtype argument for floating operands.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def cuda_stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def bfp_library():
    """``csrc/bfp.cu``, built if needed, with its three C entry points
    declared."""
    from repro_torch.kernels.build import load_library
    lib = load_library("bfp")
    if lib.bfp_matmul_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bfp_matmul_fwd.argtypes = [p, p, p, i, i, i, i, ll, ll, ll, ll,
                                       i, i, i, i, p]
        lib.bfp_quantize_fwd.argtypes = [p, i, i, i, ll, ll, p, p, i, i, i,
                                         i, i, p]
        lib.bfp_matmul_packed_fwd.argtypes = [p, p, p, p, p, i, i, i,
                                              ctypes.POINTER(ll), i, i, p]
        for fn in (lib.bfp_matmul_fwd, lib.bfp_quantize_fwd,
                   lib.bfp_matmul_packed_fwd):
            fn.restype = ctypes.c_int
    return lib
