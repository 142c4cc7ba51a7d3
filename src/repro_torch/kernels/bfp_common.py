"""Plain PyTorch versions of the in-tile 2D-BFP helpers.

Counterpart of ``repro/kernels/bfp_common.py``.  The same arithmetic runs in
the device functions of ``csrc/bfp.cu``: the exponent comes from the f32 bit
pattern (``floor(log2|x|)`` = biased exponent − 127, and −127 for zeros and
subnormals), mantissas round half to even (``torch.round``, ``rintf`` on the
card), and every scale is an exact power of two.  Below them: what the
kernels accept, the layout of the operand buffers, the bf16 GEMM that both
products end in (``gemm_tn``, with its plain version), and the ctypes
binding of ``csrc/bfp.cu`` that the wrappers of ``bfp_matmul.py`` and
``bfp_quant.py`` share.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import refuse_dtensor
from repro_torch.utils import ceil_to

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


# What the CUDA kernels of csrc/bfp.cu take: their 96-wide staging tiles
# hold whole groups of these sizes, and with at most 7 mantissa and exponent
# bits every scale is a normal f32, every mantissa fits int8 and every BFP
# value is exact in bf16.
SUPPORTED_GROUPS = (3, 8, 16, 32)

# The CTA tile of the bf16 GEMM of csrc/bfp.cu (bfp_gemm_tiles): rows of A,
# rows of Bq (columns of C), depth.  The operand passes pad to its multiples.
GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K = 128, 256, 64


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


def check_error(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def operand_shape(rows: int, k: int, tile_rows: int) -> tuple[int, int]:
    """Shape of an operand's bf16 GEMM buffer: (rows, k) padded to the tile
    multiples (``tile_rows``, ``GEMM_TILE_K``)."""
    return ceil_to(rows, tile_rows), ceil_to(k, GEMM_TILE_K)


def pad_operand(q: torch.Tensor, rows: int, k: int,
                tile_rows: int) -> torch.Tensor:
    """The values ``q`` of a (rows x k) operand, given at that size or
    larger with zeros past the matrix, as the GEMM's bf16 buffer: zero-padded
    or cut to ``operand_shape``, as the operand passes write it."""
    rp, kp = operand_shape(rows, k, tile_rows)
    out = torch.zeros((rp, kp), dtype=torch.bfloat16, device=q.device)
    r, c = min(rp, q.shape[0]), min(kp, q.shape[1])
    out[:r, :c] = q[:r, :c]
    return out


def tile_flags(buf: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The zero gate of a GEMM buffer: uint8 (rows/tile_rows, k/GEMM_TILE_K),
    1 where the (tile_rows x GEMM_TILE_K) tile holds a nonzero value."""
    rp, kp = buf.shape
    t = buf.reshape(rp // tile_rows, tile_rows, kp // GEMM_TILE_K,
                    GEMM_TILE_K)
    return (t != 0).any(dim=3).any(dim=1).to(torch.uint8)


def gemm_tn_plain(aq: torch.Tensor, bq: torch.Tensor, m: int,
                  n: int) -> torch.Tensor:
    """Plain version of the GEMM: ``aq @ bq.T`` in f32, cut to (m, n)."""
    return torch.matmul(aq.float(), bq.float().T)[:m, :n]


def gemm_tn(aq: torch.Tensor, bq: torch.Tensor, m: int, n: int,
            a_flags: torch.Tensor | None = None,
            b_flags: torch.Tensor | None = None) -> torch.Tensor:
    """C (m, n) f32 = ``aq @ bq.T`` over the operand passes' bf16 buffers
    (``aq`` (Mp, Kp), ``bq`` (Np, Kp)).  With both flags, a K step whose A
    or B tile is all zero is skipped (which changes no value).

    CPU tensors take ``gemm_tn_plain``; CUDA tensors launch the kernel
    (counted in ``gemm_tn.launches``) or raise; a DTensor raises
    ``TypeError``.
    """
    refuse_dtensor("gemm_tn", aq, bq)
    if aq.dim() != 2 or bq.dim() != 2 or \
            (aq.dtype, bq.dtype) != (torch.bfloat16, torch.bfloat16) or \
            bq.shape[1] != aq.shape[1] or bq.device != aq.device or \
            not (aq.is_contiguous() and bq.is_contiguous()):
        raise ValueError(f"gemm_tn takes contiguous bf16 (Mp, Kp) and "
                         f"(Np, Kp) buffers on one device, got {aq.dtype} "
                         f"{tuple(aq.shape)}, {bq.dtype} {tuple(bq.shape)}")
    (mp, kp), np_ = aq.shape, bq.shape[0]
    if (mp, np_, kp) != (ceil_to(mp, GEMM_TILE_M), ceil_to(np_, GEMM_TILE_N),
                         ceil_to(kp, GEMM_TILE_K)) or m > mp or n > np_:
        raise ValueError(f"gemm_tn: buffers {tuple(aq.shape)}, "
                         f"{tuple(bq.shape)} do not tile by "
                         f"{(GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K)} or are "
                         f"smaller than ({m}, {n})")
    if (a_flags is None) != (b_flags is None):
        raise ValueError("gemm_tn: give both zero-gate flags or neither")
    if aq.device.type == "cpu":
        return gemm_tn_plain(aq, bq, m, n)
    if aq.device.type != "cuda":
        raise ValueError(f"gemm_tn: unsupported device {aq.device}")
    c = torch.empty((m, n), dtype=torch.float32, device=aq.device)
    fa = 0 if a_flags is None else a_flags.data_ptr()
    fb = 0 if b_flags is None else b_flags.data_ptr()
    with torch.cuda.device(aq.device):
        err = bfp_library().bfp_gemm_fwd(
            aq.data_ptr(), bq.data_ptr(), c.data_ptr(), m, n, mp, np_, kp,
            fa, fb, cuda_stream(aq))
    check_error("gemm_tn", err)
    gemm_tn.launches += 1
    return c


gemm_tn.launches = 0


def bfp_library():
    """``csrc/bfp.cu``, built if needed, with its C entry points declared."""
    from repro_torch.kernels.build import load_library
    lib = load_library("bfp")
    if lib.bfp_gemm_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bfp_operand_fwd.argtypes = [p, i, i, i, ll, ll, p, i, i, i, i, i,
                                        p, i, i, p]
        lib.bfp_dequant_operand_fwd.argtypes = [p, p, i, i, ll, ll, ll, ll,
                                                p, i, i, i, i, i, i, p]
        lib.bfp_gemm_fwd.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.bfp_quantize_fwd.argtypes = [p, i, i, i, ll, ll, p, p, i, i, i,
                                         i, i, p]
        for fn in (lib.bfp_operand_fwd, lib.bfp_dequant_operand_fwd,
                   lib.bfp_gemm_fwd, lib.bfp_quantize_fwd):
            fn.restype = ctypes.c_int
        lib.bfp_gemm_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.bfp_gemm_tiles.restype = None
        tiles = (ctypes.c_int * 3)()
        lib.bfp_gemm_tiles(tiles)
        if tuple(tiles) != (GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K):
            raise RuntimeError(f"csrc/bfp.cu tiles its GEMM by "
                               f"{tuple(tiles)}, bfp_common.py by "
                               f"{(GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K)}")
    return lib
