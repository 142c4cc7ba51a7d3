"""2D-BFP matmul ``Q(A) @ Q(B)``: hand-written CUDA kernels + their plain
versions.

Replaces ``repro/kernels/bfp_matmul.py::bfp_matmul`` (Pallas body
``_bfp_matmul_kernel``).  ``bfp_matmul`` keeps the JAX keyword signature and
validation: 2D operands, matching K, blocks that are multiples of the group
(``ValueError`` otherwise), f32 accumulation, output ``(M, N)`` in
``out_dtype``.  ``block_*`` are the reference's tiling contract only; the
CUDA kernels (``csrc/bfp.cu``) use their own tiles, so the result is the
same.

On the card the product is two stages: ``quantize_operand`` writes each
operand's ``Q(x)`` once as a bf16 buffer in the GEMM's layout (A as is, B
through its transposed view, since Q(Bᵀ) = Q(B)ᵀ for square groups), then
``bfp_common.gemm_tn`` multiplies the two buffers.  Dispatch: a tensor on
the CPU takes the plain version (``bfp_matmul_plain``, and
``quantize_operand_plain`` for the stage); a CUDA tensor launches the
kernels (f32 or bf16 operands, read through their strides, so transposed
views need no copy; a mixed pair is cast to f32 first, as the reference
casts both) or raises.  ``skip_zero_groups`` is the reference's tile-level
gate and changes no value, so the plain version has no gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd, refuse_dtensor
from repro_torch.kernels.bfp_common import (DTYPE_CODE, GEMM_TILE_K,
                                            GEMM_TILE_M, GEMM_TILE_N,
                                            bfp_library, check_error,
                                            check_kernel_args, cuda_stream,
                                            gemm_tn, operand_shape,
                                            pad_operand, qdq_block,
                                            tile_flags)
from repro_torch.utils import ceil_to


def _qdq_padded(x: torch.Tensor, group: int, mbits: int, ebits: int):
    m, n = x.shape
    xp = F.pad(x.to(torch.float32), (0, ceil_to(n, group) - n,
                                     0, ceil_to(m, group) - m))
    return qdq_block(xp, group, mbits, ebits)


def bfp_matmul_plain(a: torch.Tensor, b: torch.Tensor, *, group: int = 32,
                     mbits: int = 5, ebits: int = 4) -> torch.Tensor:
    """Plain version of the kernel: global group qdq of the zero-padded
    operands, then one f32 product cut back to (M, N)."""
    m, n = a.shape[0], b.shape[1]
    return torch.matmul(_qdq_padded(a, group, mbits, ebits),
                        _qdq_padded(b, group, mbits, ebits))[:m, :n]


def quantize_operand_plain(x: torch.Tensor, tile_rows: int, *,
                           group: int = 32, mbits: int = 5, ebits: int = 4,
                           gate: bool = False):
    """Plain version of the operand pass: ``qdq_block`` of the zero-padded
    ``x`` (rows x K) as bf16, in the GEMM layout (``operand_shape``), and
    with ``gate`` its tile flags (``tile_flags``), else None."""
    buf = pad_operand(_qdq_padded(x, group, mbits, ebits), *x.shape,
                      tile_rows)
    return buf, tile_flags(buf, tile_rows) if gate else None


def quantize_operand(x: torch.Tensor, tile_rows: int, *, group: int = 32,
                     mbits: int = 5, ebits: int = 4, gate: bool = False):
    """One operand of the GEMM: ``Q(x)`` of ``x`` (rows x K, f32 or bf16,
    any strides) as a bf16 (Rp, Kp) buffer, zeros past the matrix, and with
    ``gate`` the uint8 flags of its nonzero (tile_rows x GEMM_TILE_K) tiles.

    CPU tensors take ``quantize_operand_plain``; CUDA tensors launch the
    operand pass (counted in ``quantize_operand.launches``) or raise.
    """
    refuse_dtensor("quantize_operand", x)
    if x.device.type == "cpu":
        return quantize_operand_plain(x, tile_rows, group=group, mbits=mbits,
                                      ebits=ebits, gate=gate)
    check_kernel_args("quantize_operand", group, mbits, ebits)
    if x.device.type != "cuda" or x.dim() != 2 or x.dtype not in DTYPE_CODE:
        raise ValueError(f"quantize_operand takes a 2D float32 or bfloat16 "
                         f"CUDA tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    (rows, k), (rp, kp) = x.shape, operand_shape(*x.shape, tile_rows)
    buf = torch.empty((rp, kp), dtype=torch.bfloat16, device=x.device)
    flags = torch.empty((rp // tile_rows, kp // GEMM_TILE_K),
                        dtype=torch.uint8, device=x.device) if gate else None
    with torch.cuda.device(x.device):
        err = bfp_library().bfp_operand_fwd(
            x.data_ptr(), DTYPE_CODE[x.dtype], rows, k, *x.stride(),
            buf.data_ptr(), rp, kp, group, mbits, ebits,
            0 if flags is None else flags.data_ptr(), tile_rows, GEMM_TILE_K,
            cuda_stream(x))
    check_error("quantize_operand", err)
    quantize_operand.launches += 1
    return buf, flags


quantize_operand.launches = 0


def _launch(a, b, group, mbits, ebits, skip_zero_groups) -> torch.Tensor:
    check_kernel_args("bfp_matmul", group, mbits, ebits)
    if not (b.is_cuda and a.device == b.device):
        raise ValueError("bfp_matmul: a and b must be on one CUDA device")
    if a.dtype not in DTYPE_CODE or b.dtype not in DTYPE_CODE:
        raise ValueError(f"bfp_matmul kernel takes float32 or bfloat16 "
                         f"operands, got {a.dtype, b.dtype}")
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    kw = dict(group=group, mbits=mbits, ebits=ebits, gate=skip_zero_groups)
    aq, fa = quantize_operand(a, GEMM_TILE_M, **kw)
    bq, fb = quantize_operand(b.T, GEMM_TILE_N, **kw)
    c = gemm_tn(aq, bq, a.shape[0], b.shape[1], fa, fb)
    bfp_matmul.launches += 1
    return c


def bfp_matmul(a: torch.Tensor, b: torch.Tensor, *, group: int = 32,
               mbits: int = 5, ebits: int = 4, block_m: int = 256,
               block_n: int = 256, block_k: int = 256,
               skip_zero_groups: bool = False,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``Q(a) @ Q(b)`` with square-group 2D BFP operands, f32 accumulate.

    ``a``: (M, K), ``b``: (K, N).  CPU tensors take the plain version; CUDA
    tensors launch the operand passes and the GEMM (one count in
    ``bfp_matmul.launches`` per product) or raise.  Forward only: an input
    that requires grad under grad mode raises ``RuntimeError``; a DTensor
    operand raises ``TypeError``.
    """
    refuse_dtensor("bfp_matmul", a, b)
    refuse_autograd("bfp_matmul", a, b)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected 2D operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    for blk in (block_m, block_n, block_k):
        if blk % group:
            raise ValueError(f"block size {blk} not a multiple of group "
                             f"{group}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        out = bfp_matmul_plain(a, b, group=group, mbits=mbits, ebits=ebits)
    elif a.device.type == "cuda":
        out = _launch(a, b, group, mbits, ebits, skip_zero_groups)
    else:
        raise ValueError(f"bfp_matmul: unsupported devices "
                         f"{a.device}, {b.device}")
    return out.to(out_dtype)


bfp_matmul.launches = 0
