"""Standalone 2D-BFP quantization and the matmul of packed operands: CUDA
kernels + their plain versions.

Replaces the two Pallas kernels of ``repro/kernels/bfp_quant.py``:

* ``bfp_quantize`` is the counterpart of ``bfp_quantize_pallas`` (body
  ``_quant_kernel``): f32 or bf16 ``(M, N)`` → int8 mantissas ``(Mp, Np)``
  and int8 per-group exponents ``(Mp/g, Np/g)``, padded to the reference's
  *block* multiples (``bm = min(block_m, ceil(M, g))``, ``Mp = ceil(M, bm)``),
  the padding quantized from zeros.  Bit-exact with the reference.
* ``bfp_matmul_packed`` (body ``_packed_matmul_kernel``): the product of
  packed operands, ``mant·2^(exp−mbits+1)``, f32 accumulate, f32 out; dims
  must be group-padded and tile by the blocks.  On the card it is two
  stages: ``dequantize_operand`` writes each operand once as a bf16 buffer
  in the GEMM's layout (B through its transposed view), then
  ``bfp_common.gemm_tn``, the GEMM that ``bfp_matmul`` ends in too.

Dispatch as everywhere in the port: CPU tensors take the plain version, a
CUDA tensor launches the kernels of ``csrc/bfp.cu`` (operands read through
their strides) or raises.  Each wrapper counts its launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd, refuse_dtensor
from repro_torch.kernels.bfp_common import (DTYPE_CODE, GEMM_TILE_K,
                                            GEMM_TILE_M, GEMM_TILE_N,
                                            bfp_library, check_error,
                                            check_kernel_args, cuda_stream,
                                            dequant_block, gemm_tn,
                                            operand_shape, pad_operand,
                                            quant_block)
from repro_torch.utils import ceil_to


def _padded_shape(m, n, group, block_m, block_n):
    bm, bn = min(block_m, ceil_to(m, group)), min(block_n, ceil_to(n, group))
    if bm % group or bn % group:
        raise ValueError(f"blocks {(bm, bn)} not multiples of group {group}")
    return ceil_to(m, bm), ceil_to(n, bn)


def bfp_quantize_plain(x: torch.Tensor, *, group: int = 32, mbits: int = 5,
                       ebits: int = 4, block_m: int = 256,
                       block_n: int = 256):
    """Plain version of the quantize kernel: zero-pad, then quant_block."""
    m, n = x.shape
    mp, np_ = _padded_shape(m, n, group, block_m, block_n)
    xp = F.pad(x.to(torch.float32), (0, np_ - n, 0, mp - m))
    return quant_block(xp, group, mbits, ebits)


def bfp_quantize(x: torch.Tensor, *, group: int = 32, mbits: int = 5,
                 ebits: int = 4, block_m: int = 256, block_n: int = 256):
    """Quantize a 2D array → (mant int8, exp int8) in packed layout.

    Counterpart of the JAX ``bfp_quantize_pallas``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    ``bfp_quantize.launches``) or raise.  Forward only: an input that
    requires grad under grad mode raises ``RuntimeError``; a DTensor raises
    ``TypeError``.
    """
    refuse_dtensor("bfp_quantize", x)
    refuse_autograd("bfp_quantize", x)
    if x.dim() != 2:
        raise ValueError(f"expected 2D input, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bfp_quantize_plain(x, group=group, mbits=mbits, ebits=ebits,
                                  block_m=block_m, block_n=block_n)
    if x.device.type != "cuda":
        raise ValueError(f"bfp_quantize: unsupported device {x.device}")
    check_kernel_args("bfp_quantize", group, mbits, ebits)
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"bfp_quantize kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    m, n = x.shape
    mp, np_ = _padded_shape(m, n, group, block_m, block_n)
    mant = torch.empty((mp, np_), dtype=torch.int8, device=x.device)
    exp = torch.empty((mp // group, np_ // group), dtype=torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = bfp_library().bfp_quantize_fwd(
            x.data_ptr(), DTYPE_CODE[x.dtype], m, n, *x.stride(),
            mant.data_ptr(), exp.data_ptr(), mp, np_, group, mbits, ebits,
            cuda_stream(x))
    check_error("bfp_quantize", err)
    bfp_quantize.launches += 1
    return mant, exp


bfp_quantize.launches = 0


def bfp_matmul_packed_plain(a_mant, a_exp, b_mant, b_exp, *, group: int = 32,
                            mbits: int = 5) -> torch.Tensor:
    """Plain version of the packed kernel: dequantize both, f32 product."""
    return torch.matmul(dequant_block(a_mant, a_exp, group, mbits),
                        dequant_block(b_mant, b_exp, group, mbits))


def dequantize_operand_plain(mant: torch.Tensor, exp: torch.Tensor,
                             tile_rows: int, *, group: int = 32,
                             mbits: int = 5) -> torch.Tensor:
    """Plain version of the packed operand pass: ``dequant_block`` as bf16,
    in the GEMM layout (``operand_shape``)."""
    return pad_operand(dequant_block(mant, exp, group, mbits), *mant.shape,
                       tile_rows)


def dequantize_operand(mant: torch.Tensor, exp: torch.Tensor, tile_rows: int,
                       *, group: int = 32, mbits: int = 5) -> torch.Tensor:
    """One packed operand of the GEMM: int8 mantissas (rows x K) and
    exponents (rows/g x K/g), any strides, as the bf16 (Rp, Kp) buffer of
    ``mant·2^(exp−mbits+1)``, zeros past the matrix.

    CPU tensors take ``dequantize_operand_plain``; CUDA tensors launch the
    operand pass (counted in ``dequantize_operand.launches``) or raise.
    """
    refuse_dtensor("dequantize_operand", mant, exp)
    if mant.device.type == "cpu":
        return dequantize_operand_plain(mant, exp, tile_rows, group=group,
                                        mbits=mbits)
    check_kernel_args("dequantize_operand", group, mbits)
    (rows, k), (rp, kp) = mant.shape, operand_shape(*mant.shape, tile_rows)
    if mant.device.type != "cuda" or exp.device != mant.device or \
            (mant.dtype, exp.dtype) != (torch.int8, torch.int8) or \
            rows % group or k % group or \
            tuple(exp.shape) != (rows // group, k // group):
        raise ValueError(f"dequantize_operand takes group-padded int8 "
                         f"mantissas and their exponents on one CUDA device, "
                         f"got {mant.dtype} {tuple(mant.shape)}, {exp.dtype} "
                         f"{tuple(exp.shape)} on {mant.device}, "
                         f"{exp.device}")
    buf = torch.empty((rp, kp), dtype=torch.bfloat16, device=mant.device)
    with torch.cuda.device(mant.device):
        err = bfp_library().bfp_dequant_operand_fwd(
            mant.data_ptr(), exp.data_ptr(), rows, k, *mant.stride(),
            *exp.stride(), buf.data_ptr(), rp, kp, group, mbits, tile_rows,
            GEMM_TILE_K, cuda_stream(mant))
    check_error("dequantize_operand", err)
    dequantize_operand.launches += 1
    return buf


dequantize_operand.launches = 0


def _launch_packed(a_mant, a_exp, b_mant, b_exp, group, mbits):
    """Both operand passes (which check dtypes, devices and exponent
    shapes), then the GEMM."""
    aq = dequantize_operand(a_mant, a_exp, GEMM_TILE_M, group=group,
                            mbits=mbits)
    bq = dequantize_operand(b_mant.T, b_exp.T, GEMM_TILE_N, group=group,
                            mbits=mbits)
    c = gemm_tn(aq, bq, a_mant.shape[0], b_mant.shape[1])
    bfp_matmul_packed.launches += 1
    return c


def bfp_matmul_packed(a_mant, a_exp, b_mant, b_exp, *, group: int = 32,
                      mbits: int = 5, block_m: int = 256, block_n: int = 256,
                      block_k: int = 256,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Matmul on pre-quantized packed operands (mant/exp from the quantizer).

    CPU tensors take the plain version; CUDA tensors launch the operand
    passes and the GEMM (one count in ``bfp_matmul_packed.launches`` per
    product) or raise.  Forward only, like every kernel wrapper (integer
    operands cannot require grad, so only float inputs are checked).  A
    DTensor operand raises ``TypeError``.
    """
    refuse_dtensor("bfp_matmul_packed", a_mant, a_exp, b_mant, b_exp)
    refuse_autograd("bfp_matmul_packed", a_mant, a_exp, b_mant, b_exp)
    (m, k), (k2, n) = a_mant.shape, b_mant.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a_mant.shape)} @ "
                         f"{tuple(b_mant.shape)}")
    if m % group or k % group or n % group:
        raise ValueError("packed operands must already be group-padded")
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"dims {(m, k, n)} must tile by blocks "
                         f"{(bm, bk, bn)}")
    ops = (a_mant, a_exp, b_mant, b_exp)
    if all(t.device.type == "cpu" for t in ops):
        out = bfp_matmul_packed_plain(*ops, group=group, mbits=mbits)
    elif a_mant.device.type == "cuda":
        out = _launch_packed(*ops, group, mbits)
    else:
        raise ValueError(f"bfp_matmul_packed: unsupported devices "
                         f"{[str(t.device) for t in ops]}")
    return out.to(out_dtype)


bfp_matmul_packed.launches = 0
