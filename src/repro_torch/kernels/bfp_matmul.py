"""Fused 2D-BFP matmul ``Q(A) @ Q(B)``: hand-written CUDA kernel + its plain
version.

Replaces ``repro/kernels/bfp_matmul.py::bfp_matmul`` (Pallas body
``_bfp_matmul_kernel``).  ``bfp_matmul`` keeps the JAX keyword signature and
validation: 2D operands, matching K, blocks that are multiples of the group
(``ValueError`` otherwise), f32 accumulation, output ``(M, N)`` in
``out_dtype``.  ``block_*`` are the reference's tiling contract only; the
CUDA kernel (``csrc/bfp.cu``) uses its own 96 x 96 tiles, which hold whole
groups of every supported size, so the result is the same.

Dispatch: a tensor on the CPU takes ``bfp_matmul_plain``; a CUDA tensor
launches the kernel (f32 or bf16 operands, read through their strides, so
transposed views need no copy; a mixed pair is cast to f32 first, as the
reference casts both) or raises.  ``skip_zero_groups`` is the kernel's
tile-level gate and changes no value, so the plain version has no gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.bfp_common import (DTYPE_CODE, bfp_library,
                                            check_kernel_args, cuda_stream,
                                            qdq_block)
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


def _launch(a, b, group, mbits, ebits, skip_zero_groups) -> torch.Tensor:
    check_kernel_args("bfp_matmul", group, mbits, ebits)
    if not (b.is_cuda and a.device == b.device):
        raise ValueError("bfp_matmul: a and b must be on one CUDA device")
    if a.dtype not in DTYPE_CODE or b.dtype not in DTYPE_CODE:
        raise ValueError(f"bfp_matmul kernel takes float32 or bfloat16 "
                         f"operands, got {a.dtype, b.dtype}")
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = bfp_library().bfp_matmul_fwd(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), DTYPE_CODE[a.dtype],
            m, k, n, *a.stride(), *b.stride(), group, mbits, ebits,
            int(skip_zero_groups), cuda_stream(a))
    if err != 0:
        raise RuntimeError(f"bfp_matmul kernel launch failed: cudaError {err}")
    bfp_matmul.launches += 1
    return c


def bfp_matmul(a: torch.Tensor, b: torch.Tensor, *, group: int = 32,
               mbits: int = 5, ebits: int = 4, block_m: int = 256,
               block_n: int = 256, block_k: int = 256,
               skip_zero_groups: bool = False,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``Q(a) @ Q(b)`` with square-group 2D BFP operands, f32 accumulate.

    ``a``: (M, K), ``b``: (K, N).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``bfp_matmul.launches``) or raise.
    """
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
