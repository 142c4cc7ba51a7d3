"""Flash attention forward: hand-written CUDA kernel + its plain version.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (the Pallas TPU
kernel).  ``flash_attention`` keeps the JAX signature and validation: q
``[B,H,Sq,d]``, k/v ``[B,KV,Skv,d]``, GQA with kv head ``h // (H/KV)``,
top-left causal mask (key position <= query position), masked scores -1e30,
optional softcap ``cap·tanh(s/cap)`` after the 1/√d scale, f32 softmax
state, output ``[B,H,Sq,d]`` in ``q.dtype``.  ``q_chunk``/``kv_chunk`` are
the reference's tiling contract (Sq and Skv must tile by them); the GPU
kernels use their own tiles (``csrc/flash_attention.cu``).

Dispatch: a tensor on the CPU takes ``flash_attention_plain``; a CUDA
tensor launches the kernel (``csrc/flash_attention.cu``, f32 or bf16 I/O,
head dim 64, 128 or 256) or raises.  The kernel takes element strides, so the
``[B,S,H,d] → [B,H,S,d]`` transposed views that ``attention_layer`` passes
go in without a copy; the output is allocated with the same layout as q
(``torch.empty_like``), so transposing it back is a contiguous tensor.
The bf16 kernel loads its tiles with TMA, which needs 16-byte aligned
bases and strides: a bf16 operand whose pointer is not 16-byte aligned or
whose strides are not multiples of 8 is copied to a fresh contiguous
tensor first (the main path's views never are).

Design (bf16, the main path): one CTA per (128-query tile, head, batch); a
producer warpgroup loads Q once and 128-key K/V tiles into a two-stage ring
with TMA; two consumer warpgroups of 64 query rows run S = Q·Kᵀ and
O += P·V on ``wgmma`` (P from registers, V read MN-major) with the online
softmax on the score fragments between them.  At head dim 256 (gemma2's
global layers) that layout needs 321 KB of shared memory and more
registers than 384 threads leave, so bf16 d=256 runs its own kernel:
64-key tiles (192 KB with Q), no producer warpgroup (256 threads, up to
255 registers a thread for the 64 x 256 f32 output fragment), the loads
issued by one consumer thread.  f32 inputs run a SIMT kernel (64 x 64
tiles) that meets the 2e-5 check.

Bound at the main path's shapes (B=2, H=32, KV=8, S=4096, d=128, bf16,
causal): 4·B·H·d·S(S+1)/2 = 275 GFLOP per launch — 0.28 ms at the H100's
989 TFLOP/s bf16 peak — against 168 MB of q/k/v/o, 0.05 ms at 3.35 TB/s:
compute-bound.  At gemma2's global layers (B=2, H=16, KV=8, S=4096, d=256)
the FLOPs are the same 275 GFLOP.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import refuse_autograd, refuse_dtensor

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          softcap: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: materialised f32 scores."""
    b, h, sq, d = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    g = h // nkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w, vf).to(q.dtype)


def _check_cuda_args(q, k, v, softcap):
    b, h, sq, d = q.shape
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype, k.dtype, v.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a contiguous head dim")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def _aligned16(t: torch.Tensor) -> bool:
    """16-byte aligned pointer, batch/head/sequence strides multiples of 8."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _launch(q, k, v, causal, softcap) -> torch.Tensor:
    from repro_torch.kernels.build import load_library
    _check_cuda_args(q, k, v, softcap)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _aligned16(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    lib = load_library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i] + [ll] * 12 + \
            [i, f, f, p]
        fn.restype = ctypes.c_int
    b, h, sq, d = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, h, nkv, sq, skv, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], int(causal),
                 0.0 if softcap is None else float(softcap),
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float | None = None,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Fused flash attention; returns [B, H, Sq, d] in q.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``) or raise.  Forward only: an
    input that requires grad under grad mode raises ``RuntimeError``.  A
    DTensor raises ``TypeError``: on a mesh, ``models/layers.py::
    attention_layer`` runs this function on each rank's local block.
    """
    refuse_dtensor("flash_attention", q, k, v)
    refuse_autograd("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    _, nkv, skv, _ = k.shape
    if h % nkv:
        raise ValueError(f"{h} query heads not a multiple of {nkv} kv heads")
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"seq lens {(sq, skv)} must tile by chunks "
                         f"{(q_chunk, kv_chunk)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, softcap)


flash_attention.launches = 0
