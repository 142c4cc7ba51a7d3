"""Public wrappers around the BFP kernels.

Counterpart of ``repro/kernels/ops.py``.  ``bfp_dense`` is the
training-facing op: a linear layer whose forward AND backward matmuls run
the BFP kernel.  The backward pass consumes transposed operands (Table I:
∇A = ∇O·Wᵀ, ∇W = Aᵀ·∇O); with *square* 2D BFP groups the transposed
quantization is exactly the transpose of the forward one (Q(Wᵀ) = Q(W)ᵀ).

There is no ``interpret`` switch: the tensors' device decides, as in every
kernel wrapper of the port (CPU → plain version, CUDA → kernel or raise).
``matmul``, ``quantize`` and ``matmul_packed`` are forward only, as in the
reference: under grad mode an input that requires grad raises
``RuntimeError`` in the kernel wrapper they call.  ``bfp_dense`` is its own
``autograd.Function``, whose forward and backward run with grad mode off.
Every wrapper refuses a DTensor operand (``TypeError``): no model calls
them on a mesh, and they have no route that runs on each rank's block.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import refuse_dtensor
from repro_torch.kernels.bfp_matmul import bfp_matmul
from repro_torch.kernels.bfp_quant import bfp_matmul_packed, bfp_quantize


@dataclasses.dataclass(frozen=True)
class BFPKernelConfig:
    group: int = 32
    mbits: int = 5
    ebits: int = 4
    block_m: int = 256
    block_n: int = 256
    block_k: int = 256


def matmul(a: torch.Tensor, b: torch.Tensor,
           cfg: BFPKernelConfig = BFPKernelConfig()) -> torch.Tensor:
    return bfp_matmul(a, b, group=cfg.group, mbits=cfg.mbits,
                      ebits=cfg.ebits, block_m=cfg.block_m,
                      block_n=cfg.block_n, block_k=cfg.block_k)


def quantize(x: torch.Tensor, cfg: BFPKernelConfig = BFPKernelConfig()):
    return bfp_quantize(x, group=cfg.group, mbits=cfg.mbits, ebits=cfg.ebits,
                        block_m=cfg.block_m, block_n=cfg.block_n)


def matmul_packed(a_mant, a_exp, b_mant, b_exp,
                  cfg: BFPKernelConfig = BFPKernelConfig()) -> torch.Tensor:
    return bfp_matmul_packed(a_mant, a_exp, b_mant, b_exp, group=cfg.group,
                             mbits=cfg.mbits, block_m=cfg.block_m,
                             block_n=cfg.block_n, block_k=cfg.block_k)


class _BFPDense(torch.autograd.Function):
    """Forward ``Q(x2)@Q(w)``; backward ``dx = Q(g2)@Q(wᵀ)``,
    ``dw = Q(x2ᵀ)@Q(g2)``: all three products through the kernel."""

    @staticmethod
    def forward(ctx, x, w, cfg):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        y = matmul(x.reshape(-1, x.shape[-1]), w, cfg)
        return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        g2 = g.reshape(-1, g.shape[-1]).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = matmul(g2, w.float().T, cfg).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = matmul(x.reshape(-1, x.shape[-1]).float().T, g2,
                        cfg).to(w.dtype)
        return dx, dw, None


def bfp_dense(x: torch.Tensor, w: torch.Tensor,
              cfg: BFPKernelConfig = BFPKernelConfig()) -> torch.Tensor:
    """``x @ w`` with both operands 2D-BFP quantized, kernel-backed.

    x: (..., K), w: (K, N) → (..., N) in x.dtype.
    """
    refuse_dtensor("bfp_dense", x, w)
    return _BFPDense.apply(x, w, cfg)
