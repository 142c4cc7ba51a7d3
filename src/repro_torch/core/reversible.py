"""Reversible block stacks with O(1) activation storage (CAMEL §II-C, §III).

Counterpart of ``repro/core/reversible.py``.  A reversible block computes

    y2 = x2 + F1(x1)        y1 = x1 + F2(y2)            (eq 1)

and its inputs are recoverable from its outputs:

    x1 = y1 − F2(y2)        x2 = y2 − F1(x1)            (eq 2)

``ReversibleStack`` runs L such blocks inside a ``torch.autograd.Function``
whose forward saves only the stack outputs ``(y1, y2)``, the injection
stream and the stacked params; its backward walks the blocks in reverse,
recomputes every block input by eq 2 under ``no_grad``, re-runs the block on
detached leaves and takes its VJP with ``torch.autograd.grad``.  So the
training step stores no per-block activations.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.utils import tree_flatten, tree_unflatten

# F1/F2 signature: (params, x) -> y with y.shape == x.shape.
ApplyFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _block_params(paths, leaves, i):
    return tree_unflatten([(pth, leaf[i]) for pth, leaf in zip(paths, leaves)])


class _ReversibleFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stack, paths, x1, x2, inj, *leaves):
        y1, y2 = stack._scan(paths, leaves, x1, x2, inj)
        # Residuals: ONLY the stack outputs + params/taps.
        ctx.save_for_backward(inj, y1, y2, *leaves)
        ctx.stack, ctx.paths = stack, paths
        return y1, y2

    @staticmethod
    def backward(ctx, g1, g2):
        inj, y1, y2, *leaves = ctx.saved_tensors
        stack, paths = ctx.stack, ctx.paths
        n = leaves[0].shape[0]
        gleaves = [[None] * n for _ in leaves]
        ginj = [None] * n
        for i in reversed(range(n)):
            p = _block_params(paths, leaves, i)
            z = inj[i]
            with torch.no_grad():                    # eq 2
                x1 = y1 - stack.f2(p["f2"], y2)
                x2 = (y2 - stack.f1(p["f1"], x1)) - z
            with torch.enable_grad():
                pl = [leaf[i].detach().requires_grad_() for leaf in leaves]
                x1d = x1.detach().requires_grad_()
                x2d = x2.detach().requires_grad_()
                zd = z.detach().requires_grad_()
                pd = tree_unflatten(list(zip(paths, pl)))
                y2_ = (x2d + zd) + stack.f1(pd["f1"], x1d)
                y1_ = x1d + stack.f2(pd["f2"], y2_)
                grads = torch.autograd.grad(
                    (y1_, y2_), (*pl, x1d, x2d, zd), (g1, g2),
                    allow_unused=True)
            *gp, g1, g2, gz = (torch.zeros_like(t) if g is None else g
                               for g, t in zip(grads, (*pl, x1d, x2d, zd)))
            for j, g in enumerate(gp):
                gleaves[j][i] = g
            ginj[i] = gz
            y1, y2 = x1, x2
        return (None, None, g1, g2, torch.stack(ginj),
                *(torch.stack(g) for g in gleaves))


class ReversibleStack:
    """A stack of reversible blocks with a memory-O(1) custom backward.

    Parameters are a nested dict whose leaves are stacked on a leading ``L``
    axis (one slice per block), holding sub-trees ``f1`` and ``f2``.  An
    optional injection stream ``inj`` (leading axis ``L``, broadcastable to
    ``x2``) is added to ``x2`` before each block; its gradient is returned so
    the tap projections train too.
    """

    def __init__(self, f1: ApplyFn, f2: ApplyFn):
        self.f1 = f1
        self.f2 = f2

    def _scan(self, paths, leaves, x1, x2, inj):
        for i in range(leaves[0].shape[0]):
            p = _block_params(paths, leaves, i)
            x2 = x2 + inj[i]                    # duplex tap injection
            y2 = x2 + self.f1(p["f1"], x1)      # eq 1
            x1 = x1 + self.f2(p["f2"], y2)
            x2 = y2
        return x1, x2

    @staticmethod
    def _default_inj(params, x):
        n_blocks = tree_flatten(params)[0][1].shape[0]
        return torch.zeros((n_blocks,) + (1,) * x.dim(), dtype=x.dtype,
                           device=x.device)

    def __call__(self, params, x1: torch.Tensor, x2: torch.Tensor,
                 inj: Optional[torch.Tensor] = None):
        if inj is None:
            inj = self._default_inj(params, x2)
        paths, leaves = zip(*tree_flatten(params))
        return _ReversibleFn.apply(self, paths, x1, x2, inj, *leaves)

    def forward_only(self, params, x1, x2, inj=None):
        """Inference path (no autograd registration)."""
        if inj is None:
            inj = self._default_inj(params, x2)
        paths, leaves = zip(*tree_flatten(params))
        with torch.no_grad():
            return self._scan(paths, leaves, x1, x2, inj)

    def invert(self, params, y1, y2, inj=None):
        """Recover stack inputs from outputs (eq 2)."""
        if inj is None:
            inj = self._default_inj(params, y2)
        paths, leaves = zip(*tree_flatten(params))
        with torch.no_grad():
            for i in reversed(range(leaves[0].shape[0])):
                p = _block_params(paths, leaves, i)
                x1 = y1 - self.f2(p["f2"], y2)
                x2 = y2 - self.f1(p["f1"], x1) - inj[i]
                y1, y2 = x1, x2
        return y1, y2


def stack_params(init_fn: Callable[[tuple], Any], n_blocks: int) -> Any:
    """Initialize L block param trees stacked on a leading axis.

    ``init_fn(lead)`` builds one tree whose leaves carry the leading shape
    ``lead`` — here ``(n_blocks,)`` — the layout the JAX package's vmapped
    init produces.
    """
    return init_fn((n_blocks,))
