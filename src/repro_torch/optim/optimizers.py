"""Optimizers over nested dicts of tensors (functional, like the JAX package).

Counterpart of ``repro/optim/optimizers.py``: SGD+momentum (the paper's
optimizer, §VI-B) and AdamW; global-norm clipping before the update and
decoupled weight decay.  Updates return new tensors and never modify the
params or state they are given.  All states are f32.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.distributed import ctx
from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    clip_norm: float | None = 1.0


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0


OptConfig = Union[SGDConfig, AdamWConfig]


def global_norm(tree) -> torch.Tensor:
    # over DTensors, one reduction of the ranks' summed squares
    return torch.sqrt(ctx.total(lambda l: torch.sum(torch.square(l.float())),
                                tree_leaves(tree)))


def _clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def opt_init(cfg: OptConfig, params):
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    if isinstance(cfg, SGDConfig):
        return {"mu": zeros()}
    # no "step" yet: it appears after the first update, as in the JAX package
    return {"mu": zeros(), "nu": zeros()}


def opt_update(cfg: OptConfig, grads, state, params, lr):
    """Returns (new_params, new_state, metrics)."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm is not None:
        grads, gnorm = _clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)

    if isinstance(cfg, SGDConfig):
        mu = tree_map(lambda m, g: cfg.momentum * m + g, state["mu"], grads)
        upd = tree_map(lambda m, g: cfg.momentum * m + g, mu, grads) \
            if cfg.nesterov else mu
        new_params = tree_map(
            lambda p, u: (p - lr * (u + cfg.weight_decay * p)).to(p.dtype),
            params, upd)
        return new_params, {"mu": mu}, {"grad_norm": gnorm}

    # AdamW (bias-corrected via step count carried in the state)
    dev = tree_leaves(params)[0].device
    step = state.get("step", torch.zeros((), dtype=torch.int32,
                                         device=dev)) + 1
    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                  state["mu"], grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                  state["nu"], grads)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=dev), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=dev), stepf)
    new_params = tree_map(
        lambda p, m, v: (p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                                   + cfg.weight_decay * p)).to(p.dtype),
        params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm}
