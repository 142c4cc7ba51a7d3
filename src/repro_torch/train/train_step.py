"""Train steps: the paper's Duplex regime (frozen backbone + reversible
branch) as the first-class path, plus the full-finetune baseline (the
paper's FR comparison arm).

Counterpart of ``repro/train/train_step.py``.
Duplex step dataflow (paper Fig 9):
  1. backbone forward in ``backbone_dtype`` under ``torch.no_grad()``,
     collecting pooled per-superblock taps — no backbone activations kept;
  2. reversible branch over pooled streams (O(1) saved activations);
  3. correction added to the detached backbone hidden; the frozen
     unembedding produces logits, so the gradient reaches the branch
     through it;
  4. gradients and the optimizer touch ONLY the branch params.

``mode="full"`` differentiates the whole backbone, kept at its f32 init
dtype, with the loss plus ``aux_weight·aux``.  It runs the backbone under
autograd, so with ``use_flash`` it raises: the flash kernel is forward
only, as ``jax.grad`` through the reference's raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.common import ModelConfig
from repro_torch.core import duplex as dx
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import constrain
from repro_torch.models import layers as L
from repro_torch.optim import OptConfig, SGDConfig, opt_init, opt_update
from repro_torch.train.losses import lm_cross_entropy
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    mode: str = "duplex"                   # duplex | full
    duplex: dx.DuplexConfig = dx.DuplexConfig()
    opt: OptConfig = SGDConfig()
    lr: float = 1e-3
    lr_schedule: Callable | None = None    # step → lr (overrides .lr)
    z_loss: float = 1e-4
    aux_weight: float = 1e-2               # MoE load-balance weight (full mode)
    microbatch: int = 1                    # gradient-accumulation splits
    backbone_dtype: torch.dtype = torch.bfloat16   # frozen storage precision


def tap_indices(n_rep: int, n_blocks: int) -> np.ndarray:
    """Evenly spaced backbone superblocks feeding the branch blocks."""
    if n_rep <= 0:
        raise ValueError("backbone has no scanned blocks to tap")
    return np.round(np.linspace(0, n_rep - 1, n_blocks)).astype(np.int32)


def init_state(gen: torch.Generator, entry, cfg: ModelConfig,
               tcfg: TrainConfig, policy: L.Policy = L.Policy(), *,
               device=None) -> dict:
    """Duplex: ``{"step", "backbone", "branch", "opt"}``, the backbone drawn
    straight into ``backbone_dtype``.  Full: ``{"step", "backbone", "opt"}``,
    the backbone at its f32 init dtype and the optimizer state over all of
    it.  No tensor requires grad."""
    step = torch.zeros((), dtype=torch.int32, device=device)
    if tcfg.mode != "duplex":
        backbone = entry.module.init_params(gen, cfg, device=device)
        return {"step": step, "backbone": backbone,
                "opt": opt_init(tcfg.opt, backbone)}
    backbone = entry.module.init_params(gen, cfg, dtype=tcfg.backbone_dtype,
                                        device=device)
    branch = dx.duplex_init(gen, tcfg.duplex, cfg.d_model, device=device)
    return {"step": step, "backbone": backbone, "branch": branch,
            "opt": opt_init(tcfg.opt, branch)}


def _lr(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    if tcfg.lr_schedule is not None:
        return tcfg.lr_schedule(step)
    # laid out as the step (a replicated DTensor on a mesh)
    return torch.full_like(step, tcfg.lr, dtype=torch.float32)


def make_loss_fn(entry, cfg: ModelConfig, tcfg: TrainConfig,
                 policy: L.Policy = L.Policy()):
    """Returns ``loss_fn(trainable, frozen, batch) -> (loss, metrics)``, the
    loss that ``make_train_step`` differentiates: duplex ``(branch,
    backbone, batch)``, full ``(backbone, None, batch)``."""
    module = entry.module

    def frontend_kw(batch):
        fe = batch.get("frontend")
        return {} if fe is None else {"frontend": fe}

    if tcfg.mode != "duplex":
        def full_loss_fn(backbone, _unused, batch):
            out = module.forward(backbone, cfg, batch["tokens"],
                                 policy=policy, **frontend_kw(batch))
            logits = module.lm_logits(backbone, cfg, out["hidden"], policy)
            loss, metrics = lm_cross_entropy(logits, batch["labels"],
                                             batch.get("mask"),
                                             z_loss=tcfg.z_loss)
            return loss + tcfg.aux_weight * out["aux"], metrics

        return full_loss_fn

    idx = tap_indices(cfg.n_rep, tcfg.duplex.n_blocks)

    def loss_fn(branch, backbone, batch):
        with torch.no_grad():
            out = module.forward(backbone, cfg, batch["tokens"],
                                 collect_taps=True, tap_indices=idx,
                                 tap_pool=tcfg.duplex.pool_factor,
                                 policy=policy, **frontend_kw(batch))
        corr = dx.duplex_apply(branch, tcfg.duplex, out["emb"], out["taps"],
                               policy=policy, taps_pooled=True)
        # laid out as the residual stream (the correction's columns may be
        # split), so that the unembedding splits the vocab, not d
        hidden = constrain(out["hidden"].detach() + corr, "resid")
        logits = module.lm_logits(backbone, cfg, hidden, policy)
        return lm_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                z_loss=tcfg.z_loss)

    return loss_fn


def make_grad_fn(entry, cfg: ModelConfig, tcfg: TrainConfig,
                 policy: L.Policy = L.Policy()):
    """Returns ``grad_fn(trainable, frozen, batch) -> (metrics, grads)``,
    the gradients of ``make_loss_fn``'s loss with respect to every leaf of
    ``trainable``, as a tree of its structure; ``make_train_step`` takes
    one per (micro)batch."""
    loss_fn = make_loss_fn(entry, cfg, tcfg, policy)

    def grad_fn(params, frozen, batch):
        paths, leaves = zip(*tree_flatten(params))
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(tree_unflatten(list(zip(paths, leaves))),
                                frozen, batch)
        # a leaf the loss does not read (whisper's encoder embedding) gets
        # zeros, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        # on DTensors, each gradient laid out as its leaf (a pending sum
        # reduce-scattered onto the leaf's shards)
        grads = [ctx.placed_like(g, p) for g, p in zip(grads, leaves)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree_unflatten(list(zip(paths, grads)))

    return grad_fn


def make_train_step(entry, cfg: ModelConfig, tcfg: TrainConfig,
                    policy: L.Policy = L.Policy()):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens" [B,S] int, "labels" [B,S] int, optional "mask",
    optional "frontend" dict of stub embeddings ({"frames"} for an audio
    arch, {"cross_kv"} for a vision-language one, each [B, T, D])}, as
    tensors on the state's device.  With ``microbatch`` k every tensor,
    the frontend's included, is split along its batch axis.  The step
    returns a new state dict; the given state's tensors are not modified.

    On DTensor state and batch (a cell placed on a mesh,
    ``launch/dryrun.py``) the step runs forward and backward on them under
    DTensor's ``implicit_replication`` (``ctx.replicate_made``), a shard of
    a dim of one over a one-rank axis relabelled replicated first, and the
    new state is laid out as the old.
    """
    grad_fn = make_grad_fn(entry, cfg, tcfg, policy)
    trainable = "branch" if tcfg.mode == "duplex" else "backbone"

    def train_step(state, batch):
        if ctx.placed(state):
            state, batch = map(ctx.unit_shards_replicated, (state, batch))
        with ctx.replicate_made(state):
            return _step(state, batch)

    def _step(state, batch):
        frozen = state["backbone"] if tcfg.mode == "duplex" else None
        if tcfg.microbatch > 1:
            k = tcfg.microbatch
            split = tree_map(
                lambda x: x.reshape((k, x.shape[0] // k) + x.shape[1:]),
                batch)
            mbs = [tree_map(lambda x: x[j], split) for j in range(k)]
            gsum, ms = None, []
            for mb in mbs:
                metrics, g = grad_fn(state[trainable], frozen, mb)
                g = tree_map(lambda t: t.float(), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                ms.append(metrics)
            grads = tree_map(lambda g: g / k, gsum)
            metrics = {n: torch.mean(torch.stack([m[n] for m in ms]))
                       for n in ms[0]}
        else:
            metrics, grads = grad_fn(state[trainable], frozen, batch)

        lr = _lr(tcfg, state["step"])
        new_p, new_opt, om = opt_update(tcfg.opt, grads, state["opt"],
                                        state[trainable], lr)
        new_state = dict(state)
        new_state[trainable] = new_p
        new_state["opt"] = new_opt
        new_state["step"] = state["step"] + 1
        return new_state, {**metrics, **om, "lr": lr}

    return train_step
