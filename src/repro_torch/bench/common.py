"""Shared benchmark scaffolding: the four accuracy arms of CAMEL Fig 20/24
(DuDNN / FR / CA / BO) at laptop scale on the synthetic bigram-LM task.

Counterpart of ``benchmarks/common.py``, with the same configs, optimizer
settings, learning rates and step counts.  The scaled-down protocol:
"pretrain" a small dense backbone on the task distribution, freeze it,
then train each arm's adapter for N steps with the same budget.  The
paper's qualitative claim to reproduce (Table II): DuDNN ≈ FR ≫ CA ≫ BO.

Random params are drawn from a ``torch.Generator`` on ``device`` seeded
with ``key``, unless ``init=`` hands in a tree of tensors (the bridged JAX
init, in the tests).  Everything runs on ``device``, ``cuda`` unless the
caller names ``cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.common import LayerSpec, ModelConfig
from repro_torch.core import duplex as dx
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import layers as L, transformer as T
from repro_torch.optim import AdamWConfig, opt_init, opt_update
from repro_torch.train import train_step as ts
from repro_torch.train.losses import lm_cross_entropy
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten

P32 = L.Policy(compute_dtype=torch.float32)

BB_CFG = ModelConfig(
    name="bench-backbone", family="dense", vocab=256,
    d_model=64, n_layers=4, pattern=(LayerSpec("attn", "dense"),),
    n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab_pad_multiple=16,
).validate()

DATA = DataConfig(vocab=256, seq_len=64, batch_per_host=8, seed=0)


class _Entry:
    module = T


def _batch(src: SyntheticLM, i: int, device) -> dict:
    return {k: torch.as_tensor(v, device=device).long()
            for k, v in src.batch(i).items()}


def _sync(device) -> None:
    """Wait for the device, so that a host clock times the work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cli(run, argv=None) -> list[str]:
    """A bench's command line: ``--device`` (cuda unless cpu is named; no
    bench falls back to the CPU, so cuda without a card raises), then
    ``run(device)``'s rows, printed and returned."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    rows, _ = run(args.device)
    print("\n".join(rows))
    return rows


def pretrain_backbone(steps: int = 150, key: int = 0, *, init=None,
                      device="cuda"):
    """The offline-pretrained backbone (paper §III-A): returns (backbone,
    last train loss).  ``init``: the backbone to start from."""
    tcfg = ts.TrainConfig(mode="full", opt=AdamWConfig(weight_decay=0.0),
                          lr=3e-3)
    if init is None:
        gen = torch.Generator(device=device).manual_seed(key)
        state = ts.init_state(gen, _Entry, BB_CFG, tcfg, P32, device=device)
    else:
        state = {"step": torch.zeros((), dtype=torch.int32, device=device),
                 "backbone": init, "opt": opt_init(tcfg.opt, init)}
    step = ts.make_train_step(_Entry, BB_CFG, tcfg, P32)
    src = SyntheticLM(DATA)
    for i in range(steps):
        state, m = step(state, _batch(src, i, device))
    return state["backbone"], float(m["loss"])


def eval_arm(loss_fn, params, n_batches: int = 8, offset: int = 10_000, *,
             device="cuda"):
    src = SyntheticLM(DATA)
    tot, acc = 0.0, 0.0
    with torch.no_grad():
        for i in range(n_batches):
            l, a = loss_fn(params, _batch(src, offset + i, device))
            tot += float(l)
            acc += float(a)
    return tot / n_batches, acc / n_batches


def duplex_cfg(pool: int = 4, use_norm: bool = False,
               bfp: bool = True) -> dx.DuplexConfig:
    return dx.DuplexConfig(
        n_blocks=2, d_branch=32, pool_factor=pool, branch_heads=2,
        use_norm=use_norm,
        bfp=L.BFPPolicy(enabled=bfp, group=(3, 3)))


def train_arm(arm: str, backbone, steps: int = 200, key: int = 1,
              dcfg: dx.DuplexConfig | None = None, *, init=None,
              device="cuda"):
    """Train one accuracy arm; returns (val_loss, val_acc, train_time_s).

    arms: duplex (taps from all depths) | chain (taps only from the final
    block — the CA baseline) | branch_only (zeroed taps & no backbone
    correction target — BO) | full (FR: finetune the whole backbone).
    ``init``: the branch to start from (branch arms; ignored by ``full``,
    whose only params are the backbone's).
    """
    dcfg = dcfg or duplex_cfg()
    src = SyntheticLM(DATA)

    if arm == "full":
        tcfg = ts.TrainConfig(mode="full", opt=AdamWConfig(weight_decay=0.0),
                              lr=1e-3)
        bb = tree_map(torch.clone, backbone)
        state = {"step": torch.zeros((), dtype=torch.int32, device=device),
                 "backbone": bb, "opt": opt_init(tcfg.opt, bb)}
        step = ts.make_train_step(_Entry, BB_CFG, tcfg, P32)
        t0 = time.time()
        for i in range(steps):
            state, m = step(state, _batch(src, i, device))
        _sync(device)
        dt = time.time() - t0

        def loss_fn(params, batch):
            out = T.forward(params, BB_CFG, batch["tokens"], policy=P32)
            logits = T.lm_logits(params, BB_CFG, out["hidden"], P32)
            _, met = lm_cross_entropy(logits, batch["labels"])
            return met["loss"], met["accuracy"]

        l, a = eval_arm(loss_fn, state["backbone"], device=device)
        return l, a, dt

    if arm not in ("duplex", "chain", "branch_only"):
        raise ValueError(arm)
    idx = ts.tap_indices(BB_CFG.n_rep, dcfg.n_blocks)

    branch = init if init is not None else dx.duplex_init(
        torch.Generator(device=device).manual_seed(key), dcfg,
        BB_CFG.d_model, device=device)
    opt_cfg = AdamWConfig(weight_decay=0.0)
    opt = opt_init(opt_cfg, branch)

    def loss_full(branch, batch):
        with torch.no_grad():
            out = T.forward(backbone, BB_CFG, batch["tokens"],
                            collect_taps=True, tap_indices=idx,
                            tap_pool=dcfg.pool_factor, policy=P32)
        taps = out["taps"]
        if arm in ("branch_only", "chain"):
            # no intermediate-depth knowledge transfer (Fig 20 CA/BO)
            taps = torch.zeros_like(taps)
        # CA: the branch is chained AFTER the backbone — it consumes the
        # backbone output and fully replaces the head (no additive support)
        emb_in = out["hidden"] if arm == "chain" else out["emb"]
        corr = dx.duplex_apply(branch, dcfg, emb_in, taps, policy=P32,
                               taps_pooled=True)
        hidden = out["hidden"] + corr if arm == "duplex" else corr
        logits = T.lm_logits(backbone, BB_CFG, hidden, P32)
        return lm_cross_entropy(logits, batch["labels"])

    def step(branch, opt, batch):
        paths, leaves = zip(*tree_flatten(branch))
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss, met = loss_full(tree_unflatten(list(zip(paths, leaves))),
                              batch)
        grads = tree_unflatten(list(zip(paths, torch.autograd.grad(
            loss, leaves))))
        new_b, new_o, _ = opt_update(opt_cfg, grads, opt, branch, 3e-3)
        return new_b, new_o, met

    t0 = time.time()
    for i in range(steps):
        branch, opt, met = step(branch, opt, _batch(src, i, device))
    _sync(device)
    dt = time.time() - t0

    def eval_fn(params, batch):
        _, met = loss_full(params, batch)
        return met["loss"], met["accuracy"]

    l, a = eval_arm(eval_fn, branch, device=device)
    return l, a, dt
