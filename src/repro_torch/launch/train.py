"""Training launcher for the port: the DuDNN duplex step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --preset full --mode duplex --steps 3 --seq 4096 --batch 2

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.  ``--preset full`` runs the model at its published widths with
a bf16 backbone and compute and the backbone attention on the hand-written
flash kernel (``use_flash=True``); ``--preset smoke`` is the tiny f32
config.  Weights are random, drawn from seed 0 with a
``torch.Generator`` on the device.  There is no mesh: one card.
"""
from __future__ import annotations

import argparse
import dataclasses as dc

import torch

from repro_torch.core import duplex as dx
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.cells import duplex_tcfg
from repro_torch.models import layers as L, registry
from repro_torch.train import loop, train_step as ts
from repro_torch.utils import tree_checksum, tree_leaves, tree_map


def build(arch: str, preset: str):
    """(entry, cfg, tcfg, policy) for an arch and preset."""
    entry = registry.get(arch)
    cfg = entry.config(preset)
    if preset == "full":
        cfg = dc.replace(cfg, use_flash=True)
        policy = L.Policy(compute_dtype=torch.bfloat16)
        tcfg = duplex_tcfg(cfg)
    else:
        policy = L.Policy(compute_dtype=torch.float32)
        tcfg = dc.replace(
            duplex_tcfg(cfg), backbone_dtype=torch.float32,
            duplex=dx.DuplexConfig(n_blocks=2, d_branch=32, pool_factor=4,
                                   branch_heads=2,
                                   bfp=L.BFPPolicy(enabled=True,
                                                   group=(3, 3))))
    return entry, cfg, tcfg, policy


def main(argv=None) -> dict:
    """Parse ``argv``, train, and return ``{"report": LoopReport,
    "backbone_checksum": (before, after), "branch_max_abs_change": x}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--mode", default="duplex", choices=["duplex"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    entry, cfg, tcfg, policy = build(args.arch, args.preset)
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    initial = {}

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(0)
        st = ts.init_state(gen, entry, cfg, tcfg, policy, device=device)
        initial["backbone"] = tree_checksum(st["backbone"])
        initial["branch"] = tree_map(torch.clone, st["branch"])
        return st

    def step_fn(state, batch):
        return step(state, {k: torch.as_tensor(v, device=device).long()
                            for k, v in batch.items()})

    report = loop.run(
        loop.LoopConfig(total_steps=args.steps, log_every=args.log_every,
                        step_deadline_s=60.0),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   batch_per_host=args.batch, seed=0),
        step_fn, init_fn)
    final = report.state
    bb = (initial["backbone"], tree_checksum(final["backbone"]))
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(initial["branch"]), tree_leaves(final["branch"])))
    print(f"finished {report.steps_run} steps in {report.wall_s:.1f}s; "
          f"backbone checksum {bb[0]} -> {bb[1]}; "
          f"branch max |change| {moved:.3e}")
    return {"report": report, "backbone_checksum": bb,
            "branch_max_abs_change": moved}


if __name__ == "__main__":
    main()
