"""Training launcher for the port on one card: the DuDNN duplex step, or
the full finetune (the paper's FR baseline).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --preset full --mode duplex --steps 3 --seq 4096 --batch 2 \\
        --ckpt-dir /path/to/ckpt --ckpt-every 100

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.  ``--preset full`` runs the model at its published widths with
bf16 compute; in duplex mode the backbone is stored in bf16 and its
attention runs the hand-written flash kernel (``use_flash=True``).  Full
mode keeps f32 params and flash off, as the reference does: the kernel has
no backward.  ``--preset smoke`` is the tiny f32 config.  Weights are
random, drawn from seed 0 with a ``torch.Generator`` on the device.  An
arch with a stubbed frontend (whisper-base's audio frames,
llama-3.2-vision-90b's image patch embeddings) is fed one stub per run, of
``ArchEntry.frontend_shape``'s shape, ``randn * 0.1`` from its own
generator on the device (seed 1), in bf16 under ``--preset full`` and f32
under ``smoke``; every step's batch carries it.  Flash is switched on for
the decoder stack only: whisper's encoder keeps the reference's
``use_flash=False``.  With
``--ckpt-dir`` the loop saves every ``--ckpt-every`` steps and resumes from
the latest checkpoint there.  The launcher runs one card without a mesh:
the sharding rules, the activation context and the meshes are in
``repro_torch.distributed`` and ``launch/mesh.py``, and a run across ranks
is still to come.
"""
from __future__ import annotations

import argparse
import dataclasses as dc

import torch

from repro_torch.ckpt.checkpoint import CheckpointConfig
from repro_torch.core import duplex as dx
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.cells import duplex_tcfg
from repro_torch.models import layers as L, registry
from repro_torch.train import loop, train_step as ts
from repro_torch.utils import tree_checksum, tree_leaves, tree_map


def build(arch: str, preset: str, mode: str = "duplex"):
    """(entry, cfg, tcfg, policy) for an arch, preset and mode."""
    entry = registry.get(arch)
    cfg = entry.config(preset)
    tcfg = duplex_tcfg(cfg) if mode == "duplex" else \
        ts.TrainConfig(mode="full")
    if preset == "full":
        if mode == "duplex":
            cfg = dc.replace(cfg, use_flash=True)
        policy = L.Policy(compute_dtype=torch.bfloat16)
    else:
        policy = L.Policy(compute_dtype=torch.float32)
        tcfg = dc.replace(
            tcfg, backbone_dtype=torch.float32,
            duplex=dx.DuplexConfig(n_blocks=2, d_branch=32, pool_factor=4,
                                   branch_heads=2,
                                   bfp=L.BFPPolicy(enabled=True,
                                                   group=(3, 3))))
    return entry, cfg, tcfg, policy


def stub_frontend(entry, cfg, batch: int, dtype: torch.dtype,
                  device, seed: int = 1) -> dict | None:
    """The run's stub frontend, shaped as the reference's ``input_specs``
    (``frontend_shape``), drawn ``randn * 0.1`` from ``seed`` on
    ``device``; None for an arch without one."""
    shapes = entry.frontend_shape(cfg, batch)
    if shapes is None:
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: (torch.randn(v, generator=gen, device=device) * 0.1).to(dtype)
            for k, v in sorted(shapes.items())}


def loop_step(step, device, frontend: dict | None = None):
    """``train.loop``'s step function: ``step`` on the data's batch, every
    key cast to long on ``device``, with the run's stub ``frontend`` added
    after the cast when there is one."""
    def step_fn(state, batch):
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in batch.items()}
        if frontend is not None:
            batch["frontend"] = frontend
        return step(state, batch)
    return step_fn


def main(argv=None) -> dict:
    """Parse ``argv``, train, and return ``{"report": LoopReport,
    "backbone_checksum": (before, after), "branch_max_abs_change": x,
    "frontend": the stub frontend or None}``.
    ``before`` and the branch's change are None when the run resumed from a
    checkpoint, and the change is None in full mode (no branch)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--mode", default="duplex", choices=["duplex", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    entry, cfg, tcfg, policy = build(args.arch, args.preset, args.mode)
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    frontend = stub_frontend(entry, cfg, args.batch, policy.compute_dtype,
                             device)
    initial = {}

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(0)
        st = ts.init_state(gen, entry, cfg, tcfg, policy, device=device)
        initial["backbone"] = tree_checksum(st["backbone"])
        if "branch" in st:
            initial["branch"] = tree_map(torch.clone, st["branch"])
        return st

    report = loop.run(
        loop.LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt=(CheckpointConfig(args.ckpt_dir)
                              if args.ckpt_dir else None),
                        log_every=args.log_every, step_deadline_s=60.0),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   batch_per_host=args.batch, seed=0),
        loop_step(step, device, frontend), init_fn, device=device)
    final = report.state
    bb = (initial.get("backbone"), tree_checksum(final["backbone"]))
    moved = None
    if "branch" in initial:
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(initial["branch"]), tree_leaves(final["branch"])))
    start = "fresh start" if report.resumed_from is None else \
        f"resumed from step {report.resumed_from}"
    print(f"finished {report.steps_run} steps ({start}) in "
          f"{report.wall_s:.1f}s; backbone checksum {bb[0]} -> {bb[1]}; "
          f"branch max |change| {moved}")
    return {"report": report, "backbone_checksum": bb,
            "branch_max_abs_change": moved, "frontend": frontend}


if __name__ == "__main__":
    main()
