"""Training launcher for the port: the DuDNN duplex step, or the full
finetune (the paper's FR baseline), on one card or on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --preset full --mode duplex --steps 3 --seq 4096 --batch 2 \\
        --ckpt-dir /path/to/ckpt --ckpt-every 100
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-3-8b --preset smoke --steps 3 --seq 32 --batch 4 \\
        --device cpu --distributed

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
the latest checkpoint there.

``--mesh host|pod|multipod`` and ``--distributed`` are the reference's.
Without ``--distributed`` one process runs plain tensors (``--mesh host``
on one device is the identity, as JAX's one-device mesh is; ``pod`` and
``multipod`` raise, naming the 256 or 512 ranks they need).  With it the
launcher starts the default group from torchrun's environment (``nccl`` on
``cuda:LOCAL_RANK``, ``gloo`` on the CPU), makes the mesh
(``make_host_mesh``: every rank on ``data``; or the production mesh),
places the state by ``state_pspecs`` (``sharding.device_put``), runs every
step under ``activation_sharding(mesh, activation_rules(cfg, mesh))``, and
destroys the group on exit.  Checkpoints are gathered and written by rank
0, and restored onto the mesh (``ckpt/checkpoint.py``).

Departure from the reference: its data is seeded with
``jax.process_index()``, so each host feeds other rows into what ``jit``
treats as one global array.  In eager torch each rank is a process, so
here every rank draws the same global batch (``DataConfig(seed=0,
batch_per_host=--batch)``), and the same stub frontend, and keeps its
block by ``batch_pspec``; every rank also draws the whole state from seed
0 and keeps its block, as the reference's ``device_put`` of a host array
does.  A run on N ranks is then the run on one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc

import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointConfig
from repro_torch.core import duplex as dx
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch.cells import activation_rules, duplex_tcfg
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models import layers as L, registry
from repro_torch.train import loop, train_step as ts
from repro_torch.utils import tree_checksum, tree_leaves, tree_map, whole


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


def place_batch(tree, mesh):
    """Each leaf of a batch tree (tokens, labels, a stub frontend), whole on
    every rank, as a DTensor holding this rank's block by ``batch_pspec``;
    the tree as it is without a ``mesh``, and ``None`` as it is."""
    if tree is None or mesh is None:
        return tree
    return sh.device_put(tree, sh.to_named(tree_map(
        lambda x: sh.batch_pspec(tuple(x.shape), mesh), tree), mesh))


def loop_step(step, device, frontend: dict | None = None, mesh=None):
    """``train.loop``'s step function: ``step`` on the data's batch, every
    key cast to long on ``device`` (and on a ``mesh`` placed by
    ``place_batch``), with the run's stub ``frontend`` (placed alike by the
    caller) added after the cast when there is one."""
    def step_fn(state, batch):
        batch = {k: torch.as_tensor(v, device=device).long()
                 for k, v in batch.items()}
        batch = place_batch(batch, mesh)
        if frontend is not None:
            batch["frontend"] = frontend
        return step(state, batch)
    return step_fn


def train(entry, cfg, tcfg, policy, *, steps: int, seq: int, batch: int,
          device, mesh=None, ckpt_dir: str | None = None,
          ckpt_every: int = 100, log_every: int = 10) -> dict:
    """Train ``cfg`` for ``steps`` on a global batch of ``batch`` sequences
    of ``seq`` tokens, on ``device``, or on ``mesh`` (a ``DeviceMesh`` of
    the default group, whose ranks all call this) with the state, batches
    and frontend placed as DTensors and every step under the arch's
    activation rules; with ``ckpt_dir`` save every ``ckpt_every`` steps and
    resume from the latest checkpoint there.

    Returns ``{"report": LoopReport (its state as the loop left it:
    DTensors on a mesh), "state": the final state's whole values (plain
    tensors), "history": the logged metrics, "backbone_checksum": (before,
    after), "branch_max_abs_change": x, "frontend": the stub frontend,
    whole, or None}``.  ``before`` and the branch's change are None when
    the run resumed from a checkpoint, and the change is None in full mode
    (no branch)."""
    device = torch.device(device)
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    frontend = stub_frontend(entry, cfg, batch, policy.compute_dtype,
                             device)
    named, rules = None, contextlib.nullcontext()
    if mesh is not None:
        shapes = ts.init_state(torch.Generator(), entry, cfg, tcfg, policy,
                               device="meta")
        named = sh.to_named(sh.state_pspecs(shapes, mesh), mesh)
        rules = ctx.activation_sharding(mesh, activation_rules(cfg, mesh))
    log_fn = print if mesh is None or dist.get_rank() == 0 else \
        (lambda line: None)
    initial = {}

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(0)
        st = ts.init_state(gen, entry, cfg, tcfg, policy, device=device)
        initial["backbone"] = tree_checksum(st["backbone"])
        if "branch" in st:
            initial["branch"] = tree_map(torch.clone, st["branch"])
        return st if named is None else sh.device_put(st, named)

    with rules:
        report = loop.run(
            loop.LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                            ckpt=(CheckpointConfig(ckpt_dir)
                                  if ckpt_dir else None),
                            log_every=log_every, step_deadline_s=60.0),
            DataConfig(vocab=cfg.vocab, seq_len=seq, batch_per_host=batch,
                       seed=0),
            loop_step(step, device, place_batch(frontend, mesh), mesh),
            init_fn, log_fn, device=device, shardings=named)
    final = tree_map(whole, report.state)
    bb = (initial.get("backbone"), tree_checksum(final["backbone"]))
    moved = None
    if "branch" in initial:
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(initial["branch"]), tree_leaves(final["branch"])))
    start = "fresh start" if report.resumed_from is None else \
        f"resumed from step {report.resumed_from}"
    log_fn(f"finished {report.steps_run} steps ({start}) in "
           f"{report.wall_s:.1f}s; backbone checksum {bb[0]} -> {bb[1]}; "
           f"branch max |change| {moved}")
    return {"report": report, "state": final,
            "history": report.metrics_history, "backbone_checksum": bb,
            "branch_max_abs_change": moved, "frontend": frontend}


def main(argv=None) -> dict:
    """Parse ``argv`` and ``train`` the arch at its preset and mode, on the
    mesh ``--mesh`` and ``--distributed`` give; returns what ``train``
    returns."""
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
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    device = checked_device(args.device)
    entry, cfg, tcfg, policy = build(args.arch, args.preset, args.mode)
    with launcher_mesh(args.mesh, args.distributed, device) as (device,
                                                                mesh):
        return train(entry, cfg, tcfg, policy, steps=args.steps,
                     seq=args.seq, batch=args.batch, device=device,
                     mesh=mesh, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, log_every=args.log_every)


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    """The launchers' ``--mesh`` and ``--distributed``."""
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"],
                    help="host: every rank on data (default); pod: 16x16 "
                    "(256 ranks); multipod: 2x16x16 (512 ranks)")
    ap.add_argument("--distributed", action="store_true",
                    help="start the default process group from torchrun's "
                    "environment and run on the mesh")


def checked_device(name: str) -> torch.device:
    """``torch.device(name)``; ``cuda`` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    return device


if __name__ == "__main__":
    main()
