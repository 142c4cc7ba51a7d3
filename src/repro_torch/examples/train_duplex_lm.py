"""End-to-end training driver: Duplex-train an LM with the full substrate —
data pipeline (synthetic or byte corpus), AdamW on a cosine warmup
schedule, checkpoint/restart, straggler deadline, metrics.  Kill it mid-run
and re-launch: it resumes from the last published checkpoint at the exact
batch index.

Counterpart of ``examples/train_duplex_lm.py``.  Default is a small model;
``--d-model 768 --layers 12`` gives the ~100M-class configuration.

    PYTHONPATH=src python -m repro_torch.examples.train_duplex_lm \\
        --steps 200 --ckpt-dir /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.examples.train_duplex_lm \\
        --steps 400 --ckpt-dir /path/to/ckpt         # resumes

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.ckpt.checkpoint import CheckpointConfig
from repro_torch.configs.common import LayerSpec, ModelConfig
from repro_torch.core import duplex as dx
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import layers as L, transformer as T
from repro_torch.optim import AdamWConfig, cosine_warmup
from repro_torch.train import loop, train_step as ts


class _Entry:
    module = T


def main(argv=None) -> loop.LoopReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--corpus", default=None,
                    help="path to a text file (byte-level LM); default "
                         "synthetic")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    vocab = 256 if args.corpus else args.vocab
    cfg = ModelConfig(
        name="duplex-lm", family="dense", vocab=vocab,
        d_model=args.d_model, n_layers=args.layers,
        pattern=(LayerSpec("attn", "dense"),),
        n_heads=max(4, args.d_model // 64), n_kv=max(2, args.d_model // 128),
        head_dim=min(64, args.d_model // 4), d_ff=args.d_model * 4,
        vocab_pad_multiple=16,
    ).validate()
    policy = L.Policy(compute_dtype=torch.float32)

    tcfg = ts.TrainConfig(
        mode="duplex",
        duplex=dx.DuplexConfig(
            n_blocks=2, d_branch=max(32, args.d_model // 4), pool_factor=8,
            branch_heads=2, bfp=L.BFPPolicy(enabled=True, group=(3, 3))),
        opt=AdamWConfig(weight_decay=0.01), lr=3e-3,
        lr_schedule=cosine_warmup(3e-3, warmup=20, total=args.steps),
        backbone_dtype=torch.float32)

    entry = _Entry()
    train_step = ts.make_train_step(entry, cfg, tcfg, policy)
    data_cfg = DataConfig(
        vocab=vocab, seq_len=args.seq, batch_per_host=args.batch,
        kind="bytes" if args.corpus else "synthetic", path=args.corpus)
    loop_cfg = loop.LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt=CheckpointConfig(args.ckpt_dir, keep=2),
        log_every=10, step_deadline_s=30.0)

    def step_fn(state, batch):
        return train_step(state, {k: torch.as_tensor(v, device=device).long()
                                  for k, v in batch.items()})

    report = loop.run(
        loop_cfg, data_cfg, step_fn,
        init_state_fn=lambda: ts.init_state(
            torch.Generator(device=device).manual_seed(0), entry, cfg, tcfg,
            policy, device=device),
        device=device)
    src = "resumed from step " + str(report.resumed_from) \
        if report.resumed_from else "fresh start"
    last = report.metrics_history[-1]['loss'] if report.metrics_history \
        else float("nan")
    print(f"done ({src}): ran {report.steps_run} steps in "
          f"{report.wall_s:.1f}s; final loss={last:.4f}")
    return report


if __name__ == "__main__":
    main()
