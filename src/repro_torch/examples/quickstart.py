"""Quickstart: train a Duplex (frozen backbone + reversible branch) LM for a
few steps, then decode from it.

Counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import duplex as dx
from repro_torch.models import layers as L, registry
from repro_torch.optim import AdamWConfig
from repro_torch.train import serve_step as ss, train_step as ts

ARCH = "granite-3-8b"  # any arch whose layers are all ``attn`` or ``local``
POLICY = L.Policy(compute_dtype=torch.float32)


def main(argv=None) -> dict:
    """Returns ``{"losses": [10 floats], "generated": [9 token ids]}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    entry = registry.get(ARCH)
    cfg = entry.smoke          # reduced config; entry.full is the real one

    tcfg = ts.TrainConfig(
        mode="duplex",
        duplex=dx.DuplexConfig(n_blocks=2, d_branch=32, pool_factor=4,
                               branch_heads=2,
                               bfp=L.BFPPolicy(enabled=True, group=(3, 3))),
        opt=AdamWConfig(weight_decay=0.0), lr=3e-3,
        backbone_dtype=torch.float32)

    state = ts.init_state(torch.Generator(device=device).manual_seed(0),
                          entry, cfg, tcfg, POLICY, device=device)
    step = ts.make_train_step(entry, cfg, tcfg, POLICY)

    tokens = torch.randint(0, cfg.vocab, (4, 32), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    print(f"training the duplex branch on a fixed batch ({ARCH} smoke):")
    losses = []
    for i in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 3 == 0 or i == 9:
            print(f"  step {i}: loss={losses[-1]:.4f} "
                  f"acc={float(m['accuracy']):.3f}")

    # serve: prefill a prompt + greedy-decode 8 tokens from the backbone
    prefill = ss.make_prefill_step(entry, cfg, max_len=64, policy=POLICY,
                                   cache_dtype=torch.float32)
    decode = ss.make_decode_step(entry, cfg, policy=POLICY)
    out = prefill(state["backbone"], tokens[:1, :16])
    cache = out["cache"]
    tok = torch.argmax(out["next_token_logits"], -1)[:, None].to(torch.int32)
    generated = [int(tok[0, 0])]
    for _ in range(8):
        tok, cache = decode(state["backbone"], cache, tok)
        generated.append(int(tok[0, 0]))
    print("greedy continuation token ids:", generated)
    return {"losses": losses, "generated": generated}


if __name__ == "__main__":
    main()
