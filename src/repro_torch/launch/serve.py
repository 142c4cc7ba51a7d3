"""Serving launcher for the port on one card: batched prefill, then a
greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --preset full --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --preset smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --preset smoke --prompt-len 12 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --preset smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --preset smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --preset smoke --device cpu

Counterpart of ``repro/launch/serve.py``.  Runs on ``cuda`` unless
``--device cpu`` is given; a CUDA request without a card raises.  The
launcher runs one card without a mesh: the sharding rules, the activation
context and the meshes are in ``repro_torch.distributed`` and
``launch/mesh.py``, and a run across ranks is still to come.
``--preset full`` runs bf16 compute, bf16 params and a bf16 cache;
``smoke`` runs f32.  Params are random, drawn on the device from seed 0,
and prompts from seed 1.  An arch
with a stubbed frontend (whisper-base's audio frames, llama-3.2-vision-90b's
``cross_kv``) is fed one draw per run of ``ArchEntry.frontend_shape``'s
shape, ``randn * 0.1`` in the compute dtype from seed 7
(``train.stub_frontend``), which prefill encodes (whisper) and caches as
the cross layers' keys and values.  The cache holds ``prompt + gen + 8``
tokens; a ``local`` layer whose window is shorter (gemma2-9b's 4096 past a
4088-token prompt, its smoke config's 8) keeps a ring of ``window`` slots;
an ``ssd`` layer (mamba2-780m) keeps its state and the cache a ``step``
counter, whatever the length; an ``lru`` layer (recurrentgemma-9b) keeps
its RG-LRU state beside the rings of its ``local`` layers (the default
32-token prompt passes its smoke window of 8, so they wrap).  ``main``
parses the arguments and calls ``serve``, which a caller can give a config
of its own (a model cut in depth).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.launch.train import stub_frontend
from repro_torch.models import layers as L, registry
from repro_torch.train import serve_step as ss
from repro_torch.utils import tree_checksum


def _mark(device: torch.device):
    """A point in time: a recorded CUDA event on the card, the host clock
    on the CPU (whose ops run synchronously)."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else \
        (b - a) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Parse ``argv`` and ``serve`` the arch at its preset; returns what
    ``serve`` returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda."
                           "is_available() is False; pass --device cpu to "
                           "run on the CPU")
    entry = registry.get(args.arch)
    return serve(entry, entry.config(args.preset), batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen,
                 dtype=(torch.bfloat16 if args.preset == "full"
                        else torch.float32), device=device)


def serve(entry, cfg, *, batch: int, prompt_len: int, gen: int,
          dtype: torch.dtype, device) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens greedily, with ``dtype`` compute, params and
    cache on ``device``; return ``{"tokens": [B, gen] int32, "cache",
    "params", "frontend" (None without one), "prefill_logits": [B, V],
    "prefill_s", "decode_s", "decode_step_ms": one per decode step,
    "tok_per_s", "backbone_checksum": (before, after)}``."""
    device = torch.device(device)
    policy = L.Policy(compute_dtype=dtype)
    max_len = prompt_len + gen + 8
    params = entry.module.init_params(
        torch.Generator(device=device).manual_seed(0), cfg, dtype=dtype,
        device=device)
    before = tree_checksum(params)
    frontend = stub_frontend(entry, cfg, batch, dtype, device, seed=7)
    prompts = torch.randint(
        0, cfg.vocab, (batch, prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    prefill = ss.make_prefill_step(entry, cfg, max_len=max_len,
                                   policy=policy, cache_dtype=dtype,
                                   logits_mode="last")
    decode = ss.make_decode_step(entry, cfg, policy=policy)

    _sync(device)
    t0 = time.perf_counter()
    out = prefill(params, prompts, frontend)
    cache, logits = out["cache"], out["next_token_logits"]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefill: {prefill_s:.2f}s")

    t0 = time.perf_counter()
    toks, marks = [tok], [_mark(device)]
    for _ in range(gen - 1):
        tok, cache = decode(params, cache, tok)
        toks.append(tok)
        marks.append(_mark(device))
    _sync(device)
    decode_s = time.perf_counter() - t0
    step_ms = [_elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
    tok_per_s = (gen - 1) * batch / decode_s
    print(f"decode: {gen - 1} steps, {tok_per_s:.1f} tok/s" + (
        f", step median {statistics.median(step_ms):.2f} ms" if step_ms
        else ""))
    generated = torch.cat(toks, dim=1)
    print("first sequence:", generated[0].tolist())
    return {"tokens": generated, "cache": cache, "params": params,
            "frontend": frontend, "prefill_logits": logits,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_step_ms": step_ms, "tok_per_s": tok_per_s,
            "backbone_checksum": (before, tree_checksum(params))}


if __name__ == "__main__":
    main()
