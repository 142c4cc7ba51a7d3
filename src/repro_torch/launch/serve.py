"""Serving launcher for the port, on one card or on a mesh of ranks:
batched prefill, then a greedy decode loop.

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
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch granite-3-8b --preset smoke --device cpu --distributed

Counterpart of ``repro/launch/serve.py``.  Runs on ``cuda`` unless
``--device cpu`` is given; a CUDA request without a card raises.
``--mesh`` and ``--distributed`` are the train launcher's
(``launch/train.py``): with ``--distributed`` every rank draws the whole
params, prompts and frontend, keeps its block (params by ``param_pspec``,
prompts and frontend by ``batch_pspec``), and runs prefill and decode under
the arch's activation rules; the tokens and the prefill logits come back
gathered.
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
import contextlib
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch.cells import activation_rules
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.launch.train import add_mesh_args, checked_device, \
    place_batch, stub_frontend
from repro_torch.models import layers as L, registry
from repro_torch.train import serve_step as ss
from repro_torch.utils import tree_checksum, whole


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
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    device = checked_device(args.device)
    entry = registry.get(args.arch)
    with launcher_mesh(args.mesh, args.distributed, device) as (device,
                                                                mesh):
        return serve(entry, entry.config(args.preset), batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen,
                     dtype=(torch.bfloat16 if args.preset == "full"
                            else torch.float32), device=device, mesh=mesh)


def serve(entry, cfg, *, batch: int, prompt_len: int, gen: int,
          dtype: torch.dtype, device, mesh=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens greedily, with ``dtype`` compute, params and
    cache on ``device``, or on ``mesh`` (a ``DeviceMesh`` of the default
    group, whose ranks all call this) with params, prompts and frontend
    placed as DTensors and both steps under the arch's activation rules;
    return ``{"tokens": [B, gen] int32, "cache", "params", "frontend"
    (None without one), "prefill_logits": [B, V], "prefill_s",
    "decode_s", "decode_step_ms": one per decode step, "tok_per_s",
    "backbone_checksum": (before, after)}``.  On a mesh the tokens, the
    prefill logits and the frontend are whole, and the cache and params
    DTensors."""
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
    rules = contextlib.nullcontext()
    if mesh is not None:
        params = sh.device_put(params, sh.to_named(
            sh.tree_pspecs(params, mesh, sh.param_pspec), mesh))
        rules = ctx.activation_sharding(mesh, activation_rules(cfg, mesh))
    with rules:
        out = _serve_steps(entry, cfg, params, place_batch(prompts, mesh),
                           place_batch(frontend, mesh), max_len=max_len,
                           gen=gen, policy=policy, device=device)
    log = mesh is None or dist.get_rank() == 0
    if log:
        print(f"prefill: {out['prefill_s']:.2f}s")
        step_ms = out["decode_step_ms"]
        print(f"decode: {gen - 1} steps, {out['tok_per_s']:.1f} tok/s" + (
            f", step median {statistics.median(step_ms):.2f} ms" if step_ms
            else ""))
        print("first sequence:", out["tokens"][0].tolist())
    return {**out, "params": params, "frontend": frontend,
            "backbone_checksum": (before, tree_checksum(params))}


def _serve_steps(entry, cfg, params, prompts, frontend, *, max_len: int,
                 gen: int, policy: L.Policy, device) -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps, timed."""
    batch = prompts.shape[0]
    dtype = policy.compute_dtype
    prefill = ss.make_prefill_step(entry, cfg, max_len=max_len,
                                   policy=policy, cache_dtype=dtype,
                                   logits_mode="last")
    decode = ss.make_decode_step(entry, cfg, policy=policy)

    _sync(device)
    t0 = time.perf_counter()
    out = prefill(params, prompts, frontend)
    # a vocab-sharded DTensor's logits are gathered for the argmax
    cache, logits = out["cache"], ctx.gather_dim(out["next_token_logits"],
                                                 -1)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks, marks = [tok], [_mark(device)]
    for _ in range(gen - 1):
        tok, cache = decode(params, cache, tok)
        toks.append(tok)
        marks.append(_mark(device))
    _sync(device)
    decode_s = time.perf_counter() - t0
    step_ms = [_elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
    return {"tokens": whole(torch.cat(toks, dim=1)), "cache": cache,
            "prefill_logits": whole(logits), "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_step_ms": step_ms,
            "tok_per_s": (gen - 1) * batch / decode_s}


if __name__ == "__main__":
    main()
