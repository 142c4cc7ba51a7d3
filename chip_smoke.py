"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of their own:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and a few small ones, with times (kernel, plain version,
     one library call as a yardstick) and the bound the card sets;
  4. the main path: ``repro_torch.launch.train`` trains granite-3-8b at full
     width (random weights from a seed, bf16 backbone, flash kernel on) for
     3 duplex steps at batch 2 x 4096 tokens; the launch counts are zeroed
     just before and read just after; the loss must be finite, the branch
     must move and the backbone's checksum must not; the flash path's loss
     is then held against the plain attention path's on the same state;
  5. one JSON line with every kernel's numbers, the card line again, and
     the last line {"ok": true, "device": {...}}.
Any failure raises and the exit code is not 0.  Without a CUDA device it
exits with code 2 before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 SIMT pipes
# (the kernel's f32 arithmetic), HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
MAIN_STEPS = 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, h, kv, sq, skv, d, causal, dtype):
    """Least time for the attention forward: the (query, key) pairs these
    inputs need (the causal triangle, top-left aligned) at 4·d FLOPs each
    over the peak for the dtype, against q/k/v read once and o written once
    over the memory rate."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * h * sq * d + 2 * b * kv * skv * d) * \
        torch.tensor([], dtype=dtype).element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# (label, b, h, kv, sq, skv, d, causal, softcap, dtype, iters)
FLASH_CASES = [
    ("main", 2, 32, 8, 4096, 4096, 128, True, None, torch.bfloat16, 10),
    ("mqa", 1, 8, 1, 1024, 1024, 128, True, None, torch.bfloat16, 20),
    ("rect_causal_bf16", 1, 8, 2, 384, 640, 128, True, None, torch.bfloat16,
     20),
    ("rect_causal_f32", 1, 8, 2, 384, 640, 64, True, None, torch.float32, 20),
    ("softcap_f32", 2, 4, 2, 512, 512, 128, True, 20.0, torch.float32, 20),
]
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# relative Frobenius error ||kernel - plain|| / ||plain||, over all rows and
# over the query rows past Sq/2.  The elementwise criterion is loose where
# |o| is small: a late causal row averages many keys, so |o| ~ 1/sqrt(row).
REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}


def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def check_flash(gen) -> dict:
    """Kernel vs plain version per shape; returns the main shape's numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    main = None
    for (label, b, h, kv, sq, skv, d, causal, cap, dtype,
         iters) in FLASH_CASES:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda",
                        dtype=dtype)
        k = torch.randn((b, kv, skv, d), generator=gen, device="cuda",
                        dtype=dtype)
        v = torch.randn((b, kv, skv, d), generator=gen, device="cuda",
                        dtype=dtype)
        kw = dict(causal=causal, softcap=cap)
        # chunks are the reference's tiling contract only (128 tiles
        # every shape here); the kernel uses its own tiles
        kw = dict(kw, q_chunk=128, kv_chunk=128)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal, softcap=cap)
        # the criterion of tests/test_kernels_flash.py (assert_allclose with
        # rtol = atol = tol): |kernel - plain| <= tol + tol * |plain|
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - TOL[dtype] * (1 + want.float().abs())).max())
        if not excess <= 0:
            raise AssertionError(f"flash {label}: |kernel - plain| exceeds "
                                 f"{TOL[dtype]} (1 + |plain|) by {excess}; "
                                 f"max |diff| {err}")
        rel_all = rel_fro(got, want)
        rel_tail = rel_fro(got[:, :, sq // 2:], want[:, :, sq // 2:])
        if not max(rel_all, rel_tail) <= REL_TOL[dtype]:
            raise AssertionError(f"flash {label}: relative Frobenius error "
                                 f"{rel_all} (all rows), {rel_tail} (rows "
                                 f"past Sq/2) exceeds {REL_TOL[dtype]}")
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters)
        plain_ms = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                             softcap=cap),
            max(2, iters // 5), warmup=1)
        library_ms = None
        if cap is None:  # the library call has no softcap
            sdpa = F.scaled_dot_product_attention  # library yardstick only
            library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                              enable_gqa=True), iters)
        bound_ms, bound_by = attention_bound_ms(b, h, kv, sq, skv, d, causal,
                                                dtype)
        row = {"shape": label, "q": [b, h, sq, d], "kv": [b, kv, skv, d],
               "causal": causal, "softcap": cap, "dtype": str(dtype),
               "max_abs_err": err, "tol": TOL[dtype], "rel_fro_err": rel_all,
               "rel_fro_err_tail": rel_tail, "rel_tol": REL_TOL[dtype],
               "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        print("flash_check " + json.dumps(row), flush=True)
        if label == "main":
            main = row
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return main


def run_main_path() -> dict:
    import dataclasses as dc
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.train import train_step as ts

    argv = ["--arch", "granite-3-8b", "--preset", "full", "--mode", "duplex",
            "--steps", str(MAIN_STEPS), "--seq", "4096", "--batch", "2",
            "--log-every", "1", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = train.main(argv)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()

    report = out["report"]
    for m in report.metrics_history:
        print(f"main_step {m['step']}: loss {m['loss']!r} step_time_s "
              f"{m['step_time_s']!r} grad_norm {m['grad_norm']!r}")
    entry, cfg, tcfg, policy = train.build("granite-3-8b", "full")
    n_attn = cfg.n_rep * len(cfg.pattern)
    print(f"main_path: steps {report.steps_run} wall_s {wall!r} "
          f"max_memory_allocated_bytes {peak} flash_launches {launches} "
          f"expected {n_attn * MAIN_STEPS} backbone_checksum "
          f"{out['backbone_checksum']} branch_max_abs_change "
          f"{out['branch_max_abs_change']!r}", flush=True)
    losses = [m["loss"] for m in report.metrics_history]
    if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"main path losses not finite: {losses}")
    if launches != n_attn * MAIN_STEPS:
        raise AssertionError(f"flash launched {launches} times, expected "
                             f"{n_attn * MAIN_STEPS}")
    before, after = out["backbone_checksum"]
    if before != after:
        raise AssertionError(f"backbone changed: checksum {before} -> {after}")
    if not out["branch_max_abs_change"] > 0:
        raise AssertionError("branch params did not move")

    # reference: the same loss through the plain attention path (blockwise,
    # PyTorch ops) on the final state and the first batch.  bf16 backbone
    # over 40 layers: the two attention outputs differ by bf16 rounding, so
    # the losses agree to 1e-2 relative, not bit for bit.
    state = report.state
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=4096,
                                   batch_per_host=2, seed=0)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in batch.items()}
    with torch.no_grad():
        lf, _ = ts.make_loss_fn(entry, cfg, tcfg, policy)(
            state["branch"], state["backbone"], batch)
        lp, _ = ts.make_loss_fn(entry, dc.replace(cfg, use_flash=False),
                                tcfg, policy)(
            state["branch"], state["backbone"], batch)
    rel = abs(float(lf) - float(lp)) / abs(float(lp))
    print(f"main_path_reference: loss_flash {float(lf)!r} loss_plain_attention"
          f" {float(lp)!r} rel_diff {rel!r}", flush=True)
    if not rel <= 1e-2:
        raise AssertionError(f"flash path loss {float(lf)} vs plain attention"
                             f" path {float(lp)}: rel diff {rel} > 1e-2")
    profile_step(entry, cfg, tcfg, policy, state, batch)
    return {"launches": launches, "peak_bytes": peak,
            "step_times": [m["step_time_s"] for m in report.metrics_history]}


def profile_step(entry, cfg, tcfg, policy, state, batch):
    """One more duplex step under torch.profiler: device time by kernel and
    the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import train_step as ts
    step = ts.make_train_step(entry, cfg, tcfg, policy)
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []      # device-side events only: op rows repeat their kernels
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"profile_step: wall_s {wall!r} device_busy_s {busy_us / 1e6!r} "
          f"busy_share {busy_us / 1e6 / wall!r} (profiler on)")
    for dev, key, count in rows[:12]:
        print(f"profile_kernel: {dev / 1e3:.3f} ms x{count} "
              f"{dev / busy_us:.3f} {key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)

    from repro_torch.kernels import build
    built = build.build()
    for name, info in built.items():
        regs = [l.strip() for l in info["log"].splitlines()
                if "registers" in l or "spill" in l]
        print(f"build {name}: seconds {info['seconds']!r} ptxas {regs}",
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(gen)
    main_path = run_main_path()

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": main_path["launches"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["kernel_ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
    }]
    print(f"total_s {time.perf_counter() - t_start!r}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
