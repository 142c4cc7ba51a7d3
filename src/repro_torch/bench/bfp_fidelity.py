"""2D BFP (§III-E) numeric fidelity + kernel timing: quantization error of
the paper format, transpose invariance, BFP-vs-fp32 training parity, and
the BFP matmul kernel's call time.

Counterpart of ``benchmarks/bfp_fidelity.py``, with the same rows in the
same order.  The input is a 256x256 standard normal drawn from
``torch.Generator(device).manual_seed(0)`` unless ``x`` is handed in; JAX's
``PRNGKey(0)`` draw cannot be replayed, so the rmse values differ from the
reference's by the draw alone.  The kernel row calls
``repro_torch.kernels.bfp_matmul.bfp_matmul`` on the reference's operands
(128x128 f32, both the same draw, group 32, blocks 64; one warm call, then
3 timed): on a CUDA device that launches the hand-written kernels
(``bfp/cuda_matmul_128``, timed with CUDA events), on the CPU it is the
plain version (``bfp/plain_matmul_128``, host clock).  Either way the
product is held against ``bfp_matmul_plain`` on the same device.

    PYTHONPATH=src python -m repro_torch.bench.bfp_fidelity --device cuda

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.
"""
from __future__ import annotations

import time

import torch

from repro_torch.bench import common
from repro_torch.core import bfp
from repro_torch.kernels.bfp_matmul import bfp_matmul, bfp_matmul_plain

# (group, mbits) of the rmse rows: the paper's format, a coarse group, more
# mantissa bits
RMSE_CASES = (((3, 3), 5), ((32, 32), 5), ((3, 3), 7))
MATMUL_N = 128
MATMUL_ITERS = 3


def quantization_rows(x: torch.Tensor) -> tuple[list[str], dict]:
    """The rmse rows and the transpose row for the input ``x``."""
    rows, values = [], {"rmse": {}, "bits": {}}
    for group, mbits in RMSE_CASES:
        name = f"bfp/rmse_g{group[0]}m{mbits}"
        rmse = float(bfp.quantization_rmse(x, group=group, mbits=mbits))
        bits = bfp.bfp_quantize(x, group=group, mbits=mbits).bits_per_value
        values["rmse"][name], values["bits"][name] = rmse, bits
        rows.append(f"{name},0,rmse={rmse:.5f};bits={bits:.2f}")

    # transpose invariance (the §III-E property)
    q1 = bfp.bfp_dequantize(bfp.bfp_quantize(x.T))
    q2 = bfp.bfp_dequantize(bfp.bfp_quantize(x)).T
    values["transpose_max_diff"] = float((q1 - q2).abs().max())
    rows.append(f"bfp/transpose_invariance,0,"
                f"max_diff={values['transpose_max_diff']:.2e}")
    return rows, values


def matmul_row(a: torch.Tensor) -> tuple[str, dict]:
    """The kernel row: ``bfp_matmul(a, a)`` at the reference's group and
    blocks, one warm call and ``MATMUL_ITERS`` timed; the warm call's
    product against the plain version on ``a``'s device."""
    def f():
        return bfp_matmul(a, a, group=32, block_m=64, block_n=64,
                          block_k=64)

    out = f()
    if a.is_cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(MATMUL_ITERS):
            f()
        end.record()
        end.synchronize()
        us = start.elapsed_time(end) * 1e3 / MATMUL_ITERS
    else:
        t0 = time.perf_counter()
        for _ in range(MATMUL_ITERS):
            f()
        us = (time.perf_counter() - t0) * 1e6 / MATMUL_ITERS
    route = "cuda" if a.is_cuda else "plain"
    err = float((out - bfp_matmul_plain(a, a, group=32)).abs().max())
    row = (f"bfp/{route}_matmul_{a.shape[0]},{us:.0f},"
           f"oracle=bfp_matmul_plain;max_abs_err={err:.2e}")
    return row, {"route": route, "a": a, "out": out, "us": us,
                 "max_abs_err": err}


def run(device="cuda", pretrain_steps: int = 120, arm_steps: int = 150,
        x=None) -> tuple[list[str], dict]:
    """The rows, and the values behind them: ``x``, ``rmse``, ``bits``,
    ``transpose_max_diff``, ``matmul`` (its operand, product, time and
    error) and ``training_parity`` (``{"fp32" | "bfp": (val_loss,
    val_acc, train_s)}``)."""
    if x is None:
        x = torch.randn((256, 256),
                        generator=torch.Generator(device).manual_seed(0),
                        device=device)
    else:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
    rows, values = quantization_rows(x)
    values["x"] = x

    a = torch.randn((MATMUL_N, MATMUL_N),
                    generator=torch.Generator(device).manual_seed(0),
                    device=device)
    row, values["matmul"] = matmul_row(a)
    rows.append(row)

    # end-to-end: duplex training with paper-format BFP vs fp32 branch
    backbone, _ = common.pretrain_backbone(steps=pretrain_steps,
                                           device=device)
    parity = {name: common.train_arm("duplex", backbone, steps=arm_steps,
                                     dcfg=common.duplex_cfg(bfp=q),
                                     device=device)
              for name, q in (("fp32", False), ("bfp", True))}
    values["training_parity"] = parity
    l_fp, l_q = parity["fp32"][0], parity["bfp"][0]
    rows.append(f"bfp/training_parity,0,"
                f"fp32_loss={l_fp:.4f};bfp_loss={l_q:.4f};"
                f"gap={(l_q-l_fp):.4f}")
    return rows, values


def main(argv=None) -> list[str]:
    return common.cli(run, argv)


if __name__ == "__main__":
    main()
