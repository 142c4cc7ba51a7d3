"""§Roofline: three-term analysis per (arch × shape × mesh) from the dry run
(counterpart of ``benchmarks/roofline.py`` and of ``benchmarks/run.py``'s
``_roofline_rows``).

    compute term    = dot_FLOPs_per_device / peak_FLOP/s
    memory term     = traffic_bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The constants are one NVIDIA H100 SXM's (80 GB HBM3), at its full power
limit of 700 W: the data sheet's dense bf16 tensor-core peak, its HBM3
rate, and one inter-host link per card (``LINK_BW``, below: the traffic is
budgeted against one link, conservative).  A card set below 700 W runs
slower than these bounds say.  Also reports MODEL_FLOPS = 2·N_active·D
(the frozen duplex backbone's forward, prefill and decode alike) and the
useful-compute ratio MODEL_FLOPS / counted FLOPs.

The rows read a record of ``launch/dryrun.py`` traced per device
(``partitioned: true``: ``cost.dot_flops``, ``cost.traffic_bytes``,
``collectives.total``, ``memory.temp_bytes``, ``memory.argument_bytes``);
a whole-cell record (``partitioned: false``) is refused, since its share
per device is not the total over ``n_devices`` where the work splits
unevenly.  ``roofline_fraction`` divides by the bf16 peak for every
variant, tuned2's fp8 backbone included, as the reference does.

    PYTHONPATH=src python -m repro_torch.bench.roofline \\
        --dryrun-dir experiments/dryrun --json-out experiments/roofline.json
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from repro_torch.configs.common import SHAPES
from repro_torch.models import registry
from repro_torch.utils import count_params

# dense bf16 tensor cores, H100 SXM data sheet, at the 700 W power limit
PEAK_FLOPS = 989e12          # FLOP/s
# HBM3, H100 SXM data sheet
HBM_BW = 3.35e12             # bytes/s
# One card's share of the links that carry a collective, each way.  Both
# axes of the 16x16 production mesh have 16 members, so on 32 hosts of
# eight cards both cross hosts: the term budgets the inter-host link, one
# 400 Gb/s NDR InfiniBand adapter a card (ConnectX-7 in NVIDIA's DGX H100
# design), 50e9 B/s each way.  That it equals the reference's per-link
# figure for its own interconnect is a coincidence, not a carried number.
LINK_BW = 50e9               # bytes/s
# NVLink inside a host, each way (900 GB/s both ways); not used in the term
NVLINK_BW = 450e9            # bytes/s


def param_counts(arch: str) -> dict:
    """Total & active parameter counts for MODEL_FLOPS (from a ``meta``
    init: no memory is allocated)."""
    entry = registry.get(arch)
    cfg = entry.full
    shapes = entry.module.init_params(torch.Generator(), cfg, device="meta")
    total = count_params(shapes)
    active = total
    if cfg.n_experts:
        # only top_k (+shared) experts are active per token
        expert_params = cfg.n_experts * (cfg.d_model * cfg.d_ff *
                                         (3 if cfg.gated_mlp else 2))
        per_layer_moe = sum(1 for s in cfg.pattern if s.mlp == "moe")
        total_moe = expert_params * cfg.n_rep * per_layer_moe
        active_frac = cfg.top_k / cfg.n_experts
        active = total - total_moe * (1 - active_frac)
    return {"total": total, "active": active}


def model_flops(arch: str, shape_name: str, counts: dict) -> float:
    """Global useful FLOPs for the cell (duplex: fwd-only backbone).  The
    train term is the backbone's forward alone: the branch's forward and
    backward are not added, as in the reference."""
    shape = SHAPES[shape_name]
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * counts["active"] * tokens
    if shape.mode == "prefill":
        return 2.0 * counts["active"] * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * counts["active"] * shape.global_batch


def load_cells(dryrun_dir: str = "experiments/dryrun") -> list[dict]:
    """The records (``*.json``) in ``dryrun_dir``, by file name; the
    ``.trace.txt`` files beside them are not read."""
    cells = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        cells.append(json.loads(p.read_text()))
    return cells


def roofline_terms(flops: float, traffic_bytes: float,
                   collective_bytes: float = 0) -> dict:
    """Seconds of one device's ``flops``, ``traffic_bytes`` and
    ``collective_bytes`` at the H100's peaks: ``{"compute", "memory",
    "collective"}`` (the collective term 0 on one card)."""
    return {"compute": flops / PEAK_FLOPS, "memory": traffic_bytes / HBM_BW,
            "collective": collective_bytes / LINK_BW}


def roofline_row(rec: dict, counts: dict) -> dict:
    """One cell's row from a per-device record; ``counts`` is
    ``param_counts(rec["arch"])``."""
    if not rec.get("partitioned", True):
        raise ValueError(
            f"{rec.get('arch')} {rec.get('shape')}: the record counts the "
            f"whole cell (partitioned: false), not one device; trace it on "
            f"a DeviceMesh as dryrun.main does (run_cell(..., "
            f"partitioned=True))")
    n_dev = rec["n_devices"]
    flops_dev = rec["cost"]["dot_flops"]          # per device
    terms = roofline_terms(flops_dev, rec["cost"]["traffic_bytes"],
                           rec["collectives"].get("total", 0))
    t_compute = terms["compute"]
    bottleneck = max(terms, key=terms.get)
    mflops = model_flops(rec["arch"], rec["shape"], counts)
    hlo_global = flops_dev * n_dev
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_compute, "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "bottleneck": bottleneck,
        "model_flops": mflops,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mflops / hlo_global if hlo_global else 0.0,
        "step_s_bound": max(terms.values()),
        # fraction of the step bound spent on compute (1.0 ⇔ compute-bound)
        "compute_bound_fraction": (t_compute / max(terms.values())
                                   if max(terms.values()) > 0 else 0.0),
        # useful-model-FLOP/s at the bound, as a fraction of peak
        "roofline_fraction": (mflops / n_dev / max(terms.values()) / PEAK_FLOPS
                              if max(terms.values()) > 0 else 0.0),
        "temp_gib": rec["memory"]["temp_bytes"] / 2**30,
        "args_gib": rec["memory"]["argument_bytes"] / 2**30,
    }


def build_table(dryrun_dir: str = "experiments/dryrun",
                mesh: str = "pod", variant: str = "baseline") -> list[dict]:
    counts_cache: dict = {}
    rows = []
    for rec in load_cells(dryrun_dir):
        if rec["mesh"] != mesh or rec.get("variant", "baseline") != variant:
            continue
        if rec["status"] == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": mesh, "bottleneck": "SKIP",
                         "note": rec["reason"]})
            continue
        if rec["status"] != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": mesh, "bottleneck": "ERROR"})
            continue
        if rec["arch"] not in counts_cache:
            counts_cache[rec["arch"]] = param_counts(rec["arch"])
        rows.append(roofline_row(rec, counts_cache[rec["arch"]]))
    return rows


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound | "
           "useful | roofline frac |\n|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.get("bottleneck") in ("SKIP", "ERROR"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['bottleneck']} | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    return hdr + "\n".join(lines)


def roofline_rows(dryrun_dir: str = "experiments/dryrun") -> list[str]:
    """The table of the ``pod`` mesh as ``name,us_per_call,derived`` CSV
    rows (``benchmarks/run.py``'s roofline rows)."""
    if not Path(dryrun_dir).exists():
        return [f"roofline/skipped,0,no {dryrun_dir} artifacts"]
    rows = []
    for r in build_table(dryrun_dir, mesh="pod"):
        if r.get("bottleneck") in ("SKIP", "ERROR"):
            rows.append(f"roofline/{r['arch']}/{r['shape']},0,"
                        f"{r['bottleneck']}")
            continue
        rows.append(
            f"roofline/{r['arch']}/{r['shape']},"
            f"{r['step_s_bound']*1e6:.0f},"
            f"bound={r['bottleneck']};frac={r['roofline_fraction']:.3f};"
            f"useful={r['useful_ratio']:.2f}")
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--json-out", default="experiments/roofline.json")
    args = ap.parse_args()
    rows = build_table(args.dryrun_dir, args.mesh, args.variant)
    Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json_out).write_text(json.dumps(rows, indent=2))
    print(markdown_table(rows))


if __name__ == "__main__":
    main()
