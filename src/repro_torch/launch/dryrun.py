"""Dry run: trace every (arch × shape × mesh) cell on ``meta`` and record
its cost (counterpart of ``repro/launch/dryrun.py``).

For each cell this builds the real step function (duplex train step /
prefill step / decode step) with ``launch.cells.build_cell`` on the
production layout (``launch.mesh.production_layout``: an ``AbstractMesh``
of 16×16 or 2×16×16, no process group), calls it once on the ``meta``
arguments under the cell's ``activation_rules`` and an
``op_analysis.OpTrace``, and writes a JSON record:

* ``memory.argument_bytes`` / ``memory.output_bytes`` — bytes one device
  holds of the arguments and of the outputs, exactly, from the shard
  shapes of the cell's shardings (the outputs by the same rules: a train
  step's new state in its state's layout, caches by ``cache_pspec``,
  logits and tokens by ``batch_pspec``, scalars replicated);
* ``memory.temp_bytes_global`` — the most bytes the call's own
  allocations held at once, less its outputs (``OpTrace.temp_bytes``),
  for the whole cell;
* ``cost.dot_flops_global``, ``cost.traffic_bytes_global``,
  ``cost.traffic_bytes_pessimistic_global`` — the counter's totals for
  the whole cell: the ``meta`` run is not partitioned, so a device's share
  is the total over ``n_devices`` only where the work spreads evenly;
* ``collectives`` — what the counter saw, which is nothing: the ``meta``
  run is one process without a group, and the collectives of the
  partitioned step come with running the cells on DTensors;
* ``ops`` — the census by aten op, ``products`` (the ops with a FLOP
  formula) and ``kernel`` (the hand-written kernels launched: the cells
  leave flash off, and a kernel wrapper raises on ``meta``);
* ``trace_s`` — seconds to build and trace the cell (there is no compile).

One cell per call:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --mesh pod --out /tmp/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs.common import SHAPES
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import op_analysis
from repro_torch.launch.cells import activation_rules, build_cell
from repro_torch.launch.mesh import production_layout
from repro_torch.models import registry
from repro_torch.utils import tree_flatten, tree_map

def shard_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """One device's block of a ``shape`` laid out by ``spec``, as
    ``jax.sharding.NamedSharding.shard_shape``: each dim over the sizes of
    the mesh axes its entry names; a dim they do not divide raises."""
    sizes = sh.mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        k = math.prod(sizes[a] for a in axes)
        if n % k:
            raise ValueError(f"spec {spec} splits dim {d} of {shape} "
                             f"{k} ways")
        out.append(n // k)
    return tuple(out)


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` under the spec tree ``specs``."""
    return sum(math.prod(shard_shape(tuple(x.shape), s, mesh)) *
               x.element_size()
               for (_, x), (_, s) in zip(tree_flatten(tree),
                                         tree_flatten(specs)))


def output_specs(mode: str, out, in_specs, mesh) -> tuple:
    """The spec trees of a step's outputs by the cell's rules, one per
    output: ``(new_state, metrics)`` of a train step (the state in its own
    layout, the metrics replicated), ``{"next_token_logits", "cache"}`` of
    prefill (one output) and ``(tokens, cache)`` of decode (caches by
    ``cache_pspec``, logits and tokens by ``batch_pspec``)."""
    def batch(x):
        return sh.batch_pspec(tuple(x.shape), mesh)

    if mode == "train":
        return in_specs[0], tree_map(lambda x: (), out[1])
    if mode == "prefill":
        return ({"next_token_logits": batch(out["next_token_logits"]),
                 "cache": sh.tree_pspecs(out["cache"], mesh,
                                         sh.cache_pspec)},)
    return batch(out[0]), sh.tree_pspecs(out[1], mesh, sh.cache_pspec)


def output_bytes(mode: str, out, in_specs, mesh) -> int:
    """Bytes one device holds of a step's outputs (``output_specs``)."""
    outs = out if isinstance(out, tuple) else (out,)
    return sum(device_bytes(o, s, mesh) for o, s in
               zip(outs, output_specs(mode, out, in_specs, mesh)))


def trace_cell(arch: str, shape, mesh, variant: str = "baseline",
               keep_order: bool = False) -> dict:
    """Build the cell of ``shape`` (a ``ShapeSpec``; a caller may cut its
    batch) on ``mesh`` and trace one call on its ``meta`` arguments under
    its ``activation_rules``: the record's measured keys, and ``trace``,
    the ``OpTrace``."""
    t0 = time.time()
    fn, args, in_sh, _, _, cfg, fsdp_pure = build_cell(arch, shape, mesh,
                                                       variant)
    with ctx.activation_sharding(
            mesh, activation_rules(cfg, mesh, fsdp_pure=fsdp_pure)):
        out, t = op_analysis.trace(fn, *args, keep_order=keep_order)
    trace_s = time.time() - t0

    in_specs = [tree_map(lambda s: s.spec, s) for s in in_sh]
    census = t.op_census()
    return {
        "trace_s": round(trace_s, 2),
        "n_devices": math.prod(sh.mesh_shape(mesh).values()),
        "memory": {
            "argument_bytes": sum(device_bytes(a, s, mesh)
                                  for a, s in zip(args, in_specs)),
            "output_bytes": output_bytes(shape.mode, out, in_specs, mesh),
            "temp_bytes_global": t.temp_bytes(out),
        },
        "cost": {
            "dot_flops_global": t.dot_flops(),
            "traffic_bytes_global": t.traffic_bytes(fusion_aware=True),
            "traffic_bytes_pessimistic_global":
                t.traffic_bytes(fusion_aware=False),
        },
        "collectives": t.collective_bytes(),
        "ops": {"products": sum(n for k, n in t.counts.items() if k[3]),
                "kernel": census.pop("kernel"),
                **dict(sorted(census.items(), key=lambda kv: -kv[1]))},
        "trace": t,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             save_trace: bool = False, variant: str = "baseline") -> dict:
    shape = SHAPES[shape_name]
    entry = registry.get(arch)
    mesh_name = "multipod" if multi_pod else "pod"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "variant": variant}

    if shape.name == "long_500k" and not entry.full.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = registry.LONG_CONTEXT_SKIP
        return rec

    got = trace_cell(arch, shape, production_layout(multi_pod=multi_pod),
                     variant, keep_order=save_trace)
    t = got.pop("trace")
    rec.update({"status": "ok", **got})
    if save_trace:
        suffix = "" if variant == "baseline" else f"__{variant}"
        (out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.trace.txt"
         ).write_text(t.text())
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--save-trace", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "tuned", "tuned2"])
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{args.arch}__{args.shape}__{args.mesh}"
    if args.variant != "baseline":
        name += f"__{args.variant}"
    try:
        rec = run_cell(args.arch, args.shape, args.mesh == "multipod",
                       out_dir, save_trace=args.save_trace,
                       variant=args.variant)
    except Exception as e:  # recorded, not swallowed — sweep reports it
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
    status = rec["status"]
    extra = rec.get("reason") or rec.get("error", "")
    print(f"[dryrun] {name}: {status} {extra}")
    if status == "ok":
        m, c = rec["memory"], rec["cost"]
        print(f"  args={m['argument_bytes']/2**30:.2f}GiB/device "
              f"temp={m['temp_bytes_global']/2**30:.2f}GiB global "
              f"dot_flops={c['dot_flops_global']:.3e} global "
              f"coll={rec['collectives'].get('total', 0)/2**30:.2f}GiB "
              f"trace={rec['trace_s']:.1f}s")
    return 0 if status in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
