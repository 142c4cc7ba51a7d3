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
* ``collectives`` — what the counter saw: nothing in a whole-cell trace
  (one process without a group);
* ``ops`` — the census by aten op, ``products`` (the ops with a FLOP
  formula) and ``kernel`` (the hand-written kernels launched: the cells
  leave flash off, and a kernel wrapper raises on ``meta``);
* ``partitioned`` — whether the record counts one device (below);
* ``trace_s`` — seconds to build and trace the cell (there is no compile).

Every cell is also traced partitioned (``trace_cell`` on a
``DeviceMesh``; the CLI starts torch's in-process ``fake`` group of 256 or
512 ranks): its ``meta`` arguments placed as DTensors by the cell's
shardings, one call counted on one device.  A prefill lays its new cache
out by ``cache_pspec``, as the decode cell takes it; a train cell's
duplex step runs forward and backward on the DTensors, its branch's
gradients reduce-scattered onto their leaves' shards and its new state
laid out as the old.  The record then has the reference's per-device
keys beside the whole cell's, ``memory.temp_bytes`` and
``cost.{dot_flops, traffic_bytes, traffic_bytes_pessimistic}``,
``collectives`` by kind (all-reduce and reduce-scatter at their operand,
all-gather at its result), ``implicit`` (the ops whose operands DTensor
redistributed on its own, and how often), one device's ``ops``, and
``partitioned: true``.

One cell per call:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --mesh pod --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape decode_32k --mesh pod --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
        --shape prefill_32k --mesh pod --out /tmp/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs.common import SHAPES
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import op_analysis
from repro_torch.launch.cells import activation_rules, build_cell
from repro_torch.launch.mesh import make_production_mesh, production_layout
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


def _record(t: op_analysis.OpTrace, out) -> tuple:
    """``(memory, cost)`` keys of one trace, unsuffixed."""
    return ({"temp_bytes": t.temp_bytes(out)},
            {"dot_flops": t.dot_flops(),
             "traffic_bytes": t.traffic_bytes(fusion_aware=True),
             "traffic_bytes_pessimistic": t.traffic_bytes(fusion_aware=False)})


def _ops(t: op_analysis.OpTrace) -> dict:
    census = t.op_census()
    return {"products": sum(n for k, n in t.counts.items() if k[3]),
            "kernel": census.pop("kernel"),
            **dict(sorted(census.items(), key=lambda kv: -kv[1]))}


def trace_cell(arch: str, shape, mesh, variant: str = "baseline",
               keep_order: bool = False) -> dict:
    """Build the cell of ``shape`` (a ``ShapeSpec``; a caller may cut its
    batch) on ``mesh`` and trace one call on its ``meta`` arguments under
    its ``activation_rules``: the record's measured keys, and ``trace``,
    the ``OpTrace``.

    On an ``AbstractMesh`` the call is the whole cell (the ``*_global``
    keys, ``partitioned: False``).  On a ``DeviceMesh`` (any cell: a
    train cell's step runs forward and backward on DTensors; a ``fake``
    group of the mesh's size will do) the whole cell is traced so
    on the abstract layout of the mesh's sizes, and once more partitioned:
    the ``meta`` arguments placed as DTensors by the cell's shardings
    (``sharding.device_put``) and one call counted on the device of this
    process's rank.  That adds the reference's per-device keys,
    ``memory.temp_bytes``, ``cost.{dot_flops, traffic_bytes,
    traffic_bytes_pessimistic}`` and ``collectives``, with ``implicit``
    (the ops whose operands DTensor redistributed on its own, and how
    often) and ``partitioned: True``; ``ops`` is then one device's census
    and ``trace`` its ``OpTrace``, ``trace_global`` the whole cell's."""
    t0 = time.time()
    sizes = sh.mesh_shape(mesh)
    partitioned = not isinstance(mesh, sh.AbstractMesh)
    layout = sh.AbstractMesh(tuple(sizes.values()), tuple(sizes)) \
        if partitioned else mesh
    fn, args, in_sh, _, _, cfg, fsdp_pure = build_cell(arch, shape, layout,
                                                       variant)
    with ctx.activation_sharding(
            layout, activation_rules(cfg, layout, fsdp_pure=fsdp_pure)):
        out, t = op_analysis.trace(fn, *args, keep_order=keep_order)
    in_specs = [tree_map(lambda s: s.spec, s) for s in in_sh]
    memory, cost = _record(t, out)
    rec = {
        "partitioned": partitioned,
        "n_devices": math.prod(sizes.values()),
        "memory": {
            "argument_bytes": sum(device_bytes(a, s, mesh)
                                  for a, s in zip(args, in_specs)),
            "output_bytes": output_bytes(shape.mode, out, in_specs, mesh),
            **{f"{k}_global": v for k, v in memory.items()},
        },
        "cost": {f"{k}_global": v for k, v in cost.items()},
        "collectives": t.collective_bytes(),
        "ops": _ops(t),
        "trace": t,
    }
    if partitioned:
        fn, args, in_sh, _, _, cfg, fsdp_pure = build_cell(arch, shape, mesh,
                                                           variant)
        placed = [sh.device_put(a, s) for a, s in zip(args, in_sh)]
        with ctx.activation_sharding(mesh, activation_rules(
                cfg, mesh, fsdp_pure=fsdp_pure)):
            out, one = op_analysis.trace(fn, *placed, keep_order=keep_order)
        memory, cost = _record(one, out)
        rec["memory"].update(memory)
        rec["cost"].update(cost)
        rec.update(collectives=one.collective_bytes(),
                   implicit=dict(sorted(one.implicit.items())),
                   ops=_ops(one), trace=one, trace_global=t)
    rec["trace_s"] = round(time.time() - t0, 2)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             save_trace: bool = False, variant: str = "baseline",
             partitioned: bool = False) -> dict:
    """The cell's record.  ``partitioned``: the cell (train, prefill or
    decode) is traced on the production mesh over the default process
    group (``make_production_mesh(device_type="cpu")``; ``main`` starts a
    ``fake`` group of the mesh's size), with the per-device keys of
    ``trace_cell``; without it, the cell is traced whole on the
    production layout, ``partitioned: False``."""
    shape = SHAPES[shape_name]
    entry = registry.get(arch)
    mesh_name = "multipod" if multi_pod else "pod"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "variant": variant}

    if shape.name == "long_500k" and not entry.full.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = registry.LONG_CONTEXT_SKIP
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu") \
        if partitioned else \
        production_layout(multi_pod=multi_pod)
    got = trace_cell(arch, shape, mesh, variant, keep_order=save_trace)
    t = got.pop("trace")
    got.pop("trace_global", None)
    rec.update({"status": "ok", **got})
    if save_trace:
        suffix = "" if variant == "baseline" else f"__{variant}"
        (out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.trace.txt"
         ).write_text(t.text())
    return rec


def fake_group(ranks: int) -> None:
    """The default group as torch's in-process ``fake`` backend of
    ``ranks`` ranks, this process rank 0: its collectives move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def main(argv=None) -> int:
    """One cell's record (the reference's CLI, file name and exit codes):
    the cell traced whole and per device on the production mesh, over a
    ``fake`` group of its 256 (``pod``) or 512 (``multipod``) ranks that
    ``main`` starts where the process has no group and destroys after;
    the JSON record under ``--out`` and one line of one device's counts
    beside the whole cell's FLOPs.  Exit 1 on an error, which is
    recorded."""
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
    multi_pod = args.mesh == "multipod"
    own_group = not dist.is_initialized()
    try:
        if own_group:
            fake_group(math.prod(production_layout(
                multi_pod=multi_pod).sizes))
        rec = run_cell(args.arch, args.shape, multi_pod, out_dir,
                       save_trace=args.save_trace, variant=args.variant,
                       partitioned=True)
    except Exception as e:  # recorded, not swallowed — sweep reports it
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
    status = rec["status"]
    extra = rec.get("reason") or rec.get("error", "")
    print(f"[dryrun] {name}: {status} {extra}")
    if status == "ok":
        m, c = rec["memory"], rec["cost"]
        print(f"  args={m['argument_bytes']/2**30:.2f}GiB "
              f"temp={m['temp_bytes']/2**30:.2f}GiB "
              f"dot_flops={c['dot_flops']:.3e} per device "
              f"({c['dot_flops_global']:.3e} global) "
              f"coll={rec['collectives'].get('total', 0)/2**30:.2f}GiB "
              f"implicit={sum(rec['implicit'].values())} "
              f"trace={rec['trace_s']:.1f}s")
    return 0 if status in ("ok", "skipped") else 1


if __name__ == "__main__":
    raise SystemExit(main())
