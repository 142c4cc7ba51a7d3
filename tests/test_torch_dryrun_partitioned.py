"""The dry run per device (``repro_torch.launch.dryrun.trace_cell`` on a
``DeviceMesh``, ``op_analysis.OpTrace`` on DTensors) against
``repro.launch.dryrun``'s per-device record (``HloModule`` of the step
compiled on a mesh).

* The counter on DTensors over torch's in-process ``fake`` group of 4
  ranks, a (2, 2) mesh: a product of a (data, model)-sharded [64, 128] and
  a model-sharded [128, 256] counts one rank's [32, 128] @ [128, 128]
  (1,048,576 FLOPs) and the all-gather that DTensor issues on its own
  (16,384 bytes at its result), not the DTensor-level product and not
  DTensor's shape propagation on the global shapes; the op is listed in
  ``implicit``.  An in-place op whose destination DTensor would have to
  move raises.
* The 12 decode cells at SMOKE (``decode_32k`` on the ten archs at B=2,
  ``long_500k`` on mamba2-780m and recurrentgemma-9b at B=1; 20 cache
  slots; f32 compute) on that mesh, against JAX's decode step compiled on
  a (2, 2) mesh of 4 CPU devices (one subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` compiles all 12):
  - where the work spreads evenly (``EVEN``), per-device ``dot_flops``
    x 4 equals ``dot_flops_global``;
  - the products, ``{(result elements, contraction): count}``, differ from
    JAX's by exactly ``GAPS[cell]["flops"]``;
  - the collectives by kind, ``(bytes, count)`` in ``HloModule``'s
    conventions (all-gather at its result, the others at their operand),
    differ from JAX's by exactly ``GAPS[cell]["coll"]``.

The gaps, in the order of ``GAPS``.  granite-3-8b decode_32k is the
worked example (2 layers, B=2: one row a rank, 4 heads of 8, 2 kv heads,
20 cache slots, 10 a rank):

* **Products.**  Seven cells match product for product.  Where they do
  not:
  - llama-3.2-vision-90b: the cross layer's P·V over the frontend's 4
    tokens splits the heads where XLA splits the batch: (16, 8) -1, (32,
    4) +1, the same FLOPs;
  - mamba2-780m: the one-device gaps of ``test_torch_dryrun.py``
    (``ssd_gap``: C·Bᵀ once per group, (1, 16) x3, against JAX's per head
    split over ``model``, (4, 16) x3; the one-position chunk's products
    on a rank's block, (32, 1) and (512, 1), which XLA multiplies) and the
    ``b_proj`` / ``c_proj`` products: their weights are replicated over
    ``model`` (``ssd/(b|c)_proj/w`` is (data, None)), so each model rank
    runs the whole product, (16, 32) x6 (B=2) or (16, 16) x6 (B=1), where
    XLA slices the weight and runs half, (8, 32) or (8, 16).  The scan runs
    on each rank's block of batch and heads (``ssm._ssd_scan``);
  - granite-moe-1b-a400m and llama4-maverick-400b-a17b: a decode
    routing group is the whole batch, so ``moe._moe_placed`` gathers the
    tokens and every rank routes all of them: the router runs whole, (8,
    32) against JAX's (2, 32) (granite-moe; llama4's (8, 40) against (4,
    40)), and the combine over each token's ``top_k`` rows, (64, 2) or
    (80, 1), stands for JAX's one-hot einsum split over ``model``, (32, 8)
    or (40, 8) (``moe_gap`` of the one-device test).  A rank runs its own
    experts (E split over ``model``) on every token with the whole of d,
    (128, 32) x4 and (256, 16) x2 (granite-moe; llama4's (128, 40) x4 and
    (320, 16) x2), where XLA splits the tokens' d over ``data`` too,
    (128, 16) x6 ((128, 20) x4 and (160, 16) x2): twice the expert FLOPs
    a device;
  - recurrentgemma-9b long_500k (B=1): the batch does not split over
    ``data``, so ``ctx.at_use`` keeps each weight's ``data`` shard and the
    product contracts half of d (partial sums, reduced over ``data``),
    (·, 16) where XLA gathers the weight and runs the whole contraction
    on both data ranks, (·, 32): half the FLOPs a device.
* **Collectives** (granite-3-8b: all-gather +1712 bytes, +4; all-to-all
  -640, -5; collective-permute -4, -1):
  - the weights' ``data`` shards and the activations gathered for the
    row-parallel products are JAX's, gather for gather, and so are the
    all-reduces: the row-parallel sums, the attention's sums over the
    cache's sequence shards, and ``ctx.softmax``'s max and sum over them
    (DTensor's own softmax would gather the scores);
  - XLA's all-to-alls (the row-parallel products' d-split outputs back to
    the batch split), 5 x 128 bytes, are gathers here: torch's CPU groups
    have no all-to-all, and DTensor gathers and chunks (+5, +1280 bytes);
  - the cache write lays the new k and v out as the cache, in its dtype,
    4 x [2, 1, 1, 8] bf16, where XLA gathers them in f32 (-128 bytes);
  - the greedy argmax gathers the vocab-sharded logits, [2, 72] f32,
    where XLA gathers each rank's (max, index) pair, 2 x 8 bytes (+560,
    -1);
  - the token ids are gathered once, where XLA also permutes them (-4,
    -1).
  The other cells' differences are these, per layer, and: recurrentgemma-9b
  reduces the lru gates' two sums in two all-reduces where XLA merges
  them into one of two operands (+4 all-reduces, 0 bytes), and XLA shifts
  the ring's conv states by collective-permutes; whisper-base's and
  llama-3.2-vision-90b's cross layers gather the query heads and
  reduce-scatter what XLA gathers; mamba2-780m gathers the whole ``b_proj``
  / ``c_proj`` weights where XLA gathers the half it runs (6 x 1024
  bytes); the MoE layers gather their tokens and sum their experts' rows
  once; and the two B=1 cells reduce over ``data`` what XLA gathers
  (recurrentgemma-9b: all-gather -68048 bytes).
"""
import dataclasses as dc
import json
import math
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.common import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cells, dryrun, op_analysis as oa
from repro_torch.models import layers as TL, registry

ROOT = Path(__file__).resolve().parents[1]
DECODE = [(a, "decode_32k", 2) for a in registry.ARCHS] + \
    [(a, "long_500k", 1) for a in ("mamba2-780m", "recurrentgemma-9b")]
SLOTS = 20

GAPS = {
    ("whisper-base", "decode_32k"): {
        "flops": {},
        "coll": {"all-gather": (2032, 6), "all-reduce": (-256, -2),
                 "reduce-scatter": (256, 2), "all-to-all": (-1152, -10),
                 "collective-permute": (-4, -1)}},
    ("gemma2-9b", "decode_32k"): {
        "flops": {},
        "coll": {"all-gather": (2800, 10), "all-to-all": (-1792, -13),
                 "collective-permute": (-4, -1)}},
    ("qwen2-72b", "decode_32k"): {
        "flops": {},
        "coll": {"all-gather": (2096, 6), "all-to-all": (-896, -7),
                 "collective-permute": (-4, -1)}},
    ("starcoder2-7b", "decode_32k"): {
        "flops": {},
        "coll": {"all-gather": (2320, 6), "all-to-all": (-1008, -7),
                 "collective-permute": (-4, -1)}},
    ("granite-3-8b", "decode_32k"): {
        "flops": {},
        "coll": {"all-gather": (1712, 4), "all-to-all": (-640, -5),
                 "collective-permute": (-4, -1)}},
    ("llama-3.2-vision-90b", "decode_32k"): {
        "flops": {(16, 8): -1, (32, 4): 1},
        "coll": {"all-gather": (3184, 11), "all-reduce": (32, 2),
                 "reduce-scatter": (128, 1), "all-to-all": (-1920, -13),
                 "collective-permute": (-4, -1)}},
    ("mamba2-780m", "decode_32k"): {
        "flops": {(1, 16): 3, (4, 16): -3, (8, 32): -6, (16, 32): 6,
                  (32, 1): 3, (512, 1): 3},
        "coll": {"all-gather": (7664, 3), "all-to-all": (-512, -4),
                 "collective-permute": (-4, -1)}},
    ("recurrentgemma-9b", "decode_32k"): {
        "flops": {},
        "coll": {"all-gather": (3184, 9), "all-reduce": (0, 4),
                 "all-to-all": (-1472, -12),
                 "collective-permute": (-20, -3)}},
    ("granite-moe-1b-a400m", "decode_32k"): {
        "flops": {(2, 32): -2, (8, 32): 2, (32, 8): -2, (64, 2): 2,
                  (128, 16): -6, (128, 32): 4, (256, 16): 2},
        "coll": {"all-gather": (26032, 0), "all-reduce": (-4152, -14),
                 "all-to-all": (-640, -5), "collective-permute": (-36, -5)}},
    ("llama4-maverick-400b-a17b", "decode_32k"): {
        "flops": {(4, 40): -2, (8, 40): 2, (40, 8): -2, (80, 1): 2,
                  (128, 20): -4, (128, 40): 4, (160, 16): -2, (320, 16): 2},
        "coll": {"all-gather": (33648, 12), "all-reduce": (-4936, -6),
                 "all-to-all": (-1120, -7), "collective-permute": (-20, -3)}},
    ("mamba2-780m", "long_500k"): {
        "flops": {(1, 16): 3, (4, 16): -3, (8, 16): -6, (16, 16): 6,
                  (32, 1): 3, (512, 1): 3},
        "coll": {"all-gather": (624, 0), "all-reduce": (444, 11)}},
    ("recurrentgemma-9b", "long_500k"): {
        "flops": {(4, 16): 2, (4, 32): -2, (16, 16): 9, (16, 32): -9,
                  (32, 16): 10, (32, 32): -10, (64, 16): 1, (64, 32): -1},
        "coll": {"all-gather": (-68048, -22), "all-reduce": (-404, 8),
                 "all-to-all": (-1472, -12),
                 "collective-permute": (-16, -2)}},
}
# the cells whose work spreads evenly over the 4 ranks
EVEN = {("whisper-base", "decode_32k"), ("gemma2-9b", "decode_32k"),
        ("qwen2-72b", "decode_32k"), ("starcoder2-7b", "decode_32k"),
        ("granite-3-8b", "decode_32k"),
        ("llama-3.2-vision-90b", "decode_32k"),
        ("recurrentgemma-9b", "decode_32k")}

JAX_SIDE = r"""
import collections, dataclasses as dc, json, math, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.common import ShapeSpec
from repro.distributed import ctx
from repro.launch import cells, hlo_analysis as ha
from repro.models import layers as L, registry
for name, entry in list(registry.ARCHS.items()):
    registry.ARCHS[name] = dc.replace(entry, full=entry.smoke)
cells.POLICY = L.Policy(compute_dtype=jnp.float32)
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
out = {}
for arch, name, b in json.loads(sys.argv[1]):
    fn, args, ins, outs, don, cfg, fp = cells.build_cell(
        arch, ShapeSpec(name, int(sys.argv[2]), b, "decode"), mesh)
    with mesh, ctx.activation_sharding(
            mesh, cells.activation_rules(cfg, mesh, fsdp_pure=fp)):
        hlo = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                      donate_argnums=don).lower(*args).compile().as_text()
    mod = ha.HloModule(hlo)
    prods = collections.Counter()
    for ins_ in mod.instrs:
        if ins_.opcode not in ("dot", "convolution"):
            continue
        _, rdims = ha._shape_dims(ins_.result)
        k = 1
        cm = ha._CONTRACT_RE.search(ins_.attrs)
        if cm and ins_.operands:
            _, ldims = ha._shape_dims(mod.shapes.get(ins_.operands[0], ""))
            for ci in cm.group(1).split(","):
                if ci and int(ci) < len(ldims):
                    k *= ldims[int(ci)]
        prods[f"{math.prod(rdims)},{k}"] += int(mod.mult.get(ins_.comp, 1))
    out[f"{arch}|{name}"] = {"dot_flops": mod.dot_flops(),
                             "collectives": mod.collective_bytes(),
                             "products": dict(prods)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    """JAX's 12 decode steps compiled on a (2, 2) mesh of 4 CPU devices, in
    a process of their own: dot FLOPs, collectives and products."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    got = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(DECODE),
                          str(SLOTS)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2) ``DeviceMesh`` over torch's in-process ``fake`` group of 4
    ranks (this process is rank 0; collectives move nothing), with the
    registry at SMOKE and f32 compute."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    with pytest.MonkeyPatch.context() as mp:
        for name, entry in list(registry.ARCHS.items()):
            mp.setitem(registry.ARCHS, name,
                       dc.replace(entry, full=entry.smoke))
        mp.setattr(cells, "POLICY", TL.Policy(compute_dtype=torch.float32))
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def meta(*shape):
    return torch.empty(shape, device="meta")


def test_probe_product_counts_one_rank(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    a = distribute_tensor(meta(64, 128), fake_mesh, (Shard(0), Shard(1)))
    b = distribute_tensor(meta(128, 256), fake_mesh,
                          (Replicate(), Shard(1)))
    for _ in range(2):          # DTensor's propagation caches the second
        with oa.OpTrace() as t:
            c = a @ b
        assert c.to_local().shape == (32, 128)
        assert t.dot_flops() == 2 * 32 * 128 * 128 == 1_048_576
        got = t.collective_bytes()
        assert got["all-gather"] == 32 * 128 * 4 == 16_384
        assert got["counts"] == {"all-gather": 1}
        assert dict(t.implicit) == {"aten.mm": 1}
        products = [k for k in t.counts if k[3]]
        assert [(k[1][0][0], k[1][1][0]) for k in products] == \
            [((32, 128), (128, 128))]


def test_explicit_redistribute_is_not_implicit(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    a = distribute_tensor(meta(64, 128), fake_mesh, (Shard(0), Shard(1)))
    with oa.OpTrace() as t:
        a.redistribute(fake_mesh, (Shard(0), Replicate()))
    assert t.collective_bytes()["counts"] == {"all-gather": 1}
    assert dict(t.implicit) == {} and t.dot_flops() == 0


def test_in_place_op_on_a_moving_destination_raises(fake_mesh):
    """DTensor's ``index_copy_`` along a sharded dim gathers the
    destination and writes into the gathered copy; the counter refuses it
    (``ctx.index_copy_`` writes each rank's block instead)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cache = distribute_tensor(meta(2, 20, 2, 8), fake_mesh,
                              (Shard(0), Shard(1)))
    upd = distribute_tensor(meta(2, 1, 2, 8), fake_mesh,
                            (Shard(0), Replicate()))
    idx = torch.zeros(1, dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError, match="in-place"), torch.no_grad():
        with oa.OpTrace():
            cache.index_copy_(1, idx, upd)


def test_plain_product_counts_as_before(fake_mesh):
    with oa.OpTrace() as t:
        meta(64, 128) @ meta(128, 256)
    assert t.dot_flops() == 2 * 64 * 128 * 256 and dict(t.implicit) == {}


def _products(t) -> Counter:
    out = Counter()
    for key, n in t.counts.items():
        if key[3]:
            elems = math.prod(key[2][0])
            out[(elems, key[3] // (2 * elems))] += n
    return out


@pytest.mark.parametrize("arch,shape_name,batch", DECODE,
                         ids=[f"{a}-{s}" for a, s, _ in DECODE])
def test_smoke_decode_cell_per_device_against_jax(arch, shape_name, batch,
                                                  fake_mesh, jax_side):
    rec = dryrun.trace_cell(arch, ShapeSpec(shape_name, SLOTS, batch,
                                            "decode"), fake_mesh)
    assert rec["partitioned"] and rec["n_devices"] == 4
    cost, mem = rec["cost"], rec["memory"]
    assert set(cost) == {"dot_flops", "traffic_bytes",
                         "traffic_bytes_pessimistic", "dot_flops_global",
                         "traffic_bytes_global",
                         "traffic_bytes_pessimistic_global"}
    assert {"temp_bytes", "temp_bytes_global"} <= set(mem)
    assert 0 < cost["traffic_bytes"] <= cost["traffic_bytes_pessimistic"]
    assert rec["ops"]["kernel"] == 0 and rec["implicit"]
    t = rec["trace"]
    assert cost["dot_flops"] == t.dot_flops()
    if (arch, shape_name) in EVEN:
        assert cost["dot_flops"] * 4 == cost["dot_flops_global"]
    else:
        assert cost["dot_flops"] * 4 != cost["dot_flops_global"]

    jax = jax_side[f"{arch}|{shape_name}"]
    gap = GAPS[(arch, shape_name)]
    diff = _products(t)
    diff.subtract(Counter({tuple(map(int, k.split(","))): n
                           for k, n in jax["products"].items()}))
    assert {k: v for k, v in diff.items() if v} == gap["flops"]
    named = sum(2 * e * k * n for (e, k), n in gap["flops"].items())
    assert cost["dot_flops"] - jax["dot_flops"] == named

    got, want = rec["collectives"], jax["collectives"]
    coll = {}
    for kind in oa.COLLECTIVE_KINDS:
        d = (got.get(kind, 0) - int(want.get(kind, 0)),
             got["counts"].get(kind, 0) - int(want["counts"].get(kind, 0)))
        if d != (0, 0):
            coll[kind] = d
    assert coll == gap["coll"]
    assert got["total"] - int(want["total"]) == \
        sum(b for b, _ in gap["coll"].values())


def test_train_cell_on_a_device_mesh_raises(fake_mesh):
    with pytest.raises(ValueError, match="only decode cells"):
        dryrun.trace_cell("granite-3-8b", ShapeSpec("t", 16, 2, "train"),
                          fake_mesh)


def test_abstract_record_says_it_is_not_partitioned(fake_mesh):
    rec = dryrun.trace_cell("granite-3-8b", ShapeSpec("d", SLOTS, 2,
                                                      "decode"),
                            sh.AbstractMesh((2, 2), ("data", "model")))
    assert rec["partitioned"] is False
    assert "dot_flops" not in rec["cost"] and "implicit" not in rec
