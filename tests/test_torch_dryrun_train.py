"""The dry run of the train cells per device (``dryrun.trace_cell`` on a
``DeviceMesh``: the duplex step, forward and backward, on ``meta``
DTensors) against ``repro.launch.dryrun``'s per-device record (``HloModule``
of JAX's train step compiled on a (2, 2) mesh of 4 CPU devices).

The ten train cells at SMOKE (``train_4k`` on the ten archs at B=2, 16
tokens, f32 compute) and granite-3-8b at 64 tokens (so that the branch has
four pooled positions, not one) on a (2, 2) mesh over torch's in-process
``fake`` group, each traced with its state and batch placed by the cell's
own shardings (``fake_mesh``, ``compiled_on_jax`` and ``held_to_jax`` of
``tests/test_torch_dryrun_partitioned.py``): the record is partitioned and
has the per-device keys; per-device ``dot_flops`` x 4 equals the whole
cell's where the work spreads evenly (all but ``UNEVEN``); the products and the
collectives by kind differ from JAX's by exactly ``TRAIN_GAPS``; the
branch's gradients are reduce-scattered onto their leaves' shards (the
backward was counted), and nothing launched.

The gaps.  The branch at SMOKE: d_branch 256, 4 heads of 64, an MLP of
1024, ``n`` blocks (2; 3 on qwen2-72b, starcoder2-7b, mamba2-780m), its
weights split (data, model) as the sharding scheme says; 16 tokens pool to
one position, so a rank's block of the branch's stream is one row.  A
product is ``(result elements, contraction)`` on one device.
``branch_gap(d, n, heads)`` gives the branch's gaps for a backbone of
width ``d`` (``m = d / 2`` a data rank's share), in four groups:

* **The reversible backward's extra work**, net +458,752 FLOPs a block
  (1,835,008 over 4 devices): F1's q, k and v products run
  three times a block, in the forward, in eq 2's recompute and in the
  VJP's forward, where XLA merges the last two (128, 256) +6n; F2's ``wo``
  runs in the VJP's forward, which XLA drops, (256, 512) +n; and DTensor
  splits the MLP's in-products and F1's ``wo`` otherwise than XLA (the
  same FLOPs): (512, 256) +4n for (1024, 128) -4n, (256, 128) -3n.
* **ZeRO-3 against a gathered batch**, the same FLOPs: the port gathers
  each branch weight's ``data`` shard (``ctx.at_use``) and reduce-scatters
  its gradient, computed over the rank's one row, (K, 1), where XLA
  gathers the batch's two rows and computes the gradient's shard over
  both, (K / 2, 2): q, k, v (32768, 1) +3n for (16384, 2) -3n; the MLP's
  in-projections (131072, 1) +2n for (65536, 2) -2n; the input and tap
  projections (128·d, 1) +(2 + n) for (128·m, 2) -2 and the taps' one
  batched dot (128·m·n, 2) -1 (the port runs one product a block, as
  ``tests/test_torch_dryrun.py`` names), and their forwards (128, d)
  +(2 + n) for (256, m) -2 and (256·n, m) -1.
* **Products over one position** (counted as products here, turned into
  multiplies by XLA, as ``tests/test_torch_dryrun.py`` names): the
  branch attention's P·V and its two gradients over its one key,
  (64·h, 1) +2n (h, the heads a rank holds: 2, or 4 where the backbone
  is sequence parallel and its ``act_q`` rule leaves the heads whole);
  ``out_proj``'s weight gradient over the rank's one row, (512·m, 1)
  +1; dP, a dot in JAX and a multiply plus a sum here, (2, 64) -n.
* Nothing else of the branch differs: ``out_proj`` and its input's
  gradient, the loss and the unembedding's gradient are JAX's products.

Net, granite-3-8b at 16 tokens: +917,504 (reversible) + 0 (ZeRO-3) +
16,896 (one position: 1,024 + 16,384 - 512) = +934,400 FLOPs a device.
At 64 tokens (four pooled positions, a rank's block four rows) the
one-position products are gone and the rest scales: exactly the
reversible +3,670,016 (2 x 1,835,008), ``GRANITE_64``.

The backbone runs forward only, as in the prefill cell, and has the
prefill cell's gaps (``PREFILL_GAPS`` of the partitioned test): none for
seven archs, the MoE routing gaps for granite-moe-1b-a400m; and:

* starcoder2-7b and llama4-maverick-400b-a17b (sequence parallel): XLA
  forms ``out_proj``'s weight gradient as a dot over the batch's two rows
  beside the port's, (256·m, 2) -1: (4608, 2) and (5120, 2);
* llama4-maverick-400b-a17b: one pair of its MoE combine products (640,
  32) -2 runs over 1280 elements in JAX's train compile, (1280, 32) -2,
  where the prefill compile has (640, 32) -4;
* mamba2-780m (no attention, so no ``act_q`` rule for the branch's q):
  the port splits the branch's heads over ``model`` where XLA's compile
  keeps them whole on each rank, scores (2, 64) +12 for (4, 64) -12
  (-3,072 FLOPs), and its q, k, v products over a rank's row where XLA's
  span the batch, (128, 256) +9 for (256, 128) -9 (the same FLOPs); the
  SSD layers' C·Bᵀ once per group on a rank's batch and heads
  (``ssm._ssd_scan``) and their chunk products, (128, 16) +3, (256, 32)
  +6 for (256, 16) -6 and (512, 16) -3 (+12,288 FLOPs).

The collectives (granite-3-8b, 16 tokens: all-gather +7,644,800 bytes /
+125, all-reduce -104,104 / -24, reduce-scatter +3,004,416 / +30,
all-to-all -101,888 / -12, collective-permute -40,512 / -48):

* ZeRO-3: the port all-gathers each branch weight's ``data`` shard at
  each of its three runs a block, and reduce-scatters each gradient onto
  the leaf's shards (30 reduce-scatters: q, k, v's after a gather over
  ``model``, one of the layouts DTensor takes for the transposed product
  of their gradient); XLA gathers the batch's rows and all-reduces.
* At SMOKE a 32 x 32 BFP group straddles ranks (a weight's 16-row data
  shard, the stream's one row a rank), so ``ctx.tiled`` gathers the cut
  dim first; at the production widths the groups lie in a rank's block.
* XLA's all-to-alls and collective-permutes are gathers here (torch's
  CPU groups have no all-to-all, as in the decode cells).
* The global norm reduces the ranks' summed squares over the two mesh
  dims in turn, two all-reduces of 4 bytes (``ctx.total``); the loss's
  vocab-parallel log-sum-exp, pick and argmax are five all-reduces of a
  row each (``ctx.logsumexp_pick``, ``ctx.argmax``).
The other cells' differences are these, by layer and block, and their
backbones' prefill differences.
"""
from collections import Counter

import pytest

from repro_torch.configs.common import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models import registry
from test_torch_dryrun_partitioned import (PREFILL_GAPS, compiled_on_jax,
                                           fake_mesh, held_to_jax)

__all__ = ["fake_mesh"]       # the fixture, shared with the partitioned test

CASES = [(a, 16) for a in registry.ARCHS] + [("granite-3-8b", 64)]


def branch_gap(d: int, n: int, heads: int = 2) -> Counter:
    """The branch's product gaps at 16 tokens (module docstring), for a
    backbone of width ``d``, ``n`` blocks and ``heads`` branch heads a
    rank."""
    m = d // 2
    g = Counter()
    for key, k in (  # the reversible backward's extra work
            ((128, 256), 6 * n), ((256, 512), n), ((512, 256), 4 * n),
            ((1024, 128), -4 * n), ((256, 128), -3 * n),
            # ZeRO-3 against a gathered batch
            ((32768, 1), 3 * n), ((16384, 2), -3 * n),
            ((131072, 1), 2 * n), ((65536, 2), -2 * n),
            ((128 * d, 1), 2 + n), ((128 * m, 2), -2),
            ((128 * m * n, 2), -1),
            ((128, d), 2 + n), ((256, m), -2), ((256 * n, m), -1),
            # products over one position
            ((64 * heads, 1), 2 * n), ((512 * m, 1), 1), ((2, 64), -n)):
        g[key] += k
    return g


def with_gaps(branch: Counter, *more: dict) -> dict:
    out = Counter(branch)
    for extra in more:
        out.update(extra)
    return {k: v for k, v in out.items() if v}


def prefill_flops(arch: str) -> dict:
    return PREFILL_GAPS[(arch, "prefill_32k")]["flops"]


ZERO3 = {"reduce-scatter": (3004416, 30)}
TRAIN_GAPS = {
    ("whisper-base", 16): {
        "flops": with_gaps(branch_gap(32, 2)),
        "coll": {"all-gather": (7662208, 137), "all-reduce": (-104168, -25),
                 **ZERO3, "all-to-all": (-101888, -12),
                 "collective-permute": (-40512, -48)}},
    ("gemma2-9b", 16): {
        "flops": with_gaps(branch_gap(32, 2)),
        "coll": {"all-gather": (7644800, 125), "all-reduce": (-104232, -26),
                 **ZERO3, "all-to-all": (-101888, -12),
                 "collective-permute": (-40512, -48)}},
    ("qwen2-72b", 16): {
        "flops": with_gaps(branch_gap(32, 3)),
        "coll": {"all-gather": (11415424, 185),
                 "all-reduce": (-137164, -34),
                 "reduce-scatter": (4472832, 43),
                 "all-to-all": (-151168, -16),
                 "collective-permute": (-55872, -67)}},
    ("starcoder2-7b", 16): {
        "flops": with_gaps(branch_gap(36, 3), {(4608, 2): -1}),
        "coll": {"all-gather": (11454240, 197),
                 "all-reduce": (-105112, -40),
                 "reduce-scatter": (4487424, 43),
                 "all-to-all": (-161456, -17),
                 "collective-permute": (-165952, -82)}},
    ("granite-3-8b", 16): {
        "flops": with_gaps(branch_gap(32, 2)),
        "coll": {"all-gather": (7644800, 125), "all-reduce": (-104104, -24),
                 **ZERO3, "all-to-all": (-101888, -12),
                 "collective-permute": (-40512, -48)}},
    ("llama-3.2-vision-90b", 16): {
        "flops": with_gaps(branch_gap(32, 2)),
        "coll": {"all-gather": (7652992, 129), "all-reduce": (-103976, -22),
                 **ZERO3, "all-to-all": (-101760, -11),
                 "collective-permute": (-40512, -48)}},
    ("mamba2-780m", 16): {
        "flops": with_gaps(branch_gap(32, 3), {
            (2, 64): 12, (4, 64): -12, (128, 256): 9, (256, 128): -9,
            (128, 16): 3, (256, 32): 6, (256, 16): -6, (512, 16): -3}),
        "coll": {"all-gather": (12632128, 224),
                 "all-reduce": (-152380, -34),
                 "reduce-scatter": (4473024, 46), "all-to-all": (-3712, -7),
                 "collective-permute": (-43584, -46)}},
    ("recurrentgemma-9b", 16): {
        "flops": with_gaps(branch_gap(32, 2)),
        "coll": {"all-gather": (7646848, 125), "all-reduce": (-104232, -22),
                 **ZERO3, "all-to-all": (-101760, -11),
                 "collective-permute": (-40768, -50)}},
    ("granite-moe-1b-a400m", 16): {
        "flops": with_gaps(branch_gap(32, 2),
                           prefill_flops("granite-moe-1b-a400m")),
        "coll": {"all-gather": (7655040, 117), "all-reduce": (-137528, -38),
                 **ZERO3, "all-to-all": (-101888, -12),
                 "collective-permute": (-40512, -48)}},
    ("llama4-maverick-400b-a17b", 16): {
        "flops": with_gaps(branch_gap(40, 2, heads=4),
                           prefill_flops("llama4-maverick-400b-a17b"),
                           {(640, 32): 2, (1280, 32): -2, (5120, 2): -1}),
        "coll": {"all-gather": (7711232, 135), "all-reduce": (-80008, -20),
                 "reduce-scatter": (3036672, 32),
                 "all-to-all": (-134848, -42),
                 "collective-permute": (-121056, -63)}},
}
# granite-3-8b at 64 tokens: the reversible backward's extra work, and
# ZeRO-3 against the gathered batch, each over a rank's four rows
GRANITE_64 = {
    "flops": {(512, 256): 12, (1024, 512): 2, (2048, 256): 8,
              (4096, 128): -8, (1024, 128): -6,
              (32768, 4): 6, (16384, 8): -6, (131072, 4): 4,
              (65536, 8): -4, (4096, 4): 4, (2048, 8): -2, (4096, 8): -1,
              (512, 32): 4, (1024, 16): -2, (2048, 16): -1},
    "coll": {"all-gather": (8074752, 126), "all-reduce": (-316456, -24),
             "reduce-scatter": (3072000, 30), "all-to-all": (-112640, -12),
             "collective-permute": (-162048, -48)}}
TRAIN_GAPS[("granite-3-8b", 64)] = GRANITE_64
# the cells whose work does not spread evenly over the 4 ranks
UNEVEN = {("mamba2-780m", 16), ("granite-moe-1b-a400m", 16),
          ("llama4-maverick-400b-a17b", 16)}


@pytest.fixture(scope="module")
def jax_train():
    """JAX's train steps of ``CASES`` (``compiled_on_jax``)."""
    return compiled_on_jax([(a, "train_4k", 2, "train", s, {})
                            for a, s in CASES])


@pytest.mark.parametrize("arch,seq", CASES,
                         ids=[f"{a}-{s}" for a, s in CASES])
def test_smoke_train_cell_per_device_against_jax(arch, seq, fake_mesh,
                                                 jax_train):
    rec = dryrun.trace_cell(arch, ShapeSpec("train_4k", seq, 2, "train"),
                            fake_mesh)
    assert rec["partitioned"] and rec["n_devices"] == 4
    cost, mem = rec["cost"], rec["memory"]
    assert set(cost) == {"dot_flops", "traffic_bytes",
                         "traffic_bytes_pessimistic", "dot_flops_global",
                         "traffic_bytes_global",
                         "traffic_bytes_pessimistic_global"}
    assert {"temp_bytes", "temp_bytes_global"} <= set(mem)
    assert 0 < cost["traffic_bytes"] <= cost["traffic_bytes_pessimistic"]
    assert rec["ops"]["kernel"] == 0 and rec["implicit"]
    # the backward was counted: the branch's gradients reduce-scattered
    assert rec["collectives"]["counts"]["reduce-scatter"] >= 30
    held_to_jax(rec, jax_train[f"{arch}|train_4k|{seq}"],
                TRAIN_GAPS[(arch, seq)], (arch, seq) not in UNEVEN)
