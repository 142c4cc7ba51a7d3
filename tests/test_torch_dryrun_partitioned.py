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
* The ten prefill cells at SMOKE (``prefill_32k`` on the ten archs at B=2,
  16 tokens, a cache of 80 slots), and three of them blockwise
  (``blockwise_threshold``, ``q_chunk`` and ``kv_chunk`` 8, 32 tokens):
  granite-3-8b with its heads sharded over ``model``,
  llama4-maverick-400b-a17b sequence parallel (5 heads over 2) and
  gemma2-9b with its ring, on that mesh against JAX's prefill step
  compiled likewise (one more subprocess compiles all 13): the same three
  checks against ``PREFILL_GAPS`` and ``PREFILL_EVEN``.  No chunk's slice
  makes DTensor gather q, k or v on its own (no ``aten.slice`` in
  ``implicit``): each rank attends over its own block of plain tensors
  (``ctx.attention_blocks``), and a sequence-sharded q is gathered once,
  before the chunks, as XLA gathers its reshaped chunks once.
* F4: a write through a slice along a sharded dim, a view of a copy that
  DTensor gathered, raises under the counter; a read through it records.
  ``ctx.write_slots_``, the prefill's write, gives rank 0's block of the
  plain write with no collective, a ring's wrapped rows included.

The decode gaps, in the order of ``GAPS``.  granite-3-8b decode_32k is the
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

The prefill gaps, in the order of ``PREFILL_GAPS``.  granite-3-8b is the
worked example (2 layers, a row of 16 tokens a data rank, 4 heads of 8
and 2 kv heads over ``model``, d 32):

* **Products.**  Seven of the ten cells and two of the three blockwise
  ones match product for product; the blockwise chunks are JAX's chunk
  for chunk (llama4: 64 score and P·V products of (320, 8), 4 query
  chunks against 4 kv chunks in 2 layers): each rank attends over its
  own batch rows and query heads (``ctx.attention_blocks``; the local
  layer of recurrentgemma-9b reads its one kv head).  Where they do not:
  - mamba2-780m (3 ``ssd`` layers): XLA keeps the 32 tokens whole on
    each device and contracts d over ``data`` (the partial sums
    all-reduced), where the port splits the tokens over ``data`` and
    gathers the weights' data shards: the projections and the
    unembedding run the same FLOPs split otherwise, (64, 32) for
    (128, 16) [dt], (256, 32) x2 for (512, 16) x2 [B, C], (512, 32) x2
    for (1024, 16) x2 [z, x], (1024, 32) for (2048, 16) [unembedding].
    The scan (``ssm._ssd_scan``) runs on each rank's block of batch and
    heads and forms C·Bᵀ once per group: C·Bᵀ (128, 16), the chunk
    outputs (512, 8) and (512, 16), the chunk states (1024, 8), where XLA
    scans the whole batch, C·Bᵀ per head: (1024, 16), (1024, 8),
    (1024, 16), (2048, 8).  A layer's scan: 45,056 FLOPs against
    114,688;
  - granite-moe-1b-a400m and llama4-maverick-400b-a17b: every rank routes
    all 32 tokens (``moe._moe_placed`` gathers them): the router (128,
    32) for JAX's (32, 32) over a quarter of them (llama4 (128, 40) for
    (32, 40); blockwise (256, 40) for (128, 40)); each token's ``top_k``
    rows combined by a ``bmm``, (1024, 2) or (1280, 1) (blockwise
    (2560, 1)), for XLA's one-hot dispatch and combine, (1024, 16) and
    (512, 64) (llama4 (640, 32) x2; blockwise (2560, 32) and (1280,
    64)); a rank's own experts on every token with the whole of d,
    (1024, 32) x2 for (1024, 16) x2 (llama4 (512, 40) x2 and (1280, 16)
    for (512, 20) x2 and (640, 16); blockwise (1024, 40) x2 and
    (2560, 16) for (1024, 20) x2 and (1280, 16)), a layer: twice the
    expert FLOPs a device.  llama4 at 16 tokens also splits two products
    otherwise, the same FLOPs: the attention's out-projection contracts
    half of the heads over ``model`` on a data rank's 16 rows, (640, 20),
    where XLA gathers the heads and computes half of d, (320, 40); the
    shared expert's down product contracts half of its width, (640, 8),
    where XLA's runs the whole width for half of d, (320, 16).
* **Collectives** (granite-3-8b: all-gather +6144 bytes, +5; all-to-all
  -2048, -1; collective-permute -64, -1):
  - the weights' ``data`` shards, the row-parallel sums and the vocab-
    parallel lookup's sum are JAX's, gather for gather and all-reduce
    for all-reduce (some gathered weights have another shape, the same
    bytes);
  - the token ids are gathered once, s32[2, 16], where XLA also permutes
    one data rank's, s32[1, 16, 1] (-64, -1; -128 at 32 tokens);
  - the looked-up rows are laid out by batch by a gather, f32[4, 16, 16]
    (+4096, +1), where XLA's all-to-all moves 2 x [1, 1, 16, 16] (-2048,
    -1): torch's CPU groups have no all-to-all, and DTensor gathers and
    chunks (twice the bytes at 32 tokens);
  - the cache: the port lays each new k and v out as the decode cell
    takes its cache (``cache_pspec``: the sequence over ``model``), so
    the heads that ``model`` split are gathered, in bf16, 4 x bf16[2, 16,
    1, 8] (+2048, +4); XLA leaves its prefill's cache in the heads'
    layout, (None, data, None, model), with no collective.  gemma2-9b's
    ring gathers its 8 kept slots, 4 x bf16[2, 8, 1, 8]; llama4's and
    recurrentgemma-9b's kv heads are not split, and nothing is gathered.
  The other cells' differences are these, per layer, and:
  llama-3.2-vision-90b's cross layer copies the k and v of its 8 frontend
  tokens into the cache in f32 (``copy_`` lays them out first), 2 x
  f32[2, 8, 1, 8]; whisper-base's encoder over its 12 frames moves its
  activations by gathers (f32[4, 6, 16] x4, [2, 6, 32] x2, [12, 32] x2,
  [24, 16] x2, [24, 32] x2) where XLA's three all-to-alls move 4096
  bytes, and it gathers 10 weights' shards, the port 6 (of other shapes);
  its cross layers copy their k and v in f32, 4 x f32[2, 12, 2, 8];
  starcoder2-7b (d 36) lays each layer's two row-parallel outputs back by
  gathers, 6 x f32[4, 8, 18], for XLA's all-to-alls (-6 x 2304 bytes),
  and DTensor leaves the residual split by rows over ``model``, so each
  layer's q, k, v and MLP-in products and the unembedding gather their
  input, 10 x f32[16, 36]; mamba2-780m gathers 19 weights' data shards
  where XLA all-reduces the projections' partial sums (11 all-reduces
  fewer, 47,488 bytes), gathers B and C for the scan (6 x f32[2, 16, 1,
  8]) and reduces the gated norm's statistic by a reduce-scatter and a
  gather (3 x f32[2, 8, 1] each); recurrentgemma-9b gathers the local
  layer's one kv head by ``split_last`` (2 x f32[2, 16, 4], where XLA
  gathers 2 x [1, 16, 1, 4] and [1, 16, 8]), reduces the lru gates' two
  sums in two all-reduces where XLA merges them (+4, 0 bytes), and XLA
  shifts the conv states by collective-permutes (2 x f32[1, 16, 1, 2]);
  the MoE layers gather their 32 tokens and sum their experts' rows once
  (llama4: a reduce-scatter each, 2 x f32[2, 8, 40]), where XLA gathers
  and all-reduces its routing and one-hot tensors.  llama4's blockwise
  layers gather q once each, 2 x f32[2, 16, 5, 8], as XLA gathers its
  chunks, 2 x f32[4, 1, 8, 5, 8].
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

# the prefill cells: prefill_32k on the ten archs at B=2 and 16 tokens,
# and three of them blockwise at 32 tokens (chunks of 8)
BLOCKWISE = {"blockwise_threshold": 8, "q_chunk": 8, "kv_chunk": 8}
PREFILL = [(a, 16, {}) for a in registry.ARCHS] + \
    [(a, 32, BLOCKWISE) for a in ("granite-3-8b",
                                   "llama4-maverick-400b-a17b", "gemma2-9b")]
TOKENS_AND_ROWS = {"all-to-all": (-2048, -1),
                   "collective-permute": (-64, -1)}
PREFILL_GAPS = {
    ("whisper-base", "prefill_32k"): {
        "flops": {},
        "coll": {"all-gather": (23552, 17), "all-to-all": (-6144, -4),
                 "collective-permute": (-64, -1)}},
    ("gemma2-9b", "prefill_32k"): {
        "flops": {}, "coll": {"all-gather": (7168, 9), **TOKENS_AND_ROWS}},
    ("qwen2-72b", "prefill_32k"): {
        "flops": {}, "coll": {"all-gather": (7168, 7), **TOKENS_AND_ROWS}},
    ("starcoder2-7b", "prefill_32k"): {
        "flops": {},
        "coll": {"all-gather": (44544, 23), "all-to-all": (-16128, -7),
                 "collective-permute": (-64, -1)}},
    ("granite-3-8b", "prefill_32k"): {
        "flops": {}, "coll": {"all-gather": (6144, 5), **TOKENS_AND_ROWS}},
    ("llama-3.2-vision-90b", "prefill_32k"): {
        "flops": {}, "coll": {"all-gather": (9216, 11), **TOKENS_AND_ROWS}},
    ("mamba2-780m", "prefill_32k"): {
        "flops": {(64, 32): 3, (256, 32): 6, (512, 8): 3,
                  (512, 16): -3, (512, 32): 6, (1024, 16): -12,
                  (1024, 32): 1, (2048, 8): -3, (2048, 16): -1},
        "coll": {"all-gather": (69312, 29), "all-reduce": (-47488, -11),
                 "reduce-scatter": (192, 3),
                 "collective-permute": (-64, -1)}},
    ("recurrentgemma-9b", "prefill_32k"): {
        "flops": {},
        "coll": {"all-gather": (4096, 0), "all-reduce": (0, 4),
                 "all-to-all": (-2048, -1),
                 "collective-permute": (-320, -3)}},
    ("granite-moe-1b-a400m", "prefill_32k"): {
        "flops": {(32, 32): -2, (128, 32): 2, (512, 64): -2, (1024, 2): 2,
                  (1024, 16): -6, (1024, 32): 4},
        "coll": {"all-gather": (20480, -1), "all-reduce": (-33424, -14),
                 "all-to-all": (-6144, -3),
                 "collective-permute": (-64, -1)}},
    ("llama4-maverick-400b-a17b", "prefill_32k"): {
        "flops": {(32, 40): -2, (128, 40): 2, (320, 16): -2, (320, 40): -2,
                  (512, 20): -4, (512, 40): 4, (640, 8): 2, (640, 16): -2,
                  (640, 20): 2, (640, 32): -4, (1280, 1): 2,
                  (1280, 16): 2},
        "coll": {"all-gather": (37824, 3), "all-reduce": (-3200, -2),
                 "reduce-scatter": (5120, 2), "all-to-all": (-8960, -7)}},
    ("granite-3-8b", "blockwise"): {
        "flops": {},
        "coll": {"all-gather": (12288, 5), "all-to-all": (-4096, -1),
                 "collective-permute": (-128, -1)}},
    ("llama4-maverick-400b-a17b", "blockwise"): {
        "flops": {(128, 40): -2, (256, 40): 2, (1024, 20): -4,
                  (1024, 40): 4, (1280, 16): -2, (1280, 64): -2,
                  (2560, 1): 2, (2560, 16): 2, (2560, 32): -2},
        "coll": {"all-gather": (37888, 7), "all-reduce": (-37120, -4),
                 "all-to-all": (-30720, -7),
                 "collective-permute": (-128, -1)}},
    ("gemma2-9b", "blockwise"): {
        "flops": {},
        "coll": {"all-gather": (13312, 9), "all-to-all": (-4096, -1),
                 "collective-permute": (-128, -1)}},
}
PREFILL_EVEN = {(a, "prefill_32k") for a in (
    "whisper-base", "gemma2-9b", "qwen2-72b", "starcoder2-7b",
    "granite-3-8b", "llama-3.2-vision-90b", "recurrentgemma-9b")} | \
    {("granite-3-8b", "blockwise"), ("gemma2-9b", "blockwise")}

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
smoke = {name: entry.full for name, entry in registry.ARCHS.items()}
out = {}
for arch, name, b, mode, seq, over in json.loads(sys.argv[1]):
    registry.ARCHS[arch] = dc.replace(registry.ARCHS[arch],
                                      full=dc.replace(smoke[arch], **over))
    fn, args, ins, outs, don, cfg, fp = cells.build_cell(
        arch, ShapeSpec(name, seq, b, mode), mesh)
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
    out[f"{arch}|{name}|{seq}"] = {"dot_flops": mod.dot_flops(),
                             "collectives": mod.collective_bytes(),
                             "products": dict(prods)}
print(json.dumps(out))
"""


def compiled_on_jax(cases: list) -> dict:
    """JAX's steps of ``cases``, ``(arch, shape name, batch, mode, seq,
    config overrides)`` at SMOKE, compiled on a (2, 2) mesh of 4 CPU
    devices in a process of their own: dot FLOPs, collectives and
    products, by ``arch|name|seq``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    got = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(cases)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_side():
    """JAX's 12 decode steps (``compiled_on_jax``)."""
    return compiled_on_jax([(a, s, b, "decode", SLOTS, {})
                            for a, s, b in DECODE])


@pytest.fixture(scope="module")
def jax_prefill():
    """JAX's ten prefill steps and the three blockwise ones
    (``compiled_on_jax``)."""
    return compiled_on_jax([(a, "prefill_32k", 2, "prefill", seq, over)
                            for a, seq, over in PREFILL])


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


def test_write_through_a_gathered_view_raises(fake_mesh):
    """F4: a slice along a sharded dim is a view of a copy that DTensor
    gathered; a write through it would leave the cache as it was, so the
    counter refuses it (``ctx.write_slots_`` writes each rank's block)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    cache = distribute_tensor(meta(2, 20, 2, 8), fake_mesh,
                              (Shard(0), Shard(1)))
    k = distribute_tensor(meta(2, 16, 2, 8), fake_mesh,
                          (Shard(0), Replicate()))
    with pytest.raises(RuntimeError, match="writes into a gathered copy"), \
            torch.no_grad(), implicit_replication():
        with oa.OpTrace():
            cache[:, :16] = k


def test_read_through_a_gathered_view_records(fake_mesh):
    from torch.distributed.tensor import Shard, distribute_tensor
    cache = distribute_tensor(meta(2, 20, 2, 8), fake_mesh,
                              (Shard(0), Shard(1)))
    with torch.no_grad(), oa.OpTrace() as t:
        cache[:, :16].sum()
    assert dict(t.implicit) == {"aten.slice": 1}
    assert t.collective_bytes()["counts"] == {"all-gather": 1}


@pytest.mark.parametrize("size,first,rows,ring", [
    (20, 0, 16, False), (20, 6, 8, False), (8, 8, 8, True),
    (8, 4, 8, True), (8, 2, 4, True)])
def test_write_slots_writes_this_ranks_block(size, first, rows, ring,
                                             fake_mesh):
    """``ctx.write_slots_`` on a (data, model)-sharded cache (real values,
    this process rank 0 of the fake group): rank 0's block of batch and
    slots equals that block of the plain write; a ring's rows that wrap
    land at the start (two runs of slots)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import ctx
    gen = torch.Generator().manual_seed(0)
    cache = torch.randn(2, size, 2, 8, generator=gen)
    new = torch.randn(2, rows, 2, 8, generator=gen)
    placed = DTensor.from_local(cache[:1, :size // 2].clone(), fake_mesh,
                                (Shard(0), Shard(1)), run_check=False,
                                shape=cache.shape, stride=cache.stride())
    src = DTensor.from_local(new[:1].clone(), fake_mesh,
                             (Shard(0), Replicate()), run_check=False,
                             shape=new.shape, stride=new.stride())
    with oa.OpTrace() as t:
        ctx.write_slots_(placed, 1, first, src, ring=ring)
    ctx.write_slots_(cache, 1, first, new, ring=ring)
    assert torch.equal(placed.to_local(), cache[:1, :size // 2])
    assert t.collective_bytes()["counts"] == {}


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
    held_to_jax(rec, jax_side[f"{arch}|{shape_name}|{SLOTS}"],
                GAPS[(arch, shape_name)], (arch, shape_name) in EVEN)


def held_to_jax(rec: dict, jax: dict, gap: dict, even: bool) -> None:
    """A partitioned record against JAX's compile of the same cell: the
    per-device FLOPs x 4 equal the whole cell's where the work spreads
    evenly (and differ elsewhere), and the products and the collectives
    by kind differ from JAX's by exactly ``gap``."""
    cost = rec["cost"]
    t = rec["trace"]
    assert cost["dot_flops"] == t.dot_flops()
    if even:
        assert cost["dot_flops"] * 4 == cost["dot_flops_global"]
    else:
        assert cost["dot_flops"] * 4 != cost["dot_flops_global"]

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


@pytest.mark.parametrize("arch,seq,over", PREFILL,
                         ids=[a + ("-blockwise" if o else "")
                              for a, _, o in PREFILL])
def test_smoke_prefill_cell_per_device_against_jax(arch, seq, over,
                                                   fake_mesh, jax_prefill,
                                                   monkeypatch):
    entry = registry.ARCHS[arch]
    monkeypatch.setitem(registry.ARCHS, arch, dc.replace(
        entry, full=dc.replace(entry.full, **over)))
    rec = dryrun.trace_cell(arch, ShapeSpec("prefill_32k", seq, 2,
                                            "prefill"), fake_mesh)
    assert rec["partitioned"] and rec["n_devices"] == 4
    cost, mem = rec["cost"], rec["memory"]
    assert {"dot_flops", "traffic_bytes", "traffic_bytes_pessimistic",
            "dot_flops_global"} <= set(cost)
    assert {"temp_bytes", "temp_bytes_global"} <= set(mem)
    assert 0 < cost["traffic_bytes"] <= cost["traffic_bytes_pessimistic"]
    assert rec["ops"]["kernel"] == 0 and rec["implicit"]
    if over:
        # no chunk's slice made DTensor gather q, k or v (a
        # sequence-sharded q is gathered once, before the chunks)
        assert "aten.slice" not in rec["implicit"]
    key = (arch, "blockwise" if over else "prefill_32k")
    held_to_jax(rec, jax_prefill[f"{arch}|prefill_32k|{seq}"],
                PREFILL_GAPS[key], key in PREFILL_EVEN)


def test_train_record_on_a_device_mesh_is_partitioned(fake_mesh):
    """A train cell on a ``DeviceMesh`` is traced per device as the
    prefill and decode cells are (``tests/test_torch_dryrun_train.py``
    holds the ten against JAX): ``partitioned: true``, the per-device keys
    beside the whole cell's, and the branch's gradients reduce-scattered."""
    rec = dryrun.trace_cell("granite-3-8b", ShapeSpec("t", 16, 2, "train"),
                            fake_mesh)
    assert rec["partitioned"] is True and rec["n_devices"] == 4
    assert {"temp_bytes", "temp_bytes_global"} <= set(rec["memory"])
    assert {"dot_flops", "traffic_bytes", "traffic_bytes_pessimistic",
            "dot_flops_global"} <= set(rec["cost"])
    assert rec["cost"]["dot_flops"] * 4 == rec["cost"]["dot_flops_global"]
    assert rec["collectives"]["counts"]["reduce-scatter"] > 0
    assert rec["implicit"] and rec["ops"]["kernel"] == 0


def test_abstract_record_says_it_is_not_partitioned(fake_mesh):
    rec = dryrun.trace_cell("granite-3-8b", ShapeSpec("d", SLOTS, 2,
                                                      "decode"),
                            sh.AbstractMesh((2, 2), ("data", "model")))
    assert rec["partitioned"] is False
    assert "dot_flops" not in rec["cost"] and "implicit" not in rec
