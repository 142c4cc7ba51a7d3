"""The dry run (``repro_torch.launch.dryrun``) and its cost counter
(``repro_torch.launch.op_analysis``) against ``repro.launch.dryrun`` and
``repro.launch.hlo_analysis``.

* The reference's five ``tests/test_hlo_analysis.py`` cases, counted by
  the port's ``OpTrace`` (a Python loop in place of ``lax.scan``, so the
  port counts what ran, with no trip weighting) and by JAX's ``HloModule``
  on the same function compiled on the CPU.
* The counter's rules: the fusion-aware traffic table, dtype bytes (fp8
  at one byte), the peak of live bytes, the kernel census, and every kernel
  wrapper raising on ``meta``.
* Every cell of ``registry.cells()`` at SMOKE (10 archs x train, prefill,
  decode, baseline; the fixtures of ``tests/test_torch_cells.py``): the
  port's ``dot_flops`` equal ``FlopCounterMode``'s over the same call, and
  JAX's ``HloModule.dot_flops()`` of the compiled step plus the products
  that differ, named in ``GAPS`` by (result elements, contraction) and
  count, exactly.
* ``argument_bytes`` and ``output_bytes`` per device of the 40 cells on
  both production layouts against the bytes reckoned from JAX's own
  shardings (``NamedSharding.shard_shape`` on its ``AbstractMesh``), the
  skip records against the reference's, ``main`` and its exit codes.
"""
import collections
import dataclasses as dc
import functools
import json
import math
import os
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.common import SHAPES as JSHAPES, ShapeSpec as JShapeSpec
from repro.distributed import ctx as jctx, sharding as jsh
from repro.launch import cells as jcells, hlo_analysis as ha
from repro.models import layers as JL, registry as jreg
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import cells, dryrun, mesh as tmesh, op_analysis as oa
from repro_torch.models import layers as TL, registry
from repro_torch.utils import tree_map

ARCHS = list(jreg.ARCHS)
CELLS = [(a, s.name) for a, s, _ in jreg.cells()]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# --------------------------------------------------------------------------
# the reference's five cases
# --------------------------------------------------------------------------

def test_dot_flops_loop_of_products():
    """Ten products in a loop: the port counts the ten that ran; JAX's
    analyzer weights the scan body by its trip count."""
    def f(w, x):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    def jf(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return lax.scan(body, x, None, length=10)[0]

    _, t = oa.trace(f, meta(256, 256), meta(8, 256))
    expect = 2 * 8 * 256 * 256 * 10
    assert t.dot_flops() == expect
    hlo = _hlo(jf, jax.ShapeDtypeStruct((256, 256), jnp.float32),
               jax.ShapeDtypeStruct((8, 256), jnp.float32))
    assert ha.HloModule(hlo).dot_flops() == expect
    # the reference's ``analyze`` summary, key for key
    got, want = oa.analyze(f, meta(256, 256), meta(8, 256)), ha.analyze(hlo)
    assert set(got) == set(want)
    assert got["dot_flops"] == want["dot_flops"] == expect
    assert got["census_top"]["aten.mm"] == 10
    assert got["collectives"] == {"total": 0, "counts": {}}


def test_nested_loops_compose():
    def f(w, x):
        for _ in range(3):
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x

    def jf(w, x):
        def outer(c, _):
            def inner(ci, _):
                return jnp.tanh(ci @ w), None
            return lax.scan(inner, c, None, length=5)[0], None
        return lax.scan(outer, x, None, length=3)[0]

    _, t = oa.trace(f, meta(64, 64), meta(4, 64))
    expect = 2 * 4 * 64 * 64 * 15
    assert t.dot_flops() == expect
    assert ha.HloModule(_hlo(jf, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                             jax.ShapeDtypeStruct((4, 64), jnp.float32))
                        ).dot_flops() == expect


def test_branch_taken_half_the_time_counts_half():
    """A branch taken on 5 of 10 iterations: the port counts the 5 that
    ran; JAX's analyzer weights each branch of the ``cond`` by 1/2."""
    def f(x):
        for i in range(10):
            x = torch.tanh(x @ x) if i < 5 else x
        return x

    def jf(x):
        def body(c, i):
            return lax.cond(i < 5, lambda a: jnp.tanh(a @ a), lambda a: a,
                            c), None
        return lax.scan(body, x, jnp.arange(10))[0]

    _, t = oa.trace(f, meta(64, 64))
    full = 2 * 64 * 64 * 64 * 10
    assert t.dot_flops() == full // 2
    assert ha.HloModule(_hlo(jf, jax.ShapeDtypeStruct((64, 64), jnp.float32))
                        ).dot_flops() == full // 2


SYNTHETIC_HLO = """
HloModule test, entry_computation_layout={()->f32[]}

ENTRY %main.1 (p0: f32[16,32]) -> f32[16,32] {
  %p0 = f32[16,32]{1,0} parameter(0)
  %ar = f32[16,32]{1,0} all-reduce(%p0), replica_groups={}, to_apply=%add
  %ag = f32[64,32]{1,0} all-gather(%p0), dimensions={0}
  ROOT %out = f32[16,32]{1,0} copy(%ar)
}
"""


@pytest.fixture
def group(request):
    """A default group of ``request.param`` = (backend, ranks), destroyed
    when the test ends: ``gloo`` over one rank, or torch's in-process
    ``fake`` backend, which moves nothing, for a gather over 4 ranks."""
    backend, ranks = request.param
    assert not dist.is_initialized()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=ranks,
                            timeout=timedelta(seconds=60))
    yield ranks
    dist.destroy_process_group()


@pytest.mark.parametrize("group", [("gloo", 1), ("fake", 4)], indirect=True,
                         ids=["gloo1", "fake4"])
def test_collectives_all_reduce_at_operand_all_gather_at_result(group):
    """``c10d`` and ``_c10d_functional`` ops: an all-reduce at its operand,
    an all-gather at its result (the whole gathered array); with 4 ranks
    the reference's synthetic module's numbers."""
    from torch.distributed import _functional_collectives as fc
    x = torch.ones(16, 32)
    out = torch.empty(16 * group, 32)
    with oa.OpTrace() as t:
        dist.all_reduce(x)
        dist.all_gather_into_tensor(out, x)
        y = fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD))
        z = fc.wait_tensor(fc.all_gather_tensor(x, 0, dist.group.WORLD))
    assert tuple(y.shape) == (16, 32) and tuple(z.shape) == (16 * group, 32)
    got = t.collective_bytes()
    assert got["all-reduce"] == 2 * 16 * 32 * 4
    assert got["all-gather"] == 2 * 16 * group * 32 * 4
    assert got["total"] == got["all-reduce"] + got["all-gather"]
    assert got["counts"] == {"all-reduce": 2, "all-gather": 2}
    want = ha.collective_bytes(SYNTHETIC_HLO)
    if group == 4:
        assert got["all-reduce"] // 2 == want["all-reduce"]
        assert got["all-gather"] // 2 == want["all-gather"]
        assert got["total"] // 2 == want["total"]


def test_elementwise_has_no_dots_and_fused_traffic_below_pessimistic():
    def f(x):
        return torch.tanh(x) * 2 + 1

    _, t = oa.trace(f, meta(128, 128))
    assert t.dot_flops() == 0
    assert t.traffic_bytes(fusion_aware=True) == 0
    assert t.traffic_bytes(fusion_aware=True) <= \
        t.traffic_bytes(fusion_aware=False) == 3 * 2 * 128 * 128 * 4
    mod = ha.HloModule(_hlo(lambda x: jnp.tanh(x) * 2 + 1,
                            jax.ShapeDtypeStruct((128, 128), jnp.float32)))
    assert mod.dot_flops() == 0
    assert mod.traffic_bytes(fusion_aware=True) <= \
        mod.traffic_bytes(fusion_aware=False)


# --------------------------------------------------------------------------
# the counter's rules
# --------------------------------------------------------------------------

def test_traffic_table():
    """One op of each rule: a product (operands + result), ``copy_`` (src
    read + self written), ``index_copy_`` (2x the update), ``index_select``
    (2x the result), a reduction (operands + result); views cost nothing,
    elementwise ops only pessimistically."""
    def f(a, b, cache, upd, idx):
        c = a @ b                                     # 4·(8·16+16·4+8·4)
        a.t().contiguous()                            # clone: 2·4·8·16
        cache.index_copy_(0, idx, upd)                # 2·4·2·4
        g = a.index_select(0, idx)                    # 2·4·2·16
        cache[:2].copy_(upd)                          # 2·4·2·4
        s = (c * 2).sum(dim=0)                        # 4·(8·4 + 4)
        return g.view(-1), s

    idx = torch.tensor([1, 3])
    args = (torch.ones(8, 16), torch.ones(16, 4), torch.zeros(6, 4),
            torch.ones(2, 4), idx)
    _, t = oa.trace(f, *args)
    want = (4 * (8 * 16 + 16 * 4 + 8 * 4) + 2 * 4 * 8 * 16 + 2 * 4 * 2 * 4 +
            2 * 4 * 2 * 16 + 2 * 4 * 2 * 4 + 4 * (8 * 4 + 4))
    assert t.traffic_bytes(fusion_aware=True) == want
    census = t.op_census()
    assert census["aten.mm"] == 1 and census["aten.view"] == 1
    assert census["kernel"] == 0
    # pessimistic: every op that is not a view, operands plus result
    assert t.traffic_bytes(fusion_aware=False) > want
    assert t.dot_flops() == 2 * 8 * 16 * 4


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2,
                                   torch.bfloat16, torch.float32])
def test_dtype_bytes(dtype):
    """A cast to ``dtype`` moves 4 bytes in and ``itemsize`` out per
    element: fp8 at one byte."""
    _, t = oa.trace(lambda x: x.to(dtype), meta(32, 32))
    want = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
            torch.bfloat16: 2, torch.float32: 4}[dtype]
    assert t.traffic_bytes() == (dtype != torch.float32) * 32 * 32 * (4 + want)


def test_peak_bytes_counts_what_lives_at_once():
    """Storages made inside the block: two of 4 KiB alive together, then
    one freed; tensors made before the block and views count nothing."""
    def f(x):
        y = x * 2
        z = y + 1
        del y
        w = z.view(32, 32) * 3
        return w.view(-1)

    out, t = oa.trace(f, torch.ones(1024))
    assert t.peak_bytes == 2 * 1024 * 4
    assert t.live_bytes == 1024 * 4         # the output, still referenced
    # y and z held together, neither an output
    assert t.temp_bytes(out) == 2 * 1024 * 4


def test_temp_bytes_leave_out_the_outputs():
    """``temp_bytes`` takes each output's storage off from its allocation
    on: an output made early, one that is a view of an intermediate, and
    an argument passed through count nothing; the intermediate that lived
    beside them does."""
    def f(x):
        a = x * 2                   # output, made first
        b = x + 1                   # intermediate
        c = (b * 3)[:512]           # output, a view of its own storage
        del b
        return {"a": a, "c": c, "x": x}

    out, t = oa.trace(f, torch.ones(1024))
    # a + b + (b * 3) at once; less a and c's storage, b alone
    assert t.peak_bytes == 3 * 1024 * 4
    assert t.temp_bytes(out) == 1024 * 4
    assert t.temp_bytes(None) == t.peak_bytes


def test_kernel_census_counts_device_kernels():
    """``kernel`` is the launches of the wrappers that are one device
    kernel each over the block: a ``bfp_matmul`` counts its two operand
    passes and its GEMM, not itself a fourth time."""
    w = oa.kernel_wrappers()

    def launch():
        w["flash_attention"].launches += 1
        w["bfp_matmul"].launches += 1
        w["quantize_operand"].launches += 2
        w["gemm_tn"].launches += 1

    before = {k: f.launches for k, f in w.items()}
    try:
        _, t = oa.trace(launch)
    finally:
        for k, f in w.items():
            f.launches = before[k]
    assert t.op_census() == {"kernel": 4}
    assert t.kernels == {"flash_attention": 1, "bfp_matmul": 1,
                         "bfp_quantize": 0, "bfp_matmul_packed": 0,
                         "quantize_operand": 2, "dequantize_operand": 0,
                         "gemm_tn": 1}
    # a decomposition re-enters the mode: the count spans the outer block
    try:
        with oa.OpTrace() as t:
            launch()
            with t:
                launch()
            torch.ones(2) * 2
            launch()
    finally:
        for k, f in w.items():
            f.launches = before[k]
    assert t.op_census()["kernel"] == 12


def _wrapper_calls():
    from repro_torch.kernels import bfp_common as bc, bfp_matmul as bm, \
        bfp_quant as bq, flash_attention as fa
    q = meta(1, 2, 128, 64)
    i8 = functools.partial(meta, dtype=torch.int8)
    bf = functools.partial(meta, dtype=torch.bfloat16)
    return {
        "flash_attention": lambda: fa.flash_attention(q, q, q, q_chunk=128,
                                                      kv_chunk=128),
        "bfp_matmul": lambda: bm.bfp_matmul(meta(64, 64), meta(64, 64)),
        "bfp_quantize": lambda: bq.bfp_quantize(meta(64, 64)),
        "bfp_matmul_packed": lambda: bq.bfp_matmul_packed(
            i8(64, 64), i8(2, 2), i8(64, 64), i8(2, 2)),
        "quantize_operand": lambda: bm.quantize_operand(meta(64, 64), 128),
        "dequantize_operand": lambda: bq.dequantize_operand(
            i8(64, 64), i8(2, 2), 128),
        "gemm_tn": lambda: bc.gemm_tn(bf(128, 64), bf(256, 64), 64, 64),
    }


@pytest.mark.parametrize("name", sorted(oa.kernel_wrappers()))
def test_kernel_wrapper_on_meta_raises(name):
    """A kernel wrapper given ``meta`` tensors raises and counts nothing:
    the dry run never counts a plain version in a kernel's place."""
    f = oa.kernel_wrappers()[name]
    before = f.launches
    with pytest.raises(ValueError, match="meta|device"):
        _wrapper_calls()[name]()
    assert f.launches == before


# --------------------------------------------------------------------------
# the cells at SMOKE: the port's dot FLOPs against JAX's HLO
# --------------------------------------------------------------------------

B = 2
SMOKE_SHAPES = {"train": 16, "prefill": 16, "decode": 20}


def branch_gap(n: int, d: int) -> dict:
    """The train step's duplex branch (``n`` blocks, backbone width ``d``;
    at SMOKE: B=2, 16 tokens pooled by 16 to one position, d_branch 256, 4
    heads of 64), ``{(result elements, contraction): port count - JAX
    count}``:

    * (512, 256) +3n: wq, wk, wv of F1 in the reversible backward.  The
      port runs F1(x1) under ``no_grad`` (eq 2) and again with grad for the
      VJP; XLA's CSE merges the two for these three products.
    * (512, 1024) +n: F2's ``wo`` in the VJP's forward, whose result only
      ``y1_`` reads: ``torch.autograd.grad`` computes it, XLA drops it.
    * (8, 64) -n: dP = dO·Vᵀ.  JAX contracts it as a dot; ``torch.einsum``
      runs P·V over one key as a broadcast multiply, so its gradient is a
      multiply and a sum.
    * (512, 1) +2n: dQ and dK of the one-key scores, ``bmm``s that contract
      a dim of 1; XLA rewrites a dot of contraction 1 into a multiply.
    * (512, d) +n, (512n, d) -1, (256d, 2) +n, (256dn, 2) -1: the tap
      projections and their weight gradients, one product per block in the
      port, one batched dot over the blocks in JAX (vmap): no FLOP moves.
    """
    return {(512, 256): 3 * n, (512, 1024): n, (8, 64): -n, (512, 1): 2 * n,
            (512, d): n, (512 * n, d): -1, (256 * d, 2): n,
            (256 * d * n, 2): -1}


def ssd_gap(layers: int, decode: bool = False) -> dict:
    """mamba2-780m's ``_ssd_chunked`` (3 ``ssd`` layers at SMOKE: 8 heads
    of 8 in one group, d_state 16, chunks of 8): the port forms C·Bᵀ once
    per router group, (256, 16), where JAX's einsum over the repeated B and
    C forms it per head, (2048, 16).  One decode token (chunk 1): C·Bᵀ
    (2, 16) against (16, 16), and the port's intra-chunk product and chunk
    state contract the chunk's one position, (128, 1) and (2048, 1), which
    XLA multiplies."""
    if decode:
        return {(2, 16): layers, (16, 16): -layers, (128, 1): layers,
                (2048, 1): layers}
    return {(256, 16): layers, (2048, 16): -layers}


def moe_gap(layers: int, rows: int, top_k: int, slots: int, buf: int,
            group: int) -> dict:
    """The MoE layers: the reference moves tokens with one-hot einsums, a
    combine of ``rows`` = tokens x d outputs over E·C ``slots`` and a
    dispatch of ``buf`` = E·C·d outputs over a ``group`` of tokens; the
    port copies rows by index and combines each token's ``top_k`` rows with
    one ``bmm`` (contraction ``top_k``; at top-1 XLA would multiply)."""
    return {(rows, top_k): layers, (rows, slots): -layers,
            (buf, group): -layers}


def add(*gaps) -> dict:
    out = collections.Counter()
    for g in gaps:
        out.update(g)
    return {k: v for k, v in out.items() if v}


# the backbone's differing products, prefill and the train step's forward
# (2 MoE layers at SMOKE, 3 ssd layers)
BACKBONE_GAPS = {
    "mamba2-780m": ssd_gap(3),
    "granite-moe-1b-a400m": moe_gap(2, 32 * 32, 2, 128, 4096, 32),
    "llama4-maverick-400b-a17b": moe_gap(2, 32 * 40, 1, 64, 2560, 32),
}
DECODE_GAPS = {
    "mamba2-780m": ssd_gap(3, decode=True),
    "granite-moe-1b-a400m": moe_gap(2, 2 * 32, 2, 16, 512, 2),
    "llama4-maverick-400b-a17b": moe_gap(2, 2 * 40, 1, 16, 640, 2),
}


def expected_gap(arch: str, mode: str) -> dict:
    if mode == "decode":
        return DECODE_GAPS.get(arch, {})
    if mode == "prefill":
        return BACKBONE_GAPS.get(arch, {})
    cfg = jreg.get(arch).smoke
    n = cells.duplex_tcfg(cfg).duplex.n_blocks
    return add(branch_gap(n, cfg.d_model), BACKBONE_GAPS.get(arch, {}))


@pytest.fixture
def smoke(monkeypatch):
    """Both registries' ``full`` is their ``smoke`` config and both
    ``POLICY``s compute in f32, as in ``tests/test_torch_cells.py``."""
    for reg in (jreg, registry):
        for name, entry in list(reg.ARCHS.items()):
            monkeypatch.setitem(reg.ARCHS, name,
                                dc.replace(entry, full=entry.smoke))
    monkeypatch.setattr(jcells, "POLICY",
                        JL.Policy(compute_dtype=jnp.float32))
    monkeypatch.setattr(cells, "POLICY",
                        TL.Policy(compute_dtype=torch.float32))


@functools.cache
def one_device_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def ssd_bytes_gap(layers: int, decode: bool = False) -> dict:
    """mamba2-780m's products of equal count and FLOPs whose operands
    differ, ``{(result elements, contraction): port bytes - JAX bytes}``:
    the chunk states (train and prefill; B of a chunk, 2·2·8·16 values) and
    a decode token's y = C·h (C, 2·16 values) read the router group's
    operand once, where JAX's einsum reads it broadcast to the 8 heads."""
    if decode:
        return {(128, 16): -layers * 7 * 2 * 16 * 4}
    return {(4096, 8): -layers * 7 * 2 * 2 * 8 * 16 * 4}


def expected_bytes_gap(arch: str, mode: str) -> dict:
    if arch != "mamba2-780m":
        return {}
    return ssd_bytes_gap(3, decode=mode == "decode")


def jax_products(hlo: str, weigh=None) -> collections.Counter:
    """``{(result elements, contraction): count}`` of the dots and
    convolutions of a compiled module, trip-weighted and with the
    contraction read as ``HloModule.dot_flops`` reads it; with ``weigh``,
    each counted at ``weigh(module, instruction)`` instead of 1."""
    mod = ha.HloModule(hlo)
    out = collections.Counter()
    for ins in mod.instrs:
        if ins.opcode not in ("dot", "convolution"):
            continue
        _, rdims = ha._shape_dims(ins.result)
        k = 1
        cm = ha._CONTRACT_RE.search(ins.attrs)
        if cm and ins.operands:
            _, ldims = ha._shape_dims(mod.shapes.get(ins.operands[0], ""))
            for ci in cm.group(1).split(","):
                if ci and int(ci) < len(ldims):
                    k *= ldims[int(ci)]
        m = mod.mult.get(ins.comp, 1)
        assert m == int(m), (ins.name, m)
        w = 1 if weigh is None else weigh(mod, ins)
        out[(math.prod(rdims), k)] += int(m) * w
    return out


def jax_dot_bytes(mod, ins) -> int:
    """A dot's bytes as ``HloModule.traffic_bytes`` counts them."""
    return ha._shape_bytes(ins.result) + sum(
        ha._shape_bytes(mod.shapes.get(op, "")) for op in ins.operands)


def port_products(t: oa.OpTrace, nbytes: bool = False) -> collections.Counter:
    """``{(result elements, contraction): count}`` of the products, or
    with ``nbytes`` their bytes as ``traffic_bytes`` counts them."""
    out = collections.Counter()
    for key, n in t.counts.items():
        flops, res = key[3], key[2]
        if not flops:
            continue
        elems = math.prod(res[0])
        w = 1
        if nbytes:
            one = oa.OpTrace()
            one.counts[key] = 1
            w = one.traffic_bytes()
        out[(elems, flops // (2 * elems))] += n * w
    return out


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_dot_flops_match_jax(arch, mode, smoke):
    """The baseline cell at SMOKE: the port's count equals
    ``FlopCounterMode``'s over the same call; it differs from JAX's
    compiled step by exactly the products of ``expected_gap``, each named
    by (result elements, contraction) and count, and by their FLOPs.

    Fusion-aware traffic: the products' bytes equal JAX's dots' key for
    key, but for the keys of ``expected_gap`` and the operands named by
    ``expected_bytes_gap``.  The other ops' bytes are the port's own
    reckoning (aten ops, where XLA's CPU module materialises the slices and
    transposes that the port takes as views): the whole count lies between
    a quarter of JAX's and JAX's on every cell."""
    s = SMOKE_SHAPES[mode]
    jm = one_device_mesh()
    jfn, jargs, jin, jout, jdon, jcfg, jfp = jcells.build_cell(
        arch, JShapeSpec(f"{mode}_smoke", s, B, mode), jm)
    with jm, jctx.activation_sharding(
            jm, jcells.activation_rules(jcfg, jm, fsdp_pure=jfp)):
        hlo = jax.jit(jfn, in_shardings=jin, out_shardings=jout,
                      donate_argnums=jdon).lower(*jargs).compile().as_text()
    tm = sh.AbstractMesh((1, 1), ("data", "model"))
    got = dryrun.trace_cell(arch, ShapeSpec(f"{mode}_smoke", s, B, mode), tm)
    t = got["trace"]
    fn, args, *_, cfg, fsdp_pure = cells.build_cell(
        arch, ShapeSpec(f"{mode}_smoke", s, B, mode), tm)
    with ctx.activation_sharding(tm, cells.activation_rules(cfg, tm)), \
            FlopCounterMode(display=False) as fc:
        fn(*args)
    assert t.dot_flops() == fc.get_total_flops() == \
        got["cost"]["dot_flops_global"]

    gap = expected_gap(arch, mode)
    diff = port_products(t)
    diff.subtract(jax_products(hlo))
    assert {k: v for k, v in diff.items() if v} == gap
    named = sum(2 * elems * k * n for (elems, k), n in gap.items())
    assert t.dot_flops() - ha.HloModule(hlo).dot_flops() == named

    bytes_diff = port_products(t, nbytes=True)
    bytes_diff.subtract(jax_products(hlo, weigh=jax_dot_bytes))
    assert {k: v for k, v in bytes_diff.items()
            if v and k not in gap} == expected_bytes_gap(arch, mode)
    traffic = got["cost"]["traffic_bytes_global"]
    assert traffic == t.traffic_bytes()
    jax_traffic = ha.HloModule(hlo).traffic_bytes()
    assert jax_traffic / 4 <= traffic <= jax_traffic
    assert got["ops"]["kernel"] == 0 and got["collectives"]["total"] == 0


def test_smoke_gaps_of_the_motivation():
    """The two gaps named where this comparison began: granite-3-8b's
    train step +3,672,064 and mamba2-780m's prefill -172,032."""
    def flops(gap):
        return sum(2 * e * k * n for (e, k), n in gap.items())
    assert flops(expected_gap("granite-3-8b", "train")) == 3_672_064
    assert flops(expected_gap("mamba2-780m", "prefill")) == -172_032
    assert flops(expected_gap("granite-moe-1b-a400m", "train")) == 2_631_680


# --------------------------------------------------------------------------
# bytes per device on the production layouts
# --------------------------------------------------------------------------

def _jax_abstract_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:                      # jax <= 0.4.x: (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


@functools.cache
def jax_cell(arch, shape, mesh_key):
    mesh = _jax_abstract_mesh(*MESHES[mesh_key])
    return mesh, jcells.build_cell(arch, JSHAPES[shape], mesh)


@functools.cache
def jax_outputs(arch, shape):
    """The step's output tree (``ShapeDtypeStruct``s); no layout changes
    it."""
    _, cell = jax_cell(arch, shape, "pod")
    return jax.eval_shape(cell[0], *cell[1])


def jax_nbytes(tree, shardings) -> int:
    """Bytes one device holds: each leaf's ``shard_shape`` under its
    ``NamedSharding``."""
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(leaves, shs))


def jax_output_bytes(arch, shape, mesh_key) -> int:
    """The outputs by the cell's rules, JAX's: the train step's state in
    its state's shardings and the metrics replicated; caches by
    ``cache_pspec``; logits and tokens by ``batch_pspec``."""
    mesh, (_, _, jin, *_) = jax_cell(arch, shape, mesh_key)
    out = jax_outputs(arch, shape)
    ns = lambda spec: jax.sharding.NamedSharding(mesh, spec)
    mode = JSHAPES[shape].mode
    if mode == "train":
        state, metrics = out
        return jax_nbytes(state, jin[0]) + sum(
            x.dtype.itemsize for x in jax.tree_util.tree_leaves(metrics))
    if mode == "prefill":
        logits, cache = out["next_token_logits"], out["cache"]
    else:
        logits, cache = out
    cspecs = jsh.to_named(jsh.tree_pspecs(cache, mesh, jsh.cache_pspec), mesh)
    return jax_nbytes(logits, ns(jsh.batch_pspec(logits.shape, mesh))) + \
        jax_nbytes(cache, cspecs)


def to_meta(tree):
    """A JAX output tree as ``meta`` tensors of the same shapes and
    dtypes (tuples and dicts kept)."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_meta(v) for v in tree)
    return torch.empty(tree.shape, dtype=getattr(torch, tree.dtype.name),
                       device="meta")


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_bytes_per_device_match_jax(mesh_key, cell):
    """All 40 cells at baseline on 16x16 and 2x16x16: the port's argument
    bytes per device (``dryrun.device_bytes`` of ``build_cell``'s
    arguments and specs) and output bytes per device
    (``dryrun.output_bytes`` on the step's output tree) equal JAX's
    ``shard_shape`` reckoning on its own ``build_cell``'s shardings."""
    arch, shape = cell
    mesh = tmesh.production_layout(multi_pod=mesh_key == "multipod")
    assert mesh == sh.AbstractMesh(*MESHES[mesh_key])
    _, args, in_sh, *_ = cells.build_cell(arch, SHAPES[shape], mesh)
    specs = [tree_map(lambda s: s.spec, x) for x in in_sh]
    _, (_, jargs, jin, *_) = jax_cell(arch, shape, mesh_key)
    assert sum(dryrun.device_bytes(a, s, mesh)
               for a, s in zip(args, specs)) == \
        sum(jax_nbytes(a, s) for a, s in zip(jargs, jin))
    out = to_meta(jax_outputs(arch, shape))
    assert dryrun.output_bytes(SHAPES[shape].mode, out, specs, mesh) == \
        jax_output_bytes(arch, shape, mesh_key)


def test_constrain_passes_a_meta_tensor_on_an_abstract_mesh():
    """On an ``AbstractMesh`` of many ranks a ``meta`` tensor is the whole
    abstract value and comes back as it is; a CPU tensor there is still
    one rank's local data and raises."""
    mesh = tmesh.production_layout()
    x = meta(4, 16, 32)
    with ctx.activation_sharding(mesh, {"resid": ("data", None, None)}):
        assert ctx.constrain(x, "resid") is x
        with pytest.raises(ValueError, match="local data"):
            ctx.constrain(torch.zeros(4, 16, 32), "resid")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_decode_records_bytes_of_its_own_outputs(arch, tmp_path):
    """``run_cell`` on decode_32k at production size on the pod layout (a
    quick cell): the record's argument and output bytes, reckoned from the
    port's own outputs, equal JAX's; every product counted, no kernel, no
    collective."""
    rec = dryrun.run_cell(arch, "decode_32k", False, tmp_path)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    _, (_, jargs, jin, *_) = jax_cell(arch, "decode_32k", "pod")
    assert rec["memory"]["argument_bytes"] == \
        sum(jax_nbytes(a, s) for a, s in zip(jargs, jin))
    assert rec["memory"]["output_bytes"] == \
        jax_output_bytes(arch, "decode_32k", "pod")
    assert rec["cost"]["dot_flops_global"] > 0
    assert rec["ops"]["kernel"] == 0
    assert rec["collectives"] == {"total": 0, "counts": {}}
    assert 0 < rec["memory"]["temp_bytes_global"]
    assert rec["cost"]["traffic_bytes_global"] <= \
        rec["cost"]["traffic_bytes_pessimistic_global"]


# --------------------------------------------------------------------------
# the records and the CLI
# --------------------------------------------------------------------------

@functools.cache
def jax_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` put back as it
    was (the module sets it at import for a process of its own)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdr
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdr


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_skip_records_match_jax(arch, multi_pod, tmp_path):
    """long_500k: the reference's skip record, word for word, for the
    eight archs without long context; the other two are traced, and the
    reference skips neither."""
    got = dryrun.run_cell(arch, "long_500k", multi_pod, tmp_path)
    if registry.get(arch).full.supports_long_context:
        assert jreg.get(arch).full.supports_long_context
        assert got["status"] == "ok" and got["mode"] == "decode"
        return
    want = jax_dryrun().run_cell(arch, "long_500k", multi_pod, tmp_path)
    assert got == want
    assert got["status"] == "skipped" and \
        got["reason"] == registry.LONG_CONTEXT_SKIP


def test_main_writes_the_record_and_exits_0(smoke, monkeypatch, tmp_path,
                                            capsys):
    """``main`` on granite-3-8b SMOKE with a small train shape: the
    reference's file name and summary line, exit 0, the record's keys
    (the whole cell's and one device's: ``main`` traces the cell on a
    ``fake`` group of the pod's 256 ranks), the whole cell's FLOPs equal
    to the same cell traced directly, and one device's op trace in
    order."""
    shape = ShapeSpec("train_smoke", 16, B, "train")
    monkeypatch.setitem(SHAPES, "train_smoke", shape)
    rc = dryrun.main(["--arch", "granite-3-8b", "--shape", "train_smoke",
                      "--mesh", "pod", "--out", str(tmp_path),
                      "--save-trace"])
    assert rc == 0
    rec = json.loads(
        (tmp_path / "granite-3-8b__train_smoke__pod.json").read_text())
    assert {k: rec[k] for k in ("arch", "shape", "mesh", "mode", "variant",
                                "status", "n_devices")} == {
        "arch": "granite-3-8b", "shape": "train_smoke", "mesh": "pod",
        "mode": "train", "variant": "baseline", "status": "ok",
        "n_devices": 256}
    assert rec["partitioned"] is True
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes_global", "temp_bytes"}
    assert set(rec["cost"]) == {
        "dot_flops_global", "traffic_bytes_global",
        "traffic_bytes_pessimistic_global", "dot_flops", "traffic_bytes",
        "traffic_bytes_pessimistic"}
    assert rec["collectives"]["counts"]["reduce-scatter"] > 0
    assert rec["trace_s"] >= 0 and rec["ops"]["kernel"] == 0
    direct = dryrun.trace_cell("granite-3-8b", shape,
                               tmesh.production_layout())
    assert rec["cost"]["dot_flops_global"] == \
        direct["cost"]["dot_flops_global"]
    assert 0 < rec["cost"]["dot_flops"] < rec["cost"]["dot_flops_global"]
    lines = (tmp_path / "granite-3-8b__train_smoke__pod.trace.txt"
             ).read_text().splitlines()
    assert len(lines) == sum(n for k, n in rec["ops"].items()
                             if k not in ("products", "kernel"))
    assert sum("flops=" in ln for ln in lines) == rec["ops"]["products"]
    out = capsys.readouterr().out
    assert "[dryrun] granite-3-8b__train_smoke__pod: ok" in out
    assert "per device" in out


REFUSED = {"mamba2-780m": "ssd_block", "recurrentgemma-9b": "_gates"}


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "granite-3-8b"])
def test_main_records_the_refused_tuned2_cells_as_error(arch, tmp_path,
                                                        capsys):
    """train_4k at tuned2: the fp8 backbone meets an f32 operand in
    mamba2-780m's ``ssd_block`` and recurrentgemma-9b's ``_gates``, where
    JAX's refuses to trace; the record says ``error`` with the exception
    and its traceback, and the exit code is 1.  granite-3-8b's runs in
    both."""
    mesh = _jax_abstract_mesh(*MESHES["pod"])
    jfn, jargs, *_ = jcells.build_cell(arch, JSHAPES["train_4k"], mesh,
                                       "tuned2")
    rc = dryrun.main(["--arch", arch, "--shape", "train_4k",
                      "--out", str(tmp_path), "--variant", "tuned2"])
    rec = json.loads(
        (tmp_path / f"{arch}__train_4k__pod__tuned2.json").read_text())
    line = capsys.readouterr().out
    if arch not in REFUSED:
        jax.eval_shape(jfn, *jargs)
        assert rc == 0 and rec["status"] == "ok"
        return
    with pytest.raises(ValueError) as jerr:
        jax.eval_shape(jfn, *jargs)
    assert type(jerr.value).__name__ == "TypePromotionError"
    assert rc == 1 and rec["status"] == "error"
    assert rec["error"].startswith(
        "RuntimeError: Promotion for Float8 Types is not supported")
    frames = [ln for ln in rec["traceback"].splitlines()
              if "repro_torch/models" in ln]
    assert frames[-1].endswith(f"in {REFUSED[arch]}")
    assert f"[dryrun] {arch}__train_4k__pod__tuned2: error" in line


def test_fp8_promotion_refused_on_meta_as_on_the_cpu():
    """A pointwise op of an fp8 and an f32 tensor raises under ``OpTrace``
    on ``meta`` as it does on the CPU; a cast of fp8, and fp8 with fp8
    (for which the CPU has no kernel, which is no promotion), do not."""
    a = meta(4, dtype=torch.float8_e4m3fn)
    b = meta(2, 4)
    with pytest.raises(RuntimeError, match="Promotion for Float8"):
        (torch.zeros(4, dtype=torch.float8_e4m3fn) * torch.zeros(2, 4))
    with pytest.raises(RuntimeError, match="Promotion for Float8"):
        oa.trace(lambda: a * b)
    out, _ = oa.trace(lambda: (a.float() * b, a * a))
    assert out[0].dtype == torch.float32
    assert out[1].dtype == torch.float8_e4m3fn
