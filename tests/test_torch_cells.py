"""The cells (``repro_torch.launch.cells``: ``POLICY``, ``tuned_cfg``,
``input_specs``, ``build_cell``; ``repro_torch.models.registry.cells``)
against ``repro.launch.cells`` and ``repro.models.registry``, and the fp8
backbone of the ``tuned2`` train cells.

* The registry's 40 cells and ``tuned_cfg`` at levels 1 and 2, field for
  field.
* Every ``build_cell`` (40 cells x 3 variants) and every ``input_specs``
  on the 16x16 and 2x16x16 production layouts, which both sides reckon
  from sizes and names (JAX's ``AbstractMesh``, the port's own): argument
  paths, shapes and dtypes (JAX's ``ShapeDtypeStruct``s, the port's
  ``meta`` tensors), specs as tuples (JAX's ``NamedSharding.spec``),
  ``donate``, ``fsdp_pure`` and ``cfg``.
* The steps at SMOKE: each registry's ``full`` is its ``smoke`` config
  (``monkeypatch``) and each mode gets a small ``ShapeSpec``.  Both
  ``POLICY``s are patched to f32 compute, so that the tolerances of
  ``test_torch_train_step`` (rtol 1e-5, atol 1e-6) and ``test_torch_serve``
  (2e-5 for f32 values, 2e-2 for bf16 cache leaves) hold.  JAX's ``fn``
  runs jitted on a one-device mesh with the cell's shardings and
  donation, the port's on the CPU under a one-rank gloo mesh, each under
  its ``activation_rules``, from JAX's init bridged, on one numpy batch.
* ``tuned2`` train raises in both frameworks for exactly mamba2-780m and
  recurrentgemma-9b, where the fp8 backbone meets an f32 operand, and runs
  for the other eight archs.
* The bridge carries ``float8_e4m3fn`` both ways bit for bit.
"""
import dataclasses as dc
import functools
from datetime import timedelta

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.common import SHAPES as JSHAPES, ShapeSpec as JShapeSpec
from repro.distributed import ctx as jctx
from repro.launch import cells as jcells
from repro.models import layers as JL, registry as jreg
from repro.train import train_step as jts
from repro.utils import path_str
from repro_torch import bridge
from repro_torch.configs.common import SHAPES, ShapeSpec
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import cells, mesh as tmesh
from repro_torch.models import layers as TL, registry
from repro_torch.train import train_step as ts
from repro_torch.utils import tree_checksum, tree_flatten

ARCHS = list(jreg.ARCHS)                       # the reference's order
VARIANTS = ("baseline", "tuned", "tuned2")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s.name) for a, s, _ in jreg.cells()]
# the two archs whose fp8 backbone meets an f32 operand: JAX's type
# promotion refuses, and so does torch's, in the function named
REFUSED = {"mamba2-780m": "ssd_block", "recurrentgemma-9b": "_gates"}

TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)      # test_torch_train_step
TOL = dict(rtol=2e-5, atol=2e-5)            # test_torch_serve
BF16_TOL = dict(rtol=2e-2, atol=2e-2)       # test_torch_serve, bf16 leaves

B = 2
SMOKE_SHAPES = {"train": 16, "prefill": 16, "decode": 20}


def _jax_abstract_mesh(sizes, names):
    # jax <= 0.4.x takes ((name, size), ...) pairs; newer jax takes
    # (sizes, names) positionally
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


@functools.cache
def jax_mesh(key):
    return _jax_abstract_mesh(*MESHES[key])


@functools.cache
def port_mesh(key):
    return sh.AbstractMesh(*MESHES[key])


def jax_sig(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(path_str(p), tuple(x.shape), str(x.dtype)) for p, x in flat]


def port_sig(tree) -> list:
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in tree_flatten(tree)]


def jax_specs(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return [(path_str(p), tuple(s.spec)) for p, s in flat]


def port_specs(tree, mesh) -> list:
    out = []
    for p, s in tree_flatten(tree):
        assert s.mesh is mesh and s.placements == sh.placements(s.spec, mesh)
        out.append((p, s.spec))
    return out


def assert_same_cell(jcell, tcell, mesh):
    jfn, jargs, jin, jout, jdon, jcfg, jfp = jcell
    tfn, targs, tin, tout, tdon, tcfg, tfp = tcell
    assert len(targs) == len(jargs) == len(tin) == len(jin)
    for ja, ta in zip(jargs, targs):
        assert port_sig(ta) == jax_sig(ja)
    for js, tsp in zip(jin, tin):
        want, got = jax_specs(js), port_specs(tsp, mesh)
        assert [p for p, _ in got] == [p for p, _ in want]
        diff = {p: (g, w) for (p, g), (_, w) in zip(got, want) if g != w}
        assert not diff, diff
    assert tout is None and jout is None
    assert (tdon, tfp) == (jdon, jfp)
    assert dc.asdict(tcfg) == dc.asdict(jcfg)


# --------------------------------------------------------------------------
# the registry, POLICY and tuned_cfg
# --------------------------------------------------------------------------

def test_registry_cells_match_jax():
    """The reference's 40 triples in its order, with its skip reason (the
    counterpart of ``tests/test_arch_smoke.py::test_registry_cells_cover_40``),
    and ``include_skips=False`` the 32 runnable ones."""
    want = [(a, dc.astuple(s), k) for a, s, k in jreg.cells()]
    got = [(a, dc.astuple(s), k) for a, s, k in registry.cells()]
    assert got == want
    assert list(registry.ARCHS) == list(jreg.ARCHS)
    assert len(got) == 40
    assert len([c for c in got if c[2] is not None]) == 8
    runnable = {(a, s.name) for a, s, k in registry.cells(include_skips=False)}
    assert len(runnable) == 32
    assert ("mamba2-780m", "long_500k") in runnable
    assert ("recurrentgemma-9b", "long_500k") in runnable
    assert [dc.astuple(s) for s in SHAPES.values()] == \
        [dc.astuple(s) for s in JSHAPES.values()]


def test_policy_matches_jax():
    for field in ("param_dtype", "compute_dtype"):
        assert str(getattr(cells.POLICY, field)).removeprefix("torch.") == \
            jnp.dtype(getattr(jcells.POLICY, field)).name


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_tuned_cfg_matches_jax(arch, level):
    want = jcells.tuned_cfg(jreg.get(arch).full, level)
    got = cells.tuned_cfg(registry.get(arch).full, level)
    assert dc.asdict(got) == dc.asdict(want)
    assert got.causal_skip and (got.lru_scan_chunk == 4096) == \
        bool(got.lru_width)
    assert (got.q_chunk, got.kv_chunk) == ((1024, 2048) if level == 2 else
                                           (512, 1024))


# --------------------------------------------------------------------------
# specs on the production layouts
# --------------------------------------------------------------------------

@pytest.fixture(params=sorted(MESHES))
def mesh_key(request):
    return request.param


@pytest.mark.parametrize("fsdp_pure", [False, True])
def test_input_specs_match_jax(mesh_key, fsdp_pure):
    """All 40 cells: the batch's paths, shapes and dtypes, and its specs
    (over every mesh axis with ``fsdp_pure`` where the batch divides)."""
    jm, tm = jax_mesh(mesh_key), port_mesh(mesh_key)
    for arch, shape in CELLS:
        jb, js = jcells.input_specs(arch, JSHAPES[shape], jm, fsdp_pure)
        tb, tsp = cells.input_specs(arch, SHAPES[shape], tm, fsdp_pure)
        assert all(x.is_meta for _, x in tree_flatten(tb))
        assert port_sig(tb) == jax_sig(jb), (arch, shape)
        assert port_specs(tsp, tm) == jax_specs(js), (arch, shape)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_cell_matches_jax(mesh_key, cell, variant):
    arch, shape = cell
    jcell = jcells.build_cell(arch, JSHAPES[shape], jax_mesh(mesh_key),
                              variant)
    tcell = cells.build_cell(arch, SHAPES[shape], port_mesh(mesh_key),
                             variant)
    assert all(x.is_meta for a in tcell[1] for _, x in tree_flatten(a))
    assert_same_cell(jcell, tcell, port_mesh(mesh_key))


@pytest.mark.parametrize("arch", ARCHS)
def test_tuned2_backbone_is_fp8_at_half_the_bytes(arch):
    """The train cell's backbone: bf16 at baseline and tuned, every leaf
    fp8 at tuned2, exactly half the bytes; the branch stays f32."""
    mesh = port_mesh("16x16")

    def backbone(variant):
        state = cells.build_cell(arch, SHAPES["train_4k"], mesh,
                                 variant)[1][0]
        return state, [x for _, x in tree_flatten(state["backbone"])]

    (_, bf16), (_, tuned), (state, fp8) = map(backbone, VARIANTS)
    assert {x.dtype for x in bf16 + tuned} == {torch.bfloat16}
    assert {x.dtype for x in fp8} == {torch.float8_e4m3fn}
    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs)
    assert 2 * nbytes(fp8) == nbytes(bf16) == nbytes(tuned)
    assert {x.dtype for _, x in tree_flatten(state["branch"])} == \
        {torch.float32}


def test_build_cell_on_a_device_mesh(one_rank_group):
    """A ``DeviceMesh`` takes the place of an ``AbstractMesh``: the same
    specs, as shardings on that mesh."""
    mesh = tmesh.make_host_mesh(device_type="cpu")
    for shape in ("train_4k", "decode_32k"):
        got = cells.build_cell("granite-3-8b", SHAPES[shape], mesh, "tuned")
        want = cells.build_cell("granite-3-8b", SHAPES[shape],
                                sh.AbstractMesh((1, 1), ("data", "model")),
                                "tuned")
        for g, w in zip(got[2], want[2]):
            assert [s.spec for _, s in tree_flatten(g)] == \
                [s.spec for _, s in tree_flatten(w)]
            assert all(s.mesh is mesh for _, s in tree_flatten(g))


# --------------------------------------------------------------------------
# the steps at SMOKE
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    """A one-rank gloo default group, destroyed when the test ends so that
    no other test in this worker sees it."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    yield
    dist.destroy_process_group()


@pytest.fixture
def smoke_registry(monkeypatch):
    for reg in (jreg, registry):
        for name, entry in list(reg.ARCHS.items()):
            monkeypatch.setitem(reg.ARCHS, name,
                                dc.replace(entry, full=entry.smoke))


@pytest.fixture
def smoke(smoke_registry, monkeypatch, one_rank_group):
    monkeypatch.setattr(jcells, "POLICY",
                        JL.Policy(compute_dtype=jnp.float32))
    monkeypatch.setattr(cells, "POLICY",
                        TL.Policy(compute_dtype=torch.float32))
    return tmesh.make_host_mesh(device_type="cpu")


def shapes(mode):
    s = SMOKE_SHAPES[mode]
    return (JShapeSpec(f"{mode}_smoke", s, B, mode),
            ShapeSpec(f"{mode}_smoke", s, B, mode))


@functools.cache
def one_device_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def numpy_batch(entry, cfg, mode, s):
    """Tokens (and labels) drawn with seed 1, int32, and the stub frontend
    in bf16, of ``input_specs``' shapes."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, 1 if mode == "decode" else s)
                          ).astype(np.int32)
    batch = {"tokens": tokens}
    if mode == "train":
        batch["labels"] = np.roll(tokens, -1, axis=1)
    fe = entry.frontend_shape(cfg, B)
    if fe is not None and mode != "decode":
        batch["frontend"] = {
            k: (0.1 * rng.standard_normal(v)).astype(ml_dtypes.bfloat16)
            for k, v in fe.items()}
    return batch


@functools.cache
def jax_init(arch, backbone_dtype=None):
    """JAX's init (key 0) at SMOKE, as numpy, once per arch: the duplex
    state with its backbone in ``backbone_dtype``, or (``None``) the
    params.  No variant changes a shape or a value of it."""
    entry = jreg.get(arch)
    cfg = entry.smoke
    if backbone_dtype is None:
        init = lambda k: entry.module.init_params(k, cfg)
    else:
        init = lambda k: jts.init_state(k, entry, cfg, jcells.duplex_tcfg(
            cfg, jnp.dtype(backbone_dtype)), jcells.POLICY)
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)(
        jax.random.PRNGKey(0)))


def jax_args(arch, mode, cfg, args):
    """Concrete JAX arguments of a SMOKE cell: JAX's init, in the dtypes of
    the cell's ``ShapeDtypeStruct``s, and the numpy batch."""
    entry = jreg.get(arch)
    batch = numpy_batch(entry, cfg, mode, SMOKE_SHAPES[mode])
    if mode == "train":
        bdt = jax.tree_util.tree_leaves(args[0]["backbone"])[0].dtype
        out = (jax_init(arch, bdt.name), batch)
    elif mode == "prefill":
        out = (jax_init(arch), batch)
    else:
        cache = entry.module.init_cache(cfg, batch=B,
                                        max_len=SMOKE_SHAPES[mode],
                                        dtype=jnp.bfloat16)
        out = (jax_init(arch), jax.tree_util.tree_map(np.asarray, cache),
               batch)
    assert [jax_sig(a) for a in out] == [jax_sig(a) for a in args]
    return out


def run_both(arch, mode, variant, host_mesh):
    """(JAX's outputs as numpy, the port's, the port's arguments)."""
    jshape, tshape = shapes(mode)
    jm = one_device_mesh()
    jfn, jargs, jin, jout, jdon, jcfg, jfp = jcells.build_cell(
        arch, jshape, jm, variant)
    tcell = cells.build_cell(arch, tshape, host_mesh, variant)
    tfn, targs, tin, tout, tdon, tcfg, tfp = tcell
    assert (tdon, tfp) == (jdon, jfp)
    assert dc.asdict(tcfg) == dc.asdict(jcfg)
    real = jax_args(arch, mode, jcfg, jargs)
    if mode == "decode":        # the port's own zero cache
        ported = (bridge.to_torch(real[0], "cpu"),
                  registry.get(arch).module.init_cache(
                      tcfg, batch=B, max_len=SMOKE_SHAPES[mode],
                      dtype=torch.bfloat16, device="cpu"),
                  bridge.to_torch(real[2], "cpu"))
    else:
        ported = tuple(bridge.to_torch(a, "cpu") for a in real)
    assert [port_sig(a) for a in ported] == [port_sig(a) for a in targs]
    with jm, jctx.activation_sharding(
            jm, jcells.activation_rules(jcfg, jm, fsdp_pure=jfp)):
        want = jax.jit(jfn, in_shardings=jin, out_shardings=jout,
                       donate_argnums=jdon)(
            *jax.tree_util.tree_map(jnp.asarray, real))
    with ctx.activation_sharding(
            host_mesh, cells.activation_rules(tcfg, host_mesh,
                                              fsdp_pure=tfp)):
        got = tfn(*ported)
    return jax.tree_util.tree_map(np.asarray, want), got, ported


def assert_cache_close(got, want, pinned=()):
    """Leaf for leaf: bf16 leaves at ``BF16_TOL``, the others at ``TOL``.
    A leaf named in ``pinned`` may be bf16 where JAX's is f32."""
    g, w = tree_flatten(bridge.to_numpy(got)), tree_flatten(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    dtypes = dict(tree_flatten(got))
    for (path, a), (_, b) in zip(g, w):
        dt = dtypes[path].dtype
        if str(dt).removeprefix("torch.") != b.dtype.name:
            assert path.rsplit("/", 1)[-1] in pinned, path
            assert (dt, b.dtype.name) == (torch.bfloat16, "float32"), path
        tol = BF16_TOL if dt == torch.bfloat16 else TOL
        np.testing.assert_allclose(a, b.astype(a.dtype), **tol, err_msg=path)


TRAIN_CASES = [("granite-3-8b", v) for v in VARIANTS] + \
    [("gemma2-9b", v) for v in VARIANTS] + [("whisper-base", "tuned2")]


@pytest.mark.parametrize("arch,variant", TRAIN_CASES)
def test_train_cell_step_matches_jax(arch, variant, smoke):
    """One duplex step of the train cell: metrics and the new branch,
    optimizer state and step at test_torch_train_step's tolerances; the
    backbone bridged bit for bit (fp8 at tuned2) and left as it was.
    gemma2's ``local`` layers run with ``causal_skip`` when tuned."""
    want, (new, metrics), (state, _) = run_both(arch, "train", variant,
                                                smoke)
    want_state, want_m = want
    assert set(metrics) == set(want_m)
    for key, w in want_m.items():
        np.testing.assert_allclose(float(metrics[key]), w, **TRAIN_TOL,
                                   err_msg=key)
    got = tree_flatten(bridge.to_numpy({k: new[k] for k in
                                        ("branch", "opt", "step")}))
    exp = tree_flatten({k: want_state[k] for k in ("branch", "opt", "step")})
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, g), (_, w) in zip(got, exp):
        np.testing.assert_allclose(g, w, **TRAIN_TOL, err_msg=path)
    dt = torch.float8_e4m3fn if variant == "tuned2" else torch.bfloat16
    assert {x.dtype for _, x in tree_flatten(state["backbone"])} == {dt}
    assert new["backbone"] is state["backbone"]


SERVE_ARCHS = ["mamba2-780m", "recurrentgemma-9b", "whisper-base",
               "llama-3.2-vision-90b"]


@pytest.mark.parametrize("variant", ["baseline", "tuned"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_cell_matches_jax(arch, variant, smoke):
    """The prefill cell (``logits_mode`` "all" at baseline, "last" when
    tuned): the next-token logits at 2e-5 and the bf16 cache leaf for
    leaf."""
    want, got, _ = run_both(arch, "prefill", variant, smoke)
    np.testing.assert_allclose(got["next_token_logits"].numpy(),
                               want["next_token_logits"], **TOL)
    assert_cache_close(got["cache"], want["cache"])


@pytest.mark.parametrize("variant", ["baseline", "tuned"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_cell_matches_jax(arch, variant, smoke):
    """The decode cell from a zero cache, the dry run's entry point: the
    same greedy tokens, and the cache leaf for leaf.  A zero bf16 cache
    decoded at f32 compute keeps bf16 ``conv*`` states in the port where
    JAX's turn f32 (the pinned divergence of ROADMAP §3)."""
    want, (tok, cache), _ = run_both(arch, "decode", variant, smoke)
    np.testing.assert_array_equal(tok.numpy(), want[0])
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (B, 1)
    assert_cache_close(cache, want[1], pinned=("conv", "conv_x", "conv_b",
                                               "conv_c"))


@pytest.mark.parametrize("arch", ARCHS)
def test_tuned2_train_raises_for_the_archs_jax_refuses(arch,
                                                       smoke_registry):
    """The tuned2 train cell at SMOKE with the cells' own ``POLICY``: JAX's
    step refuses to trace for mamba2-780m and recurrentgemma-9b (type
    promotion of the fp8 ``dt_bias`` and Λ with f32), and the port's raises
    at the same products before any update; the other eight run in both,
    the port's to a finite loss."""
    jshape, tshape = shapes("train")
    jfn, jargs, *_ = jcells.build_cell(arch, jshape, one_device_mesh(),
                                       "tuned2")
    tfn, targs, _, _, _, cfg, _ = cells.build_cell(
        arch, tshape, sh.AbstractMesh((1, 1), ("data", "model")), "tuned2")
    entry = registry.get(arch)
    state = ts.init_state(torch.Generator().manual_seed(0), entry, cfg,
                          cells.duplex_tcfg(cfg, torch.float8_e4m3fn),
                          cells.POLICY)
    assert port_sig(state) == port_sig(targs[0])
    batch = bridge.to_torch(numpy_batch(entry, cfg, "train", tshape.seq_len),
                            "cpu")
    before = tree_checksum(state)
    if arch in REFUSED:
        with pytest.raises(ValueError) as jerr:
            jax.eval_shape(jfn, *jargs)
        assert type(jerr.value).__name__ == "TypePromotionError"
        with pytest.raises(RuntimeError, match="Promotion for Float8") as err:
            tfn(state, batch)
        assert err.traceback[-1].name == REFUSED[arch]
        assert tree_checksum(state) == before
    else:
        jax.eval_shape(jfn, *jargs)
        new, metrics = tfn(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert tree_checksum(new["branch"]) != tree_checksum(state["branch"])


# --------------------------------------------------------------------------
# the bridge carries float8_e4m3fn
# --------------------------------------------------------------------------

def test_bridge_carries_every_fp8_code():
    """All 256 codes, both NaNs and both zeros included, into the port and
    back (widened to f32, as bf16 is) bit for bit."""
    codes = np.arange(256, dtype=np.uint8)
    a = codes.view(ml_dtypes.float8_e4m3fn)
    t = bridge.to_torch({"x": a}, "cpu")["x"]
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), codes)
    back = bridge.to_numpy({"x": t})["x"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(
        back.astype(ml_dtypes.float8_e4m3fn).view(np.uint8), codes)


def test_bridged_jax_fp8_duplex_state(smoke_registry):
    """JAX's tuned2 duplex state (granite-3-8b SMOKE) bridged: the port's
    tree, paths, shapes and dtypes of its own init, every backbone leaf
    fp8 and bit for bit JAX's."""
    jshape, tshape = shapes("train")
    _, jargs, *_, jcfg, _ = jcells.build_cell("granite-3-8b", jshape,
                                              one_device_mesh(), "tuned2")
    _, targs, *_ = cells.build_cell(
        "granite-3-8b", tshape, sh.AbstractMesh((1, 1), ("data", "model")),
        "tuned2")
    jstate = jax_args("granite-3-8b", "train", jcfg, jargs)[0]
    state = bridge.state_from_jax(jstate, "cpu")
    assert port_sig(state) == port_sig(targs[0])
    for (path, t), (_, a) in zip(tree_flatten(state["backbone"]),
                                 tree_flatten(jstate["backbone"])):
        assert t.dtype == torch.float8_e4m3fn, path
        np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                      a.view(np.uint8), err_msg=path)
