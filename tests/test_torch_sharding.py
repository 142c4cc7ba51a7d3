"""The port's sharding rules, activation-sharding context and meshes
(``repro_torch.distributed.{sharding,ctx}``, ``repro_torch.launch.mesh``,
``repro_torch.launch.cells.activation_rules``) against
``repro.distributed.sharding`` and ``repro.launch.cells``.

Specs are compared as tuples, path by path, for all ten archs at full
config on the 16×16 and 2×16×16 production layouts, which both sides
reckon from sizes and names alone (JAX's ``AbstractMesh``, the port's own).
Each arch's trees are built once: JAX's by ``jax.eval_shape``, the port's
on the ``meta`` device.  The duplex state's ``backbone`` is the arch's
``init_params`` tree (drawn in bf16), so it serves the param rules too.
Meshes with ranks run over gloo: one rank in this process (a
``HashStore``), four ranks each in a process of its own (a ``FileStore``
under ``tmp_path``).
"""
import functools
import importlib
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.distributed import ctx as jctx, sharding as jsh
from repro.launch import cells as jcells
from repro.models import registry as jreg
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro.utils import path_str
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.distributed.sharding import AbstractMesh, P
from repro_torch.launch import cells, mesh as tmesh
from repro_torch.models import layers as L, registry
from repro_torch.optim import AdamWConfig
from repro_torch.train import train_step as ts
from repro_torch.utils import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(registry.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the batch axes of each mesh: dp_axes' bare name or tuple
DP = {"16x16": "data", "2x16x16": ("pod", "data")}


def _jax_abstract_mesh(sizes, names):
    # jax <= 0.4.x takes ((name, size), ...) pairs; newer jax takes
    # (sizes, names) positionally
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


@functools.cache
def port_mesh(key):
    return AbstractMesh(*MESHES[key])


@functools.cache
def jax_mesh(key):
    return _jax_abstract_mesh(*MESHES[key])


@functools.cache
def duplex_states(arch):
    """(JAX's duplex ``init_state`` shapes, the port's on ``meta``) under
    ``duplex_tcfg``."""
    je, te = jreg.get(arch), registry.get(arch)
    jstate = jax.eval_shape(
        lambda k: jts.init_state(k, je, je.full,
                                 jcells.duplex_tcfg(je.full)),
        jax.random.PRNGKey(0))
    tstate = ts.init_state(torch.Generator().manual_seed(0), te, te.full,
                           cells.duplex_tcfg(te.full), device="meta")
    return jstate, tstate


def jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {path_str(p): tuple(s) for p, s in flat}


def port_specs(tree) -> dict:
    return dict(tree_flatten(tree))


def assert_same_specs(jtree, ttree):
    want, got = jax_specs(jtree), port_specs(ttree)
    assert list(got) == list(want)          # the same paths, in order
    diff = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not diff, diff


@pytest.fixture(params=sorted(MESHES))
def mesh_key(request):
    return request.param


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
def host_mesh(one_rank_group):
    return tmesh.make_host_mesh(device_type="cpu")


# --------------------------------------------------------------------------
# tests/test_sharding.py, mirrored on both production layouts
# --------------------------------------------------------------------------

def test_attention_weights_tp(mesh_key):
    mesh = port_mesh(mesh_key)
    assert sh.param_pspec("stack/sub0/attn/wq/w", (80, 8192, 8192),
                          mesh) == P(None, "data", "model")
    assert sh.param_pspec("stack/sub0/attn/wo/w", (80, 8192, 8192),
                          mesh) == P(None, "model", "data")
    assert sh.param_pspec("rem/sub0/attn/wq/w", (4096, 4096), mesh) == \
        P("data", "model")


def test_divisibility_guard_drops_axis(mesh_key):
    # 36-head starcoder bias: 4608 % 16 == 0 → sharded; 13 → replicated
    mesh = port_mesh(mesh_key)
    assert sh.param_pspec("attn/wq/b", (4608,), mesh) == P("model")
    assert sh.param_pspec("attn/wq/b", (13,), mesh) == P(None)


def test_moe_expert_parallel(mesh_key):
    mesh = port_mesh(mesh_key)
    spec = sh.param_pspec("stack/sub0/moe/wi", (48, 128, 5120, 8192), mesh)
    assert spec == P(None, "model", "data", None)
    assert sh.param_pspec("stack/sub0/moe/router/w", (48, 5120, 128),
                          mesh) == P(None, None, None)


def test_embed_fsdp_tp(mesh_key):
    assert sh.param_pspec("embed/table", (152064, 8192),
                          port_mesh(mesh_key)) == P("model", "data")


def test_norms_replicated(mesh_key):
    mesh = port_mesh(mesh_key)
    assert sh.param_pspec("stack/sub0/norm/scale", (80, 8192), mesh) == \
        P(None, None)
    # but the SSD inner norm spans the model-sharded d_inner
    assert sh.param_pspec("stack/sub0/ssd/norm/scale", (48, 3072), mesh) == \
        P(None, "model")


def test_fsdp_pure_variant(mesh_key):
    mesh = port_mesh(mesh_key)
    # dim0 divisible by 256 → fully sharded over (data, model)
    assert sh.param_pspec("stack/sub0/attn/wq/w", (80, 8192, 8192), mesh,
                          fsdp_pure=True) == P(None, ("data", "model"), None)
    # 29568 % 256 != 0 → the other dim (8192) carries the full 256-way shard
    spec = sh.param_pspec("stack/sub0/mlp/wo/w", (80, 29568, 8192), mesh,
                          fsdp_pure=True)
    shards = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                shards *= mesh.shape[a]
    assert shards == 256, spec


@pytest.mark.parametrize("shape,want", [
    ((80, 29568, 8208), P(None, "data", "model")),
    ((80, 29568, 8193), P(None, "data", None)),
    ((80, 29569, 8208), P(None, None, "model"))],
    ids=["split", "first_only", "second_only"])
def test_fsdp_pure_splits_across_two_dims(mesh_key, shape, want):
    """No dim divides 256: ``data`` takes the first dim and ``model`` the
    second where each divides 16, on both sides."""
    for mod, mesh in ((sh, port_mesh(mesh_key)), (jsh, jax_mesh(mesh_key))):
        assert tuple(mod.param_pspec("stack/sub0/mlp/wo/w", shape, mesh,
                                     fsdp_pure=True)) == want


def test_lru_gate_variants(mesh_key):
    mesh = port_mesh(mesh_key)
    assert sh.param_pspec("stack/sub0/lru/wr/w", (12, 4096, 4096),
                          mesh) == P(None, "model", None)
    assert sh.param_pspec("stack/sub0/lru/wr/w", (12, 4096, 4096), mesh,
                          lru_gates_colparallel=True) == \
        P(None, None, "model")


def test_batch_specs(mesh_key):
    mesh, dp = port_mesh(mesh_key), DP[mesh_key]
    assert sh.batch_pspec((256, 4096), mesh) == P(dp, None)
    # batch 1 (long_500k): nothing divides → replicated
    assert sh.batch_pspec((1, 1), mesh) == P(None, None)
    # fsdp_pure: batch over every axis; 256 does not divide 2×16×16, so
    # the multi-pod layout falls back to pod×data
    every = ("data", "model") if mesh_key == "16x16" else ("pod", "data")
    assert sh.batch_pspec((256, 4096), mesh, include_model=True) == \
        P(every, None)


def test_cache_specs(mesh_key):
    mesh, dp = port_mesh(mesh_key), DP[mesh_key]
    # stacked KV cache: [n_rep, B, S, KV, hd] — seq over model, batch DP
    assert sh.cache_pspec("stack/sub0/k", (80, 128, 32768, 8, 128),
                          mesh) == P(None, dp, "model", None, None)
    # ring cache position array replicated; len scalar
    assert sh.cache_pspec("stack/sub0/pos", (12, 2048), mesh) == P(None, None)
    assert sh.cache_pspec("stack/sub0/len", (12,), mesh) == P()
    # ssd state: heads over model
    assert sh.cache_pspec("stack/sub0/h", (48, 128, 48, 64, 128), mesh) == \
        P(None, dp, "model", None, None)


def test_optimizer_state_mirrors_params(mesh_key):
    state_path = "opt/mu/branch/blocks/f1/attn/wq/w"
    assert sh._strip(state_path) == "blocks/f1/attn/wq/w"
    assert sh.param_pspec(sh._strip(state_path), (8, 1024, 1024),
                          port_mesh(mesh_key)) == P(None, "data", "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_params_get_specs(arch, mesh_key):
    """No param of any full config falls through with a bad spec rank."""
    mesh = port_mesh(mesh_key)
    params = duplex_states(arch)[1]["backbone"]
    specs = port_specs(sh.tree_pspecs(params, mesh, sh.param_pspec))
    flat = dict(tree_flatten(params))
    assert list(specs) == list(flat)
    for path, s in specs.items():
        shape = tuple(flat[path].shape)
        assert len(s) <= len(shape), (path, shape, s)
        for dim, ax in zip(shape, s):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= mesh.shape[a]
            assert dim % n == 0, (path, shape, s)


# --------------------------------------------------------------------------
# spec for spec against JAX: all ten archs at full config
# --------------------------------------------------------------------------

PARAM_VARIANTS = {"plain": {}, "fsdp_pure": {"fsdp_pure": True},
                  "lru_gates_colparallel": {"lru_gates_colparallel": True}}


@pytest.mark.parametrize("variant", sorted(PARAM_VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_key, variant):
    kw = PARAM_VARIANTS[variant]
    jstate, tstate = duplex_states(arch)
    assert_same_specs(
        jsh.tree_pspecs(jstate["backbone"], jax_mesh(mesh_key),
                        functools.partial(jsh.param_pspec, **kw)),
        sh.tree_pspecs(tstate["backbone"], port_mesh(mesh_key),
                       functools.partial(sh.param_pspec, **kw)))


@pytest.mark.parametrize("arch", ARCHS)
def test_duplex_state_specs_match_jax(arch, mesh_key):
    jstate, tstate = duplex_states(arch)
    assert_same_specs(jsh.state_pspecs(jstate, jax_mesh(mesh_key)),
                      sh.state_pspecs(tstate, port_mesh(mesh_key)))


def test_full_state_specs_match_jax(mesh_key):
    """granite-3-8b's FR state under AdamW: ``_strip`` takes ``opt/mu/``
    and ``opt/nu/`` off, so each moment leaf takes its param's spec."""
    je, te = jreg.get("granite-3-8b"), registry.get("granite-3-8b")
    jstate = jax.eval_shape(
        lambda k: jts.init_state(k, je, je.full, jts.TrainConfig(
            mode="full", opt=JAdamW())), jax.random.PRNGKey(0))
    tstate = ts.init_state(torch.Generator(), te, te.full, ts.TrainConfig(
        mode="full", opt=AdamWConfig()), device="meta")
    jspecs = jsh.state_pspecs(jstate, jax_mesh(mesh_key))
    tspecs = sh.state_pspecs(tstate, port_mesh(mesh_key))
    assert_same_specs(jspecs, tspecs)
    assert sorted(tspecs["opt"]) == ["mu", "nu"]
    for moment in ("mu", "nu"):
        assert tspecs["opt"][moment] == tspecs["backbone"]
    assert tspecs["step"] == P()


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, mesh_key, batch):
    """``init_cache`` at max_len 32768; at B=1 nothing divides the batch
    axes, so ``dp`` falls to ``None`` (``long_500k``)."""
    je, te = jreg.get(arch), registry.get(arch)
    jcache = jax.eval_shape(lambda: je.module.init_cache(
        je.full, batch, 32768, jax.numpy.bfloat16))
    tcache = te.module.init_cache(te.full, batch, 32768, torch.bfloat16,
                                  device="meta")
    tspecs = sh.tree_pspecs(tcache, port_mesh(mesh_key), sh.cache_pspec)
    assert_same_specs(
        jsh.tree_pspecs(jcache, jax_mesh(mesh_key), jsh.cache_pspec), tspecs)
    batch_entries = {s[1 if p.startswith("stack/") else 0]
                     for p, s in tree_flatten(tspecs)
                     if p.rsplit("/", 1)[-1] not in ("len", "step", "pos")}
    assert batch_entries == ({DP[mesh_key]} if batch == 128 else {None})


@pytest.mark.parametrize("include_model", [False, True],
                         ids=["dp", "every_axis"])
@pytest.mark.parametrize("shape", [(256, 4096), (1, 1)],
                         ids=["256x4096", "1x1"])
def test_batch_specs_match_jax(mesh_key, shape, include_model):
    assert sh.batch_pspec(shape, port_mesh(mesh_key), include_model) == \
        tuple(jsh.batch_pspec(shape, jax_mesh(mesh_key), include_model))


@pytest.mark.parametrize("fsdp_pure", [False, True],
                         ids=["baseline", "fsdp_pure"])
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_match_jax(arch, mesh_key, fsdp_pure):
    want = jcells.activation_rules(jreg.get(arch).full, jax_mesh(mesh_key),
                                   fsdp_pure=fsdp_pure)
    got = cells.activation_rules(registry.get(arch).full,
                                 port_mesh(mesh_key), fsdp_pure=fsdp_pure)
    assert got == {k: tuple(v) for k, v in want.items()}


# --------------------------------------------------------------------------
# specs → placements
# --------------------------------------------------------------------------

def test_tuple_entry_shards_in_mesh_order():
    two = AbstractMesh((2, 2), ("data", "model"))
    assert sh.placements(P(None, ("data", "model")), two) == \
        (Shard(1), Shard(1))
    assert sh.placements(P("model", "data"), two) == (Shard(1), Shard(0))
    pod = AbstractMesh((2, 2, 1), ("pod", "data", "model"))
    assert sh.placements(P(("pod", "data"), None), pod) == \
        (Shard(0), Shard(0), Replicate())


def test_short_spec_replicates_the_trailing_dims():
    two = AbstractMesh((2, 2), ("data", "model"))
    assert sh.placements(P("model"), two) == (Replicate(), Shard(0))
    assert sh.placements(P(), two) == (Replicate(), Replicate())
    assert sh.placements(P(None, None, None), two) == \
        (Replicate(), Replicate())


@pytest.mark.parametrize("spec", [P(("model", "data"), None),
                                  P("data", "data"),
                                  P(None, ("data", "model"), "model"),
                                  P("pod", None)],
                         ids=["out_of_mesh_order", "axis_at_two_dims",
                              "tuple_and_name", "unknown_axis"])
def test_placements_refuse(spec):
    with pytest.raises(ValueError):
        sh.placements(spec, AbstractMesh((2, 2), ("data", "model")))


def test_to_named_maps_a_tree(host_mesh):
    named = sh.to_named({"a": P("data", None), "b": {"c": P()}}, host_mesh)
    assert named["a"] == sh.NamedSharding(host_mesh, (Shard(0), Replicate()))
    assert named["b"]["c"].placements == (Replicate(), Replicate())
    x = torch.arange(6.0).reshape(2, 3)
    put = sh.device_put({"a": x, "b": {"c": x}}, named)
    assert put["a"].placements == (Shard(0), Replicate())
    assert torch.equal(put["a"].to_local(), x)
    assert torch.equal(put["b"]["c"].full_tensor(), x)


# --------------------------------------------------------------------------
# the activation-sharding context
# --------------------------------------------------------------------------

def test_constrain_without_rules_returns_the_same_object():
    x = torch.randn(2, 3, 4)
    assert ctx._RULES is None and ctx.constrain(x, "resid") is x
    with ctx.activation_sharding(AbstractMesh((1, 1), ("data", "model")),
                                 {"act_q": P("data")}):
        assert ctx.constrain(x, "resid") is x      # a name not in them


def test_activation_sharding_restores_nested_and_on_exception():
    m1 = AbstractMesh((1, 1), ("data", "model"))
    m2 = AbstractMesh((2, 2), ("data", "model"))
    r1, r2 = {"resid": P("data")}, {"resid": P("model")}
    with ctx.activation_sharding(m1, r1):
        with ctx.activation_sharding(m2, r2):
            assert (ctx._MESH, ctx._RULES) == (m2, r2)
        assert (ctx._MESH, ctx._RULES) == (m1, r1)
        with pytest.raises(KeyError):
            with ctx.activation_sharding(m2, r2):
                raise KeyError("inside")
        assert (ctx._MESH, ctx._RULES) == (m1, r1)
    assert ctx._MESH is None and ctx._RULES is None


def test_constrain_plain_tensor_on_many_ranks_raises():
    with ctx.activation_sharding(AbstractMesh((2, 2), ("data", "model")),
                                 {"resid": P("data", None, None)}):
        with pytest.raises(ValueError, match="local data"):
            ctx.constrain(torch.zeros(4, 2, 2), "resid")


def test_constrain_on_one_rank_mesh(host_mesh):
    """A plain tensor comes back as it is; a DTensor is redistributed to
    the rule's placements, its spec cut to its rank (``dec_scores`` has 4
    entries, the tensor 2), and one on another mesh raises."""
    rules = {"resid": P("data", None, "model"),
             "dec_scores": P("data", None, None, "model")}
    x = torch.arange(24.0).reshape(2, 3, 4)
    with ctx.activation_sharding(host_mesh, rules):
        assert ctx.constrain(x, "resid") is x
        y = ctx.constrain(distribute_tensor(x, host_mesh, [Replicate()] * 2),
                          "resid")
        assert y.placements == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x)
        z = ctx.constrain(distribute_tensor(x[0], host_mesh,
                                            [Replicate()] * 2), "dec_scores")
        assert z.placements == (Shard(0), Replicate())
        other = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
        with pytest.raises(ValueError, match="not on the installed mesh"):
            ctx.constrain(distribute_tensor(x, other, [Replicate()]), "resid")


# --------------------------------------------------------------------------
# the meshes
# --------------------------------------------------------------------------

def test_importing_mesh_touches_no_group():
    assert not dist.is_initialized()
    importlib.reload(tmesh)
    assert not dist.is_initialized()


def test_meshes_without_a_group_raise():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_host_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_production_mesh(device_type="cpu")
    assert not dist.is_initialized()


def test_make_host_mesh_on_one_rank(host_mesh):
    assert tuple(host_mesh.mesh_dim_names) == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)
    assert sh.mesh_shape(host_mesh) == {"data": 1, "model": 1}
    assert host_mesh.device_type == "cpu"


def test_mesh_makers_refuse_one_rank(one_rank_group):
    with pytest.raises(RuntimeError):
        tmesh.make_host_mesh(model=2, device_type="cpu")
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod,
                                       device_type="cpu")


# --------------------------------------------------------------------------
# four gloo ranks, each a process of its own
# --------------------------------------------------------------------------

RANK = """
import functools, sys
from datetime import timedelta
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import cells, mesh as tmesh
from repro_torch.models import registry
from repro_torch.train import train_step as ts
from repro_torch.utils import tree_flatten
d, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", 4),
                        rank=rank, world_size=4,
                        timeout=timedelta(seconds=60))
try:
    out = {}
    mesh = tmesh.make_host_mesh(model=2, device_type="cpu")
    assert tuple(mesh.shape) == (2, 2), mesh
    entry = registry.get("granite-3-8b")
    state = ts.init_state(torch.Generator().manual_seed(0), entry,
                          entry.smoke, cells.duplex_tcfg(entry.smoke),
                          device="cpu")
    for fsdp_pure in (False, True):
        specs = sh.state_pspecs(state, mesh, functools.partial(
            sh.param_pspec, fsdp_pure=fsdp_pure))
        put = sh.device_put(state, sh.to_named(specs, mesh))
        for (p, x), (_, t) in zip(tree_flatten(state), tree_flatten(put)):
            assert isinstance(t, DTensor), p
            assert torch.equal(t.full_tensor(), x), p
            out[f"{fsdp_pure}:{p}"] = t.to_local().clone()
    pod = init_device_mesh("cpu", (2, 2, 1),
                           mesh_dim_names=("pod", "data", "model"))
    spec = sh.batch_pspec((4, 8), pod)
    out["batch_spec"] = spec
    out["batch"] = sh.device_put(torch.arange(32.0).reshape(4, 8),
                                 sh.to_named(spec, pod)).to_local().clone()
    resid = torch.arange(60.0).reshape(4, 3, 5)
    with ctx.activation_sharding(mesh,
                                 cells.activation_rules(entry.smoke, mesh)):
        y = ctx.constrain(distribute_tensor(resid, mesh, [Replicate()] * 2),
                          "resid")
        out["resid_placements"] = [str(p) for p in y.placements]
        out["resid"] = y.to_local().clone()
        try:
            ctx.constrain(resid, "resid")
            out["plain"] = "returned"
        except ValueError as e:
            out["plain"] = "raised: " + str(e)
    torch.save(out, f"{d}/out{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def jax_block(x: torch.Tensor, spec: tuple, sizes: dict, coords: dict):
    """The block of ``x`` that JAX's ``NamedSharding`` gives the device at
    mesh ``coords``: along a dim sharded over axes (a1, a2, ...), block c
    of n = ∏ sizes, c row-major over the axes' coordinates."""
    index = []
    for d in range(x.ndim):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        c, n = 0, 1
        for a in axes:
            c, n = c * sizes[a] + coords[a], n * sizes[a]
        step = x.shape[d] // n
        index.append(slice(c * step, (c + 1) * step))
    return x[tuple(index)]


def test_four_ranks_hold_the_blocks_jax_gives_them(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp_path), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"rank {r}: {err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    entry = registry.get("granite-3-8b")
    state = ts.init_state(torch.Generator().manual_seed(0), entry,
                          entry.smoke, cells.duplex_tcfg(entry.smoke),
                          device="cpu")
    two = AbstractMesh((2, 2), ("data", "model"))
    # the port's specs on (2, 2) are JAX's, path by path
    je = jreg.get("granite-3-8b")
    jstate = jax.eval_shape(lambda k: jts.init_state(
        k, je, je.smoke, jcells.duplex_tcfg(je.smoke)), jax.random.PRNGKey(0))
    sharded = set()
    for fsdp_pure in (False, True):
        specs = sh.state_pspecs(state, two, functools.partial(
            sh.param_pspec, fsdp_pure=fsdp_pure))
        assert_same_specs(jsh.state_pspecs(
            jstate, _jax_abstract_mesh((2, 2), ("data", "model")),
            functools.partial(jsh.param_pspec, fsdp_pure=fsdp_pure)), specs)
        for p, spec in tree_flatten(specs):
            sharded |= {type(e) for e in spec if e is not None}
    assert sharded == {str, tuple}     # names and (data, model) pairs
    for r in range(4):
        out = torch.load(tmp_path / f"out{r}.pt")
        coords = {"data": r // 2, "model": r % 2}
        for fsdp_pure in (False, True):
            specs = dict(tree_flatten(sh.state_pspecs(
                state, two, functools.partial(sh.param_pspec,
                                              fsdp_pure=fsdp_pure))))
            for p, x in tree_flatten(state):
                want = jax_block(x, specs[p], two.shape, coords)
                assert torch.equal(out[f"{fsdp_pure}:{p}"], want), \
                    (r, fsdp_pure, p, specs[p])
        assert out["batch_spec"] == (("pod", "data"), None)
        assert torch.equal(out["batch"],
                           torch.arange(32.0).reshape(4, 8)[r:r + 1])
        assert out["resid_placements"] == ["S(0)", "R"]
        assert torch.equal(out["resid"], torch.arange(60.0).reshape(
            4, 3, 5)[2 * (r // 2):2 * (r // 2) + 2])
        assert out["plain"].startswith("raised: "), out["plain"]


# --------------------------------------------------------------------------
# the models under rules
# --------------------------------------------------------------------------

class _Asked(dict):
    """Rules that hold no name and record each name asked for."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __contains__(self, name):
        self.names.add(name)
        return False


MODEL_ARCHS = ["granite-3-8b", "recurrentgemma-9b", "gemma2-9b"]
TP32 = L.Policy(compute_dtype=torch.float32)


def _tokens(cfg, b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s))).long()


def _port_run(path, entry, cfg):
    """The path's outputs, on a fresh seed-0 draw each call."""
    gen = torch.Generator().manual_seed(0)
    if path == "duplex_step":
        tcfg = cells.duplex_tcfg(cfg, backbone_dtype=torch.float32)
        state = ts.init_state(gen, entry, cfg, tcfg, TP32, device="cpu")
        tokens = _tokens(cfg, 2, 16)
        new, metrics = ts.make_train_step(entry, cfg, tcfg, TP32)(
            state, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
        return [metrics["loss"]] + [t for _, t in tree_flatten(new)]
    params = entry.module.init_params(gen, cfg, device="cpu")
    if path == "forward":
        out = entry.module.forward(params, cfg, _tokens(cfg, 2, 16),
                                   policy=TP32)
        return [out["hidden"], out["emb"], out["aux"]]
    out = entry.module.prefill(params, cfg, _tokens(cfg, 2, 12),
                               max_len=20, policy=TP32,
                               cache_dtype=torch.float32)
    cache, outs = out["cache"], [out["logits"]]
    for i in range(3):
        logits, cache = entry.module.decode_step(
            params, cfg, _tokens(cfg, 2, 1, seed=i + 1), cache, policy=TP32)
        outs.append(logits)
    return outs + [t for _, t in tree_flatten(cache)]


def _jax_names(path, arch):
    """The names JAX's models ask ``constrain`` for on ``path``, traced by
    ``jax.eval_shape``."""
    entry = jreg.get(arch)
    cfg, asked = entry.smoke, _Asked()
    tokens = jax.ShapeDtypeStruct((2, 16), jax.numpy.int32)
    key = jax.random.PRNGKey(0)
    with jctx.activation_sharding(None, asked):
        if path == "duplex_step":
            tcfg = jcells.duplex_tcfg(cfg)
            state = jax.eval_shape(lambda k: jts.init_state(
                k, entry, cfg, tcfg), key)
            jax.eval_shape(jts.make_train_step(entry, cfg, tcfg), state,
                           {"tokens": tokens, "labels": tokens})
        else:
            params = jax.eval_shape(lambda k: entry.module.init_params(
                k, cfg), key)
            if path == "forward":
                jax.eval_shape(lambda p, t: entry.module.forward(p, cfg, t),
                               params, tokens)
            else:
                def serve(p, t):
                    cache = entry.module.prefill(p, cfg, t,
                                                 max_len=20)["cache"]
                    return entry.module.decode_step(p, cfg, t[:, :1], cache)
                jax.eval_shape(serve, params, jax.ShapeDtypeStruct(
                    (2, 12), jax.numpy.int32))
    return asked.names


@pytest.mark.parametrize("path", ["forward", "duplex_step", "decode"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_models_under_rules_change_nothing(host_mesh, arch, path):
    """With ``activation_rules`` installed on a one-rank mesh, the path's
    outputs are bit for bit those without rules; and the names the port's
    models ask ``constrain`` for are the names JAX's ask for."""
    entry = registry.get(arch)
    cfg = entry.smoke
    want = _port_run(path, entry, cfg)
    with ctx.activation_sharding(host_mesh,
                                 cells.activation_rules(cfg, host_mesh)):
        got = _port_run(path, entry, cfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    asked = _Asked()
    with ctx.activation_sharding(host_mesh, asked):
        _port_run(path, entry, cfg)
    assert asked.names == _jax_names(path, arch)
    assert "resid" in asked.names or path == "decode"
