"""The decode cells placed on a mesh: F3 (a decode cache's empty ``rem``
kept in its shardings) and the decode step on DTensors.

* Every cell of ``registry.cells()`` at the three variants, at SMOKE on
  the 16x16 layout: each ``in_shardings`` tree has the structure of its
  arguments, empty subtrees included (the reference's ``tree_pspecs`` maps
  with ``jax.tree_util.tree_map_with_path``, which keeps an empty dict),
  and a decode cell's cache specs keep its ``rem`` as the cache does.
* The 12 decode cells (``decode_32k`` on the ten archs at B=2, and
  ``long_500k`` on mamba2-780m and recurrentgemma-9b at B=1; 20 cache
  slots) at SMOKE, with random weights from a seed and a cache three
  decode steps in: placed by ``sharding.device_put`` with the cell's own
  shardings on a one-rank gloo mesh, one decode step gives the plain
  step's tokens and cache bit for bit.
* The same 12 cells on a (2, 2) mesh of four gloo ranks, each rank a
  process: the tokens equal the plain step's, and the cache leaves agree
  within ``torch.testing.assert_close``'s defaults for their dtype (the
  shards sum in another order: the ssd and lru states and the conv states
  move by rounding; the KV caches here came out equal).
"""
import dataclasses as dc
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.common import ShapeSpec
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import cells
from repro_torch.models import layers as TL, registry
from repro_torch.train import serve_step as ss
from repro_torch.utils import tree_flatten, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(registry.ARCHS)
VARIANTS = ("baseline", "tuned", "tuned2")
CELLS = [(a, s.name) for a, s, _ in registry.cells()]
# the decode cells and their SMOKE shapes: decode_32k at B=2, long_500k
# (the two archs that serve it) at B=1; 20 slots of cache
DECODE = [(a, "decode_32k", 2) for a in ARCHS] + \
    [(a, "long_500k", 1) for a in ("mamba2-780m", "recurrentgemma-9b")]
SLOTS = 20


def structure(tree):
    """A nested dict's keys all the way down, empty dicts included."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    return None


@pytest.fixture
def smoke(monkeypatch):
    """The registry's ``full`` is its ``smoke`` config and ``POLICY``
    computes in f32, as in ``tests/test_torch_cells.py``."""
    for name, entry in list(registry.ARCHS.items()):
        monkeypatch.setitem(registry.ARCHS, name,
                            dc.replace(entry, full=entry.smoke))
    monkeypatch.setattr(cells, "POLICY",
                        TL.Policy(compute_dtype=torch.float32))


# --------------------------------------------------------------------------
# F3: the shardings have the arguments' structure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_in_shardings_have_the_structure_of_the_arguments(cell, variant,
                                                          smoke):
    arch, shape_name = cell
    mode = {"train_4k": "train", "prefill_32k": "prefill"}.get(
        shape_name, "decode")
    shape = ShapeSpec(shape_name, 16, 2, mode)
    layout = sh.AbstractMesh((16, 16), ("data", "model"))
    _, args, in_sh, *_ = cells.build_cell(arch, shape, layout, variant)
    assert len(args) == len(in_sh)
    for a, s in zip(args, in_sh):
        assert structure(s) == structure(a)
        for (p, x), (q, n) in zip(tree_flatten(a), tree_flatten(s)):
            assert p == q and isinstance(n, sh.NamedSharding)
            assert len(n.spec) <= x.dim()
    if mode == "decode":
        cache, specs = args[1], in_sh[1]
        assert "rem" in cache and structure(specs["rem"]) == \
            structure(cache["rem"])
        # only recurrentgemma-9b has remainder layers; the others keep {}
        assert (cache["rem"] != {}) == (arch == "recurrentgemma-9b")


def test_tree_pspecs_keeps_an_empty_subtree():
    layout = sh.AbstractMesh((2, 2), ("data", "model"))
    tree = {"stack": {"sub0": {"len": torch.zeros(3, dtype=torch.int32)}},
            "rem": {}}
    specs = sh.tree_pspecs(tree, layout, sh.cache_pspec)
    assert specs == {"stack": {"sub0": {"len": ()}}, "rem": {}}
    assert sh.to_named(specs, layout)["rem"] == {}


# --------------------------------------------------------------------------
# the decode step on DTensors
# --------------------------------------------------------------------------

def _decode_inputs(arch: str, batch: int):
    """``(entry, cfg, params, cache, tokens)`` at SMOKE: weights from seed
    0, a bf16 cache of ``SLOTS`` after three greedy plain steps (leaves
    cloned out of inference mode), and the next tokens."""
    entry = registry.get(arch)
    cfg = entry.smoke
    params = entry.module.init_params(torch.Generator().manual_seed(0), cfg)
    cache = entry.module.init_cache(cfg, batch=batch, max_len=SLOTS,
                                    dtype=torch.bfloat16, device="cpu")
    step = ss.make_decode_step(entry, cfg, policy=cells.POLICY)
    tok = torch.randint(0, cfg.vocab, (batch, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    for _ in range(3):
        tok, cache = step(params, cache, tok)
    return entry, cfg, params, tree_map(torch.clone, cache), tok


@pytest.fixture(scope="module")
def one_rank_mesh():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    from torch.distributed.device_mesh import init_device_mesh
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape_name,batch", DECODE,
                         ids=[f"{a}-{s}" for a, s, _ in DECODE])
def test_decode_step_on_one_rank_dtensors_is_the_plain_step(
        arch, shape_name, batch, smoke, one_rank_mesh):
    from torch.distributed.tensor import DTensor
    mesh = one_rank_mesh
    fn, _, in_sh, *_ , cfg, _ = cells.build_cell(
        arch, ShapeSpec(shape_name, SLOTS, batch, "decode"), mesh)
    entry, cfg, params, cache, tok = _decode_inputs(arch, batch)
    want_tok, want_cache = ss.make_decode_step(entry, cfg,
                                               policy=cells.POLICY)(
        params, tree_map(torch.clone, cache), tok)
    placed = [sh.device_put(x, s) for x, s in
              zip((params, cache, {"tokens": tok}), in_sh)]
    assert structure(placed[1]) == structure(cache)
    with ctx.activation_sharding(mesh, cells.activation_rules(cfg, mesh)):
        got_tok, got_cache = fn(*placed)
    assert isinstance(got_tok, DTensor)
    assert torch.equal(got_tok.full_tensor(), want_tok)
    assert structure(got_cache) == structure(want_cache)
    for (p, got), (_, want) in zip(tree_flatten(got_cache),
                                   tree_flatten(want_cache)):
        assert isinstance(got, DTensor), p
        got = got.full_tensor()
        assert got.dtype == want.dtype and torch.equal(got, want), p


RANK = r"""
import dataclasses as dc, json, sys
from datetime import timedelta
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.common import ShapeSpec
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.launch import cells
from repro_torch.models import layers as TL, registry
from repro_torch.train import serve_step as ss
from repro_torch.utils import tree_flatten, tree_map
d, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=4, timeout=timedelta(seconds=120))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for name, e in list(registry.ARCHS.items()):
    registry.ARCHS[name] = dc.replace(e, full=e.smoke)
cells.POLICY = TL.Policy(compute_dtype=torch.float32)
out = {}
try:
    for arch, shape_name, batch in json.loads(sys.argv[3]):
        entry = registry.get(arch)
        cfg = entry.smoke
        fn, _, in_sh, *_ = cells.build_cell(
            arch, ShapeSpec(shape_name, 20, batch, "decode"), mesh)
        params = entry.module.init_params(torch.Generator().manual_seed(0),
                                          cfg)
        cache = entry.module.init_cache(cfg, batch=batch, max_len=20,
                                        dtype=torch.bfloat16, device="cpu")
        step = ss.make_decode_step(entry, cfg, policy=cells.POLICY)
        tok = torch.randint(0, cfg.vocab, (batch, 1), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
        for _ in range(3):
            tok, cache = step(params, cache, tok)
        cache = tree_map(torch.clone, cache)
        placed = [sh.device_put(x, s) for x, s in
                  zip((params, cache, {"tokens": tok}), in_sh)]
        # a placed leaf may hold its source's storage: the plain step
        # writes a copy
        want_tok, want_cache = step(params, tree_map(torch.clone, cache), tok)
        with ctx.activation_sharding(mesh, cells.activation_rules(cfg, mesh)):
            got_tok, got_cache = fn(*placed)
        got = {"tokens": got_tok.full_tensor()}
        got.update({p: t.full_tensor() for p, t in tree_flatten(got_cache)})
        want = {"tokens": want_tok, **dict(tree_flatten(want_cache))}
        if rank == 0:
            torch.save({"got": got, "want": want},
                       f"{d}/{arch}-{shape_name}.pt")
finally:
    dist.destroy_process_group()
"""


def test_decode_step_on_four_gloo_ranks_is_the_plain_step(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp_path), str(r),
         json.dumps(DECODE)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for arch, shape_name, _ in DECODE:
        res = torch.load(tmp_path / f"{arch}-{shape_name}.pt")
        got, want = res["got"], res["want"]
        assert set(got) == set(want)
        assert torch.equal(got["tokens"], want["tokens"]), arch
        for p in want:
            torch.testing.assert_close(got[p], want[p], msg=lambda m: (
                f"{arch} {shape_name} {p}: {m}"))
