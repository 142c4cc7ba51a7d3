"""The train cells placed on a mesh: the duplex train step on DTensors,
forward and backward, on real values (a ``meta`` trace cannot see a float
index or a gradient left as a pending sum).

* The ten train cells (``train_4k`` on the ten archs, baseline) at SMOKE,
  B=2, 16 tokens, f32 compute, weights from seed 0, tokens (labels the
  tokens shifted by one) and the stub frontend from seed 1: the state and
  batch placed by ``sharding.device_put`` with the cell's own shardings on
  a one-rank gloo mesh, one step gives the plain step's new state (branch,
  momentum, step; the backbone untouched) and metrics bit for bit, each
  new leaf laid out as its old one.  The vocab-parallel loss
  (``ctx.logsumexp_pick``) reorders no sum on one rank, so no leaf needs a
  tolerance.
* The same ten cells on a (2, 2) mesh of four gloo ranks, each rank a
  process, and two tuned ones: granite-3-8b (``fsdp_pure``: the batch, B=4,
  split over both axes and every large weight ZeRO-3 over both) and
  granite-moe-1b-a400m (tuned, not ``fsdp_pure``: its experts need the
  ``model`` axis).  The gathered new state and metrics equal the plain
  step's within ``torch.testing.assert_close``'s defaults for their dtype
  (the shards' sums run in another order: the loss's log-sum-exp over
  vocab blocks, the gradients' reduce-scatters, the global norm), and
  each new leaf keeps its placements.  No JAX here: this file runs on the
  card's torch as well.
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
from repro_torch.train import train_step as ts
from repro_torch.utils import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(registry.ARCHS)
SEQ = 16
# (arch, variant, batch) of the four-rank run
FOUR = [(a, "baseline", 2) for a in ARCHS] + \
    [("granite-3-8b", "tuned", 4), ("granite-moe-1b-a400m", "tuned", 2)]


@pytest.fixture
def smoke(monkeypatch):
    """The registry's ``full`` is its ``smoke`` config and ``POLICY``
    computes in f32, as in ``tests/test_torch_cells.py``."""
    for name, entry in list(registry.ARCHS.items()):
        monkeypatch.setitem(registry.ARCHS, name,
                            dc.replace(entry, full=entry.smoke))
    monkeypatch.setattr(cells, "POLICY",
                        TL.Policy(compute_dtype=torch.float32))


def train_inputs(arch: str, cfg, batch: int):
    """``(state, batch)`` at SMOKE: the duplex state (bf16 backbone) from
    seed 0; tokens, labels (the tokens shifted by one) and a stub frontend
    (``randn * 0.1`` in bf16, as the cell's) from seed 1."""
    entry = registry.get(arch)
    state = ts.init_state(torch.Generator().manual_seed(0), entry, cfg,
                          cells.duplex_tcfg(cfg), cells.POLICY)
    g1 = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, SEQ), dtype=torch.int32,
                           generator=g1)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    fe = entry.frontend_shape(cfg, batch)
    if fe is not None:
        out["frontend"] = {k: (0.1 * torch.randn(v, generator=g1)).to(
            torch.bfloat16) for k, v in fe.items()}
    return state, out


def step_both(arch: str, variant: str, batch: int, mesh):
    """The cell's step on plain tensors and on the placed ones: ``(want,
    got, placed)``, each step's ``(new_state, metrics)``, and the placed
    ``(state, batch)``."""
    fn, _, in_sh, *_, cfg, fsdp_pure = cells.build_cell(
        arch, ShapeSpec("train_4k", SEQ, batch, "train"), mesh, variant)
    state, batch_ = train_inputs(arch, cfg, batch)
    want = fn(state, batch_)
    placed = [sh.device_put(x, s) for x, s in zip((state, batch_), in_sh)]
    with ctx.activation_sharding(mesh, cells.activation_rules(
            cfg, mesh, fsdp_pure=fsdp_pure)):
        got = fn(*placed)
    return want, got, placed


def laid_out_as_before(new_state, old_state) -> list:
    """The paths whose new leaf is not a DTensor with its old placements."""
    from torch.distributed.tensor import DTensor
    return [p for (p, a), (_, b) in zip(tree_flatten(new_state),
                                        tree_flatten(old_state))
            if not isinstance(a, DTensor) or
            tuple(a.placements) != tuple(b.placements)]


@pytest.fixture(scope="module")
def one_rank_mesh():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    from torch.distributed.device_mesh import init_device_mesh
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_one_rank_dtensors_is_the_plain_step(arch, smoke,
                                                           one_rank_mesh):
    (want_state, want_m), (got_state, got_m), placed = step_both(
        arch, "baseline", 2, one_rank_mesh)
    assert laid_out_as_before(got_state, placed[0]) == []
    g, w = tree_flatten(got_state), tree_flatten(want_state)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        a = a.full_tensor()
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert set(got_m) == set(want_m) == {"loss", "accuracy", "grad_norm",
                                         "lr"}
    for k in want_m:
        assert torch.equal(got_m[k].full_tensor(), want_m[k]), k


RANK = r"""
import dataclasses as dc, json, sys
from datetime import timedelta
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import cells
from repro_torch.models import layers as TL, registry
from repro_torch.utils import tree_flatten
d, rank, tests = sys.argv[1], int(sys.argv[2]), sys.argv[4]
sys.path.insert(0, tests)
from test_torch_train_cells import laid_out_as_before, step_both
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=4, timeout=timedelta(seconds=120))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for name, e in list(registry.ARCHS.items()):
    registry.ARCHS[name] = dc.replace(e, full=e.smoke)
cells.POLICY = TL.Policy(compute_dtype=torch.float32)
try:
    for arch, variant, batch in json.loads(sys.argv[3]):
        (ws, wm), (gs, gm), placed = step_both(arch, variant, batch, mesh)
        res = {"moved": laid_out_as_before(gs, placed[0]),
               "got": {p: t.full_tensor() for p, t in tree_flatten(gs)},
               "want": dict(tree_flatten(ws))}
        for k in wm:
            res["got"]["metrics/" + k] = gm[k].full_tensor()
            res["want"]["metrics/" + k] = wm[k]
        if rank == 0:
            torch.save(res, f"{d}/{arch}-{variant}.pt")
finally:
    dist.destroy_process_group()
"""


def test_train_step_on_four_gloo_ranks_is_the_plain_step(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp_path), str(r),
         json.dumps(FOUR), str(ROOT / "tests")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=400)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for arch, variant, _ in FOUR:
        res = torch.load(tmp_path / f"{arch}-{variant}.pt")
        assert res["moved"] == [], (arch, variant)
        got, want = res["got"], res["want"]
        assert set(got) == set(want)
        assert torch.equal(got["step"], want["step"])
        for p in want:
            assert got[p].dtype == want[p].dtype, (arch, p)
            torch.testing.assert_close(got[p], want[p], msg=lambda m: (
                f"{arch} {variant} {p}: {m}"))
