"""The prefill cells placed on a mesh: the prefill step on DTensors, with
its cache laid out by ``sharding.cache_pspec`` as a decode cell takes it,
on real values (a ``meta`` trace cannot see where a write lands).

* The ten prefill cells (``prefill_32k`` on the ten archs, baseline) at
  SMOKE, B=2, 16 tokens, a cache of 80 slots, weights from seed 0, tokens
  and the stub frontend from seed 1: placed by ``sharding.device_put``
  with the cell's own shardings on a one-rank gloo mesh, the step gives
  the plain step's next-token logits and every cache leaf bit for bit.
* The same ten cells on a (2, 2) mesh of four gloo ranks, each rank a
  process: the gathered logits and cache leaves equal the plain step's
  within ``torch.testing.assert_close``'s defaults for their dtype (the
  shards sum in another order), and one decode step from each rank's
  DTensor cache gives the plain step's next token.  A write that landed in
  a gathered copy (F4) would leave a cache leaf at zero here.
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
from repro_torch.utils import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(registry.ARCHS)
SEQ, BATCH = 16, 2


@pytest.fixture
def smoke(monkeypatch):
    """The registry's ``full`` is its ``smoke`` config and ``POLICY``
    computes in f32, as in ``tests/test_torch_cells.py``."""
    for name, entry in list(registry.ARCHS.items()):
        monkeypatch.setitem(registry.ARCHS, name,
                            dc.replace(entry, full=entry.smoke))
    monkeypatch.setattr(cells, "POLICY",
                        TL.Policy(compute_dtype=torch.float32))


def prefill_inputs(arch: str, cfg):
    """``(params, batch)`` at SMOKE: weights from seed 0; tokens and a stub
    frontend (``randn * 0.1`` in bf16, as the cell's) from seed 1."""
    entry = registry.get(arch)
    params = entry.module.init_params(torch.Generator().manual_seed(0), cfg)
    g1 = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ),
                                     dtype=torch.int32, generator=g1)}
    fe = entry.frontend_shape(cfg, BATCH)
    if fe is not None:
        batch["frontend"] = {k: (0.1 * torch.randn(v, generator=g1)).to(
            torch.bfloat16) for k, v in fe.items()}
    return params, batch


@pytest.fixture(scope="module")
def one_rank_mesh():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    from torch.distributed.device_mesh import init_device_mesh
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_one_rank_dtensors_is_the_plain_prefill(arch, smoke,
                                                           one_rank_mesh):
    from torch.distributed.tensor import DTensor
    mesh = one_rank_mesh
    fn, _, in_sh, *_, cfg, _ = cells.build_cell(
        arch, ShapeSpec("prefill_32k", SEQ, BATCH, "prefill"), mesh)
    params, batch = prefill_inputs(arch, cfg)
    want = fn(params, batch)
    placed = [sh.device_put(x, s) for x, s in zip((params, batch), in_sh)]
    with ctx.activation_sharding(mesh, cells.activation_rules(cfg, mesh)):
        got = fn(*placed)
    assert isinstance(got["next_token_logits"], DTensor)
    assert torch.equal(got["next_token_logits"].full_tensor(),
                       want["next_token_logits"])
    g, w = tree_flatten(got["cache"]), tree_flatten(want["cache"])
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert isinstance(a, DTensor), p
        a = a.full_tensor()
        assert a.dtype == b.dtype and torch.equal(a, b), p


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
from repro_torch.utils import tree_flatten
d, rank, tests = sys.argv[1], int(sys.argv[2]), sys.argv[4]
sys.path.insert(0, tests)
from test_torch_prefill_cells import BATCH, SEQ, prefill_inputs
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=4, timeout=timedelta(seconds=120))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for name, e in list(registry.ARCHS.items()):
    registry.ARCHS[name] = dc.replace(e, full=e.smoke)
cells.POLICY = TL.Policy(compute_dtype=torch.float32)
try:
    for arch in json.loads(sys.argv[3]):
        entry = registry.get(arch)
        fn, _, in_sh, *_, cfg, _ = cells.build_cell(
            arch, ShapeSpec("prefill_32k", SEQ, BATCH, "prefill"), mesh)
        params, batch = prefill_inputs(arch, cfg)
        placed = [sh.device_put(x, s) for x, s in zip((params, batch), in_sh)]
        rules = cells.activation_rules(cfg, mesh)
        want = fn(params, batch)
        with ctx.activation_sharding(mesh, rules):
            got = fn(*placed)
        res = {"got": {"logits": got["next_token_logits"].full_tensor()},
               "want": {"logits": want["next_token_logits"]}}
        # a replicated leaf's full_tensor is its local tensor, which the
        # decode step below writes
        for p, t in tree_flatten(got["cache"]):
            res["got"][p] = t.full_tensor().clone()
        for p, t in tree_flatten(want["cache"]):
            res["want"][p] = t.clone()
        # one greedy decode step from each cache
        tok = torch.argmax(want["next_token_logits"], -1)[:, None].to(
            torch.int32)
        step = ss.make_decode_step(entry, cfg, policy=cells.POLICY)
        res["want"]["token"], _ = step(params, want["cache"], tok)
        tok = sh.device_put(tok, sh.to_named(
            sh.batch_pspec(tuple(tok.shape), mesh), mesh))
        with ctx.activation_sharding(mesh, rules):
            got_tok, _ = step(placed[0], got["cache"], tok)
        res["got"]["token"] = got_tok.full_tensor()
        if rank == 0:
            torch.save(res, f"{d}/{arch}.pt")
finally:
    dist.destroy_process_group()
"""


def test_prefill_on_four_gloo_ranks_is_the_plain_prefill(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp_path), str(r),
         json.dumps(ARCHS), str(ROOT / "tests")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for arch in ARCHS:
        res = torch.load(tmp_path / f"{arch}.pt")
        got, want = res["got"], res["want"]
        assert set(got) == set(want)
        assert torch.equal(got.pop("token"), want.pop("token")), arch
        for p in want:
            assert got[p].dtype == want[p].dtype, (arch, p)
            torch.testing.assert_close(got[p], want[p], msg=lambda m: (
                f"{arch} {p}: {m}"))
