"""The port's int8 error-feedback all-reduce (``repro_torch.optim.compress``)
against ``repro.optim.compress``.

The quantizer's mantissas and scales are bit for bit JAX's, and so is the
local round trip.  ``compressed_psum`` runs over gloo groups: one rank in
this process (a ``HashStore``), two and three ranks each in a process of
its own (a ``FileStore`` under ``tmp_path``), against JAX's ``vmap`` with an
axis name over the stacked inputs, at rtol 1e-6 (the mean scale may differ
by an ulp where the two add in another order).  The ranks' inputs have
scales that differ tenfold, so the reference's mean-scale sum shows: both
land far from the true mean, as the reference does.
"""
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compress as jc
from repro_torch.optim import compress as tc
from repro_torch.utils import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _draw(shape, scale=1.0, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bf16_case():
    """A bf16 input that both frameworks hold exactly: torch rounds the
    draw to bf16, JAX takes those values."""
    t = torch.from_numpy(_draw((3, 4097), 3.0)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32_case(shape, scale=3.0):
    def make():
        x = _draw(shape, scale)
        return torch.from_numpy(x), jnp.asarray(x)
    return make


QUANTIZE_CASES = {
    "1000": _f32_case((1000,)), "64": _f32_case((64,)),
    "2048": _f32_case((2048,)), "5000": _f32_case((5000,)),
    "3x4097": _f32_case((3, 4097)),
    "zeros4096": _f32_case((4096,), scale=0.0),
    "bf16_3x4097": _bf16_case,
}


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def one_rank_group():
    """A one-rank gloo default group, destroyed when the test ends so that
    no other test in this worker sees it."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", sorted(QUANTIZE_CASES))
def test_quantize_and_round_trip_bitwise_equal_jax(case):
    xt, xj = QUANTIZE_CASES[case]()
    qt, st, nt = tc._quantize_int8(xt)
    qj, sj, nj = jc._quantize_int8(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert nt == nj == xt.numel()
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if case == "zeros4096":
        assert (st == np.float32(1e-20)).all() and not qt.any()
    yt, yj = tc.compress_decompress(xt), jc.compress_decompress(xj)
    assert yt.dtype == torch.float32 and yj.dtype == jnp.float32
    assert yt.shape == xt.shape
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_compression_roundtrip_error_small():
    x = torch.from_numpy(_draw((1000,), 3.0))
    assert _rel_fro(tc.compress_decompress(x), x) < 0.01


def test_error_feedback_carries_residual():
    g = {"w": torch.from_numpy(_draw((64,), seed=1))}
    sent, r1 = tc.error_feedback_update(g, {"w": torch.zeros(64)})
    np.testing.assert_allclose((sent["w"] + r1["w"]).numpy(), g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    # the residual feeds the next round: what was sent over both rounds plus
    # what is left equals both rounds' gradients
    sent2, r2 = tc.error_feedback_update(g, r1)
    np.testing.assert_allclose((sent["w"] + sent2["w"] + r2["w"]).numpy(),
                               2 * g["w"].numpy(), rtol=1e-5, atol=1e-5)


def test_compressed_psum_one_participant(one_rank_group):
    """One rank: within 0.01 of the identity, as the reference's test
    holds, and equal to the local round trip and to JAX's one-participant
    psum bit for bit."""
    x = _draw((128,), seed=2)
    y = tc.compressed_psum(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (128,)
    assert _rel_fro(y, x) < 0.01
    np.testing.assert_array_equal(
        y.numpy(), tc.compress_decompress(torch.from_numpy(x)).numpy())
    yj = jax.vmap(lambda v: jc.compressed_psum(v, "d"), axis_name="d")(
        jnp.asarray(x)[None])[0]
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


def test_error_feedback_update_matches_jax_on_a_nested_tree():
    """Three rounds on a two-leaf nested dict (a bf16 leaf among them),
    each round's residuals fed to the next on both sides."""
    w, b = _draw((5, 700), 0.1, seed=3), _draw((2100,), 2.0, seed=4)
    gt = {"blk": {"w": torch.from_numpy(w).bfloat16()}, "b":
          torch.from_numpy(b)}
    gj = {"blk": {"w": jnp.asarray(gt["blk"]["w"].float().numpy()).astype(
        jnp.bfloat16)}, "b": jnp.asarray(b)}
    rt = {"blk": {"w": torch.zeros(5, 700)}, "b": torch.zeros(2100)}
    rj = {"blk": {"w": jnp.zeros((5, 700))}, "b": jnp.zeros((2100,))}
    for _ in range(3):
        st, rt = tc.error_feedback_update(gt, rt)
        sj, rj = jc.error_feedback_update(gj, rj)
        for got, want in ((st, sj), (rt, rj)):
            # both flatten dicts in sorted key order
            for t, j in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                            strict=True):
                assert t.dtype == torch.float32 and t.shape == j.shape
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=1e-7)


RANK = """
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim import compress
d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", world),
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
try:
    out = compress.compressed_psum(
        torch.from_numpy(np.load(f"{d}/in{rank}.npy")))
    assert out.dtype == torch.float32, out.dtype
    np.save(f"{d}/out{rank}.npy", out.numpy())
finally:
    dist.destroy_process_group()
"""


def _run_ranks(tmp_path, xs) -> list:
    """``compressed_psum`` of ``xs[r]`` on gloo rank r, each rank a process
    of its own; every rank's output."""
    for r, x in enumerate(xs):
        np.save(tmp_path / f"in{r}.npy", x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp_path), str(r), str(len(xs))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(len(xs))]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r}: {err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return [np.load(tmp_path / f"out{r}.npy") for r in range(len(xs))]


@pytest.mark.parametrize("scales", [(1.0, 10.0), (1.0, 3.0, 10.0)],
                         ids=["two", "three"])
def test_compressed_psum_matches_jax_across_ranks(tmp_path, scales):
    xs = [_draw((3, 4097), s, seed=10 + r) for r, s in enumerate(scales)]
    want = np.asarray(jax.vmap(lambda v: jc.compressed_psum(v, "d"),
                               axis_name="d")(jnp.asarray(np.stack(xs))))
    outs = _run_ranks(tmp_path, xs)
    true_mean = np.mean(xs, axis=0)
    for r, got in enumerate(outs):
        assert got.shape == xs[r].shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want[r], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[r]).max())
        # the mean scale: every rank's sum is the mean only where the
        # scales agree, and these differ tenfold
        assert _rel_fro(got, true_mean) > 0.1
        assert _rel_fro(want[r], true_mean) > 0.1


def test_compressed_psum_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises((ValueError, RuntimeError)):
        tc.compressed_psum(torch.ones(8))
