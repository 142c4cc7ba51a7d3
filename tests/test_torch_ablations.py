"""The port's Fig. 21 ablations and 2D-BFP fidelity benchmarks
(repro_torch.bench.{fig21_ablations, bfp_fidelity}) against the
reference's: the duplex configurations they train, 5 steps of each from
one bridged init (validation loss within rtol 1e-5), the rmse, bits and
transpose rows on one numpy draw, the kernel row's product against the
Pallas kernel in interpret mode, and the rows each module prints."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jc
from repro.core import bfp as jbfp, duplex as jdx
from repro.kernels.bfp_matmul import bfp_matmul as jbfp_matmul
from repro_torch import bridge
from repro_torch.bench import bfp_fidelity, common as tc, fig21_ablations

STEPS = 5
# every (pool, use_norm, bfp) the two benchmarks train
BENCH_CFGS = [(8, False, True), (4, False, True), (4, True, True),
              (4, False, False)]
ROW = re.compile(r"^[\w/]+,\d+,\w+=[^;,]+(;\w+=[^;,]+)*$")


@pytest.fixture(scope="module")
def backbone():
    """The reference's 5-step backbone, as numpy leaves."""
    jbb, _ = jc.pretrain_backbone(steps=STEPS, key=0)
    return jax.tree_util.tree_map(np.asarray, jbb)


def _kw(pool, use_norm, bfp):
    return dict(pool=pool, use_norm=use_norm, bfp=bfp)


@pytest.mark.parametrize("pool,use_norm,bfp", BENCH_CFGS,
                         ids=["pool8", "pool4", "norm", "fp32"])
def test_duplex_cfg_is_the_references(pool, use_norm, bfp):
    td, jd = tc.duplex_cfg(**_kw(pool, use_norm, bfp)), \
        jc.duplex_cfg(**_kw(pool, use_norm, bfp))
    for f in ("n_blocks", "d_branch", "pool_factor", "branch_heads",
              "branch_ff_mult", "use_norm", "causal"):
        assert getattr(td, f) == getattr(jd, f), f
    for f in ("enabled", "group", "ebits", "mbits"):
        assert getattr(td.bfp, f) == getattr(jd.bfp, f), f


@pytest.mark.parametrize("pool,use_norm,bfp",
                         [(8, False, True), (4, True, True),
                          (4, False, False)], ids=["pool8", "norm", "fp32"])
def test_ablation_arm_matches_reference(backbone, pool, use_norm, bfp):
    """5 duplex steps of each configuration the two benchmarks add to
    Table II's, from the reference's backbone and one bridged branch init;
    validation loss within rtol 1e-5."""
    kw = _kw(pool, use_norm, bfp)
    jbranch = jdx.duplex_init(jax.random.PRNGKey(1), jc.duplex_cfg(**kw),
                              jc.BB_CFG.d_model)
    jbranch = jax.tree_util.tree_map(np.asarray, jbranch)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jbranch)[0]]
    assert any("norm" in p for p in paths) == use_norm
    jl, ja, _ = jc.train_arm("duplex", jax.tree_util.tree_map(jnp.asarray,
                                                              backbone),
                             steps=STEPS, key=1, dcfg=jc.duplex_cfg(**kw))
    tl, ta, _ = tc.train_arm("duplex", bridge.to_torch(backbone, "cpu"),
                             steps=STEPS, key=1, dcfg=tc.duplex_cfg(**kw),
                             init=bridge.to_torch(jbranch, "cpu"),
                             device="cpu")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert 0.0 <= ta <= 1.0


def test_quantization_rows_match_reference():
    """The three rmse rows at rtol 1e-6, bits exactly, and transpose
    invariance exactly, on one numpy draw bridged to both."""
    x = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    rows, values = bfp_fidelity.quantization_rows(torch.from_numpy(x))
    xj = jnp.asarray(x)
    for (group, mbits), row in zip(bfp_fidelity.RMSE_CASES, rows):
        name = f"bfp/rmse_g{group[0]}m{mbits}"
        assert row.startswith(name + ",")
        np.testing.assert_allclose(
            values["rmse"][name],
            float(jbfp.quantization_rmse(xj, group=group, mbits=mbits)),
            rtol=1e-6)
        assert values["bits"][name] == jbfp.bfp_quantize(
            xj, group=group, mbits=mbits).bits_per_value
    jdiff = jnp.abs(jbfp.bfp_dequantize(jbfp.bfp_quantize(xj.T))
                    - jbfp.bfp_dequantize(jbfp.bfp_quantize(xj)).T).max()
    assert float(jdiff) == 0.0
    assert values["transpose_max_diff"] == 0.0
    assert rows[-1] == "bfp/transpose_invariance,0,max_diff=0.00e+00"


def test_matmul_row_matches_pallas_interpret():
    """The CPU kernel row (the plain route) against the reference's Pallas
    kernel in interpret mode at 128x128, group 32, blocks 64, a == b."""
    a = np.random.default_rng(1).standard_normal((128, 128)).astype(
        np.float32)
    row, values = bfp_fidelity.matmul_row(torch.from_numpy(a))
    want = jbfp_matmul(jnp.asarray(a), jnp.asarray(a), group=32, block_m=64,
                       block_n=64, block_k=64, interpret=True)
    np.testing.assert_allclose(values["out"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    assert values["route"] == "plain" and values["max_abs_err"] == 0.0
    assert row.startswith("bfp/plain_matmul_128,")
    assert "oracle=bfp_matmul_plain" in row


def test_fig21_rows_on_cpu():
    """The module runs end to end (a few steps) and prints the reference's
    rows in its order; the norm-free arm is trained again, not reused."""
    rows, results = fig21_ablations.run("cpu", pretrain_steps=2,
                                        arm_steps=2)
    assert [r.split(",")[0] for r in rows] == [
        "fig21a/pool8", "fig21a/pool4", "fig21a/verdict", "fig21b/norm_free",
        "fig21b/norm"]
    assert all(ROW.match(r) for r in rows), rows
    assert sorted(results) == ["fig21a/pool4", "fig21a/pool8",
                               "fig21b/norm", "fig21b/norm_free"]
    for loss, acc, _ in results.values():
        assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    # the same configuration, data and init, trained twice
    np.testing.assert_allclose(results["fig21b/norm_free"][0],
                               results["fig21a/pool4"][0], rtol=1e-5)
    gain = results["fig21a/pool8"][0] - results["fig21a/pool4"][0]
    assert rows[2] == f"fig21a/verdict,0,loss_gain_from_4x_compute={gain:.4f}"


def test_bfp_fidelity_rows_on_cpu():
    """The module runs end to end (a few steps) and prints the reference's
    rows in its order, the kernel row named for the plain route."""
    x = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    rows, values = bfp_fidelity.run("cpu", pretrain_steps=2, arm_steps=2,
                                    x=x)
    assert [r.split(",")[0] for r in rows] == [
        "bfp/rmse_g3m5", "bfp/rmse_g32m5", "bfp/rmse_g3m7",
        "bfp/transpose_invariance", "bfp/plain_matmul_128",
        "bfp/training_parity"]
    assert all(ROW.match(r) for r in rows), rows
    np.testing.assert_array_equal(values["x"].numpy(), x)
    assert tuple(values["matmul"]["a"].shape) == (128, 128)
    for loss, acc, _ in values["training_parity"].values():
        assert np.isfinite(loss) and 0.0 <= acc <= 1.0


@pytest.mark.parametrize("module", [fig21_ablations, bfp_fidelity],
                         ids=["fig21_ablations", "bfp_fidelity"])
def test_cuda_request_without_card_raises(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
