"""The port's accuracy arms (repro_torch.bench.common) against the
reference's benchmarks.common: 5 steps of pretrain_backbone and of each of
the four arms from one bridged JAX init, losses within rtol 1e-5."""
import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jc
from repro.core import duplex as jdx
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.bench import common as tc, table2_accuracy

STEPS = 5


@pytest.fixture(scope="module")
def pretrained():
    """Both sides' 5-step backbones from one JAX init."""
    tcfg = jts.TrainConfig(mode="full", opt=jc.AdamWConfig(weight_decay=0.0),
                           lr=3e-3)
    init = jts.init_state(jax.random.PRNGKey(0), jc._Entry, jc.BB_CFG, tcfg,
                          jc.P32)["backbone"]
    init = jax.tree_util.tree_map(np.asarray, init)
    jbb, jloss = jc.pretrain_backbone(steps=STEPS, key=0)
    tbb, tloss = tc.pretrain_backbone(
        steps=STEPS, init=bridge.to_torch(init, "cpu"), device="cpu")
    return jax.tree_util.tree_map(np.asarray, jbb), jloss, tbb, tloss


def test_pretrain_backbone_matches_reference(pretrained):
    jbb, jloss, tbb, tloss = pretrained
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert np.isfinite(tloss)


@pytest.mark.parametrize("arm", ["duplex", "full", "chain", "branch_only"])
def test_arm_matches_reference(pretrained, arm):
    """Both arms start from the reference's 5-step backbone (bridged), the
    branch arms from one bridged branch init; validation loss after 5
    steps."""
    jbb = pretrained[0]
    init = None
    if arm != "full":
        jbranch = jdx.duplex_init(jax.random.PRNGKey(1), jc.duplex_cfg(),
                                  jc.BB_CFG.d_model)
        init = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jbranch),
                               "cpu")
    jl, ja, _ = jc.train_arm(arm, jax.tree_util.tree_map(jax.numpy.asarray,
                                                         jbb),
                             steps=STEPS, key=1)
    tl, ta, _ = tc.train_arm(arm, bridge.to_torch(jbb, "cpu"), steps=STEPS,
                             key=1, init=init, device="cpu")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert 0.0 <= ta <= 1.0


def test_configs_are_the_references():
    for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv", "head_dim",
              "d_ff", "vocab_pad_multiple"):
        assert getattr(tc.BB_CFG, f) == getattr(jc.BB_CFG, f), f
    assert (tc.DATA.vocab, tc.DATA.seq_len, tc.DATA.batch_per_host,
            tc.DATA.seed) == (jc.DATA.vocab, jc.DATA.seq_len,
                              jc.DATA.batch_per_host, jc.DATA.seed)
    td, jd = tc.duplex_cfg(), jc.duplex_cfg()
    assert (td.n_blocks, td.d_branch, td.pool_factor, td.branch_heads,
            td.bfp.group) == (jd.n_blocks, jd.d_branch, jd.pool_factor,
                              jd.branch_heads, jd.bfp.group)


def test_table2_rows_on_cpu(capsys):
    """The module runs end to end (a few steps) and prints the reference's
    rows: one per arm and the ordering row."""
    rows, results = table2_accuracy.run("cpu", pretrain_steps=2,
                                        arm_steps=2)
    assert [r.split(",")[0] for r in rows] == [
        "table2/duplex", "table2/full", "table2/chain", "table2/branch_only",
        "table2/ordering"]
    assert all(np.isfinite(v[0]) for v in results.values())
    assert "DuDNN~FR=" in rows[-1]


def test_table2_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        table2_accuracy.main([])


def test_unknown_arm_raises():
    with pytest.raises(ValueError):
        tc.train_arm("nope", None, steps=1, device="cpu")
