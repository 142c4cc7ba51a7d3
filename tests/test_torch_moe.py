"""repro_torch.models.moe against repro.models.moe, and the MoE archs
(granite-moe-1b-a400m, llama4-maverick-400b-a17b) through the port's
bridge and launcher, at rtol 1e-5 / atol 1e-6 in f32 (the gradients' floor
is scaled, see below).  test_torch_transformer.py and
test_torch_train_step.py hold the MoE archs' forward and train steps.  JAX's ``moe_init`` and ``init_state`` come over by the bridge; inputs
are drawn with numpy from a seed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL, moe as jmoe, registry as jreg
from repro.optim import AdamWConfig as JAdamW
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL, moe as tmoe, registry as treg
from repro_torch.utils import tree_flatten, tree_unflatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
MOE_ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]

# The cases of tests/test_special_layers.py's MoE tests, plus a ragged B·S
# that pads the last group and one with 2D BFP on the expert weights.
# (e, k, cf, b, s, gated, shared, bfp group or None)
CASES = {
    "top2_cf2": (4, 2, 2.0, 2, 16, True, False, None),
    "ample_cf100": (4, 2, 100.0, 2, 16, True, False, None),
    "dropping_cf025": (4, 2, 0.25, 2, 16, True, False, None),
    "top1_shared": (4, 1, 1.25, 1, 8, True, True, None),
    "ungated": (4, 2, 2.0, 2, 16, False, False, None),
    "ragged_pads": (4, 2, 2.0, 3, 7, True, False, None),
    "bfp_3x3": (4, 2, 2.0, 2, 16, True, False, (3, 3)),
}


def _case(name, seed=0):
    e, k, cf, b, s, gated, shared, group = CASES[name]
    kw = dict(d_model=8, d_ff=16, n_experts=e, top_k=k, capacity_factor=cf,
              group_size=16, gated=gated, shared_expert=shared)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, 8)).astype(np.float32)
    jbfp = JL.BFPPolicy(enabled=group is not None, group=group or (3, 3))
    tbfp = TL.BFPPolicy(enabled=group is not None, group=group or (3, 3))
    return (jcfg, jbfp), (tcfg, tbfp), params, x


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_jax(name):
    (jcfg, jbfp), (tcfg, tbfp), params, x = _case(name)
    want_y, want_aux = jmoe.moe_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg,
        policy=JP32, bfp=jbfp)
    y, aux = tmoe.moe_apply(bridge.to_torch(params, "cpu"),
                            torch.from_numpy(x), tcfg, policy=TP32, bfp=tbfp)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_dropping_case_drops_and_pads_route_first():
    """The heavy-dropping case really drops (so its parity holds the slot
    assignment), and in the ragged case the padded rows take expert 0 with
    uniform gates and come after the real tokens of the last group."""
    _, (tcfg, _), params, x = _case("dropping_cf025")
    tp = bridge.to_torch(params, "cpu")
    xg, gates = tmoe.router_gates(tp, torch.from_numpy(x), tcfg, policy=TP32)
    cap = tmoe.capacity(tcfg, xg.shape[1])
    _, slot, keep, _ = tmoe.route(gates, tcfg.top_k, cap)
    assert cap == 4 and 0 < int(keep.sum()) < keep.numel()
    assert int(slot.max()) >= cap

    _, (tcfg, _), params, x = _case("ragged_pads")
    xg, gates = tmoe.router_gates(bridge.to_torch(params, "cpu"),
                                  torch.from_numpy(x), tcfg, policy=TP32)
    assert tuple(xg.shape) == (2, 16, 8)                 # 21 tokens → 32
    pad = gates.reshape(-1, tcfg.n_experts)[21:]
    torch.testing.assert_close(pad, torch.full_like(pad, 0.25))
    expert, slot, _, _ = tmoe.route(gates, tcfg.top_k, 16)
    assert bool((expert[1, 5:, 0] == 0).all())           # padded rows
    real = slot[1, :5, 0][expert[1, :5, 0] == 0].tolist()
    assert int(slot[1, 5:, 0].min()) == len(real)        # after the real ones


@pytest.mark.parametrize("name", ["top2_cf2", "dropping_cf025",
                                  "top1_shared", "ragged_pads"])
def test_moe_gradients_match_jax(name):
    """d(sum(y²) + aux) for every leaf against jax.grad; the router and the
    experts get nonzero gradients.

    These gradients reach 5-50 in magnitude, and the router's pass
    through the softmax backward, which subtracts terms of that size.  Run
    beside a float64 copy of the port, each framework's f32 gradient lies
    within about 1e-6 of the leaf's largest gradient from the float64 one
    (router/w: port 3.9e-6, JAX 4.8e-6 at a scale of 6.6), so the two differ
    by up to twice that.  The absolute floor is therefore 2e-6 of each
    leaf's largest gradient (2e-6 where that is below 1); rtol stays 1e-5.
    """
    (jcfg, jbfp), (tcfg, tbfp), params, x = _case(name)

    def jloss(p):
        y, aux = jmoe.moe_apply(p, jnp.asarray(x), jcfg, policy=JP32,
                                bfp=jbfp)
        return jnp.sum(y ** 2) + aux

    want = dict(tree_flatten(jax.tree_util.tree_map(
        np.asarray, jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray,
                                                           params)))))
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    y, aux = tmoe.moe_apply(tree_unflatten(list(zip(paths, leaves))),
                            torch.from_numpy(x), tcfg, policy=TP32, bfp=tbfp)
    got = torch.autograd.grad(torch.sum(y ** 2) + aux, leaves)
    assert sorted(paths) == sorted(want)
    for p, g in zip(paths, got):
        scale = max(1.0, float(np.abs(want[p]).max()))
        np.testing.assert_allclose(g.numpy(), want[p], rtol=TOL["rtol"],
                                   atol=2e-6 * scale, err_msg=p)
    assert float(got[paths.index("router/w")].abs().max()) > 0
    assert float(got[paths.index("wi")].abs().max()) > 0


# ----------------------------------------------------------- bridge

def test_full_moe_state_bridges_and_returns():
    """A full-mode MoE state crosses over leaf for leaf, ``wi`` keeps its
    ``[n_rep, E, D, F]`` layout, and ``to_numpy`` gives the JAX state back."""
    jentry = jreg.get("granite-moe-1b-a400m")
    jt = jts.TrainConfig(mode="full", opt=JAdamW(weight_decay=0.0), lr=3e-3)
    st_np = jax.tree_util.tree_map(np.asarray, jts.init_state(
        jax.random.PRNGKey(1), jentry, jentry.smoke, jt, JP32))
    got = bridge.state_from_jax(st_np, "cpu")
    cfg = treg.get("granite-moe-1b-a400m").smoke
    assert tuple(got["backbone"]["stack"]["sub0"]["moe"]["wi"].shape) == \
        (cfg.n_rep, cfg.n_experts, cfg.d_model, cfg.d_ff)
    back = bridge.to_numpy(got)
    assert [p for p, _ in tree_flatten(back)] == \
        [p for p, _ in tree_flatten(st_np)]
    for (p, a), (_, b) in zip(tree_flatten(back), tree_flatten(st_np)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


# ----------------------------------------------------------- launcher

@pytest.mark.parametrize("mode", ["duplex", "full"])
def test_launcher_runs_moe_smoke_steps_on_cpu(mode):
    out = tlaunch.main(["--arch", "granite-moe-1b-a400m", "--preset",
                        "smoke", "--mode", mode, "--steps", "2", "--seq",
                        "16", "--batch", "4", "--device", "cpu"])
    report = out["report"]
    assert report.steps_run == 2
    assert all(math.isfinite(m["loss"]) for m in report.metrics_history)
    before, after = out["backbone_checksum"]
    assert (before == after) == (mode == "duplex")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_build_turns_on_flash_for_moe_duplex_only(arch):
    _, cfg, tcfg, policy = tlaunch.build(arch, "full", "duplex")
    assert cfg.use_flash and policy.compute_dtype == torch.bfloat16
    assert tcfg.backbone_dtype == torch.bfloat16 and tcfg.mode == "duplex"
    _, cfg, tcfg, _ = tlaunch.build(arch, "full", "full")
    assert not cfg.use_flash and tcfg.mode == "full"
