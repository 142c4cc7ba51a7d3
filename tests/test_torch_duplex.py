"""repro_torch.core.duplex against repro.core.duplex: pooling, causal
upsampling, and the branch's forward and gradients with BFP off and on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duplex as jdx
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.core import duplex as tdx
from repro_torch.models import layers as TL
from repro_torch.utils import tree_flatten, tree_unflatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)


def _cfgs(bfp_group, **kw):
    base = dict(n_blocks=2, d_branch=32, pool_factor=4, branch_heads=2, **kw)
    return (jdx.DuplexConfig(**base, bfp=JL.BFPPolicy(
                enabled=bfp_group is not None, group=bfp_group or (3, 3))),
            tdx.DuplexConfig(**base, bfp=TL.BFPPolicy(
                enabled=bfp_group is not None, group=bfp_group or (3, 3))))


def _setup(jcfg, d_model=48, b=2, s=32, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jdx.duplex_init(jax.random.PRNGKey(seed), jcfg, d_model))
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, s, d_model)).astype(np.float32)
    taps = rng.standard_normal((jcfg.n_blocks, b, s, d_model)).astype(
        np.float32)
    return params, emb, taps


def test_pool_seq_ragged_tail():
    x = torch.arange(10, dtype=torch.float32).reshape(1, 10, 1)
    p = tdx.pool_seq(x, 4)
    assert p.shape == (1, 3, 1)
    np.testing.assert_allclose(p[0, :, 0].numpy(), [1.5, 5.5, 8.5])
    y = np.random.default_rng(1).standard_normal((2, 13, 5)).astype(
        np.float32)
    np.testing.assert_allclose(tdx.pool_seq(torch.from_numpy(y), 4).numpy(),
                               np.asarray(jdx.pool_seq(jnp.asarray(y), 4)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [1, 4])
def test_upsample_matches_jax(r):
    y = np.random.default_rng(2).standard_normal((2, 5, 3)).astype(np.float32)
    for fn in ("upsample_causal", "upsample_full"):
        want = getattr(jdx, fn)(jnp.asarray(y), r, 18)
        got = getattr(tdx, fn)(torch.from_numpy(y), r, 18)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_causal_upsample_no_future_leak():
    """Correction at token t must not depend on tokens >= floor(t/r)*r."""
    jcfg, tcfg = _cfgs(None)
    params, emb, taps = _setup(jcfg, s=16)
    tp = bridge.to_torch(params, "cpu")
    e = torch.from_numpy(emb)
    t = torch.from_numpy(taps)
    a = tdx.duplex_apply(tp, tcfg, e, t, policy=TP32)
    e2 = e.clone()
    e2[:, -1] += 100.0
    b = tdx.duplex_apply(tp, tcfg, e2, t, policy=TP32)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(a[:, :4].detach().numpy(), 0.0)


def _jax_run(params, jcfg, emb, taps):
    def loss(p):
        out = jdx.duplex_apply(p, jcfg, jnp.asarray(emb), jnp.asarray(taps),
                               policy=JP32)
        return jnp.sum(out ** 2), out
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, g)


def _torch_run(params, tcfg, emb, taps):
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    out = tdx.duplex_apply(tree_unflatten(list(zip(paths, leaves))), tcfg,
                           torch.from_numpy(emb), torch.from_numpy(taps),
                           policy=TP32)
    grads = torch.autograd.grad(torch.sum(out ** 2), leaves)
    return out.detach().numpy(), dict(zip(paths, (g.numpy() for g in grads)))


# 1e-5 with BFP off and on.  With BFP on, a mantissa or group exponent could
# round the other way where the frameworks' float orders differ by an ulp at
# a rounding boundary; one such flip moves an operand by a whole group step
# (2^(e-4)) and would fail this test.  Products of BFP operands (5-bit
# mantissas) sum exactly in f32 whatever the order, so only the non-matmul
# ops can differ: over 40 seeds per group the forward was bit-identical and
# the gradients differed by at most 2.2e-7 (relative to max(1, |g|max)).
@pytest.mark.parametrize("group,tol", [(None, 1e-5), ((3, 3), 1e-5),
                                       ((32, 32), 1e-5)])
def test_duplex_apply_forward_and_grads_match_jax(group, tol):
    jcfg, tcfg = _cfgs(group)
    params, emb, taps = _setup(jcfg)
    want_out, want_g = _jax_run(params, jcfg, emb, taps)
    got_out, got_g = _torch_run(params, tcfg, emb, taps)
    np.testing.assert_allclose(got_out, want_out, rtol=tol, atol=tol)
    for path, w in tree_flatten(want_g):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got_g[path], w, rtol=tol,
                                   atol=tol * scale, err_msg=path)


def test_branch_params_all_receive_gradient_and_inputs_none():
    jcfg, tcfg = _cfgs(None)
    params, emb, taps = _setup(jcfg)
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    e = torch.from_numpy(emb).requires_grad_()
    t = torch.from_numpy(taps).requires_grad_()
    out = tdx.duplex_apply(tree_unflatten(list(zip(paths, leaves))), tcfg,
                           e, t, policy=TP32)
    loss = torch.sum(out[:, tcfg.pool_factor:] ** 2)
    grads = torch.autograd.grad(loss, leaves + [e, t], allow_unused=True)
    for path, g in zip(paths, grads):
        assert float(g.abs().max()) > 0, f"dead gradient at {path}"
    assert grads[-2] is None and grads[-1] is None   # inputs are detached


def test_init_structure_matches_jax():
    jcfg, tcfg = _cfgs((32, 32))
    want = jax.tree_util.tree_map(
        np.asarray, jdx.duplex_init(jax.random.PRNGKey(0), jcfg, 48))
    got = tdx.duplex_init(torch.Generator().manual_seed(0), tcfg, 48)
    assert [(p, tuple(x.shape)) for p, x in tree_flatten(got)] == \
        [(p, x.shape) for p, x in tree_flatten(want)]
