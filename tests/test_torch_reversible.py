"""repro_torch.core.reversible.ReversibleStack against the JAX package's
custom_vjp stack: forward, inversion, gradients (the tolerances of
tests/test_reversible.py), and saved tensors that do not grow with depth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.reversible import ReversibleStack as JStack
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.core.reversible import ReversibleStack as TStack
from repro_torch.models import layers as TL
from repro_torch.utils import tree_leaves

D = 16
JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)


def _jf(p, x):
    return jnp.tanh(JL.dense(p, x, policy=JP32))


def _tf(p, x):
    return torch.tanh(TL.dense(p, x, policy=TP32))


def _setup(n_blocks=4, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    params = {"f1": {"w": n(n_blocks, D, D, scale=D ** -0.5)},
              "f2": {"w": n(n_blocks, D, D, scale=D ** -0.5)}}
    x1, x2 = n(2, 8, D), n(2, 8, D)
    inj = n(n_blocks, 2, 8, D, scale=0.1)
    return params, x1, x2, inj


def _jax(params, *xs):
    return jax.tree_util.tree_map(jnp.asarray, params), \
        [jnp.asarray(x) for x in xs]


def _torch(params, *xs):
    return bridge.to_torch(params, "cpu"), [torch.from_numpy(x) for x in xs]


def test_forward_matches_jax():
    params, x1, x2, inj = _setup()
    jp, jx = _jax(params, x1, x2, inj)
    tp, tx = _torch(params, x1, x2, inj)
    w1, w2 = JStack(_jf, _jf)(jp, *jx)
    y1, y2 = TStack(_tf, _tf)(tp, *tx)
    # rtol 1e-6 as in tests/test_reversible.py; across frameworks XLA's and
    # ATen's tanh and summation order differ by a few ulp, which near zero
    # needs the atol (observed max |diff| 6e-7 on O(1) values).
    np.testing.assert_allclose(y1.numpy(), np.asarray(w1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(y2.numpy(), np.asarray(w2), rtol=1e-6,
                               atol=1e-6)


def test_inversion_recovers_inputs():
    params, x1, x2, inj = _setup()
    tp, (a, b, z) = _torch(params, x1, x2, inj)
    stack = TStack(_tf, _tf)
    y1, y2 = stack.forward_only(tp, a, b, z)
    r1, r2 = stack.invert(tp, y1, y2, z)
    np.testing.assert_allclose(r1.numpy(), x1, atol=1e-5)
    np.testing.assert_allclose(r2.numpy(), x2, atol=1e-5)


def test_no_inj_defaults_to_zero():
    params, x1, x2, _ = _setup()
    tp, (a, b) = _torch(params, x1, x2)
    stack = TStack(_tf, _tf)
    y = stack(tp, a, b)
    z = stack(tp, a, b, torch.zeros(4, 2, 8, D))
    np.testing.assert_allclose(y[0].numpy(), z[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("with_inj", [True, False])
def test_gradients_match_jax_custom_vjp(with_inj):
    params, x1, x2, inj = _setup()

    def jloss(p, a, b, z):
        y1, y2 = JStack(_jf, _jf)(p, a, b, z)
        return jnp.sum(y1 * 1.3 + y2 ** 2)

    jp, jx = _jax(params, x1, x2, inj)
    if not with_inj:
        jx[2] = jnp.zeros((4, 1, 1, 1), jnp.float32)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jp, *jx)

    tp, tx = _torch(params, x1, x2, inj)
    if not with_inj:
        tx[2] = torch.zeros(4, 1, 1, 1)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tx = [t.requires_grad_() for t in tx]
    y1, y2 = TStack(_tf, _tf)(tp, *tx)
    got = torch.autograd.grad(torch.sum(y1 * 1.3 + y2 ** 2), leaves + tx)
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def _saved_count(n_blocks):
    params, x1, x2, inj = _setup(n_blocks)
    tp, tx = _torch(params, x1, x2, inj)
    for t in tree_leaves(tp):
        t.requires_grad_()
    tx[0].requires_grad_()
    count = []

    def pack(t):
        count.append(t.shape)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y1, y2 = TStack(_tf, _tf)(tp, *tx)
    return len(count)


def test_saved_tensors_do_not_grow_with_depth():
    """The O(1) claim: no per-block activations are saved for backward."""
    assert _saved_count(2) == _saved_count(6) > 0
