"""repro_torch.models.ssm against repro.models.ssm (the counterpart of
tests/test_special_layers.py's SSD tests): the chunked scan against JAX's at
rtol 1e-5 / atol 1e-6 and against the port's recurrent oracle at 1e-4 (the
reference tests' bound); the causal conv; ``ssd_block`` stateless and
stateful under an f32 and a bf16 compute policy; its gradient against
``jax.grad``.  JAX's ``ssd_init`` comes over by the bridge; inputs are drawn
with numpy from a seed.  Two router groups (``g=2``) hold the head-to-group
mapping: head h reads group h // (H/G), as ``jnp.repeat`` gives it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL, ssm as jssm
from repro_torch import bridge
from repro_torch.models import layers as TL, ssm as tssm
from repro_torch.utils import tree_flatten, tree_unflatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 compute: the bound of the port's other bf16 parity tests
# (test_torch_flash.py).  Each framework rounds its own f32 sums to bf16, and
# a one-step difference in an intermediate reaches the output through the
# norm and out_proj: measured up to 0.0156 (one step at |y| in [2, 4)).
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _assert_grad_close(got, want, err_msg):
    """rtol 1e-5, atol 1e-6 of the leaf's scale: a gradient is a sum of
    many f32 terms, and an element near zero keeps the rounding of its
    largest terms (measured: 1.4e-6 at a scale of 2.3, x_proj/w)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=err_msg)


def _ssd_inputs(seed=0, b=2, s=32, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(f32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(f32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(f32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (sequence length, chunk): chunks 4, 8, 32 and 64 at the reference tests'
# length 32 (64 > 32: the chunk shrinks to the sequence); a length that is
# not a multiple of the chunk (padded); one chunk longer than the sequence
CHUNK_CASES = {"chunk4": (32, 4), "chunk8": (32, 8), "chunk32": (32, 32),
               "chunk64": (32, 64), "ragged27_chunk8": (27, 8),
               "short5_chunk8": (5, 8)}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_ssd_chunked_matches_jax_and_oracle(case):
    s, chunk = CHUNK_CASES[case]
    inputs = _ssd_inputs(s=s)
    want, hf_want = jssm._ssd_chunked(*_j(*inputs), chunk)
    got, hf_got = tssm._ssd_chunked(*_t(*inputs), chunk)
    assert tuple(got.shape) == inputs[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf_got.numpy(), np.asarray(hf_want), **TOL)
    ref, hf_ref = tssm.ssd_reference(*_t(*inputs))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **ORACLE_TOL)
    np.testing.assert_allclose(hf_got.numpy(), hf_ref.numpy(), **ORACLE_TOL)


def test_ssd_reference_matches_jax_oracle():
    inputs = _ssd_inputs(seed=1, s=12)
    want, hf_want = jssm.ssd_reference(*_j(*inputs))
    got, hf_got = tssm.ssd_reference(*_t(*inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf_got.numpy(), np.asarray(hf_want), **TOL)


def test_group_mapping_is_repeat_not_tile():
    """With g=2 the two mappings of heads to groups differ: the port's
    result is the oracle's with B and C repeated per head (h // 2), and
    not the one with them tiled (h % 2)."""
    x, dt, A, B, C = _t(*_ssd_inputs(seed=2, s=16))
    got, _ = tssm._ssd_chunked(x, dt, A, B, C, 8)
    tiled = lambda t: t.repeat(1, 1, 2, 1)       # per head: g0 g1 g0 g1
    want, _ = tssm.ssd_reference(x, dt, A, B, C)
    other, _ = tssm.ssd_reference(x, dt, A, tiled(B), tiled(C))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ORACLE_TOL)
    assert not np.allclose(got.numpy(), other.numpy(), rtol=1e-2, atol=1e-2)


def test_ssd_prefill_then_decode_consistent():
    """Running [0:24] chunked then 8 single-step decodes == full prefill,
    and each piece equals JAX's on the same pieces."""
    x, dt, A, B, C = _ssd_inputs(s=32)
    tx, tdt, tA, tB, tC = _t(x, dt, A, B, C)
    full, hf = tssm._ssd_chunked(tx, tdt, tA, tB, tC, chunk=8)
    y_pre, h = tssm._ssd_chunked(tx[:, :24], tdt[:, :24], tA, tB[:, :24],
                                 tC[:, :24], chunk=8)
    jy, jh = jssm._ssd_chunked(*_j(x[:, :24], dt[:, :24], A, B[:, :24],
                                   C[:, :24]), chunk=8)
    outs, jouts = [y_pre], [np.asarray(jy)]
    for t in range(24, 32):
        sl = slice(t, t + 1)
        y_t, h = tssm._ssd_chunked(tx[:, sl], tdt[:, sl], tA, tB[:, sl],
                                   tC[:, sl], chunk=8, h0=h)
        jy, jh = jssm._ssd_chunked(*_j(x[:, sl], dt[:, sl], A, B[:, sl],
                                       C[:, sl]), chunk=8, h0=jh)
        outs.append(y_t)
        jouts.append(np.asarray(jy))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    got = torch.cat(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **ORACLE_TOL)
    np.testing.assert_allclose(h.numpy(), hf.numpy(), **ORACLE_TOL)
    np.testing.assert_allclose(got.numpy(), np.concatenate(jouts, 1), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    want, wst = jssm._causal_conv(*_j(x, w, b), None if st is None
                                  else jnp.asarray(st))
    got, gst = tssm._causal_conv(*_t(x, w, b), None if st is None
                                 else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


# ------------------------------------------------------------ ssd_block

CFG = dict(d_model=32, d_state=16, headdim=8, expand=2, chunk=8)


def _block(n_groups=1, seed=1, bf16=False, **kw):
    jcfg = jssm.SSDConfig(**CFG, n_groups=n_groups, **kw)
    tcfg = tssm.SSDConfig(**CFG, n_groups=n_groups, **kw)
    params = jssm.ssd_init(jax.random.PRNGKey(seed), jcfg)
    if bf16:      # the duplex backbone's storage: every leaf in bf16
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                        params)
    return jcfg, tcfg, jax.tree_util.tree_map(np.asarray, params)


def _policies(bf16):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    return JL.Policy(compute_dtype=dt[0]), TL.Policy(compute_dtype=dt[1])


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def test_ssd_init_structure_and_values():
    """Leaves and shapes equal JAX's, stacked on ``lead`` as the transformer
    stacks them; ``dt_bias`` inverts softplus over [dt_min, dt_max];
    A = -1 and D = 1 per head."""
    jcfg, tcfg, want = _block()
    sig = lambda t: [(p, tuple(x.shape)) for p, x in tree_flatten(t)]
    got = tssm.ssd_init(torch.Generator().manual_seed(0), tcfg)
    assert sig(got) == sig(want)
    stacked = tssm.ssd_init(torch.Generator().manual_seed(0), tcfg,
                            lead=(3,), dtype=torch.bfloat16)
    assert sig(stacked) == [(p, (3, *s)) for p, s in sig(want)]
    assert all(x.dtype == torch.bfloat16 for _, x in tree_flatten(stacked))
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= tcfg.dt_min * (1 - 1e-5)
    assert float(dt.max()) <= tcfg.dt_max * (1 + 1e-5)
    assert torch.equal(got["A_log"], torch.zeros(tcfg.n_heads))
    assert torch.equal(got["D"], torch.ones(tcfg.n_heads))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_ssd_block_matches_jax(n_groups, bf16):
    jcfg, tcfg, params = _block(n_groups, bf16=bf16)
    jpol, tpol = _policies(bf16)
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jpol.compute_dtype)
    want, _ = jssm.ssd_block(jax.tree_util.tree_map(jnp.asarray, params), jx,
                             jcfg, policy=jpol)
    got, st = tssm.ssd_block(bridge.to_torch(params, "cpu"),
                             torch.from_numpy(x).to(tpol.compute_dtype),
                             tcfg, policy=tpol)
    assert st is None and got.dtype == tpol.compute_dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(BF16_TOL if bf16 else TOL))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ssd_block_stateful_matches_jax(bf16):
    """A 6-token prefill through the state, then 1-token decodes: each
    step's output, ``h`` and the three conv states against JAX's; in f32 the
    decodes together equal the stateless block (the reference test's
    2e-3)."""
    jcfg, tcfg, params = _block(2, seed=4, bf16=bf16)
    jpol, tpol = _policies(bf16)
    x = np.random.default_rng(5).standard_normal((2, 12, 32)).astype(
        np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.to_torch(params, "cpu")
    jx = jnp.asarray(x).astype(jpol.compute_dtype)
    tx = torch.from_numpy(x).to(tpol.compute_dtype)
    jst = jssm.ssd_state_init(jcfg, 2, jpol.compute_dtype)
    tst = tssm.ssd_state_init(tcfg, 2, tpol.compute_dtype)
    assert [(p, tuple(a.shape)) for p, a in tree_flatten(tst)] == \
        [(p, a.shape) for p, a in tree_flatten(jst)]
    tol = BF16_TOL if bf16 else TOL
    outs = []
    for lo, hi in [(0, 6)] + [(t, t + 1) for t in range(6, 12)]:
        want, jst = jssm.ssd_block(jp, jx[:, lo:hi], jcfg, policy=jpol,
                                   state=jst)
        got, tst = tssm.ssd_block(tp, tx[:, lo:hi], tcfg, policy=tpol,
                                  state=tst)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol, err_msg=f"y {lo}:{hi}")
        for (p, g), (_, w) in zip(tree_flatten(tst), tree_flatten(jst)):
            assert g.dtype == (torch.float32 if p == "h"
                               else tpol.compute_dtype), p
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       **tol, err_msg=f"{p} {lo}:{hi}")
        outs.append(got)
    if not bf16:
        full, _ = tssm.ssd_block(tp, tx, tcfg, policy=tpol)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_ssd_state_init_takes_a_device():
    """The state is built where the caller asks (a CUDA decode's on the
    card): on the ``meta`` device every leaf is there, with JAX's shapes and
    dtypes."""
    jcfg, tcfg, _ = _block(2, seed=4, bf16=True)
    jst = jssm.ssd_state_init(jcfg, 3, jnp.bfloat16)
    tst = tssm.ssd_state_init(tcfg, 3, torch.bfloat16, device="meta")
    assert [(p, tuple(a.shape), str(a.dtype)) for p, a in tree_flatten(tst)]\
        == [(p, a.shape, "torch." + str(a.dtype)) for p, a in
            tree_flatten(jst)]
    assert all(a.device.type == "meta" for _, a in tree_flatten(tst))


def test_ssd_block_gradient_matches_jax():
    """d/dparams of sum(y²), leaf for leaf, and d/dx, against jax.grad."""
    kw = dict(d_model=16, d_state=8, headdim=8, expand=2, chunk=4,
              n_groups=2)
    jcfg, tcfg = jssm.SSDConfig(**kw), tssm.SSDConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jssm.ssd_init(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(4).standard_normal((1, 12, 16)).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.ssd_block(p, xx, jcfg, policy=JP32)[0] ** 2)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = tssm.ssd_block(tree_unflatten(list(zip(paths, leaves))), tx, tcfg,
                          policy=TP32)
    grads = torch.autograd.grad(torch.sum(y ** 2), [*leaves, tx])
    got = dict(zip(paths, grads[:-1]))
    for path, w in tree_flatten(jax.tree_util.tree_map(np.asarray, want_p)):
        assert np.all(np.isfinite(w)) and np.abs(w).max() > 0, path
        _assert_grad_close(got[path].numpy(), w, path)
    _assert_grad_close(grads[-1].numpy(), np.asarray(want_x), "x")


@pytest.mark.parametrize("dt_scale", [1.0, 40.0])
def test_scan_gradient_matches_jax(dt_scale):
    """The gradient of sum(y²) through the chunked scan alone.  At 40x the
    step sizes, exp(li - lj) overflows above the diagonal: the forward stays
    finite (the mask drops it after the exp), and the gradient of dt and A
    is NaN in both, since the masked entries' zero cotangent meets exp's
    infinite derivative, as in the reference; x, B and C stay finite and
    equal."""
    x, dt, A, B, C = _ssd_inputs(seed=6, s=16)
    dt = dt * np.float32(dt_scale)
    fn = lambda *a: jnp.sum(jssm._ssd_chunked(*a, 16)[0] ** 2)
    want = jax.jit(jax.grad(fn, argnums=(0, 1, 2, 3, 4)))(
        *_j(x, dt, A, B, C))
    ts = [t.requires_grad_() for t in _t(x, dt, A, B, C)]
    y, _ = tssm._ssd_chunked(*ts, 16)
    assert torch.isfinite(y).all()
    got = torch.autograd.grad(torch.sum(y ** 2), ts)
    for name, g, w in zip("x dt A B C".split(), got, want):
        w = np.asarray(w)
        finite = dt_scale == 1.0 or name in "xBC"
        assert np.isfinite(w).all() == finite, name
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w),
                                      err_msg=name)
        if finite:
            _assert_grad_close(g.numpy(), w, name)
