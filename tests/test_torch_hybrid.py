"""repro_torch.models.hybrid against repro.models.hybrid (the counterpart of
tests/test_special_layers.py's RG-LRU tests): the odd-even scan against
``lax.associative_scan``; ``_rg_lru`` in its three forms (the full scan,
the chunked scan, the S=1 decode step) against JAX's at rtol 1e-5 / atol
1e-6 and against the port's step-by-step oracle; ``lru_block`` stateless
and stateful under an f32, a bf16 and a BFP policy; prefill then decode;
gradients against ``jax.grad``; the config copy.  JAX's ``lru_init`` comes
over by the bridge; inputs are drawn with numpy from a seed."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import recurrentgemma_9b as jrg
from repro.models import hybrid as jhy, layers as JL
from repro_torch import bridge
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.models import hybrid as thy, layers as TL
from repro_torch.utils import tree_flatten, tree_unflatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
# the reference tests' bounds: scan against oracle and chunked against full
# (tests/test_special_layers.py:82-124), prefill then decode (:93-105)
ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 compute: test_torch_ssm.py's bound.  Each framework rounds its own
# f32 sums to bf16, and a one-step difference in an intermediate reaches the
# output through the gate and wo.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
W = 24                                       # the reference tests' width


def _assert_grad_close(got, want, err_msg):
    """rtol 1e-5, atol 1e-6 of the leaf's scale (test_torch_ssm.py's): a
    gradient is a sum of many f32 terms, and an element near zero keeps the
    rounding of its largest terms."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=err_msg)


def _params(seed=5, d_model=16, width=W, bf16=False):
    """JAX's ``lru_init`` as numpy, and the configs of both sides."""
    kw = dict(d_model=d_model, lru_width=width)
    jcfg, tcfg = jhy.LRUConfig(**kw), thy.LRUConfig(**kw)
    p = jhy.lru_init(jax.random.PRNGKey(seed), jcfg)
    if bf16:      # the duplex backbone's storage: every leaf in bf16
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
    return jcfg, tcfg, jax.tree_util.tree_map(np.asarray, p)


def _jp(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _n(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _sig(tree):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree_flatten(tree)]


# ------------------------------------------------------------ init, config

def test_lru_init_structure_and_values():
    """Leaves, shapes and dtypes equal JAX's; stacked on ``lead`` and stored
    in ``dtype`` as ``ssm.ssd_init``; the port's own Λ gives a =
    exp(-8·softplus(Λ)) within (0.9, 0.999), and ``wr``/``wi`` carry a zero
    bias."""
    _, tcfg, want = _params()
    got = thy.lru_init(torch.Generator().manual_seed(0), tcfg)
    assert _sig(got) == _sig(want)
    stacked = thy.lru_init(torch.Generator().manual_seed(0), tcfg,
                           lead=(3,), dtype=torch.bfloat16)
    assert [(p, s) for p, s, _ in _sig(stacked)] == \
        [(p, (3, *s)) for p, s, _ in _sig(want)]
    assert all(x.dtype == torch.bfloat16 for _, x in tree_flatten(stacked))
    a = torch.exp(-8.0 * torch.nn.functional.softplus(got["lambda"]))
    assert float(a.min()) > 0.9 * (1 - 1e-5)
    assert float(a.max()) < 0.999 * (1 + 1e-6)
    for k in ("wr", "wi"):
        assert not got[k]["b"].any()
        assert 0.01 < float(got[k]["w"].std()) < 0.03


@pytest.mark.parametrize("preset", ["FULL", "SMOKE"])
def test_recurrentgemma_config_copy_matches_jax(preset):
    assert dc.asdict(getattr(trg, preset)) == dc.asdict(getattr(jrg, preset))


# ------------------------------------------------------------------ _scan

@pytest.mark.parametrize("s", [1, 2, 3, 7, 8, 64, 257])
def test_scan_matches_associative_scan(s):
    """The odd-even scan against ``lax.associative_scan`` of the
    reference's ``_combine``, both outputs, at even, odd and one lengths."""
    a = np.random.default_rng(s).uniform(0.5, 1.0, (2, s, 5)).astype(
        np.float32)
    b = _n(s + 1, 2, s, 5)
    want = lax.associative_scan(jhy._combine, (jnp.asarray(a),
                                               jnp.asarray(b)), axis=1)
    got = thy._scan(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_scan_saves_tensors_linear_in_length():
    """Autograd keeps O(S) bytes for the odd-even scan's backward: at
    S=4096 about 4x one input beyond the inputs (the halving levels sum to
    a constant share), where a doubling scan keeps O(S log S), about
    2·log2(S) = 24x."""
    a = torch.rand((2, 4096, 8)).requires_grad_()
    b = torch.randn((2, 4096, 8)).requires_grad_()
    held = {}

    def pack(t):
        held[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        thy._scan(a, b)
    for t in (a, b):
        held.pop(t.untyped_storage().data_ptr(), None)
    assert 0 < sum(held.values()) <= 5 * a.numel() * 4


# ---------------------------------------------------------------- _rg_lru

RG_CASES = [(s, h0) for s in (1, 20, 32, 33, 37) for h0 in (False, True)]


@pytest.mark.parametrize("s,with_h0", RG_CASES,
                         ids=[f"s{s}-{'h0' if h else 'zero'}"
                              for s, h in RG_CASES])
def test_rg_lru_matches_jax(s, with_h0):
    """Each length with and without a carried state: S=1 with ``h0`` is the
    decode step, S=1 without it goes through the scan."""
    _, _, params = _params()
    x = _n(6 + s, 2, s, W)
    h0 = _n(22, 2, W, scale=0.1) if with_h0 else None
    want, hf_want = jhy._rg_lru(_jp(params), jnp.asarray(x), JP32,
                                h0=None if h0 is None else jnp.asarray(h0))
    got, hf_got = thy._rg_lru(bridge.to_torch(params, "cpu"),
                              torch.from_numpy(x), TP32,
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == hf_got.dtype == torch.float32
    assert tuple(got.shape) == (2, s, W) and tuple(hf_got.shape) == (2, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf_got.numpy(), np.asarray(hf_want), **TOL)


def test_rg_lru_with_bf16_lambda_matches_jax():
    """A backbone cast to bf16 under an f32 policy: Λ's softplus runs in
    bf16, before it meets the f32 ``r``, op by op as ``jax.nn.softplus``.
    Widening Λ first moves log a by up to 0.4%, far past this bound."""
    _, _, params = _params(bf16=True)
    x, h0 = _n(40, 2, 20, W), _n(41, 2, W, scale=0.1)
    want, hf_want = jhy._rg_lru(_jp(params), jnp.asarray(x), JP32,
                                h0=jnp.asarray(h0))
    tp = bridge.to_torch(params, "cpu")
    assert tp["lambda"].dtype == torch.bfloat16
    got, hf_got = thy._rg_lru(tp, torch.from_numpy(x), TP32,
                              h0=torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf_got.numpy(), np.asarray(hf_want), **TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_rg_lru_chunked_matches_full_and_jax(chunk):
    """The chunked scan at length 37 with a carried state (ragged tails;
    64 > 37 takes the full scan) against the port's full scan at the
    reference test's 1e-5 and against JAX's chunked form."""
    _, _, params = _params(seed=20)
    x, h0 = _n(21, 2, 37, W), _n(22, 2, W, scale=0.1)
    tp, tx, th0 = bridge.to_torch(params, "cpu"), torch.from_numpy(x), \
        torch.from_numpy(h0)
    full, hf_full = thy._rg_lru(tp, tx, TP32, h0=th0)
    got, hf = thy._rg_lru(tp, tx, TP32, h0=th0, scan_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **ORACLE_TOL)
    np.testing.assert_allclose(hf.numpy(), hf_full.numpy(), **ORACLE_TOL)
    want, hf_want = jhy._rg_lru(_jp(params), jnp.asarray(x), JP32,
                                h0=jnp.asarray(h0), scan_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_want), **TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rg_lru_scan_matches_oracles(with_h0):
    """The port's scan against its step-by-step oracle (the reference
    test's 1e-5), and the port's oracle against JAX's."""
    _, _, params = _params()
    x = _n(6, 2, 20, W)
    h0 = _n(7, 2, W, scale=0.1) if with_h0 else None
    tp, tx = bridge.to_torch(params, "cpu"), torch.from_numpy(x)
    th0 = None if h0 is None else torch.from_numpy(h0)
    got, hf_got = thy._rg_lru(tp, tx, TP32, h0=th0)
    ref, hf_ref = thy.rg_lru_reference(tp, tx, TP32, h0=th0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **ORACLE_TOL)
    np.testing.assert_allclose(hf_got.numpy(), hf_ref.numpy(), **ORACLE_TOL)
    want, hf_want = jhy.rg_lru_reference(
        _jp(params), jnp.asarray(x), JP32,
        h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf_ref.numpy(), np.asarray(hf_want), **TOL)


def test_rg_lru_clamp_at_a_one_matches_jax():
    """Λ = -100 on half the channels puts a at 1 and 1 - a² under the
    clamp: √max(1 - a², 1e-12) keeps the output and its gradient (sqrt's
    derivative at 0 is infinite) finite and equal to JAX's."""
    _, _, params = _params(seed=11)
    params["lambda"] = params["lambda"].copy()
    params["lambda"][::2] = -100.0
    x = _n(12, 2, 9, W)
    jp, jx = _jp(params), jnp.asarray(x)
    want = jhy._rg_lru(jp, jx, JP32)[0]
    want_lam, want_x = jax.grad(
        lambda lam, xx: jnp.sum(jhy._rg_lru({**jp, "lambda": lam}, xx,
                                            JP32)[0] ** 2),
        argnums=(0, 1))(jp["lambda"], jx)
    tp = bridge.to_torch(params, "cpu")
    lam, tx = tp["lambda"].requires_grad_(), torch.from_numpy(x)
    tx.requires_grad_()
    y, _ = thy._rg_lru(tp, tx, TP32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(torch.sum(y ** 2), [lam, tx])
    for name, g, w in (("lambda", grads[0], want_lam), ("x", grads[1],
                                                        want_x)):
        assert torch.isfinite(g).all(), name
        _assert_grad_close(g.numpy(), np.asarray(w), name)


def test_lru_state_bounded():
    """|a| < 1 keeps the state bounded over a 500-step rollout, from the
    port's own init."""
    cfg = thy.LRUConfig(d_model=8, lru_width=8)
    params = thy.lru_init(torch.Generator().manual_seed(9), cfg)
    y, hf = thy._rg_lru(params, torch.ones((1, 500, 8)), TP32)
    assert torch.isfinite(y).all()
    assert float(hf.abs().max()) < 100.0


# -------------------------------------------------------------- lru_block

def _policies(bf16):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    return JL.Policy(compute_dtype=dt[0]), TL.Policy(compute_dtype=dt[1])


BLOCK_CASES = {"f32": (False, False), "bf16": (True, False),
               "bfp_3x3": (False, True)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_lru_block_matches_jax(case):
    """Stateless, at 16 tokens (two chunks of 8 in the chunked config).
    Under BFP, ``wx``, ``wy`` and ``wo`` quantize their operands and ``wr``
    and ``wi`` do not: quantizing those too moves the output far past
    this bound."""
    bf16, bfp = BLOCK_CASES[case]
    jcfg, tcfg, params = _params(seed=1, d_model=32, bf16=bf16)
    jpol, tpol = _policies(bf16)
    jbfp = JL.BFPPolicy(enabled=bfp, group=(3, 3))
    tbfp = TL.BFPPolicy(enabled=bfp, group=(3, 3))
    x = _n(2, 2, 16, 32)
    want, _ = jhy.lru_block(_jp(params), jnp.asarray(x).astype(
        jpol.compute_dtype), jcfg, policy=jpol, bfp=jbfp)
    got, st = thy.lru_block(bridge.to_torch(params, "cpu"),
                            torch.from_numpy(x).to(tpol.compute_dtype),
                            tcfg, policy=tpol, bfp=tbfp)
    assert st is None and got.dtype == tpol.compute_dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(BF16_TOL if bf16 else TOL))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_lru_block_stateful_matches_jax(bf16):
    """A 6-token prefill through the state, then 1-token decodes: each
    step's output, ``h`` (f32) and ``conv`` (the compute dtype) against
    JAX's."""
    jcfg, tcfg, params = _params(seed=4, d_model=32, bf16=bf16)
    jpol, tpol = _policies(bf16)
    x = _n(5, 2, 12, 32)
    jp, tp = _jp(params), bridge.to_torch(params, "cpu")
    jx = jnp.asarray(x).astype(jpol.compute_dtype)
    tx = torch.from_numpy(x).to(tpol.compute_dtype)
    jst = jhy.lru_state_init(jcfg, 2, jpol.compute_dtype)
    tst = thy.lru_state_init(tcfg, 2, tpol.compute_dtype)
    tol = BF16_TOL if bf16 else TOL
    for lo, hi in [(0, 6)] + [(t, t + 1) for t in range(6, 12)]:
        want, jst = jhy.lru_block(jp, jx[:, lo:hi], jcfg, policy=jpol,
                                  state=jst)
        got, tst = thy.lru_block(tp, tx[:, lo:hi], tcfg, policy=tpol,
                                 state=tst)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol, err_msg=f"y {lo}:{hi}")
        assert sorted(tst) == ["conv", "h"]
        for (p, g), (_, w) in zip(tree_flatten(tst), tree_flatten(jst)):
            assert g.dtype == (torch.float32 if p == "h"
                               else tpol.compute_dtype), p
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       **tol, err_msg=f"{p} {lo}:{hi}")


@pytest.mark.parametrize("prefill", [0, 6])
def test_lru_block_prefill_decode_consistent(prefill):
    """A prefill of ``prefill`` tokens through the state (none: every token
    a decode step, as the reference test) then 1-token decodes equal the
    stateless block over all 10 tokens, at the reference test's 2e-4."""
    _, tcfg, params = _params(seed=7, width=16)
    tp, x = bridge.to_torch(params, "cpu"), torch.from_numpy(_n(8, 2, 10, 16))
    full, _ = thy.lru_block(tp, x, tcfg, policy=TP32)
    st = thy.lru_state_init(tcfg, batch=2)
    outs = []
    if prefill:
        o, st = thy.lru_block(tp, x[:, :prefill], tcfg, policy=TP32,
                              state=st)
        outs.append(o)
    for t in range(prefill, 10):
        o, st = thy.lru_block(tp, x[:, t:t + 1], tcfg, policy=TP32,
                              state=st)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **DECODE_TOL)


def test_lru_state_init_matches_jax():
    """The state's leaves, shapes and dtypes are JAX's (``h`` f32 whatever
    the dtype), built where the caller asks: on ``meta`` every leaf is
    there."""
    jcfg, tcfg, _ = _params()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jst = jhy.lru_state_init(jcfg, 3, jdt)
        tst = thy.lru_state_init(tcfg, 3, tdt, device="meta")
        assert _sig(tst) == _sig(jax.tree_util.tree_map(np.asarray, jst))
        assert all(a.device.type == "meta" for _, a in tree_flatten(tst))


@pytest.mark.parametrize("chunk", [None, 4], ids=["full", "chunk4"])
def test_lru_block_gradient_matches_jax(chunk):
    """d/dparams of sum(y²), leaf for leaf, and d/dx, against jax.grad,
    through the full scan and through the chunked one (13 tokens: a
    ragged last chunk)."""
    kw = dict(d_model=16, lru_width=W, scan_chunk=chunk)
    jcfg, tcfg = jhy.LRUConfig(**kw), thy.LRUConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jhy.lru_init(jax.random.PRNGKey(3), jcfg))
    x = _n(4, 2, 13, 16)

    def jloss(p, xx):
        return jnp.sum(jhy.lru_block(p, xx, jcfg, policy=JP32)[0] ** 2)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        _jp(params), jnp.asarray(x))
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = thy.lru_block(tree_unflatten(list(zip(paths, leaves))), tx, tcfg,
                         policy=TP32)
    grads = torch.autograd.grad(torch.sum(y ** 2), [*leaves, tx])
    got = dict(zip(paths, grads[:-1]))
    for path, w in tree_flatten(jax.tree_util.tree_map(np.asarray, want_p)):
        assert np.all(np.isfinite(w)) and np.abs(w).max() > 0, path
        _assert_grad_close(got[path].numpy(), w, path)
    _assert_grad_close(grads[-1].numpy(), np.asarray(want_x), "x")
