"""repro_torch.models.layers against repro.models.layers at 2e-5 (f32):
the same numpy inputs and params go through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-5, atol=2e-5)
JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(kw or TOL))


@pytest.mark.parametrize("bfp", [None, (3, 3), (32, 32)])
@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias, bfp):
    rng = _rng(0)
    p = {"w": _n(rng, 40, 24, scale=0.2)}
    if bias:
        p["b"] = _n(rng, 24)
    x = _n(rng, 2, 9, 40)
    jb = JL.BFPPolicy(enabled=bfp is not None, group=bfp or (3, 3))
    tb = TL.BFPPolicy(enabled=bfp is not None, group=bfp or (3, 3))
    want = JL.dense(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                    policy=JP32, bfp=jb)
    got = TL.dense(bridge.to_torch(p, "cpu"), _t(x), policy=TP32, bfp=tb)
    _close(got, want)


def test_norms():
    rng = _rng(1)
    x = _n(rng, 2, 5, 16, scale=3.0)
    p = {"scale": _n(rng, 16), "bias": _n(rng, 16)}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), bridge.to_torch(p, "cpu")
    _close(TL.rmsnorm(tp, _t(x)), JL.rmsnorm(jp, jnp.asarray(x)))
    _close(TL.layernorm(tp, _t(x)), JL.layernorm(jp, jnp.asarray(x)))
    xb = _t(x).to(torch.bfloat16)
    assert TL.rmsnorm(tp, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = _rng(2)
    x = _n(rng, 2, 12, 3, 16)
    pos = np.broadcast_to(np.arange(12) + 5, (2, 12)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(_t(x), _t(pos).long(), theta)
    _close(got, want)


def test_expand_kv_is_repeat_interleave():
    rng = _rng(3)
    k = _n(rng, 2, 5, 3, 4)
    want = JL.expand_kv(jnp.asarray(k), 4)
    got = TL.expand_kv(_t(k), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # query head h reads kv head h // g
    np.testing.assert_array_equal(got[:, :, 5].numpy(), k[:, :, 1])


def _qkv(seed, b, sq, skv, h, kv, d):
    rng = _rng(seed)
    return _n(rng, b, sq, h, d), _n(rng, b, skv, kv, d), _n(rng, b, skv, kv, d)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None), (True, 5, None),
    (True, None, 2.0)])
def test_full_attention(causal, window, softcap):
    q, k, v = _qkv(4, 2, 12, 12, 4, 2, 8)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = JL.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    _close(TL.full_attention(_t(q), _t(k), _t(v), **kw), want)


@pytest.mark.parametrize("sq,causal,window,skip", [
    (32, True, None, False),      # aligned, causal
    (32, True, None, True),       # causal skip
    (27, True, None, False),      # unaligned: padding path
    (32, True, 6, False),         # windowed
    (29, True, 6, True),          # windowed + skip + unaligned
    (24, False, None, False),     # non-causal
])
def test_blockwise_attention(sq, causal, window, skip):
    q, k, v = _qkv(5, 2, sq, sq, 4, 2, 8)
    kw = dict(causal=causal, window=window, q_chunk=8, kv_chunk=16,
              causal_skip=skip)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    _close(TL.blockwise_attention(_t(q), _t(k), _t(v), **kw), want)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_unembed_logits_masks_padded_rows(softcap):
    rng = _rng(6)
    p = {"table": _n(rng, 48, 16, scale=0.1)}
    x = _n(rng, 2, 3, 16)
    want = JL.unembed_logits(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x), 40, JP32, softcap=softcap)
    got = TL.unembed_logits(bridge.to_torch(p, "cpu"), _t(x), 40, TP32,
                            softcap=softcap)
    _close(got, want)
    assert float(got[..., 40:].max()) == float(np.float32(-1e30))


def test_embed_lookup():
    rng = _rng(7)
    p = {"table": _n(rng, 48, 16)}
    tok = rng.integers(0, 48, (2, 5)).astype(np.int32)
    want = JL.embed_lookup(jax.tree_util.tree_map(jnp.asarray, p),
                           jnp.asarray(tok), JP32)
    np.testing.assert_array_equal(
        TL.embed_lookup(bridge.to_torch(p, "cpu"), _t(tok).long(),
                        TP32).numpy(),
        np.asarray(want))


def _mlp_params(rng, d, f, gated):
    p = {"wi": {"w": _n(rng, d, f, scale=0.2)},
         "wo": {"w": _n(rng, f, d, scale=0.2)}}
    if gated:
        p["wg"] = {"w": _n(rng, d, f, scale=0.2)}
    return p


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_mlp(gated, act):
    rng = _rng(8)
    p = _mlp_params(rng, 16, 40, gated)
    x = _n(rng, 2, 6, 16)
    jact = jax.nn.silu if act == "silu" else jax.nn.gelu
    tact = F.silu if act == "silu" else TL.gelu_tanh
    want = JL.mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                  policy=JP32, act=jact)
    got = TL.mlp(bridge.to_torch(p, "cpu"), _t(x), policy=TP32, act=tact)
    _close(got, want)


def _attn_params(rng, d, h, kv, hd, bias):
    def lin(i, o):
        p = {"w": _n(rng, i, o, scale=i ** -0.5)}
        if bias:
            p["b"] = _n(rng, o, scale=0.1)
        return p
    return {"wq": lin(d, h * hd), "wk": lin(d, kv * hd), "wv": lin(d, kv * hd),
            "wo": {"w": _n(rng, h * hd, d, scale=(h * hd) ** -0.5)}}


BASE = dict(d_model=32, n_heads=4, n_kv=2, head_dim=8, q_chunk=16,
            kv_chunk=16)


@pytest.mark.parametrize("branch", ["full", "blockwise", "flash"])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_layer_branches(branch, bias):
    """All three branches of attention_layer; the flash branch is held
    against JAX's flash path in interpret mode."""
    rng = _rng(9)
    p = _attn_params(rng, 32, 4, 2, 8, bias)
    x = _n(rng, 2, 64, 32)
    thr = 8 if branch == "blockwise" else 1024
    jcfg = JL.AttnConfig(**BASE, qkv_bias=bias, blockwise_threshold=thr,
                         use_flash=branch == "flash", flash_interpret=True)
    tcfg = TL.AttnConfig(**BASE, qkv_bias=bias, blockwise_threshold=thr,
                         use_flash=branch == "flash")
    want = JL.attention_layer(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jcfg, policy=JP32)
    got = TL.attention_layer(bridge.to_torch(p, "cpu"), _t(x), tcfg,
                             policy=TP32)
    _close(got, want)


def test_attention_layer_flash_matches_unfused_port():
    rng = _rng(10)
    p = bridge.to_torch(_attn_params(rng, 32, 4, 2, 8, False), "cpu")
    x = _t(_n(rng, 2, 48, 32))
    ref = TL.attention_layer(p, x, TL.AttnConfig(**BASE), policy=TP32)
    got = TL.attention_layer(p, x, TL.AttnConfig(**BASE, use_flash=True),
                             policy=TP32)
    _close(got, ref.numpy())


def test_attention_layer_bfp_matches_jax():
    rng = _rng(11)
    p = _attn_params(rng, 32, 4, 2, 8, False)
    x = _n(rng, 2, 16, 32)
    jcfg = JL.AttnConfig(**BASE)
    tcfg = TL.AttnConfig(**BASE)
    want = JL.attention_layer(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jcfg, policy=JP32,
                              bfp=JL.BFPPolicy(enabled=True, group=(3, 3)))
    got = TL.attention_layer(bridge.to_torch(p, "cpu"), _t(x), tcfg,
                             policy=TP32,
                             bfp=TL.BFPPolicy(enabled=True, group=(3, 3)))
    _close(got, want, rtol=1e-4, atol=1e-4)
