"""Cross-attention and the encoder-decoder against the JAX package:
repro_torch.models.layers.attention_layer with ``kv_x``,
repro_torch.models.encdec (whisper-base) and the ``cross`` layers of
repro_torch.models.transformer (llama-3.2-vision-90b), each on its SMOKE
config, with stub frontends drawn from a numpy seed and JAX's parameters
carried over by the bridge.

Tolerances: rtol 1e-5 / atol 1e-6 for attention outputs, logits, losses,
gradients and trained leaves; the transformer's hidden state and taps at
2e-5, as for the other archs (test_torch_transformer.py).

Attention runs three ways: ``full`` (materialised scores), ``flash`` (the
port's decoder ``attn`` layers through the flash wrapper, its plain
version on the CPU; JAX without flash, which it cannot run on a CPU) and
``blockwise`` (``blockwise_threshold`` 4, 4-query and 5-key chunks on both
sides, so every layer takes the online-softmax path and neither the 12
frames, the 8 patch embeddings nor the 16 tokens tile the key chunks: the
padded keys must be masked)."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duplex as jdx
from repro.models import layers as JL, registry as jreg
from repro.optim import AdamWConfig as JAdamW, SGDConfig as JSGD
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.core import duplex as tdx
from repro_torch.models import encdec as ted, layers as TL, \
    registry as treg, transformer as ttr
from repro_torch.optim import AdamWConfig as TAdamW, SGDConfig as TSGD
from repro_torch.train import train_step as tts
from repro_torch.utils import tree_flatten, tree_unflatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-6)
HIDDEN_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["whisper-base", "llama-3.2-vision-90b"]
ATTENTION = ["full", "flash", "blockwise"]
BLOCKWISE = dict(blockwise_threshold=4, q_chunk=4, kv_chunk=5)
B, S = 2, 16


def _cfgs(arch, attention="full"):
    """(JAX config, port config) of an arch's SMOKE for one attention way;
    whisper's encoder takes the same chunks, and never flash."""
    jcfg, tcfg = jreg.get(arch).smoke, treg.get(arch).smoke
    if attention == "blockwise":
        def lower(c):
            enc = None if c.encoder is None else \
                dc.replace(c.encoder, **BLOCKWISE)
            return dc.replace(c, encoder=enc, **BLOCKWISE)
        jcfg, tcfg = lower(jcfg), lower(tcfg)
    if attention == "flash":
        tcfg = dc.replace(tcfg, use_flash=True)
    return jcfg, tcfg


def _frontend(arch, cfg, batch=B, seed=11):
    """numpy stub frontend of ``frontend_shape``'s shape, ``N(0,1)·0.1``."""
    shapes = treg.get(arch).frontend_shape(cfg, batch)
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v) * 0.1).astype(np.float32)
            for k, v in shapes.items()}


def _tokens(vocab, b=B, s=S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jax_params(arch, jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jreg.get(arch).module
                                  .init_params(jax.random.PRNGKey(seed), jcfg))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return bridge.to_torch(tree, "cpu")


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("n_kv", [2, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("attention", ["full", "blockwise"])
def test_cross_attention_layer_matches_jax(n_kv, attention):
    """Counterpart of tests/test_layers.py::test_cross_attention_no_causal:
    5 queries over 11 encoder positions, no rope, non-causal (the output at
    query 0 reads every key), against JAX's layer."""
    kw = dict(d_model=16, n_heads=2, n_kv=n_kv, head_dim=8, rope_theta=None)
    if attention == "blockwise":
        kw.update(BLOCKWISE)
    jcfg, tcfg = JL.AttnConfig(**kw), TL.AttnConfig(**kw)
    p = jax.tree_util.tree_map(np.asarray,
                               JL.attn_init(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 5, 16)).astype(np.float32)
    enc = rng.standard_normal((1, 11, 16)).astype(np.float32)
    want = JL.attention_layer(_j(p), jnp.asarray(x), jcfg, policy=JP32,
                              kv_x=jnp.asarray(enc))
    got = TL.attention_layer(bridge.to_torch(p, "cpu"), torch.from_numpy(x),
                             tcfg, policy=TP32, kv_x=torch.from_numpy(enc))
    assert tuple(got.shape) == (1, 5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # non-causal: the last key moves the first query's output
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    moved = TL.attention_layer(bridge.to_torch(p, "cpu"),
                               torch.from_numpy(x), tcfg, policy=TP32,
                               kv_x=torch.from_numpy(enc2))
    assert not torch.allclose(moved[:, 0], got[:, 0])


# ---------------------------------------------------------- whisper-base

@pytest.mark.parametrize("attention", ATTENTION)
def test_whisper_encode_forward_and_logits_match_jax(attention):
    """whisper SMOKE: ``encode`` of the stub frames, then ``forward`` with
    frames (hidden, emb and the decoder's pooled taps) and ``lm_logits``."""
    jcfg, tcfg = _cfgs("whisper-base", attention)
    params = _jax_params("whisper-base", jcfg)
    fe = _frontend("whisper-base", jcfg)
    tokens = _tokens(jcfg.vocab)
    jm = jreg.get("whisper-base").module
    idx = [0, jcfg.n_rep - 1]
    jenc = jm.encode(_j(params), jcfg, jnp.asarray(fe["frames"]),
                     policy=JP32)
    jout = jm.forward(_j(params), jcfg, jnp.asarray(tokens),
                      frontend=_j(fe), policy=JP32, collect_taps=True,
                      tap_indices=idx, tap_pool=4)
    jlogits = jm.lm_logits(_j(params), jcfg, jout["hidden"], JP32)

    tp = bridge.to_torch(params, "cpu")
    enc = ted.encode(tp, tcfg, torch.from_numpy(fe["frames"]), policy=TP32)
    assert tuple(enc.shape) == (B, jcfg.n_frontend_tokens, jcfg.d_model)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **HIDDEN_TOL)
    out = ted.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                      frontend=_t(fe), policy=TP32, collect_taps=True,
                      tap_indices=idx, tap_pool=4)
    for key in ("hidden", "emb", "taps"):
        assert tuple(out[key].shape) == jout[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   **HIDDEN_TOL, err_msg=key)
    logits = ted.lm_logits(tp, tcfg, out["hidden"], TP32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_whisper_forward_requires_frames():
    """``frontend`` is keyword-only and required, as in the reference."""
    cfg = treg.get("whisper-base").smoke
    params = ted.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="frontend"):
        ted.forward(params, cfg, tokens, policy=TP32)


# -------------------------------------------------- llama-3.2-vision-90b

@pytest.mark.parametrize("with_frontend", [True, False],
                         ids=["cross_kv", "no_frontend"])
@pytest.mark.parametrize("attention", ATTENTION)
def test_vision_forward_matches_jax(attention, with_frontend):
    """llama-3.2-vision SMOKE (4 ``attn`` + 1 ``cross`` layer) with the stub
    ``cross_kv``, and without a frontend, where the cross layer attends to
    its own input, non-causally, in both implementations."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b", attention)
    params = _jax_params("llama-3.2-vision-90b", jcfg)
    fe = _frontend("llama-3.2-vision-90b", jcfg) if with_frontend else None
    tokens = _tokens(jcfg.vocab)
    jm = jreg.get("llama-3.2-vision-90b").module
    jout = jm.forward(_j(params), jcfg, jnp.asarray(tokens),
                      frontend=None if fe is None else _j(fe), policy=JP32,
                      collect_taps=True)
    jlogits = jm.lm_logits(_j(params), jcfg, jout["hidden"], JP32)
    tp = bridge.to_torch(params, "cpu")
    out = ttr.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                      frontend=None if fe is None else _t(fe), policy=TP32,
                      collect_taps=True)
    for key in ("hidden", "emb", "taps"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   **HIDDEN_TOL, err_msg=key)
    np.testing.assert_allclose(
        ttr.lm_logits(tp, tcfg, out["hidden"], TP32).numpy(),
        np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_late_token_moves_no_earlier_state_with_a_frontend(arch):
    """With a frontend, changing token 12 of 16 leaves the hidden state at
    positions 0-11 exactly as it was: the cross layers read the stub (or
    the encoder), not their own input.  Without one, llama-3.2-vision's
    cross layer sees the future token (the reference's behaviour, mirrored
    and held against JAX above)."""
    cfg = treg.get(arch).smoke
    module = treg.get(arch).module
    params = _t(_jax_params(arch, jreg.get(arch).smoke))
    fe = _t(_frontend(arch, cfg))
    tokens = torch.from_numpy(_tokens(cfg.vocab)).long()
    late = tokens.clone()
    late[:, 12] = (late[:, 12] + 1) % cfg.vocab

    def hidden(tok, frontend):
        kw = {} if frontend is None else {"frontend": frontend}
        return module.forward(params, cfg, tok, policy=TP32, **kw)["hidden"]

    a, b = hidden(tokens, fe), hidden(late, fe)
    assert torch.equal(a[:, :12], b[:, :12])
    assert not torch.equal(a[:, 12], b[:, 12])
    if arch == "llama-3.2-vision-90b":
        leak = (hidden(tokens, None)[:, :12] - hidden(late, None)[:, :12])
        assert float(leak.abs().max()) > 0


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grad_match_jax(arch):
    """Counterpart of tests/test_arch_smoke.py::test_forward_and_grad with
    its ``_frontend``: the next-token NLL of the whole model on one batch
    with the stub frontend, and its gradient with respect to every backbone
    leaf (whisper's encoder included; its unused embedding gets zeros in
    both), against JAX's."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jreg.get(arch).module, treg.get(arch).module
    params = _jax_params(arch, jcfg)
    fe = _frontend(arch, jcfg)
    tokens = _tokens(jcfg.vocab)

    def jloss(p):
        o = jm.forward(p, jcfg, jnp.asarray(tokens), frontend=_j(fe),
                       policy=JP32)
        lp = jax.nn.log_softmax(jm.lm_logits(p, jcfg, o["hidden"], JP32), -1)
        tgt = jnp.roll(jnp.asarray(tokens), -1, axis=1)
        return -jnp.take_along_axis(lp, tgt[..., None], -1).mean()

    want, want_g = jax.value_and_grad(jloss)(_j(params))
    paths, leaves = zip(*tree_flatten(bridge.to_torch(params, "cpu")))
    leaves = [t.requires_grad_() for t in leaves]
    p = tree_unflatten(list(zip(paths, leaves)))
    tok = torch.from_numpy(tokens).long()
    o = tm.forward(p, tcfg, tok, frontend=_t(fe), policy=TP32)
    lp = torch.log_softmax(tm.lm_logits(p, tcfg, o["hidden"], TP32), -1)
    loss = -torch.gather(lp, -1, torch.roll(tok, -1, 1)[..., None]).mean()
    got_g = dict(zip(paths, torch.autograd.grad(loss, leaves,
                                                materialize_grads=True)))
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    wflat = tree_flatten(jax.tree_util.tree_map(np.asarray, want_g))
    assert sorted(got_g) == [path for path, _ in wflat]
    for path, w in wflat:
        np.testing.assert_allclose(got_g[path].numpy(), w, **TOL,
                                   err_msg=path)
    cross = "decoder/stack/sub1/attn/wk/w" if arch == "whisper-base" else \
        "stack/sub4/attn/wk/w"
    assert float(np.abs(dict(wflat)[cross]).max()) > 0


# ---------------------------------------------------------- train steps

def _configs(arch, opt="sgd", mode="duplex", microbatch=1, lr=1e-2,
             **opt_kw):
    dkw = dict(n_blocks=2, d_branch=16, pool_factor=4, branch_heads=2)
    jd = jdx.DuplexConfig(**dkw, bfp=JL.BFPPolicy(enabled=False))
    td = tdx.DuplexConfig(**dkw, bfp=TL.BFPPolicy(enabled=False))
    jo, to = (JSGD(**opt_kw), TSGD(**opt_kw)) if opt == "sgd" else \
        (JAdamW(**opt_kw), TAdamW(**opt_kw))
    jt = jts.TrainConfig(mode=mode, duplex=jd, opt=jo, lr=lr,
                         microbatch=microbatch, backbone_dtype=jnp.float32)
    tt = tts.TrainConfig(mode=mode, duplex=td, opt=to, lr=lr,
                         microbatch=microbatch, backbone_dtype=torch.float32)
    jentry, tentry = jreg.get(arch), treg.get(arch)
    tcfg = dc.replace(tentry.smoke, use_flash=mode == "duplex")
    return (jentry, jentry.smoke, jt), (tentry, tcfg, tt)


def _batch(arch, cfg, b=4, seed=0):
    tokens = _tokens(cfg.vocab, b=b, seed=seed)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
            "frontend": _frontend(arch, cfg, batch=b, seed=seed + 100)}


def _jax_state(jside, seed=0):
    jentry, jcfg, jt = jside
    st = jax.jit(lambda key: jts.init_state(key, jentry, jcfg, jt, JP32))(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, st)


def _jax_steps(jside, state_np, batch, n):
    jentry, jcfg, jt = jside
    step = jax.jit(jts.make_train_step(jentry, jcfg, jt, JP32))
    st, losses = _j(state_np), []
    for _ in range(n):
        st, m = step(st, _j(batch))
        losses.append(float(m["loss"]))
    return jax.tree_util.tree_map(np.asarray, st), losses


def _torch_batch(batch):
    out = {k: torch.from_numpy(batch[k]).long() for k in ("tokens", "labels")}
    out["frontend"] = _t(batch["frontend"])
    return out


def _torch_steps(tside, state, batch, n):
    tentry, tcfg, tt = tside
    step = tts.make_train_step(tentry, tcfg, tt, TP32)
    tb, losses = _torch_batch(batch), []
    for _ in range(n):
        state, m = step(state, tb)
        losses.append(float(m["loss"]))
    return state, losses


def _assert_leaves_close(got, want_np, keys):
    gflat = tree_flatten(bridge.to_numpy({k: got[k] for k in keys}))
    wflat = tree_flatten({k: want_np[k] for k in keys})
    assert [p for p, _ in gflat] == [p for p, _ in wflat]
    for (path, g), (_, w) in zip(gflat, wflat):
        np.testing.assert_allclose(g, w, **TOL, err_msg=path)


@pytest.mark.parametrize("mode", ["duplex", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_steps_with_a_frontend_match_jax(arch, mode):
    """3 SGD steps from one bridged init, the stub frontend in every batch:
    each loss, then the trainable and optimizer leaves.  Duplex keeps the
    backbone (encoder and decoder) exactly as it came over; full trains
    it, the cross layers' key projections included."""
    jside, tside = _configs(arch, mode=mode)
    st_np = _jax_state(jside, seed=4)
    batch = _batch(arch, jside[1], seed=4)
    want_state, want_losses = _jax_steps(jside, st_np, batch, 3)
    got_state, losses = _torch_steps(
        tside, bridge.state_from_jax(st_np, "cpu"), batch, 3)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    trainable = "branch" if mode == "duplex" else "backbone"
    _assert_leaves_close(got_state, want_state, (trainable, "opt", "step"))
    got, init = (dict(tree_flatten(t)) for t in (
        bridge.to_numpy(got_state["backbone"]), st_np["backbone"]))
    if mode == "duplex":
        for p, a in got.items():
            np.testing.assert_array_equal(a, init[p], err_msg=p)
    else:
        cross = "decoder/stack/sub1/attn/wk/w" if arch == "whisper-base" \
            else "stack/sub4/attn/wk/w"
        assert not np.array_equal(got[cross], init[cross])


def test_duplex_adamw_on_encdec_backbone_matches_jax():
    """Counterpart of tests/test_train_step.py::test_duplex_on_encdec_backbone:
    6 AdamW duplex steps on whisper SMOKE with frames, from one bridged
    init; each loss equal to JAX's, all finite."""
    jside, tside = _configs("whisper-base", "adamw", lr=3e-3,
                            weight_decay=0.0)
    st_np = _jax_state(jside, seed=4)
    batch = _batch("whisper-base", jside[1], seed=5)
    _, want_losses = _jax_steps(jside, st_np, batch, 6)
    _, losses = _torch_steps(tside, bridge.state_from_jax(st_np, "cpu"),
                             batch, 6)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("mode", ["duplex", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_with_a_frontend_matches_fullbatch_and_jax(arch, mode):
    """``microbatch=2`` splits the frontend along its batch axis with the
    tokens: the same step as the whole batch, and as JAX's microbatched
    step (loss and trainable leaves)."""
    base = dict(momentum=0.0, weight_decay=0.0, clip_norm=None)
    _, t1 = _configs(arch, mode=mode, **base)
    jside, t2 = _configs(arch, mode=mode, microbatch=2, **base)
    st_np = _jax_state(jside, seed=5)
    batch = _batch(arch, jside[1], b=8, seed=5)
    s1, (l1,) = _torch_steps(t1, bridge.state_from_jax(st_np, "cpu"),
                             batch, 1)
    s2, (l2,) = _torch_steps(t2, bridge.state_from_jax(st_np, "cpu"),
                             batch, 1)
    trainable = "branch" if mode == "duplex" else "backbone"
    np.testing.assert_allclose(l2, l1, **TOL)
    for (p, a), (_, b) in zip(tree_flatten(s1[trainable]),
                              tree_flatten(s2[trainable])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL, err_msg=p)
    want_state, (want_loss,) = _jax_steps(jside, st_np, batch, 1)
    np.testing.assert_allclose(l2, want_loss, **TOL)
    _assert_leaves_close(s2, want_state, (trainable, "opt", "step"))


@pytest.mark.parametrize("mode", ["duplex", "full"])
def test_whisper_state_bridges_leaf_for_leaf(mode):
    """The bridge needs no change for the enc-dec tree: a JAX whisper state
    (duplex with a bf16 backbone, as the launcher stores it; full in f32)
    crosses over value for value, ``encoder`` and ``decoder`` subtrees
    included, with the structure and dtypes of the port's own init."""
    (je, jc, jt), (te, tc, tt) = _configs("whisper-base", mode=mode)
    if mode == "duplex":
        jt = dc.replace(jt, backbone_dtype=jnp.bfloat16)
        tt = dc.replace(tt, backbone_dtype=torch.bfloat16)
    st_np = _jax_state((je, jc, jt))
    bridged = bridge.state_from_jax(st_np, "cpu")
    own = tts.init_state(torch.Generator().manual_seed(0), te, tc, tt, TP32)
    sig = lambda s: [(p, tuple(x.shape), x.dtype) for p, x in tree_flatten(s)]
    assert sig(bridged) == sig(own)
    assert set(own["backbone"]) == {"encoder", "decoder"}
    assert own["backbone"]["encoder"]["embed"]["table"].shape == (16, 32)
    for (p, got), (_, want) in zip(tree_flatten(bridge.to_numpy(bridged)),
                                   tree_flatten(st_np)):
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype),
                                      err_msg=p)
