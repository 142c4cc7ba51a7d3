"""repro_torch.models.transformer against repro.models.transformer at 2e-5
(the MoE aux loss at rtol 1e-5 / atol 1e-6) on the granite, qwen2,
granite-moe, llama4, gemma2, starcoder2, mamba2 and recurrentgemma smoke
configs (the frontend archs, whisper-base and llama-3.2-vision-90b, are
held in test_torch_encdec.py; their init structure and configs here).
gemma2 alternates sliding-window ``local`` layers with global ``attn``
layers (softcaps, post-norms, gelu, embedding scale); starcoder2 has
layernorm, qkv bias and an ungated gelu MLP; mamba2 is attention-free
(``ssd`` layers with no channel mixer); recurrentgemma repeats (``lru``,
``lru``, ``local``) with an (``lru``, ``lru``) remainder, MQA and a window
of 8, shorter than the 16-token inputs.

The port runs with ``use_flash`` on and off; both are held against JAX with
``use_flash=False``: JAX's transformer cannot run its flash path on a CPU
(``attn_cfg_for`` does not pass ``flash_interpret``).  The flash layer itself
is held against JAX's flash path in interpret mode in test_torch_layers.py."""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL, registry as jreg, transformer as jtr
from repro_torch import bridge
from repro_torch.models import layers as TL, registry as treg, \
    transformer as ttr
from repro_torch.utils import tree_flatten

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
TOL = dict(rtol=2e-5, atol=2e-5)
AUX_TOL = dict(rtol=1e-5, atol=1e-6)   # the stack-summed MoE aux loss
ARCHS = ["granite-3-8b", "qwen2-72b", "granite-moe-1b-a400m",
         "llama4-maverick-400b-a17b", "gemma2-9b", "starcoder2-7b",
         "mamba2-780m", "recurrentgemma-9b"]
# with the frontend archs, whose forward takes a stub frontend
# (test_torch_encdec.py holds it); whisper's params are enc-dec
ALL_ARCHS = ARCHS + ["whisper-base", "llama-3.2-vision-90b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    jcfg = jreg.get(name).smoke
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    idx = [0, jcfg.n_rep - 1]

    @jax.jit
    def run(p, tok):
        out = jtr.forward(p, jcfg, tok, policy=JP32, collect_taps=True,
                          tap_indices=idx, tap_pool=4)
        return out, jtr.lm_logits(p, jcfg, out["hidden"], JP32)

    out, logits = run(jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(tokens))
    want = {k: np.asarray(v) for k, v in out.items() if v is not None}
    want["logits"] = np.asarray(logits)
    return name, params, tokens, idx, want


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_and_logits_match_jax(model, use_flash):
    name, params, tokens, idx, want = model
    cfg = dc.replace(treg.get(name).smoke, use_flash=use_flash)
    tp = bridge.to_torch(params, "cpu")
    out = ttr.forward(tp, cfg, torch.from_numpy(tokens).long(), policy=TP32,
                      collect_taps=True, tap_indices=idx, tap_pool=4)
    for key in ("hidden", "emb", "taps", "aux"):
        assert tuple(out[key].shape) == want[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), want[key],
                                   **(AUX_TOL if key == "aux" else TOL),
                                   err_msg=key)
    logits = ttr.lm_logits(tp, cfg, out["hidden"], TP32)
    np.testing.assert_allclose(logits.numpy(), want["logits"], **TOL)


def test_collect_all_taps_without_indices(model):
    name, params, tokens, _, _ = model
    cfg = treg.get(name).smoke
    jout = jtr.forward(jax.tree_util.tree_map(jnp.asarray, params),
                       jreg.get(name).smoke, jnp.asarray(tokens),
                       policy=JP32, collect_taps=True)
    out = ttr.forward(bridge.to_torch(params, "cpu"), cfg,
                      torch.from_numpy(tokens).long(), policy=TP32,
                      collect_taps=True)
    np.testing.assert_allclose(out["taps"].numpy(), np.asarray(jout["taps"]),
                               **TOL)


@pytest.mark.parametrize("causal_skip", [False, True])
def test_blockwise_local_layers_match_jax(causal_skip):
    """gemma2 SMOKE with ``blockwise_threshold`` below its 16-token sequence,
    so both layer kinds take the online-softmax blockwise path inside the
    stack: the local layers with their 8-token window (which excludes keys
    at this length), over 4-query and 8-key chunks, with and without the
    skip of fully masked kv chunks."""
    kw = dict(blockwise_threshold=4, q_chunk=4, kv_chunk=8,
              causal_skip=causal_skip)
    jcfg = dc.replace(jreg.get("gemma2-9b").smoke, **kw)
    cfg = dc.replace(treg.get("gemma2-9b").smoke, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jax.random.PRNGKey(3), jcfg))
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    jout = jtr.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                       jnp.asarray(tokens), policy=JP32, collect_taps=True)
    jlogits = jtr.lm_logits(jax.tree_util.tree_map(jnp.asarray, params),
                            jcfg, jout["hidden"], JP32)
    tp = bridge.to_torch(params, "cpu")
    out = ttr.forward(tp, cfg, torch.from_numpy(tokens).long(), policy=TP32,
                      collect_taps=True)
    for key in ("hidden", "taps"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   **TOL, err_msg=key)
    np.testing.assert_allclose(
        ttr.lm_logits(tp, cfg, out["hidden"], TP32).numpy(),
        np.asarray(jlogits), **TOL)


def test_window_changes_the_local_layers():
    """The window bites at the smoke length: widening it past the sequence
    changes the hidden state, so the parity above holds the window."""
    cfg = treg.get("gemma2-9b").smoke
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 16))).long()
    h = ttr.forward(params, cfg, tokens, policy=TP32)["hidden"]
    wide = ttr.forward(params, dc.replace(cfg, window=64), tokens,
                       policy=TP32)["hidden"]
    assert not torch.allclose(h, wide, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_init_structure_matches_jax(name):
    want = jax.tree_util.tree_map(
        np.asarray, jreg.get(name).module.init_params(jax.random.PRNGKey(0),
                                                      jreg.get(name).smoke))
    got = treg.get(name).module.init_params(
        torch.Generator().manual_seed(0), treg.get(name).smoke,
        dtype=torch.bfloat16)
    assert [(p, tuple(x.shape)) for p, x in tree_flatten(got)] == \
        [(p, x.shape) for p, x in tree_flatten(want)]
    assert all(x.dtype == torch.bfloat16 for _, x in tree_flatten(got))


def test_full_configs_are_copies():
    """Every field, whisper's ``encoder`` config included."""
    for name in ALL_ARCHS:
        for preset in ("full", "smoke"):
            j = dc.asdict(jreg.get(name).config(preset))
            t = dc.asdict(treg.get(name).config(preset))
            assert j == t, name


@pytest.mark.parametrize("name", sorted(jreg.ARCHS) + ["no-such-arch"])
def test_registry_holds_every_reference_arch(name):
    """Every arch of ``repro.models.registry`` is in the port's registry,
    under the same name; an unknown name raises ``KeyError``, as the
    reference's ``get`` does."""
    if name not in jreg.ARCHS:
        with pytest.raises(KeyError):
            jreg.get(name)
        with pytest.raises(KeyError, match=name):
            treg.get(name)
        return
    assert treg.get(name).name == name
    assert treg.get(name).module.__name__.rsplit(".", 1)[1] == \
        jreg.get(name).module.__name__.rsplit(".", 1)[1]


@pytest.mark.parametrize("kind", ["lru", "no-such-kind"])
def test_layer_kind_on_granite_widths(kind):
    """The ``lru`` kind is in the stack: a pattern of lru layers with no
    channel mixer on granite's smoke widths initialises leaf for leaf as
    JAX's and runs forward as JAX's does.  A kind the reference does not
    know raises ``ValueError``, as the reference's ``_sub_init`` does."""
    jcfg = dc.replace(jreg.get("granite-3-8b").smoke,
                      pattern=(jtr.LayerSpec(kind, "none"),), lru_width=32)
    cfg = dc.replace(treg.get("granite-3-8b").smoke,
                     pattern=(ttr.LayerSpec(kind, "none"),), lru_width=32)
    if kind != "lru":
        with pytest.raises(ValueError, match=kind):
            jtr.init_params(jax.random.PRNGKey(2), jcfg)
        with pytest.raises(ValueError, match=kind):
            ttr.init_params(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(ValueError, match=kind):
            ttr.init_cache(cfg, 1, 8, device="cpu")
        return
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jax.random.PRNGKey(2), jcfg))
    own = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    assert [(p, tuple(x.shape)) for p, x in tree_flatten(own)] == \
        [(p, x.shape) for p, x in tree_flatten(params)]
    assert sorted(own["stack"]["sub0"]) == ["lru", "norm"]
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    want = jtr.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                       jnp.asarray(tokens), policy=JP32)["hidden"]
    got = ttr.forward(bridge.to_torch(params, "cpu"), cfg,
                      torch.from_numpy(tokens).long(), policy=TP32)["hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_pattern_on_granite_widths_runs():
    """The ``ssd`` kind is ported: a pattern of ssd layers with dense MLPs
    on granite's smoke widths initialises and runs forward as JAX's does."""
    kw = dict(pattern=(ttr.LayerSpec("ssd", "dense"),), ssm_state=16,
              ssm_headdim=8, ssm_chunk=8)
    jcfg = dc.replace(jreg.get("granite-3-8b").smoke, **kw)
    cfg = dc.replace(treg.get("granite-3-8b").smoke, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jax.random.PRNGKey(2), jcfg))
    own = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    assert [(p, tuple(x.shape)) for p, x in tree_flatten(own)] == \
        [(p, x.shape) for p, x in tree_flatten(params)]
    assert "attn" not in own["stack"]["sub0"]
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    want = jtr.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                       jnp.asarray(tokens), policy=JP32)["hidden"]
    got = ttr.forward(bridge.to_torch(params, "cpu"), cfg,
                      torch.from_numpy(tokens).long(), policy=TP32)["hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_pattern_on_granite_widths_runs():
    """The ``cross`` kind is ported: a pattern of (attn, cross) layers with
    dense MLPs on granite's smoke widths initialises and runs forward with
    a ``cross_kv`` frontend (7 positions, GQA 4/2) as JAX's does; the cross
    layer's params are an attention sublayer's."""
    kw = dict(pattern=(ttr.LayerSpec("attn", "dense"),
                       ttr.LayerSpec("cross", "dense")))
    jcfg = dc.replace(jreg.get("granite-3-8b").smoke, **kw)
    cfg = dc.replace(treg.get("granite-3-8b").smoke, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jax.random.PRNGKey(2), jcfg))
    own = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    assert [(p, tuple(x.shape)) for p, x in tree_flatten(own)] == \
        [(p, x.shape) for p, x in tree_flatten(params)]
    assert set(own["stack"]["sub1"]) == set(own["stack"]["sub0"])
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    cross_kv = (rng.standard_normal((2, 7, cfg.d_model)) * 0.1).astype(
        np.float32)
    want = jtr.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                       jnp.asarray(tokens), policy=JP32,
                       frontend={"cross_kv": jnp.asarray(cross_kv)})["hidden"]
    got = ttr.forward(bridge.to_torch(params, "cpu"), cfg,
                      torch.from_numpy(tokens).long(), policy=TP32,
                      frontend={"cross_kv": torch.from_numpy(cross_kv)}
                      )["hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
