"""Serving in the port (``attn``, ``local``, ``cross``, ``ssd`` and ``lru``
layers):
``layers.attention_decode``, ``transformer.{init_cache, prefill,
decode_step, _ring_decode, _cross_decode}``, ``encdec.{init_cache,
prefill, decode_step}``, ``train.serve_step`` and ``launch.serve`` against
the JAX package on the CPU, with bridged params (``bridge.to_torch`` of
JAX's init) and numpy-drawn inputs and frontends.

f32 at the forward's bound, rtol = atol = 2e-5 (``attention_decode``,
``_ring_decode``, ``_cross_decode`` and the cross caches' k and v at 1e-5),
cache ``len``, ``pos`` and ``step`` exact; bf16 compute with a bf16 cache at
2e-2; the counterparts of ``tests/test_arch_smoke.py``'s prefill/decode
checks at their 2e-3.  The archs are the five whose layers are all
``attn``, gemma2-9b (``local`` and ``attn``), mamba2-780m (``ssd`` only, so
its cache carries ``step``), recurrentgemma-9b (``lru`` states and
``local`` rings), whisper-base (the encoder-decoder: 12 stub
frames, sinusoidal positions, ``cross`` layers over the encoder's output)
and llama-3.2-vision-90b (a stub ``cross_kv`` of 8 patch embeddings):
gemma2's smoke window of 8 is shorter than the 11-token prompt, so its ring
has wrapped at prefill and keeps wrapping as it decodes; with the window at
32, past ``MAX_LEN``, its ``local`` layers keep a plain cache; ``local+ssd``
is gemma2's widths with an ``ssd`` layer after the ``local`` one (a ring
and an SSD state, no ``step``); ``lru`` is granite's widths with
``lru`` layers alone (RG-LRU states and a ``step``).  recurrentgemma-9b's
smoke window of 8 is shorter than the 11-token prompt too, so its rings
wrap, beside the state of four ``lru`` layers."""
import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL, registry as jreg, transformer as jtr
from repro_torch import bridge
from repro_torch.examples import quickstart
from repro_torch.launch import serve
from repro_torch.launch.train import stub_frontend
from repro_torch.models import encdec as ted, layers as TL, \
    registry as treg, transformer as ttr
from repro_torch.train import serve_step as tss
from repro_torch.utils import tree_flatten, tree_map

JP32 = JL.Policy(compute_dtype=jnp.float32)
TP32 = TL.Policy(compute_dtype=torch.float32)
JBF = JL.Policy(compute_dtype=jnp.bfloat16)
TBF = TL.Policy(compute_dtype=torch.bfloat16)
TOL = dict(rtol=2e-5, atol=2e-5)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SMOKE_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py
CROSS_ARCHS = ["whisper-base", "llama-3.2-vision-90b"]
ARCHS = ["granite-3-8b", "qwen2-72b", "starcoder2-7b",
         "granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "gemma2-9b",
         "mamba2-780m", "recurrentgemma-9b", *CROSS_ARCHS]
B, S, MAX_LEN, STEPS = 2, 11, 20, 6
# parity models beside the archs, each an arch's smoke config with fields
# replaced (given the package's LayerSpec): gemma2-9b with its window past
# MAX_LEN, so its local layers keep no ring; gemma2's widths with an ssd
# layer (mamba2's smoke state) after the local one; and granite's widths
# with lru layers alone
VARIANTS = {"gemma2-9b-window32": ("gemma2-9b", lambda spec: dict(window=32)),
            "local+ssd": ("gemma2-9b", lambda spec: dict(
                pattern=(spec("local", "dense"), spec("ssd", "none")),
                ssm_state=16, ssm_headdim=8, ssm_chunk=8)),
            "lru": ("granite-3-8b", lambda spec: dict(
                pattern=(spec("lru", "none"),), lru_width=32))}
# 4-query and 5-key chunks: the 11-token prompt pads on both axes (and
# whisper's 12 frames and vision's 8 patch embeddings the key axis)
BLOCKWISE = dict(blockwise_threshold=4, q_chunk=4, kv_chunk=5)


def _lower(cfg):
    """``cfg`` (and whisper's encoder) with the ``BLOCKWISE`` chunks."""
    enc = None if cfg.encoder is None else dc.replace(cfg.encoder,
                                                      **BLOCKWISE)
    return dc.replace(cfg, encoder=enc, **BLOCKWISE)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _lens(cache) -> list[int]:
    """Every ``len`` leaf's values, and ``step``'s: the positions held."""
    return [int(v) for p, x in tree_flatten(cache)
            if p.endswith("len") or p == "step" for v in x.reshape(-1)]


def _dtypes(tree) -> dict:
    """Each leaf's dtype name by path, of a port's or a JAX tree."""
    return {p: str(x.dtype).removeprefix("torch.")
            for p, x in tree_flatten(tree)}


def assert_trees_close(got, want, tol):
    """Every leaf of the port's tree against JAX's (numpy) by path; integer
    leaves exact."""
    got, want = dict(tree_flatten(bridge.to_numpy(got))), \
        dict(tree_flatten(jax.tree_util.tree_map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       err_msg=path, **tol)


# --------------------------------------------------------------------------
# attention_decode
# --------------------------------------------------------------------------

LAYER_CASES = {
    "mha": dict(n_heads=4, n_kv=4),
    "gqa": dict(n_heads=4, n_kv=2),
    "window3": dict(n_heads=4, n_kv=4, window=3),
    "softcap": dict(n_heads=4, n_kv=2, softcap=5.0),
}


def _layer(case: str, seed: int = 3):
    kw = dict(d_model=32, head_dim=8, blockwise_threshold=10_000,
              **LAYER_CASES[case])
    jcfg, tcfg = JL.AttnConfig(**kw), TL.AttnConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray,
                                JL.attn_init(jax.random.PRNGKey(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal((2, 7, 32)).astype(
        np.float32)
    return jcfg, tcfg, jp, x


@pytest.mark.parametrize("case", ["gqa", "window3"])
def test_attention_decode_matches_incremental_layer(case):
    """Token by token equals the port's own full-sequence layer, rope
    included (tests/test_layers.py:48-79, at its 2e-4)."""
    _, tcfg, jp, x = _layer(case)
    p, xt = bridge.to_torch(jp, "cpu"), torch.from_numpy(x)
    full = TL.attention_layer(p, xt, tcfg, policy=TP32)
    cache = TL.attn_cache_init(tcfg, 2, 8, torch.float32, device="cpu")
    outs = []
    for t in range(x.shape[1]):
        o, cache = TL.attention_decode(p, xt[:, t:t + 1], cache, tcfg,
                                       policy=TP32)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_attention_decode_matches_jax_step_for_step(case):
    """The output and the cache's k, v and len after every step, f32."""
    jcfg, tcfg, jp, x = _layer(case, seed=5)
    p = bridge.to_torch(jp, "cpu")
    jstep = jax.jit(lambda p_, x_, c_: JL.attention_decode(
        p_, x_, c_, jcfg, policy=JP32))
    jc = JL.attn_cache_init(jcfg, 2, 9, jnp.float32)
    tc = TL.attn_cache_init(tcfg, 2, 9, torch.float32, device="cpu")
    assert_trees_close(tc, jc, DECODE_TOL)
    for t in range(x.shape[1]):
        jo, jc = jstep(jp, x[:, t:t + 1], jc)
        to, same = TL.attention_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                       tc, tcfg, policy=TP32)
        assert same is tc                      # updated in place
        np.testing.assert_allclose(_np(to), np.asarray(jo), **DECODE_TOL)
        assert_trees_close(tc, jc, DECODE_TOL)
    assert int(tc["len"]) == x.shape[1]


def _ring_layer(window: int):
    """One gemma2 smoke ``local`` layer (GQA 4/2, softcap 50) with its
    window set, as both packages' ``attn_cfg_for`` give it."""
    spec = ttr.LayerSpec("local", "dense")
    jcfg = dc.replace(jreg.get("gemma2-9b").smoke, window=window)
    tcfg = dc.replace(treg.get("gemma2-9b").smoke, window=window)
    jacfg, tacfg = jtr.attn_cfg_for(jcfg, spec), ttr.attn_cfg_for(tcfg, spec)
    jp = jax.tree_util.tree_map(np.asarray,
                                JL.attn_init(jax.random.PRNGKey(6), jacfg))
    return spec, jcfg, tcfg, jacfg, tacfg, jp


def test_ring_decode_wraps_as_jax_and_the_windowed_layer():
    """A 4-slot ring driven 11 steps from empty (past 2·size): every step's
    output, k, v, pos and len against JAX's ``_ring_decode`` (1e-5, pos
    and len exact), and the outputs against the port's full-sequence
    windowed layer over the same tokens (2e-4, as the decode above)."""
    spec, jcfg, tcfg, jacfg, tacfg, jp = _ring_layer(4)
    p = bridge.to_torch(jp, "cpu")
    steps = 11
    x = np.random.default_rng(7).standard_normal(
        (B, steps, tcfg.d_model)).astype(np.float32)
    jc = jtr._sub_cache_zeros(jcfg, spec, B, 16, jnp.float32)
    tc = ttr._sub_cache_init(tcfg, spec, B, 16, torch.float32, device="cpu")
    assert_trees_close(tc, jc, DECODE_TOL)
    assert tc["k"].shape[1] == 4
    outs = []
    for t in range(steps):
        jo, jc = jtr._ring_decode(jp, x[:, t:t + 1], jc, jacfg, jcfg, JP32)
        to = ttr._ring_decode(p, torch.from_numpy(x[:, t:t + 1]), tc, tacfg,
                              policy=TP32)
        np.testing.assert_allclose(_np(to), np.asarray(jo), **DECODE_TOL)
        assert_trees_close(tc, jc, DECODE_TOL)
        outs.append(to)
    assert int(tc["len"]) == steps
    assert sorted(tc["pos"].tolist()) == list(range(steps - 4, steps))
    full = TL.attention_layer(p, torch.from_numpy(x), tacfg, policy=TP32)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window", [8, 32])
def test_local_cache_is_a_ring_only_below_max_len(window):
    """gemma2's local layers: window 8 < MAX_LEN gives 8 slots and ``pos``
    holding the prompt's last 8 positions; window 32 gives MAX_LEN slots
    and no ``pos`` after prefill, though ``init_cache`` has one, as the
    reference's do (``init_cache_matches_jax`` holds the latter)."""
    cfg = dc.replace(treg.get("gemma2-9b").smoke, window=window)
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.zeros((B, S), dtype=torch.int32)
    local = ttr.prefill(params, cfg, tok, max_len=MAX_LEN, policy=TP32,
                        cache_dtype=torch.float32)["cache"]["stack"]["sub0"]
    size = min(window, MAX_LEN)
    assert local["k"].shape == (cfg.n_rep, B, size, cfg.n_kv, cfg.head_dim)
    if window < MAX_LEN:
        held = sorted(local["pos"][0].tolist())
        assert held == list(range(S - window, S))
    else:
        assert "pos" not in local
    empty = ttr.init_cache(cfg, B, MAX_LEN, device="cpu")["stack"]["sub0"]
    assert empty["pos"].shape == (cfg.n_rep, size)
    assert (empty["pos"] == -1).all()


# --------------------------------------------------------------------------
# prefill / decode_step against JAX
# --------------------------------------------------------------------------

def _np_frontend(arch: str, cfg, batch: int = B, seed: int = 11,
                 length: int | None = None):
    """numpy stub frontend of ``frontend_shape``'s shape (its length
    replaced by ``length``), ``N(0,1)·0.1``; None for an arch without one."""
    shapes = treg.get(arch).frontend_shape(cfg, batch)
    if shapes is None:
        return None
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(
        v if length is None else (v[0], length, v[2])) * 0.1).astype(
            np.float32) for k, v in shapes.items()}


def _load_model(name: str, frontend_len: int | None = None) -> dict:
    """An arch's or a variant's smoke configs and modules (JAX's, the
    port's), JAX's params from key 0 and their bridge, numpy tokens [B, S +
    STEPS] and the stub frontend (None without one)."""
    arch, kw = VARIANTS.get(name, (name, lambda spec: {}))
    jcfg, tcfg = dc.replace(jreg.get(arch).smoke, **kw(jtr.LayerSpec)), \
        dc.replace(treg.get(arch).smoke, **kw(ttr.LayerSpec))
    jmod, tmod = jreg.get(arch).module, treg.get(arch).module
    jp = jax.tree_util.tree_map(
        np.asarray, jmod.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, S + STEPS)).astype(np.int32)
    return {"name": name, "jcfg": jcfg, "tcfg": tcfg, "jmod": jmod,
            "tmod": tmod, "jp": jp, "tp": bridge.to_torch(jp, "cpu"),
            "tokens": tokens,
            "frontend": _np_frontend(arch, tcfg, length=frontend_len)}


@pytest.fixture(scope="module", params=ARCHS + list(VARIANTS))
def model(request):
    return _load_model(request.param)


def _fe_kw(frontend, to_torch: bool = False) -> dict:
    if frontend is None:
        return {}
    return {"frontend": bridge.to_torch(frontend, "cpu") if to_torch
            else frontend}


def _jax_prefill(m, tokens, policy, cache_dtype, logits_mode="all",
                 jcfg=None, max_len=MAX_LEN):
    """JAX's prefill through the model's module, fed its frontend."""
    jcfg = m["jcfg"] if jcfg is None else jcfg
    return jax.jit(lambda p, t, f: m["jmod"].prefill(
        p, jcfg, t, max_len=max_len, policy=policy, cache_dtype=cache_dtype,
        logits_mode=logits_mode, **_fe_kw(f)))(m["jp"], tokens,
                                               m["frontend"])


def _jax_decode(m, policy):
    return jax.jit(lambda p, t, c: m["jmod"].decode_step(p, m["jcfg"], t, c,
                                                         policy=policy))


def _port_prefill(m, tokens, policy, cache_dtype, logits_mode="all",
                  tcfg=None, max_len=MAX_LEN):
    """The port's prefill through the model's module, fed its frontend."""
    tcfg = m["tcfg"] if tcfg is None else tcfg
    return m["tmod"].prefill(m["tp"], tcfg, torch.from_numpy(tokens),
                             max_len=max_len, policy=policy,
                             cache_dtype=cache_dtype, logits_mode=logits_mode,
                             **_fe_kw(m["frontend"], to_torch=True))


@pytest.mark.parametrize("blockwise", [False, True],
                         ids=["full", "blockwise"])
@pytest.mark.parametrize("logits_mode", ["all", "last"])
def test_prefill_matches_jax(model, logits_mode, blockwise):
    """Logits, hidden and every cache leaf (len and step exact; a cross
    layer's k and v at 1e-5); with the threshold at 4 the prompt (and
    whisper's encoder) takes the blockwise branch."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    if blockwise:
        jcfg, tcfg = _lower(jcfg), _lower(tcfg)
    tok = model["tokens"][:, :S]
    want = _jax_prefill(model, tok, JP32, jnp.float32, logits_mode, jcfg=jcfg)
    got = _port_prefill(model, tok, TP32, torch.float32, logits_mode,
                        tcfg=tcfg)
    assert got["logits"].shape == want["logits"].shape
    np.testing.assert_allclose(_np(got["logits"]), np.asarray(want["logits"]),
                               **TOL)
    np.testing.assert_allclose(_np(got["hidden"]), np.asarray(want["hidden"]),
                               **TOL)
    assert_trees_close(got["cache"], want["cache"], TOL)
    assert_trees_close(_cross_leaves(tcfg, got["cache"]),
                       _cross_leaves(jcfg, want["cache"]), DECODE_TOL)
    assert set(_lens(got["cache"])) == {S}


def _cross_leaves(cfg, cache) -> dict:
    """The ``cross`` layers' caches of a (stacked) cache tree, by key."""
    return {f"sub{i}": cache["stack"][f"sub{i}"]
            for i, sp in enumerate(cfg.pattern) if sp.kind == "cross"}


def test_decode_step_matches_jax(model):
    """One step from JAX's own prefill cache carried across; then 6 greedy
    steps from each side's own cache: logits, tokens and every leaf."""
    tcfg, jp, tp, tmod = model["tcfg"], model["jp"], model["tp"], \
        model["tmod"]
    tok = model["tokens"][:, :S]
    jdec = _jax_decode(model, JP32)
    jpre = _jax_prefill(model, tok, JP32, jnp.float32)
    nxt = model["tokens"][:, S:S + 1]
    jl, jc = jdec(jp, nxt, jpre["cache"])
    tl, tc = tmod.decode_step(tp, tcfg, torch.from_numpy(nxt),
                              bridge.to_torch(jpre["cache"], "cpu"),
                              policy=TP32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert_trees_close(tc, jc, TOL)

    jc = jpre["cache"]
    tc = _port_prefill(model, tok, TP32, torch.float32)["cache"]
    jt = np.asarray(jnp.argmax(jpre["logits"][:, -1], -1))[:, None]
    tt = torch.from_numpy(jt.astype(np.int32))
    for _ in range(STEPS):
        jl, jc = jdec(jp, jnp.asarray(jt, jnp.int32), jc)
        tl, tc = tmod.decode_step(tp, tcfg, tt, tc, policy=TP32)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        jt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), jt)
    assert_trees_close(tc, jc, TOL)


def assert_leaves_rel_fro(got, want, tol):
    """Each float leaf's relative Frobenius error, ||got - want|| / ||want||,
    at most ``tol``; integer leaves exact."""
    got, want = dict(tree_flatten(bridge.to_numpy(got))), \
        dict(tree_flatten(jax.tree_util.tree_map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32) if w.dtype.kind == "V" or \
            w.dtype.name == "bfloat16" else w
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        else:
            err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
            assert err <= tol, (path, err)


# Models whose bf16 floor lies past the fixed 2e-2: recurrentgemma's smoke
# stack is five layers deep and each sublayer moves the residual stream by
# about its norm, so JAX's own bf16 prefill cache drifts past 2e-2 from its
# f32 one by the last lru layers, and the port's about as far; two bf16
# paths that round apart then differ by more than 2e-2 there.  These take
# the card's derived gate (chip_smoke.py's ``serve_check``) instead.
FLOOR_GATED = {"recurrentgemma-9b"}
BF16_FLOOR_RATIO = 1.1


def _floats(tree) -> np.ndarray:
    """Every float leaf of a numpy tree, by path, as one f32 vector."""
    flat = dict(tree_flatten(tree))
    return np.concatenate([np.asarray(flat[p], np.float32).ravel()
                           for p in sorted(flat)
                           if not np.issubdtype(flat[p].dtype, np.integer)])


def assert_within_bf16_floor(got, want_bf16, want_f32):
    """The port's bf16 result's relative Frobenius error against JAX's f32
    one at most ``BF16_FLOOR_RATIO`` times JAX's bf16 result's, over the
    whole tree (all float leaves as one vector)."""
    g = _floats(bridge.to_numpy(got))
    b, f = (_floats(jax.tree_util.tree_map(np.asarray, t))
            for t in (want_bf16, want_f32))
    ours = np.linalg.norm(g - f) / np.linalg.norm(f)
    floor = np.linalg.norm(b - f) / np.linalg.norm(f)
    assert ours <= BF16_FLOOR_RATIO * floor, (ours, floor)


def test_bf16_prefill_and_decode_match_jax(model):
    """bf16 compute with a bf16 cache, the same tokens fed to both sides:
    logits elementwise at 2e-2, each cache leaf by relative Frobenius error
    at 2e-2.  (Each framework rounds its own f32 sums to bf16, and the
    residual stream carries those one-ulp flips to the next layer: cached
    k/v values near 3 then differ by two bf16 ulps, 0.03, past an
    elementwise 2e-2, on a few of 1,920 elements; layer 0's are equal.)  A
    model of ``FLOOR_GATED`` holds its logits and cache after prefill and
    after the last step within ``BF16_FLOOR_RATIO`` of JAX's bf16 distance
    from JAX's f32 instead of the cache leaves' 2e-2."""
    tcfg, jp, tp = model["tcfg"], model["jp"], model["tp"]
    tokens = model["tokens"]
    floor = model["name"] in FLOOR_GATED
    jpre = _jax_prefill(model, tokens[:, :S], JBF, jnp.bfloat16)
    tpre = _port_prefill(model, tokens[:, :S], TBF, torch.bfloat16)
    np.testing.assert_allclose(_np(tpre["logits"]),
                               _np(jpre["logits"]), **BF16_TOL)
    if floor:
        f32 = _jax_prefill(model, tokens[:, :S], JP32, jnp.float32)
        for key in ("logits", "cache"):
            assert_within_bf16_floor(tpre[key], jpre[key], f32[key])
        fdec, fc = _jax_decode(model, JP32), f32["cache"]
    else:
        assert_leaves_rel_fro(tpre["cache"], jpre["cache"], 2e-2)
    jdec = _jax_decode(model, JBF)
    jc, tc = jpre["cache"], tpre["cache"]
    for t in range(S, S + STEPS):
        jl, jc = jdec(jp, tokens[:, t:t + 1], jc)
        tl, tc = model["tmod"].decode_step(tp, tcfg, torch.from_numpy(
            tokens[:, t:t + 1]), tc, policy=TBF)
        np.testing.assert_allclose(_np(tl), _np(jl), **BF16_TOL)
        if floor:
            fl, fc = fdec(jp, tokens[:, t:t + 1], fc)
    if floor:
        assert_within_bf16_floor(tl, jl, fl)
        assert_within_bf16_floor(tc, jc, fc)
    else:
        assert_leaves_rel_fro(tc, jc, 2e-2)
    assert _dtypes(tc) == _dtypes(jc)
    assert "bfloat16" in _dtypes(tc).values()


def test_init_cache_matches_jax(model):
    """Leaf for leaf, a cross layer's k and v ``max(n_frontend_tokens,
    1)`` slots long."""
    want = model["jmod"].init_cache(model["jcfg"], B, MAX_LEN, jnp.float32)
    got = model["tmod"].init_cache(model["tcfg"], B, MAX_LEN, torch.float32,
                                   device="cpu")
    assert_trees_close(got, want, TOL)
    t = max(model["tcfg"].n_frontend_tokens, 1)
    for c in _cross_leaves(model["tcfg"], got).values():
        assert c["k"].shape[2] == c["v"].shape[2] == t


def test_first_len_counts_tokens_not_ring_slots():
    """gemma2's sub0 is ``local``, a ring of 8 slots: after an 11-token
    prompt and 3 steps the position is 14 (not the slot, 14 % 8), as
    JAX's ``_first_len`` reads it, and a copy the step can advance past."""
    m = _load_model("gemma2-9b")
    jcfg, tcfg, jp, tp = m["jcfg"], m["tcfg"], m["jp"], m["tp"]
    assert tcfg.pattern[0].kind == "local" and tcfg.window < MAX_LEN
    tok = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S + 3))
    jc = _jax_prefill(m, tok[:, :S], JP32, jnp.float32)["cache"]
    tc = _port_prefill(m, tok[:, :S], TP32, torch.float32)["cache"]
    jdec = _jax_decode(m, JP32)
    for t in range(S, S + 3):
        _, jc = jdec(jp, tok[:, t:t + 1], jc)
        ttr.decode_step(tp, tcfg, torch.from_numpy(tok[:, t:t + 1]), tc,
                        policy=TP32)
    pos = ttr._first_len(tcfg, tc)
    assert pos.dim() == 0 and int(pos) == S + 3 == int(jtr._first_len(
        jcfg, jc))
    pos.add_(1)
    assert int(tc["stack"]["sub0"]["len"][0]) == S + 3


def test_decode_past_max_len_raises():
    """F2: an ``attn`` cache of max_len slots takes max_len - prompt steps;
    the next write (slot 6 of 6 here) raises, where the reference clamps
    it onto slot 5; the port adds no host check to a step."""
    cfg = treg.get("granite-3-8b").smoke
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    cache = ttr.prefill(params, cfg, torch.zeros((B, 6), dtype=torch.int32),
                        max_len=6, policy=TP32,
                        cache_dtype=torch.float32)["cache"]
    with pytest.raises(IndexError):
        ttr.decode_step(params, cfg, torch.zeros((B, 1), dtype=torch.int32),
                        cache, policy=TP32)


def test_step_is_a_device_counter_advanced_in_place(monkeypatch):
    """mamba2's cache carries ``step``, a 0-d int32 tensor on the cache's
    device (S after prefill); a decode step embeds at a copy of it and then
    advances the same tensor by 1: set to 7, the step reads position 7 for
    every row, and ``step`` reads 8 afterwards while that copy keeps 7."""
    cfg = treg.get("mamba2-780m").smoke
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    cache = ttr.prefill(params, cfg, torch.zeros((B, 5), dtype=torch.int32),
                        max_len=8, policy=TP32,
                        cache_dtype=torch.float32)["cache"]
    step = cache["step"]
    assert step.shape == () and step.dtype == torch.int32
    assert step.device == cache["stack"]["sub0"]["h"].device
    assert int(step) == 5
    step.fill_(7)
    seen = []
    embed = ttr.embed_tokens

    def spy(params_, cfg_, tokens, positions, policy):
        seen.append(positions)
        return embed(params_, cfg_, tokens, positions, policy)
    monkeypatch.setattr(ttr, "embed_tokens", spy)
    _, after = ttr.decode_step(params, cfg, torch.zeros((B, 1),
                                                        dtype=torch.int32),
                               cache, policy=TP32)
    assert after["step"] is step and int(step) == 8
    assert seen[0].shape == (B, 1) and seen[0].tolist() == [[7]] * B


@pytest.mark.parametrize("name", ["mamba2-780m", "local+ssd"])
def test_prefill_cache_dtypes_match_jax(name):
    """f32 compute with a bf16 cache: the reference's prefill returns an
    ``ssd`` layer's conv states in the compute dtype, f32, (and ``h`` in
    f32) but k and v in ``cache_dtype``; the port's leaves take the same
    dtypes, and hold the same values (bf16 leaves at 2e-2)."""
    m = _load_model(name)
    tok = m["tokens"][:, :S]
    want = _jax_prefill(m, tok, JP32, jnp.bfloat16)
    got = _port_prefill(m, tok, TP32, torch.bfloat16)
    assert _dtypes(got["cache"]) == _dtypes(want["cache"])
    ssd = [c for c in got["cache"]["stack"].values() if "h" in c]
    assert len(ssd) == 1
    assert {t.dtype for t in ssd[0].values()} == {torch.float32}
    assert ("k" in got["cache"]["stack"]["sub0"]) == (name == "local+ssd")
    assert_trees_close(got["cache"], want["cache"], BF16_TOL)


@pytest.mark.parametrize("name", ["mamba2-780m", "lru"])
def test_ssd_decode_keeps_the_leaf_dtype_where_jax_takes_the_compute_dtype(
        name):
    """Pinned divergence (ROADMAP §3): a zero bf16 ``init_cache`` decoded
    one step under f32 compute.  JAX's step returns the conv states (an
    ``ssd`` layer's ``conv_x``/``conv_b``/``conv_c``, an ``lru`` layer's
    ``conv``) in f32; the port writes them in place, so its leaves stay
    bf16 and hold JAX's values rounded to bf16 (one bf16 ulp, past the f32
    2e-5).  The logits and ``h`` (f32 on both sides) agree at 2e-5,
    ``step`` exactly."""
    m = _load_model(name)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    nxt = m["tokens"][:, :1]
    jl, jc = _jax_decode(m, JP32)(
        m["jp"], nxt, jtr.init_cache(jcfg, B, MAX_LEN, jnp.bfloat16))
    tl, tc = ttr.decode_step(
        m["tp"], tcfg, torch.from_numpy(nxt),
        ttr.init_cache(tcfg, B, MAX_LEN, torch.bfloat16, device="cpu"),
        policy=TP32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    jd, td = _dtypes(jc), _dtypes(tc)
    assert sorted(jd) == sorted(td)
    got = dict(tree_flatten(tc))
    for path, w in tree_flatten(jc):
        w = np.asarray(w)
        if path.split("/")[-1].startswith("conv"):
            assert (jd[path], td[path]) == ("float32", "bfloat16"), path
            rounded = torch.tensor(w).to(torch.bfloat16).float()
            torch.testing.assert_close(got[path].float(), rounded,
                                       rtol=2 ** -7, atol=2e-5)
            assert np.abs(_np(got[path]) - w).max() > 1e-4, path
        else:
            assert jd[path] == td[path], path
            np.testing.assert_allclose(_np(got[path]), w, err_msg=path,
                                       **TOL)
    assert int(tc["step"]) == 1


def test_pure_ssm_cache_decodes_past_max_len():
    """An ``ssd`` state has no slots: mamba2 prefilled with 6 tokens at
    ``max_len`` 6 decodes 4 more steps as JAX's does (logits and every
    leaf at 2e-5, ``step`` 10 exact), where an ``attn`` cache raises."""
    m = _load_model("mamba2-780m")
    jcfg, tcfg, jp, tp, tok = m["jcfg"], m["tcfg"], m["jp"], m["tp"], \
        m["tokens"]
    jc = _jax_prefill(m, tok[:, :6], JP32, jnp.float32, max_len=6)["cache"]
    tc = _port_prefill(m, tok[:, :6], TP32, torch.float32,
                       max_len=6)["cache"]
    jdec = _jax_decode(m, JP32)
    for t in range(6, 10):
        jl, jc = jdec(jp, tok[:, t:t + 1], jc)
        tl, tc = ttr.decode_step(tp, tcfg, torch.from_numpy(tok[:, t:t + 1]),
                                 tc, policy=TP32)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert_trees_close(tc, jc, TOL)
    assert int(tc["step"]) == 10


# --------------------------------------------------------------------------
# the port alone: tests/test_arch_smoke.py:57-95's counterparts
# --------------------------------------------------------------------------

def _prefill_decode_forward(module, cfg, params, tokens, frontend=None):
    """(prefill's last logits, one decode step's logits, the forward's
    logits) for tokens[:, :-1] then token -1, f32, real vocab rows, the
    forward and prefill fed the same ``frontend``."""
    n, v = tokens.shape[1], cfg.vocab
    kw = _fe_kw(frontend, to_torch=True)
    full = module.lm_logits(params, cfg, module.forward(
        params, cfg, tokens, policy=TP32, **kw)["hidden"], TP32)
    pre = module.prefill(params, cfg, tokens[:, :n - 1], max_len=n + 4,
                         policy=TP32, cache_dtype=torch.float32, **kw)
    step, _ = module.decode_step(params, cfg, tokens[:, n - 1:],
                                 pre["cache"], policy=TP32)
    return pre["logits"][:, -1, :v], step[:, 0, :v], full[..., :v]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """Prefill[0:S-1] + decode step S-1 ≈ the forward's logits there, on
    tests/test_arch_smoke.py's own params, tokens and frontend (keys 2, 3
    and 11)."""
    entry, jentry = treg.get(arch), jreg.get(arch)
    params = bridge.to_torch(jax.tree_util.tree_map(
        np.asarray, jentry.module.init_params(jax.random.PRNGKey(2),
                                              jentry.smoke)), "cpu")
    tokens = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(3), (B, 16), 0, entry.smoke.vocab)))
    shapes = jentry.frontend_shape(jentry.smoke, B)
    frontend = None if shapes is None else {
        k: np.asarray(jax.random.normal(jax.random.PRNGKey(11), v) * 0.1)
        for k, v in shapes.items()}
    last, step, full = _prefill_decode_forward(entry.module, entry.smoke,
                                               params, tokens, frontend)
    torch.testing.assert_close(last, full[:, -2], **SMOKE_TOL)
    torch.testing.assert_close(step, full[:, -1], **SMOKE_TOL)


def test_moe_decode_group_drops_as_jax_does():
    """A decode step routes a group of B tokens, the forward one of B·S, so
    capacity drops can differ: on llama4's smoke config (capacity 1 of 2
    decode tokens an expert) with these numpy tokens, decode and forward
    differ by 0.125 in JAX, and the port differs exactly as JAX does."""
    name = "llama4-maverick-400b-a17b"
    jentry, entry = jreg.get(name), treg.get(name)
    jp = jax.tree_util.tree_map(np.asarray, jentry.module.init_params(
        jax.random.PRNGKey(2), jentry.smoke))
    tok = np.random.default_rng(3).integers(0, entry.smoke.vocab, (B, 16))
    jfull = jtr.lm_logits(jp, jentry.smoke, jtr.forward(
        jp, jentry.smoke, tok, policy=JP32)["hidden"], JP32)
    jpre = jtr.prefill(jp, jentry.smoke, tok[:, :-1], max_len=20,
                       policy=JP32, cache_dtype=jnp.float32)
    jstep, _ = jtr.decode_step(jp, jentry.smoke, tok[:, -1:], jpre["cache"],
                               policy=JP32)
    v = entry.smoke.vocab
    jgap = np.asarray(jstep[:, 0, :v] - jfull[:, -1, :v])
    _, step, full = _prefill_decode_forward(
        entry.module, entry.smoke, bridge.to_torch(jp, "cpu"),
        torch.from_numpy(tok))
    assert np.abs(jgap).max() > 0.1
    np.testing.assert_allclose(_np(step), np.asarray(jstep[:, 0, :v]), **TOL)
    np.testing.assert_allclose(_np(step - full[:, -1]), jgap, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_init_cache_decode_runs(arch):
    entry = treg.get(arch)
    cfg = entry.smoke
    params = entry.module.init_params(torch.Generator().manual_seed(4), cfg)
    cache = entry.module.init_cache(cfg, B, 16, torch.float32, device="cpu")
    logits, cache = entry.module.decode_step(
        params, cfg, torch.zeros((B, 1), dtype=torch.int32), cache,
        policy=TP32)
    assert logits.shape[0] == B
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert set(_lens(cache)) == {1}


# --------------------------------------------------------------------------
# serve_step
# --------------------------------------------------------------------------

def _prefilled(arch: str, prompt: int):
    """``arch``'s smoke config with a cache of 64 sequences prefilled with
    ``prompt`` tokens (and the launcher's stub frontend, if it has one),
    ``max_len`` prompt + 4."""
    entry = treg.get(arch)
    cfg = entry.smoke
    params = entry.module.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (64, prompt)))
    prefill = tss.make_prefill_step(entry, cfg, max_len=prompt + 4,
                                    policy=TP32, cache_dtype=torch.float32)
    frontend = stub_frontend(entry, cfg, 64, torch.float32, "cpu", seed=7)
    return entry, cfg, params, prefill(params, tokens, frontend)


@pytest.fixture(scope="module")
def granite():
    """granite's smoke config (vocab 130, padded to 144) with a prefilled
    cache of 64 sequences."""
    return _prefilled("granite-3-8b", 8)


# gemma2's and recurrentgemma's 10-token prompts have wrapped their rings
# of 8 slots; mamba2's position is its cache's step; whisper's decode adds
# the sinusoidal embedding at a position read on the device
@pytest.fixture(scope="module", params=[("granite-3-8b", 8),
                                        ("gemma2-9b", 10),
                                        ("mamba2-780m", 8),
                                        ("recurrentgemma-9b", 10),
                                        ("whisper-base", 8),
                                        ("llama-3.2-vision-90b", 8)],
                ids=["granite-3-8b", "gemma2-9b", "mamba2-780m",
                     "recurrentgemma-9b", "whisper-base",
                     "llama-3.2-vision-90b"])
def served(request):
    return _prefilled(*request.param)


def _fresh(out):
    return {"tok": torch.argmax(out["next_token_logits"], -1)[:, None].to(
        torch.int32),
        "cache": tree_map(torch.clone, out["cache"])}


def test_greedy_decode_step_is_argmax(granite):
    entry, cfg, params, out = granite
    a, b = _fresh(out), _fresh(out)
    nxt, cache = tss.make_decode_step(entry, cfg, policy=TP32)(
        params, a["cache"], a["tok"])
    logits, _ = ttr.decode_step(params, cfg, b["tok"], b["cache"],
                                policy=TP32)
    assert nxt.shape == (64, 1) and nxt.dtype == torch.int32
    torch.testing.assert_close(nxt[:, 0].long(), logits[:, -1].argmax(-1))
    assert cache is a["cache"]


def test_sampling_repeats_with_a_seed_and_tends_to_greedy(granite):
    entry, cfg, params, out = granite
    sample = tss.make_decode_step(entry, cfg, policy=TP32, greedy=False)
    draws = []
    for seed in (7, 7, 8):
        s = _fresh(out)
        draws.append(sample(params, s["cache"], s["tok"],
                            torch.Generator().manual_seed(seed))[0])
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    cold = tss.make_decode_step(entry, cfg, policy=TP32, greedy=False,
                                temperature=1e-4)
    greedy = tss.make_decode_step(entry, cfg, policy=TP32)
    a, b = _fresh(out), _fresh(out)
    gen = torch.Generator().manual_seed(9)
    assert torch.equal(cold(params, a["cache"], a["tok"], gen)[0],
                       greedy(params, b["cache"], b["tok"])[0])


def test_sampling_never_draws_padded_vocab(granite):
    """At temperature 100 the 130 real rows are near uniform; none of 64 x 4
    draws lands in rows 130-143."""
    entry, cfg, params, out = granite
    assert cfg.vocab == 130 and params["embed"]["table"].shape[0] == 144
    hot = tss.make_decode_step(entry, cfg, policy=TP32, greedy=False,
                               temperature=100.0)
    s = _fresh(out)
    tok, cache, gen = s["tok"], s["cache"], torch.Generator().manual_seed(3)
    seen = []
    for _ in range(4):
        tok, cache = hot(params, cache, tok, gen)
        seen.append(tok)
    seen = torch.cat(seen)
    assert int(seen.max()) < cfg.vocab and int(seen.min()) >= 0
    assert len(torch.unique(seen)) > 60          # spread, not stuck


def test_greedy_decode_reads_nothing_on_the_host(served, monkeypatch):
    """The position is a tensor (``len`` or ``step``), and so is a ring's
    slot: a greedy step calls no ``Tensor.item`` (nor int / float / bool of a tensor), so on
    the card it issues no sync."""
    entry, cfg, params, out = served
    s = _fresh(out)
    decode = tss.make_decode_step(entry, cfg, policy=TP32)

    def refuse(*_a, **_k):
        raise AssertionError("host read of a tensor in a decode step")
    for name in ("item", "__int__", "__float__", "__bool__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    nxt, _ = decode(params, s["cache"], s["tok"])
    monkeypatch.undo()
    assert nxt.shape == (64, 1)


# --------------------------------------------------------------------------
# cross layers: the frontend's length, a missing frontend, a read-only cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_cache_takes_the_frontend_length(arch):
    """The port allocates its cache before the layers run, so the cross
    leaves must take the frontend's own length, as JAX's prefill emits
    them, not ``n_frontend_tokens``: 5 frames (whisper's encoder output) or
    patch embeddings, fewer than the smoke configs' 12 and 8.  Prefill's
    logits and every leaf (cross k and v at 1e-5), then 3 decode steps,
    against JAX's."""
    m = _load_model(arch, frontend_len=5)
    tcfg, tok = m["tcfg"], m["tokens"]
    assert tcfg.n_frontend_tokens > 5
    want = _jax_prefill(m, tok[:, :S], JP32, jnp.float32)
    got = _port_prefill(m, tok[:, :S], TP32, torch.float32)
    np.testing.assert_allclose(_np(got["logits"]),
                               np.asarray(want["logits"]), **TOL)
    assert_trees_close(got["cache"], want["cache"], TOL)
    cross = _cross_leaves(tcfg, got["cache"])
    assert cross and {c[k].shape[2] for c in cross.values()
                      for k in ("k", "v")} == {5}
    assert_trees_close(cross, _cross_leaves(m["jcfg"], want["cache"]),
                       DECODE_TOL)
    jdec = _jax_decode(m, JP32)
    jc, tc = want["cache"], got["cache"]
    for t in range(S, S + 3):
        jl, jc = jdec(m["jp"], tok[:, t:t + 1], jc)
        tl, tc = m["tmod"].decode_step(m["tp"], tcfg, torch.from_numpy(
            tok[:, t:t + 1]), tc, policy=TP32)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert_trees_close(tc, jc, TOL)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_prefill_without_frontend_raises(arch):
    """A stack with cross layers and no ``frontend["cross_kv"]``: JAX's
    prefill fails on ``None.shape`` (its forward would let the cross layer
    attend to its own input); the port's raises ``ValueError`` naming the
    missing key before any compute (empty params), with no fallback.
    whisper's stack is its decoder; ``encdec.prefill`` itself requires
    ``frontend`` on both sides."""
    m = _load_model(arch)
    tok = m["tokens"][:, :S]
    jp = m["jp"]["decoder"] if arch == "whisper-base" else m["jp"]
    with pytest.raises(AttributeError):
        jtr.prefill(jp, m["jcfg"], tok, max_len=MAX_LEN, policy=JP32)
    for frontend in (None, {}):
        with pytest.raises(ValueError, match=r"frontend\['cross_kv'\]"):
            ttr.prefill({}, m["tcfg"], torch.from_numpy(tok),
                        frontend=frontend, max_len=MAX_LEN, policy=TP32)
    if arch == "whisper-base":
        with pytest.raises(TypeError):
            m["jmod"].prefill(m["jp"], m["jcfg"], tok, max_len=MAX_LEN)
        with pytest.raises(TypeError):
            ted.prefill(m["tp"], m["tcfg"], torch.from_numpy(tok),
                        max_len=MAX_LEN)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_decode_matches_jax_and_the_cross_layer(arch):
    """One smoke cross sublayer (whisper: MHA 4/4, layernorm; vision: GQA
    4/2) over a cache projected from 7 seeded encoder positions, 5 steps:
    ``_sub_decode``'s output against JAX's (1e-5), the cache's tensors bit
    for bit what they were and JAX's cache returned as given; and
    ``_cross_decode`` alone against the port's full-sequence cross layer
    at each query (no mask, no rope: row t reads only token t; 1e-5)."""
    jcfg, tcfg = jreg.get(arch).smoke, treg.get(arch).smoke
    i = next(i for i, sp in enumerate(tcfg.pattern) if sp.kind == "cross")
    spec = tcfg.pattern[i]
    jsub = jax.tree_util.tree_map(np.asarray, jtr._sub_init(
        jax.random.PRNGKey(6), jcfg, jcfg.pattern[i]))
    sub = bridge.to_torch(jsub, "cpu")
    acfg = ttr.attn_cfg_for(tcfg, spec)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 5, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 7, tcfg.d_model)).astype(np.float32)
    xt, enct = torch.from_numpy(x), torch.from_numpy(enc)
    _, k, v = TL._project_qkv(sub["attn"], xt, enct, acfg, TP32, TL.NO_BFP,
                              None)
    cache = {"k": k, "v": v}
    frozen = {n: t.clone() for n, t in cache.items()}
    jcache = {n: np.asarray(t) for n, t in cache.items()}
    full = TL.attention_layer(sub["attn"], xt, acfg, policy=TP32, kv_x=enct)
    for t in range(x.shape[1]):
        jh, jc = jtr._sub_decode(jsub, x[:, t:t + 1], jcfg.pattern[i], jcfg,
                                 jcache, policy=JP32)
        th = ttr._sub_decode(sub, xt[:, t:t + 1], spec, tcfg, cache,
                             policy=TP32)
        np.testing.assert_allclose(_np(th), np.asarray(jh), **DECODE_TOL)
        assert jc is jcache
        y = ttr._cross_decode(sub["attn"], xt[:, t:t + 1], cache, acfg,
                              policy=TP32)
        np.testing.assert_allclose(_np(y), _np(full[:, t:t + 1]),
                                   **DECODE_TOL)
    assert all(torch.equal(cache[n], frozen[n]) for n in frozen)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_decode_step_leaves_the_cross_cache_unchanged(arch):
    """Through the arch's ``decode_step``: 4 steps advance every ``len``
    and leave each cross cache's k and v bit for bit as prefill wrote
    them, in the same tensors."""
    m = _load_model(arch)
    tok = m["tokens"]
    cache = _port_prefill(m, tok[:, :S], TP32, torch.float32)["cache"]
    cross = _cross_leaves(m["tcfg"], cache)
    held = {(key, n): (c[n], c[n].clone()) for key, c in cross.items()
            for n in ("k", "v")}
    for t in range(S, S + 4):
        _, cache = m["tmod"].decode_step(m["tp"], m["tcfg"], torch.from_numpy(
            tok[:, t:t + 1]), cache, policy=TP32)
    assert set(_lens(cache)) == {S + 4}
    for (key, n), (same, before) in held.items():
        now = _cross_leaves(m["tcfg"], cache)[key][n]
        assert now is same and torch.equal(now, before), (key, n)


# --------------------------------------------------------------------------
# launch/serve, the quickstart, and what is not ported
# --------------------------------------------------------------------------

# gemma2's 12-token prompt is longer than its smoke window of 8; mamba2's
# cache holds step 14; whisper and vision are fed the stub frontend
@pytest.mark.parametrize("arch,prompt", [("granite-3-8b", 10),
                                         ("gemma2-9b", 12),
                                         ("mamba2-780m", 10),
                                         ("whisper-base", 10),
                                         ("llama-3.2-vision-90b", 10)],
                         ids=["granite-3-8b", "gemma2-9b", "mamba2-780m",
                              "whisper-base", "llama-3.2-vision-90b"])
def test_serve_launcher_on_cpu(arch, prompt):
    out = serve.main(["--arch", arch, "--preset", "smoke",
                      "--batch", "3", "--prompt-len", str(prompt), "--gen",
                      "5", "--device", "cpu"])
    vocab = treg.get(arch).smoke.vocab
    assert out["tokens"].shape == (3, 5)
    assert set(_lens(out["cache"])) == {prompt + 5 - 1}
    assert len(out["decode_step_ms"]) == 4
    assert torch.isfinite(out["prefill_logits"][:, :vocab]).all()
    before, after = out["backbone_checksum"]
    assert before == after
    assert 0 <= int(out["tokens"].min()) and int(out["tokens"].max()) < vocab


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_serve_launcher_matches_jax(arch):
    """The launcher on the CPU (smoke, f32, B=2, 10-token prompts, 5
    tokens) against JAX's prefill and greedy decode run on the launcher's
    own params, prompts and stub frontend, bridged: the prefill logits at
    2e-5, the same 5 tokens, every cache leaf at 2e-5 (``len`` exact), the
    frontend ``randn * 0.1`` of ``frontend_shape``'s shape."""
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "10",
                      "--gen", "5", "--device", "cpu"])
    jentry, cfg = jreg.get(arch), treg.get(arch).smoke
    prompts = torch.randint(0, cfg.vocab, (2, 10),
                            generator=torch.Generator().manual_seed(1))
    fe = out["frontend"]
    assert {k: tuple(t.shape) for k, t in fe.items()} == \
        treg.get(arch).frontend_shape(cfg, 2)
    assert 0.05 < float(next(iter(fe.values())).std()) < 0.2
    jp, jfe = bridge.to_numpy(out["params"]), bridge.to_numpy(fe)
    jpre = jentry.module.prefill(jp, jentry.smoke, prompts.numpy(),
                                 frontend=jfe, max_len=10 + 5 + 8,
                                 policy=JP32, cache_dtype=jnp.float32,
                                 logits_mode="last")
    np.testing.assert_allclose(_np(out["prefill_logits"]),
                               np.asarray(jpre["logits"][:, -1]), **TOL)
    jdec = jax.jit(lambda p, t, c: jentry.module.decode_step(
        p, jentry.smoke, t, c, policy=JP32))
    jt = jnp.argmax(jpre["logits"][:, -1], -1)[:, None].astype(jnp.int32)
    toks, jc = [jt], jpre["cache"]
    for _ in range(4):
        jl, jc = jdec(jp, jt, jc)
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(jt)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.concatenate(toks, axis=1))
    assert_trees_close(out["cache"], jc, TOL)


def test_serve_launcher_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "granite-3-8b", "--device", "cuda"])


def test_quickstart_trains_then_decodes():
    out = quickstart.main(["--device", "cpu"])
    assert len(out["losses"]) == 10
    assert all(math.isfinite(x) for x in out["losses"])
    vocab = treg.get(quickstart.ARCH).smoke.vocab
    assert len(out["generated"]) == 9
    assert all(0 <= t < vocab for t in out["generated"])


# configs of no registered arch (``VARIANTS``): gemma2's widths with an ssd
# layer after the local one, and granite's widths with lru layers alone
MIXES = ("local+ssd", "lru")
ENTRY_POINTS = ("init_cache", "prefill", "decode_step", "launcher")


def _mix(name: str):
    """The port's config of a mix."""
    arch, kw = VARIANTS[name]
    return dc.replace(treg.get(arch).smoke, **kw(ttr.LayerSpec))


def _cases(archs) -> list:
    """Every entry point of each; a mix has no launcher case."""
    return [(arch, where) for arch in archs for where in ENTRY_POINTS
            if not (arch in MIXES and where == "launcher")]


# the configs whose serving item 3(c) ported: they raised before it
SSD_SERVED = _cases(("mamba2-780m", "local+ssd"))
# the configs whose serving item 2(c)-ii ported: they raised before it
LRU_SERVED = _cases(("recurrentgemma-9b", "lru"))
# the archs whose serving item 3(d) ported: they raised before it
CROSS_SERVED = _cases(CROSS_ARCHS)


def _state_entry_point_runs(arch: str, where: str, kind: str):
    """One entry point serving ``kind`` (``ssd`` or ``lru``) layers:
    ``init_cache`` gives each its zero state (and ``step`` only without an
    ``attn`` or ``local`` layer), ``prefill`` and ``decode_step`` (from
    that zero cache) give finite logits, advance the position and move
    every state's ``h``; the launcher serves the arch at its defaults
    (32-token prompts, 16 tokens)."""
    if where == "launcher":
        out = serve.main(["--arch", arch, "--device", "cpu"])
        assert out["tokens"].shape == (4, 16)
        assert set(_lens(out["cache"])) == {32 + 16 - 1}
        return
    module, cfg = (ttr, _mix(arch)) if arch in MIXES else \
        (treg.get(arch).module, treg.get(arch).smoke)
    specs = [("stack", i, sp) for i, sp in enumerate(cfg.pattern)] + \
        [("rem", i, sp) for i, sp in enumerate(cfg.remainder)]
    cache = module.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    states = [cache[g][f"sub{i}"] for g, i, sp in specs if sp.kind == kind]
    assert states
    attends = any(sp.kind in ("attn", "local") for _, _, sp in specs)
    assert ("step" in cache) == (not attends)
    want = {"ssd": ["conv_b", "conv_c", "conv_x", "h"],
            "lru": ["conv", "h"]}[kind]
    for c in states:
        assert sorted(c) == want
        assert not any(t.any() for t in c.values())
    if where == "init_cache":
        return
    params = module.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    if where == "prefill":
        out = module.prefill(params, cfg, tok, max_len=8, policy=TP32,
                             cache_dtype=torch.float32)
        logits, cache, held = out["logits"], out["cache"], 4
    else:
        logits, cache = module.decode_step(params, cfg, tok[:, :1], cache,
                                           policy=TP32)
        held = 1
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert set(_lens(cache)) == {held}
    assert all(cache[g][f"sub{i}"]["h"].any() for g, i, sp in specs
               if sp.kind == kind)


@pytest.mark.parametrize("arch,where", SSD_SERVED,
                         ids=[f"{a}-{w}" for a, w in SSD_SERVED])
def test_ssd_serving_entry_point_runs(arch, where):
    """Each entry point serves an ``ssd`` layer (mamba2-780m, and the
    ``local+ssd`` mix, whose ring gives the position)."""
    _state_entry_point_runs(arch, where, "ssd")


@pytest.mark.parametrize("arch,where", LRU_SERVED,
                         ids=[f"{a}-{w}" for a, w in LRU_SERVED])
def test_lru_serving_entry_point_runs(arch, where):
    """Each entry point serves an ``lru`` layer: recurrentgemma-9b (four
    ``lru`` states in the stack and the remainder beside a ``local`` ring,
    no ``step``) and the ``lru`` mix (``lru`` layers alone, so a
    ``step``)."""
    _state_entry_point_runs(arch, where, "lru")


@pytest.mark.parametrize("arch,where", CROSS_SERVED,
                         ids=[f"{a}-{w}" for a, w in CROSS_SERVED])
def test_cross_serving_entry_point_runs(arch, where):
    """Each entry point serves ``cross`` layers: ``init_cache`` gives each
    its zero k and v of ``max(n_frontend_tokens, 1)`` slots and no ``len``
    (and no ``step``: there is an ``attn`` layer), and allocates nothing
    on the ``meta`` device; ``prefill`` (with the launcher's stub
    frontend) fills the cross caches, and it and ``decode_step`` (from the
    zero cache) give finite logits and advance the position; the launcher
    serves the arch at its defaults (32-token prompts, 16 tokens)."""
    if where == "launcher":
        out = serve.main(["--arch", arch, "--device", "cpu"])
        assert out["tokens"].shape == (4, 16)
        assert set(_lens(out["cache"])) == {32 + 16 - 1}
        return
    entry = treg.get(arch)
    module, cfg = entry.module, entry.smoke
    meta = module.init_cache(cfg, 1, 8, torch.float32, device="meta")
    assert {t.device.type for _, t in tree_flatten(meta)} == {"meta"}
    cache = module.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    assert "step" not in cache
    cross = _cross_leaves(cfg, cache)
    assert cross
    for c in cross.values():
        assert sorted(c) == ["k", "v"]
        assert c["k"].shape[2] == max(cfg.n_frontend_tokens, 1)
        assert not c["k"].any() and not c["v"].any()
    if where == "init_cache":
        return
    params = module.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    if where == "prefill":
        fe = stub_frontend(entry, cfg, 1, torch.float32, "cpu", seed=7)
        out = module.prefill(params, cfg, tok, frontend=fe, max_len=8,
                             policy=TP32, cache_dtype=torch.float32)
        logits, cache, held = out["logits"], out["cache"], 4
        assert all(c["k"].any() for c in _cross_leaves(cfg, cache).values())
    else:
        logits, cache = module.decode_step(params, cfg, tok[:, :1], cache,
                                           policy=TP32)
        held = 1
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert set(_lens(cache)) == {held}
