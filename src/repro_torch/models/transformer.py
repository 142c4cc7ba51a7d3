"""Generic pattern-driven transformer stack: the training / scoring
forward, and serving (``prefill`` + ``decode_step`` with a KV cache).

Counterpart of ``repro/models/transformer.py``.  The repeating layer
pattern's params are stacked on a leading ``n_rep`` axis (the JAX package's
scan layout, ``params["stack"]["sub<i>"]``) and the forward walks it with a
Python loop; remainder layers run unrolled.  The forward covers every
layer kind of the reference: ``attn``, ``local`` (sliding-window) and
``cross`` layers with dense or MoE channel mixers, ``ssd`` (Mamba-2,
``models/ssm.py``) and ``lru`` (Griffin's RG-LRU, ``models/hybrid.py``)
layers; an unknown kind raises ``ValueError``, as the reference's
``_sub_init`` does.  A ``cross`` layer attends to
``frontend["cross_kv"]`` (stub image embeddings, or the encoder's output in
``models/encdec.py``) without rope and without a causal mask; given no
frontend it attends to its own input, non-causally, as the reference's
does.  Serving covers every kind with any channel mixer.  The cache tree
is the reference's leaf for leaf, ``{"stack": {"sub<i>": {...}}, "rem":
{...}}``: an ``attn`` or ``local`` layer holds ``"k", "v": [n_rep, B,
size, KV, hd]`` and ``"len": [n_rep]`` int32, ``size`` being ``max_len``,
or for a ``local`` layer ``min(window, max_len)``; a ``local`` layer's
cache also has ``pos`` (``[n_rep, size]`` int32, the position held in each
slot, -1 for none) in ``init_cache`` always and in ``prefill`` when its
window is shorter than ``max_len``, and then it is a ring buffer written at
slot ``len % size``.  An ``ssd`` layer holds its Mamba-2 state, ``"h":
[n_rep, B, H, P, N]`` f32 and ``"conv_x"/"conv_b"/"conv_c": [n_rep, B,
K-1, C]``; an ``lru`` layer its RG-LRU state, ``"h": [n_rep, B, W]`` f32
and ``"conv": [n_rep, B, K-1, W]``.  A ``cross`` layer holds the keys and
values of its frontend, ``"k", "v": [n_rep, B, T, KV, hd]``, with no rope
and no ``len``: ``T`` is the frontend's length after ``prefill``,
``max(n_frontend_tokens, 1)`` in ``init_cache``; decode only reads it.  A
cache with no ``attn`` or ``local`` layer carries the position in a
top-level ``"step"`` (0-d int32).  A decode step updates the cache in
place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.common import LayerSpec, ModelConfig
from repro_torch.distributed import ctx, sharding as sh
from repro_torch.distributed.ctx import constrain
from repro_torch.models import hybrid, layers as L, moe as moe_mod, ssm

_KINDS = ("attn", "local", "cross", "ssd", "lru")
_MLPS = ("dense", "moe", "none")
_STATE_KINDS = ("ssd", "lru")      # a recurrent state, not a KV cache


def _check_spec(spec: LayerSpec):
    if spec.kind not in _KINDS:
        raise ValueError(spec.kind)
    if spec.mlp not in _MLPS:
        raise ValueError(spec.mlp)


def _norm_init(cfg: ModelConfig, d: int, **kw) -> dict:
    return (L.layernorm_init(d, **kw) if cfg.norm == "layernorm"
            else L.rmsnorm_init(d, **kw))


def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return L.layernorm(p, x) if cfg.norm == "layernorm" else L.rmsnorm(p, x)


def _act(cfg: ModelConfig):
    return L.gelu_tanh if cfg.act == "gelu" else F.silu


def attn_cfg_for(cfg: ModelConfig, spec: LayerSpec) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=(cfg.rope_theta
                    if cfg.pos_embed == "rope" and spec.kind != "cross"
                    else None),
        softcap=cfg.softcap_attn,
        window=cfg.window if spec.kind == "local" else None,
        causal=cfg.causal and spec.kind != "cross",
        blockwise_threshold=cfg.blockwise_threshold,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
        causal_skip=cfg.causal_skip,
        use_flash=cfg.use_flash and spec.kind == "attn",
    )


def _ssd_cfg(cfg: ModelConfig) -> ssm.SSDConfig:
    return ssm.SSDConfig(
        d_model=cfg.d_model, d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
        expand=cfg.ssm_expand, conv_width=cfg.conv_width, chunk=cfg.ssm_chunk)


def _lru_cfg(cfg: ModelConfig) -> hybrid.LRUConfig:
    return hybrid.LRUConfig(d_model=cfg.d_model, lru_width=cfg.lru_width,
                            conv_width=cfg.conv_width,
                            scan_chunk=cfg.lru_scan_chunk)


def _moe_cfg(cfg: ModelConfig) -> moe_mod.MoEConfig:
    return moe_mod.MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        group_size=cfg.moe_group_size, gated=cfg.gated_mlp,
        shared_expert=cfg.shared_expert)


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# sublayer init / apply
# --------------------------------------------------------------------------

def _sub_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
              **kw) -> dict:
    _check_spec(spec)
    p: dict = {"norm": _norm_init(cfg, cfg.d_model, **kw)}
    if spec.kind == "ssd":
        p["ssd"] = ssm.ssd_init(gen, _ssd_cfg(cfg), **kw)
    elif spec.kind == "lru":
        p["lru"] = hybrid.lru_init(gen, _lru_cfg(cfg), **kw)
    else:
        p["attn"] = L.attn_init(gen, attn_cfg_for(cfg, spec), **kw)
        if cfg.post_norm:
            p["post_norm"] = _norm_init(cfg, cfg.d_model, **kw)
    if spec.mlp == "dense":
        p["mlp_norm"] = _norm_init(cfg, cfg.d_model, **kw)
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff,
                              gated=cfg.gated_mlp, **kw)
        if cfg.post_norm:
            p["mlp_post_norm"] = _norm_init(cfg, cfg.d_model, **kw)
    elif spec.mlp == "moe":
        p["mlp_norm"] = _norm_init(cfg, cfg.d_model, **kw)
        p["moe"] = moe_mod.moe_init(gen, _moe_cfg(cfg), **kw)
        if cfg.post_norm:
            p["mlp_post_norm"] = _norm_init(cfg, cfg.d_model, **kw)
    return p


def _apply_mlp(p, h, spec, cfg, policy, bfp):
    """Channel mixer + residual; returns (h, aux), aux None without MoE."""
    if spec.mlp == "none":
        return h, None
    aux = None
    u = _norm(cfg, p["mlp_norm"], h)
    if spec.mlp == "dense":
        y = L.mlp(p["mlp"], u, policy=policy, bfp=bfp, act=_act(cfg))
    else:
        y, aux = moe_mod.moe_apply(p["moe"], u, _moe_cfg(cfg), policy=policy,
                                   bfp=bfp)
    if cfg.post_norm:
        y = _norm(cfg, p["mlp_post_norm"], y)
    return h + y, aux


def _sub_apply(p, h, spec, cfg, *, policy, bfp, cross_kv, positions):
    """Full-sequence sublayer (train / scoring). Returns (h, aux)."""
    _check_spec(spec)
    u = _norm(cfg, p["norm"], h)
    if spec.kind == "ssd":
        y, _ = ssm.ssd_block(p["ssd"], u, _ssd_cfg(cfg), policy=policy,
                             bfp=bfp)
    elif spec.kind == "lru":
        y, _ = hybrid.lru_block(p["lru"], u, _lru_cfg(cfg), policy=policy,
                                bfp=bfp)
    else:
        kv = cross_kv if spec.kind == "cross" else None
        y = L.attention_layer(p["attn"], u, attn_cfg_for(cfg, spec),
                              policy=policy, bfp=bfp, kv_x=kv,
                              positions=positions)
        if cfg.post_norm:
            y = _norm(cfg, p["post_norm"], y)
    return _apply_mlp(p, h + y, spec, cfg, policy, bfp)


# --------------------------------------------------------------------------
# top-level params / forward
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Backbone params; each tensor is drawn in f32 and stored in ``dtype``
    (the same values as casting an f32 tree, without holding it)."""
    cfg.validate()
    kw = dict(dtype=dtype, device=device)
    params: dict = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                              pad_to=cfg.vocab_pad_multiple, **kw),
        "final_norm": _norm_init(cfg, cfg.d_model, **kw),
    }
    if cfg.n_rep:
        params["stack"] = {
            f"sub{i}": _sub_init(gen, cfg, s, lead=(cfg.n_rep,), **kw)
            for i, s in enumerate(cfg.pattern)}
    if cfg.remainder:
        params["rem"] = {f"sub{i}": _sub_init(gen, cfg, s, **kw)
                         for i, s in enumerate(cfg.remainder)}
    return params


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, policy: L.Policy) -> torch.Tensor:
    h = L.embed_lookup(params["embed"], tokens, policy)
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    if cfg.pos_embed == "sinusoidal":
        h = h + sinusoidal_embed(positions, cfg.d_model).to(h.dtype)
    return h


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: dict | None = None,
            policy: L.Policy = L.Policy(), bfp: L.BFPPolicy = L.NO_BFP,
            collect_taps: bool = False, tap_indices=None,
            tap_pool: int = 1,
            inputs_embeds: torch.Tensor | None = None) -> dict:
    """Full-sequence forward. Returns {hidden, taps, aux, emb}; ``aux`` is
    the f32 sum of the MoE layers' load-balancing losses (0 without MoE).

    ``frontend["cross_kv"]`` ([B, T, D], as given) is what the ``cross``
    layers attend to.  ``inputs_embeds`` ([B, S, D]) replaces the token
    embedding, and sets the batch and the length (the encoder's frames).

    With ``tap_indices`` (+ ``tap_pool``) only the selected superblocks'
    hidden states are kept, pooled as the loop passes them:
    ``taps`` is ``[len(tap_indices), B, ceil(S/pool), D]`` in ``h.dtype``.
    Without indices, ``collect_taps`` stacks every superblock's output.
    """
    from repro_torch.core.duplex import pool_seq   # local import, no cycle
    b, s = (tokens if inputs_embeds is None else inputs_embeds).shape[:2]
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    h = (embed_tokens(params, cfg, tokens, positions, policy)
         if inputs_embeds is None else inputs_embeds)
    h = constrain(h, "resid")
    emb = h
    cross_kv = None if frontend is None else frontend.get("cross_kv")
    aux = torch.zeros((), dtype=torch.float32, device=dev)   # dense: adds 0
    taps = None
    if cfg.n_rep:
        use_buf = collect_taps and tap_indices is not None
        wanted = set(int(i) for i in tap_indices) if use_buf else set()
        pooled, every = {}, []
        for step_i in range(cfg.n_rep):
            p_rep = _index(params["stack"], step_i)
            for i, spec in enumerate(cfg.pattern):
                h, a = _sub_apply(p_rep[f"sub{i}"], h, spec, cfg,
                                  policy=policy, bfp=bfp, cross_kv=cross_kv,
                                  positions=positions)
                h = constrain(h, "resid")
                if a is not None:
                    aux = aux + a
            if step_i in wanted:
                pooled[step_i] = pool_seq(h, tap_pool)
            elif collect_taps and not use_buf:
                every.append(h)
        if use_buf:
            taps = torch.stack([pooled[int(i)] for i in tap_indices])
        elif collect_taps:
            taps = torch.stack(every)                     # [n_rep,B,S,D]
    for i, spec in enumerate(cfg.remainder):
        h, a = _sub_apply(params["rem"][f"sub{i}"], h, spec, cfg,
                          policy=policy, bfp=bfp, cross_kv=cross_kv,
                          positions=positions)
        if a is not None:
            aux = aux + a
    h = _norm(cfg, params["final_norm"], h)
    return {"hidden": h, "taps": taps, "aux": aux, "emb": emb}


def lm_logits(params, cfg: ModelConfig, hidden: torch.Tensor,
              policy: L.Policy = L.Policy()) -> torch.Tensor:
    return L.unembed_logits(params["embed"], hidden, cfg.vocab, policy,
                            softcap=cfg.softcap_final)


# --------------------------------------------------------------------------
# serving: prefill + decode with caches (``attn``, ``local``, ``cross``) and
# recurrent states (``ssd``, ``lru``)
# --------------------------------------------------------------------------

def _ring_size(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.kind == "local" and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def _sub_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_len: int, dtype, *, lead: tuple = (), device,
                    cross_len: int | None = None) -> dict:
    """One sublayer's zero cache, the reference's ``_sub_cache_zeros``:
    k and v sized by ``_ring_size``; a ``local`` layer's also holds ``pos``
    filled with -1 (whatever its size, as the reference's does); a
    ``cross`` layer's k and v hold ``cross_len`` frontend positions, by
    default ``max(n_frontend_tokens, 1)`` (the reference's dry-run
    stand-in), and no ``len``; an ``ssd`` or ``lru`` layer's is
    ``ssm.ssd_state_init``'s or ``hybrid.lru_state_init``'s on ``lead``
    (``h`` f32, the conv states in ``dtype``)."""
    if spec.kind == "cross":
        t = max(cfg.n_frontend_tokens, 1) if cross_len is None else cross_len
        shape = (*lead, batch, t, cfg.n_kv, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if spec.kind in _STATE_KINDS:
        base = (ssm.ssd_state_init(_ssd_cfg(cfg), batch, dtype,
                                   device="meta")
                if spec.kind == "ssd" else
                hybrid.lru_state_init(_lru_cfg(cfg), batch, dtype,
                                      device="meta"))
        return {k: torch.zeros((*lead, *t.shape), dtype=t.dtype,
                               device=device) for k, t in base.items()}
    size = _ring_size(cfg, spec, max_len)
    c = L.attn_cache_init(attn_cfg_for(cfg, spec), batch, size, dtype,
                          lead=lead, device=device)
    if spec.kind == "local":
        c["pos"] = torch.full((*lead, size), -1, dtype=torch.int32,
                              device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device,
               cross_len: int | None = None) -> dict:
    """Shape-complete zero cache (also the decode dry-run entry point; on
    the ``meta`` device it allocates nothing), with a zero ``step`` when no
    layer is ``attn`` or ``local``.  ``cross_len`` sizes the ``cross``
    layers' k and v (``prefill`` passes its frontend's length); by default
    ``max(n_frontend_tokens, 1)``."""
    for spec in cfg.pattern + cfg.remainder:
        _check_spec(spec)
    kw = dict(device=device, cross_len=cross_len)
    cache = {"stack": {f"sub{i}": _sub_cache_init(
                 cfg, spec, batch, max_len, dtype, lead=(cfg.n_rep,), **kw)
                 for i, spec in enumerate(cfg.pattern)},
             "rem": {f"sub{i}": _sub_cache_init(
                 cfg, spec, batch, max_len, dtype, **kw)
                 for i, spec in enumerate(cfg.remainder)}}
    if not any(s.kind in ("attn", "local")
               for s in cfg.pattern + cfg.remainder):
        cache["step"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _layers(params, cache, cfg: ModelConfig):
    """``(params, cache, spec)`` of every sublayer in order; the stacked
    ones are views of their ``n_rep`` slice, so writes land in the
    stack."""
    for r in range(cfg.n_rep):
        p_rep, c_rep = _index(params["stack"], r), _index(cache["stack"], r)
        for i, spec in enumerate(cfg.pattern):
            yield p_rep[f"sub{i}"], c_rep[f"sub{i}"], spec
    for i, spec in enumerate(cfg.remainder):
        yield params["rem"][f"sub{i}"], cache["rem"][f"sub{i}"], spec


def _state_serve(p, h, spec, cfg, cache, *, policy):
    """An ``ssd`` or ``lru`` sublayer over h [B, S, D] from the state in
    ``cache`` (zero at prefill), which it overwrites in place with the
    state after the last token: ``ssm.ssd_block`` or ``hybrid.lru_block``
    (at S=1, ``_rg_lru``'s one-step recurrence).  The new conv states land
    in the leaves' dtype, where the reference returns them in the compute
    dtype (``decode_step``).  Returns h."""
    u = _norm(cfg, p["norm"], h)
    if spec.kind == "ssd":
        y, st = ssm.ssd_block(p["ssd"], u, _ssd_cfg(cfg), policy=policy,
                              state=cache)
    else:
        y, st = hybrid.lru_block(p["lru"], u, _lru_cfg(cfg), policy=policy,
                                 state=cache)
    for k, t in st.items():
        cache[k].copy_(t)
    h, _ = _apply_mlp(p, h + y, spec, cfg, policy, L.NO_BFP)
    return h


def _sub_prefill(p, h, spec, cfg, cache, *, policy, positions, cross_kv):
    """Sublayer forward that fills its cache.  An ``ssd`` or ``lru`` layer
    runs its block from the zero state and keeps the state after the
    prompt.  An ``attn`` or ``local`` layer writes its k (after rope) and v
    and sets ``len`` to S: slots ``[0, S)``, or for a ring (a cache with
    ``pos``) the last ``min(size, S)`` tokens at slots ``t % size``, with
    their positions in ``pos``.  A ``cross`` layer attends to ``cross_kv``
    [B, T, D] (no rope, no mask) and writes the k and v it projected from
    it, the reference's ``dense(wk|wv, cross_kv)``.  Blockwise when the
    queries or keys pass ``blockwise_threshold``, full below, never flash
    (as the reference's).  Returns h."""
    if spec.kind in _STATE_KINDS:
        return _state_serve(p, h, spec, cfg, cache, policy=policy)
    acfg = attn_cfg_for(cfg, spec)
    b, s, _ = h.shape
    u = _norm(cfg, p["norm"], h)
    q, k, v = L._project_qkv(p["attn"], u,
                             cross_kv if spec.kind == "cross" else u, acfg,
                             policy, L.NO_BFP, positions)
    o = L.attention_core(q, k, v, acfg, causal=acfg.causal)
    y = L.dense(p["attn"]["wo"], o.reshape(b, s, acfg.n_heads * acfg.head_dim),
                policy=policy)
    if cfg.post_norm:
        y = _norm(cfg, p["post_norm"], y)
    if spec.kind == "cross":
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    elif "pos" in cache:
        size = cache["k"].shape[1]
        keep = min(size, s)
        for name, t in (("k", k), ("v", v)):
            ctx.write_slots_(cache[name], 1, s - keep,
                             t[:, -keep:].to(cache[name].dtype), ring=True)
        ctx.write_slots_(cache["pos"], 0, s - keep, torch.arange(
            s - keep, s, dtype=torch.int32, device=h.device), ring=True)
    else:
        for name, t in (("k", k), ("v", v)):
            ctx.write_slots_(cache[name], 1, 0, t.to(cache[name].dtype))
    if "len" in cache:
        cache["len"].fill_(s)
    h, _ = _apply_mlp(p, h + y, spec, cfg, policy, L.NO_BFP)
    return h


def _placed_cache(cache: dict, named: dict, device) -> dict:
    """The ``meta`` cache tree ``cache`` made anew as DTensors laid out by
    ``named`` (``cache_pspec``'s, the layout a decode cell takes), each
    rank's block allocated on ``device`` and filled as ``init_cache`` fills
    it: ``pos`` with -1, the rest with 0."""
    return {k: _placed_cache(v, named[k], device) if isinstance(v, dict)
            else ctx.full_placed(tuple(v.shape), -1 if k == "pos" else 0,
                                 v.dtype, named[k], device)
            for k, v in cache.items()}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: dict | None = None, max_len: int,
            policy: L.Policy = L.Policy(), cache_dtype=torch.bfloat16,
            logits_mode: str = "all") -> dict:
    """Process a prompt, return ``{logits, cache, hidden}`` (cache ready for
    decode).  The cache is allocated once, on the tokens' device, and each
    layer writes its slice of it.  ``logits_mode="last"`` unembeds only the
    final position.  ``cross`` layers attend to ``frontend["cross_kv"]``
    [B, T, D] and cache its k and v at its own length T (not
    ``n_frontend_tokens``); a config with a ``cross`` layer and no
    ``cross_kv`` raises ``ValueError`` before any compute, where the
    reference's prefill fails on ``None.shape``.

    A ``local`` layer whose window is shorter than ``max_len`` caches a ring
    of ``window`` slots (with ``pos``); one whose window reaches ``max_len``
    caches all ``max_len`` slots, without ``pos``, as the reference's
    prefill does (its ``init_cache`` gives that layer a ``pos`` leaf).  An
    ``ssd`` or ``lru`` layer's conv states are in the compute dtype, not
    ``cache_dtype`` (its ``h`` is f32), and ``step`` is S, as the
    reference's prefill returns them.

    Given DTensor tokens (a cell placed on a mesh), the cache is made of
    DTensors on their mesh, laid out by ``sharding.cache_pspec`` as a
    decode cell takes it, and every write lands in each rank's own block
    (``ctx.write_slots_``; the states' ``copy_``)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cross_kv = None if frontend is None else frontend.get("cross_kv")
    if cross_kv is None and any(sp.kind == "cross"
                                for sp in cfg.pattern + cfg.remainder):
        raise ValueError(f"{cfg.name}: prefill of a cross layer needs "
                         f"frontend['cross_kv'], the [B, T, D] it attends "
                         f"to; none was given")
    dev = tokens.device
    mesh = getattr(tokens, "device_mesh", None)       # a DTensor's
    positions = torch.arange(s, device=dev).expand(b, s)
    h = embed_tokens(params, cfg, tokens, positions, policy)
    cache = init_cache(cfg, b, max_len, cache_dtype,
                       device=dev if mesh is None else "meta",
                       cross_len=None if cross_kv is None
                       else cross_kv.shape[1])
    # only a ring (fewer slots than max_len) keeps ``pos``, and the conv
    # states take the compute dtype, as in the reference's prefill
    for c in (*cache["stack"].values(), *cache["rem"].values()):
        if "pos" in c and c["k"].shape[-3] == max_len:
            del c["pos"]
        for k in ("conv_x", "conv_b", "conv_c", "conv"):
            if k in c:
                c[k] = c[k].to(policy.compute_dtype)
    if mesh is not None:
        cache = _placed_cache(cache, sh.to_named(
            sh.tree_pspecs(cache, mesh, sh.cache_pspec), mesh),
            tokens.to_local().device)
    if "step" in cache:
        cache["step"].fill_(s)
    for p, c, spec in _layers(params, cache, cfg):
        h = _sub_prefill(p, h, spec, cfg, c, policy=policy,
                         positions=positions, cross_kv=cross_kv)
    h = _norm(cfg, params["final_norm"], h)
    h_out = h[:, -1:] if logits_mode == "last" else h
    return {"logits": lm_logits(params, cfg, h_out, policy), "cache": cache,
            "hidden": h}


def _ring_decode(p_attn, u, cache: dict, acfg: L.AttnConfig, *, policy):
    """Sliding-window decode over a ring cache ``{"k", "v": [B, size, KV,
    hd], "pos": [size], "len"}``: rope at position ``len``; k, v and the
    position written at slot ``len % size``, computed on the device; the
    slots whose position lies in ``(len - window, len]`` attended
    (``L.decode_attention`` over ``pos``); then ``len`` advanced, all in
    place.  A ring never overflows."""
    b = u.shape[0]
    cur = cache["len"]
    q, k, v = L._project_qkv(p_attn, u, u, acfg, policy, L.NO_BFP,
                             cur.view(1, 1).expand(b, 1))
    slot = (cur % cache["k"].shape[1]).long().view(1)
    ctx.index_copy_(cache["k"], 1, slot, k.to(cache["k"].dtype))
    ctx.index_copy_(cache["v"], 1, slot, v.to(cache["v"].dtype))
    ctx.index_copy_(cache["pos"], 0, slot, cur.view(1))
    # the reference's two "dec_scores" constraints here (on the scores and
    # on the softmax weights) are those inside L.decode_attention
    o = L.decode_attention(q, cache["k"], cache["v"], cur + 1,
                           softcap=acfg.softcap, window=acfg.window,
                           kpos=cache["pos"])
    cache["len"].add_(1)
    return L.dense(p_attn["wo"], o.reshape(b, 1, acfg.n_heads
                                           * acfg.head_dim), policy=policy)


def _cross_decode(p_attn, u, cache: dict, acfg: L.AttnConfig, *, policy):
    """One token's cross-attention over a ``cross`` cache ``{"k", "v": [B,
    T, KV, hd]}``: q from u, without rope, attends to every slot, no mask
    (``L.full_attention``, non-causal); the cache is only read."""
    b = u.shape[0]
    q = ctx.split_last(L.dense(p_attn["wq"], u, policy=policy),
                       acfg.n_heads, acfg.head_dim)
    o = L.full_attention(ctx.gather_dim(q, 2), cache["k"], cache["v"],
                         causal=False, softcap=acfg.softcap)
    return L.dense(p_attn["wo"], o.reshape(b, 1, acfg.n_heads
                                           * acfg.head_dim), policy=policy)


def _sub_decode(p, h, spec, cfg, cache, *, policy):
    """One-token sublayer step; updates ``cache`` in place (a ``cross``
    cache is only read).  Returns h."""
    _check_spec(spec)
    if spec.kind in _STATE_KINDS:
        return _state_serve(p, h, spec, cfg, cache, policy=policy)
    u = _norm(cfg, p["norm"], h)
    acfg = attn_cfg_for(cfg, spec)
    if spec.kind == "cross":
        y = _cross_decode(p["attn"], u, cache, acfg, policy=policy)
    elif "pos" in cache:
        y = _ring_decode(p["attn"], u, cache, acfg, policy=policy)
    else:
        y, _ = L.attention_decode(p["attn"], u, cache, acfg, policy=policy)
    if cfg.post_norm:
        y = _norm(cfg, p["post_norm"], y)
    h, _ = _apply_mlp(p, h + y, spec, cfg, policy, L.NO_BFP)
    return h


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                *, policy: L.Policy = L.Policy()) -> tuple:
    """One decode step: tokens [B,1] + cache → (logits [B,1,V], cache).

    The cache is updated in place (the reference donates it) and returned.
    The position is the cache's ``step`` when it has one (no ``attn`` or
    ``local`` layer), else the first ``attn`` or ``local`` cache's ``len``
    (all sublayers advance in lockstep), read on the device: the step
    issues no host sync; ``step`` is then advanced by 1.  A cache from
    ``prefill(..., max_len=M)`` of a P-token prompt takes at most M - P
    steps while it has an ``attn`` layer (or a ``local`` one without a
    ring): the next write to slot M raises (``IndexError`` on the CPU, a
    device-side assert on the card), where the reference clamps it onto
    slot M - 1.  A ring's slot is ``len % size``, and an ``ssd`` or
    ``lru`` layer's state has no length: neither fills, so a cache of only
    such layers (and rings, as recurrentgemma-9b's) has no limit; a
    ``cross`` cache is read, never written.
    An ``ssd`` or ``lru`` layer's new conv states are written in the
    leaves' dtype, where the reference returns them in the compute dtype
    (only a cache of another dtype than the compute's, as neither launcher
    makes, sees the rounding)."""
    b = tokens.shape[0]
    pos = cache["step"].clone() if "step" in cache else \
        _first_len(cfg, cache)
    h = embed_tokens(params, cfg, tokens, pos.view(1, 1).expand(b, 1),
                     policy)
    for p, c, spec in _layers(params, cache, cfg):
        h = _sub_decode(p, h, spec, cfg, c, policy=policy)
    if "step" in cache:
        cache["step"].add_(1)
    h = _norm(cfg, params["final_norm"], h)
    return lm_logits(params, cfg, h, policy), cache


def _first_len(cfg: ModelConfig, cache: dict) -> torch.Tensor:
    """A copy of the first ``attn`` or ``local`` cache's ``len`` (0-d, on the
    device; in the stack, then in the remainder): the layers advance theirs
    in place as the step runs.  It counts tokens, never a ring's slot.  A
    cache with no such layer carries ``step`` instead; a hybrid stack
    (recurrentgemma-9b: ``lru``, ``lru``, ``local``) reads its first
    ``local`` layer."""
    for i, spec in enumerate(cfg.pattern if cfg.n_rep else ()):
        if spec.kind in ("attn", "local"):
            return cache["stack"][f"sub{i}"]["len"][0].clone()
    for i, spec in enumerate(cfg.remainder):
        if spec.kind in ("attn", "local"):
            return cache["rem"][f"sub{i}"]["len"].clone()
    raise ValueError("no attn or local cache to read the position from")
