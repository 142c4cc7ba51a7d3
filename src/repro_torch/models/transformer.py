"""Generic pattern-driven transformer stack (training / scoring forward).

Counterpart of ``repro/models/transformer.py:33-277``.  The repeating layer
pattern's params are stacked on a leading ``n_rep`` axis (the JAX package's
scan layout, ``params["stack"]["sub<i>"]``) and the forward walks it with a
Python loop; remainder layers run unrolled.  The port covers ``attn``,
``local`` (sliding-window) and ``cross`` layers with dense or MoE channel
mixers, and ``ssd`` (Mamba-2) layers; the ``lru`` kind raises
``NotImplementedError``.  A ``cross`` layer attends to
``frontend["cross_kv"]`` (stub image embeddings, or the encoder's output in
``models/encdec.py``) without rope and without a causal mask; given no
frontend it attends to its own input, non-causally, as the reference's
does.  Serving (``prefill``/``decode_step``) is not ported yet (ROADMAP §1
item 3, 'Serving').
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.common import LayerSpec, ModelConfig
from repro_torch.models import layers as L, moe as moe_mod, ssm

_PORTED_KINDS = ("attn", "local", "cross", "ssd")
_PORTED_MLPS = ("dense", "moe", "none")
# the ROADMAP §1 'Modules to port' item that ports each layer kind still
# missing; the registry names an unported arch's item through it too
KIND_ITEMS = {"lru": "2(c) (models/hybrid.py: RG-LRU)"}


def roadmap_item(kind: str) -> str:
    return ("ROADMAP §1 'Modules to port' item "
            + KIND_ITEMS.get(kind, "2, 'The other layer kinds'"))


def _check_spec(spec: LayerSpec):
    if spec.kind not in _PORTED_KINDS or spec.mlp not in _PORTED_MLPS:
        raise NotImplementedError(
            f"layer {spec} is not ported to repro_torch yet "
            f"({roadmap_item(spec.kind)})")


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
