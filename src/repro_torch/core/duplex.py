"""Duplex DNN (DuDNN) — CAMEL §III: frozen backbone + reversible branch.

Counterpart of ``repro/core/duplex.py``.  The backbone runs forward only
and is frozen; the branch is a stack of norm-free reversible blocks over a
*pooled* stream with 2D-BFP quantized matmuls; backbone hidden states are
tapped at matching depths, pooled, projected and injected into the branch's
``x2`` stream.  The branch correction for token ``t`` uses only fully-past
pooled segments (``floor(t/r) − 1``), so next-token training is leak-free.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.reversible import ReversibleStack, stack_params
from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.utils import ceil_to


@dataclasses.dataclass(frozen=True)
class DuplexConfig:
    n_blocks: int = 4            # reversible branch depth (paper: 4–6)
    d_branch: int = 256          # branch stream width
    pool_factor: int = 16        # §III-C; paper uses up to 16
    branch_heads: int = 4
    branch_ff_mult: int = 4
    use_norm: bool = False       # §III-D ablation (Fig 21b): default norm-free
    causal: bool = True          # LM mode; False for classification
    bfp: L.BFPPolicy = L.BFPPolicy(enabled=True)  # §III-E on branch matmuls


# --------------------------------------------------------------------------
# pooling / upsampling (seq-dim analogue of the paper's spatial pooling)
# --------------------------------------------------------------------------

def pool_seq(x: torch.Tensor, r: int) -> torch.Tensor:
    """Non-overlapping mean pooling along seq: [B,S,D] → [B,ceil(S/r),D]."""
    if r == 1:
        return x
    b, s, d = x.shape
    sp = ceil_to(s, r)
    starts = torch.arange(0, sp, r, device=x.device)
    if sp != s:
        x = ctx.pad(x, (0, 0, 0, sp - s))
        # renormalize the ragged tail so padding doesn't dilute the mean
        counts = torch.clamp(torch.clamp(s - starts, max=r), 1, r)
    else:
        counts = torch.full((sp // r,), r, device=x.device)
    pooled = x.reshape(b, sp // r, r, d).sum(dim=2)
    return pooled / counts[None, :, None].to(x.dtype)


def upsample_causal(y: torch.Tensor, r: int, s: int) -> torch.Tensor:
    """Causal upsample: token t receives pooled segment floor(t/r) − 1.

    Segment i pools tokens [i·r, (i+1)·r); only complete, strictly past
    segments may influence a token's correction (no label leak).
    """
    seg = torch.arange(s, device=y.device) // r
    idx = torch.clamp(seg - 1, 0, y.shape[1] - 1)
    gathered = ctx.take(y, 1, idx)                     # [B,S,D]
    valid = (seg >= 1)[None, :, None]
    return torch.where(valid, gathered, torch.zeros_like(gathered))


def upsample_full(y: torch.Tensor, r: int, s: int) -> torch.Tensor:
    """Non-causal upsample (classification mode): repeat each segment."""
    idx = torch.clamp(torch.arange(s, device=y.device) // r, 0, y.shape[1] - 1)
    return y[:, idx]


# --------------------------------------------------------------------------
# branch blocks: F1 = attention mixer, F2 = gated MLP — both norm-free
# --------------------------------------------------------------------------

def _branch_attn_cfg(cfg: DuplexConfig) -> L.AttnConfig:
    hd = max(cfg.d_branch // cfg.branch_heads, 8)
    return L.AttnConfig(
        d_model=cfg.d_branch, n_heads=cfg.branch_heads,
        n_kv=cfg.branch_heads, head_dim=hd, causal=cfg.causal,
        blockwise_threshold=4096)


def branch_block_init(gen: torch.Generator, cfg: DuplexConfig, *,
                      lead: tuple = (), device=None) -> dict:
    acfg = _branch_attn_cfg(cfg)
    kw = dict(lead=lead, device=device)
    p = {
        "f1": {"attn": L.attn_init(gen, acfg, **kw)},
        "f2": {"mlp": L.mlp_init(gen, cfg.d_branch,
                                 cfg.d_branch * cfg.branch_ff_mult, **kw)},
    }
    # norm-free stability: damp the residual writers (out projections)
    p["f1"]["attn"]["wo"]["w"] = p["f1"]["attn"]["wo"]["w"] * 0.1
    p["f2"]["mlp"]["wo"]["w"] = p["f2"]["mlp"]["wo"]["w"] * 0.1
    if cfg.use_norm:
        p["f1"]["norm"] = L.rmsnorm_init(cfg.d_branch, **kw)
        p["f2"]["norm"] = L.rmsnorm_init(cfg.d_branch, **kw)
    return p


def make_branch_fns(cfg: DuplexConfig, policy: L.Policy):
    acfg = _branch_attn_cfg(cfg)

    def f1(p, x):
        h = L.rmsnorm(p["norm"], x) if cfg.use_norm else x
        return L.attention_layer(p["attn"], h, acfg, policy=policy,
                                 bfp=cfg.bfp)

    def f2(p, x):
        h = L.rmsnorm(p["norm"], x) if cfg.use_norm else x
        return L.mlp(p["mlp"], h, policy=policy, bfp=cfg.bfp)

    return f1, f2


# --------------------------------------------------------------------------
# the duplex branch head: taps in, correction out
# --------------------------------------------------------------------------

def duplex_init(gen: torch.Generator, cfg: DuplexConfig, d_model: int, *,
                device=None) -> dict:
    return {
        "in_proj1": L.dense_init(gen, d_model, cfg.d_branch, device=device),
        "in_proj2": L.dense_init(gen, d_model, cfg.d_branch, device=device),
        # one tap projection per reversible block (stacked)
        "tap_proj": stack_params(
            lambda lead: L.dense_init(gen, d_model, cfg.d_branch, scale=0.02,
                                      lead=lead, device=device),
            cfg.n_blocks),
        "out_proj": L.dense_init(gen, 2 * cfg.d_branch, d_model, scale=0.02,
                                 device=device),
        "blocks": stack_params(
            lambda lead: branch_block_init(gen, cfg, lead=lead,
                                           device=device),
            cfg.n_blocks),
    }


def duplex_apply(
    params: dict,
    cfg: DuplexConfig,
    emb: torch.Tensor,         # [B,S,d_model] frozen input embeddings
    taps: torch.Tensor,        # [n_blocks,B,S,d_model] frozen backbone taps
    *,
    policy: L.Policy = L.Policy(),
    taps_pooled: bool = False,  # taps already pooled inside the backbone loop
) -> torch.Tensor:
    """Branch forward: returns the additive correction [B,S,d_model].

    ``emb`` and ``taps`` are detached: the backbone is frozen.
    """
    b, s, d_model = emb.shape
    r = cfg.pool_factor
    emb = emb.detach()
    taps = taps.detach()

    pooled_in = pool_seq(emb, r)                        # [B,Sp,D]
    pooled_taps = taps if taps_pooled else \
        torch.stack([pool_seq(t, r) for t in taps])     # [L,B,Sp,D]

    f1, f2 = make_branch_fns(cfg, policy)
    stack = ReversibleStack(f1, f2)

    x1 = L.dense(params["in_proj1"], pooled_in, policy=policy, bfp=cfg.bfp)
    x2 = L.dense(params["in_proj2"], pooled_in, policy=policy, bfp=cfg.bfp)
    # one dense per block: BFP groups are formed per block, as under vmap
    tp = params["tap_proj"]
    inj = torch.stack([
        L.dense({k: v[i] for k, v in tp.items()}, pooled_taps[i],
                policy=policy, bfp=cfg.bfp)
        for i in range(pooled_taps.shape[0])])          # [L,B,Sp,d_branch]

    y1, y2 = stack(params["blocks"], x1, x2, inj)
    y = torch.cat([y1, y2], dim=-1)                     # [B,Sp,2·d_branch]
    corr = L.dense(params["out_proj"], y, policy=policy, bfp=cfg.bfp)
    up = upsample_causal if cfg.causal else upsample_full
    return up(corr, r, s)
