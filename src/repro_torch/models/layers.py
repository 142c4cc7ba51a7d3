"""Shared model primitives: dense (optionally 2D-BFP), norms, embeddings,
RoPE, MLPs, and the attention cores (full / blockwise / decode-with-cache).

Counterpart of ``repro/models/layers.py``.  Conventions are the JAX
package's:

* activations are ``[B, S, D]``; attention heads ``[B, S, H, hd]``;
* dense weights are ``(d_in, d_out)``; params are plain dicts of f32 master
  tensors and every apply casts to the policy's compute dtype at use;
* 2D-BFP training quantization enters exclusively through ``dense``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import bfp as bfp_mod
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import constrain
from repro_torch.utils import ceil_to

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class BFPPolicy:
    """Fake-quant (STE) 2D BFP applied to matmul operands during training."""
    enabled: bool = False
    group: Tuple[int, int] = bfp_mod.PAPER_GROUP
    ebits: int = bfp_mod.PAPER_EBITS
    mbits: int = bfp_mod.PAPER_MBITS

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return x
        # leading dims flatten to rows, so groups straddle sequences
        return bfp_mod.bfp_qdq_rows(x, self.group, self.ebits, self.mbits)


NO_BFP = BFPPolicy(enabled=False)


# --------------------------------------------------------------------------
# dense / norms / embeddings
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
               scale: float | None = None, *, lead: tuple = (),
               dtype=torch.float32, device=None) -> dict:
    """``lead`` prepends stacking axes (the JAX package's vmapped init)."""
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense(p: dict, x: torch.Tensor, *, policy: Policy = Policy(),
          bfp: BFPPolicy = NO_BFP) -> torch.Tensor:
    cd = policy.compute_dtype
    # on DTensors the gradients of the activation and of the result are
    # laid out as they are, and the product's partial sums are reduced at
    # once
    x = bfp.q(ctx.grad_laid_out(x)).to(cd)
    w = ctx.at_use(bfp.q(p["w"]).to(cd), x)
    y = ctx.grad_laid_out(ctx.reduce_partial(ctx.matmul(x, w)))
    if "b" in p:
        y = y + p["b"].to(cd)
    return y


def rmsnorm_init(d: int, *, lead: tuple = (), dtype=torch.float32,
                 device=None) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def layernorm_init(d: int, *, lead: tuple = (), dtype=torch.float32,
                   device=None) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"].float()
            + p["bias"].float()).to(dt)


def embed_init(gen: torch.Generator, vocab: int, d: int, pad_to: int = 1, *,
               dtype=torch.float32, device=None) -> dict:
    vp = ceil_to(vocab, pad_to)
    return {"table": _normal(gen, (vp, d), 0.02, dtype, device)}


def embed_lookup(p: dict, tokens: torch.Tensor,
                 policy: Policy = Policy()) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    return ctx.embedding(tokens, p["table"]).to(policy.compute_dtype)


def unembed_logits(p: dict, x: torch.Tensor, vocab: int,
                   policy: Policy = Policy(),
                   softcap: float | None = None) -> torch.Tensor:
    """Tied unembedding with padded-vocab masking (padded rows → -1e30)."""
    cd = policy.compute_dtype
    x = x.to(cd)
    logits = torch.matmul(x, ctx.at_use(p["table"].to(cd).t(), x)).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    vp = p["table"].shape[0]
    if vp != vocab:
        mask = torch.arange(vp, device=logits.device) < vocab
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, split-half convention. x: [B,S,H,hd], positions [B,S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq                  # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention cores
# --------------------------------------------------------------------------

def _softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    return cap * torch.tanh(scores / cap) if cap is not None else scores


def expand_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """GQA expansion [B,S,KV,hd] → [B,S,KV·g,hd], each kv head repeated g
    times in place (``jnp.repeat``), so query head h reads kv head h // g."""
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def _gqa_scores(q, k):
    """q: [B,Sq,H,hd] k: [B,Skv,H,hd] (expanded) → [B,H,Sq,Skv] (f32)."""
    return torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float())


def _gqa_out(w, v):
    """w: [B,H,Sq,Skv] v: [B,Skv,H,hd] (expanded) → [B,Sq,H,hd]."""
    return torch.einsum("bhqk,bkhe->bqhe", w, v.float())


def full_attention(q, k, v, *, causal: bool, softcap=None,
                   window: int | None = None, q_offset: int = 0):
    """Materialized-scores attention (short sequences).

    q: [B,Sq,H,hd]; k, v: [B,Skv,KV,hd] (expanded internally for GQA).
    ``q_offset``: the position of q's first row (a rank's block of a
    sequence-sharded q, ``ctx.attention_blocks``).  Returns [B,Sq,H,hd]
    in q.dtype.
    """
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    k = expand_kv(k, h // nkv)
    v = expand_kv(v, h // nkv)
    scores = _softcap(_gqa_scores(q, k) / math.sqrt(hd), softcap)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = ctx.softmax(scores, dim=-1)
    return _gqa_out(w, v).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool, softcap=None,
                        window: int | None = None,
                        q_chunk: int = 512, kv_chunk: int = 1024,
                        causal_skip: bool = False):
    """Online-softmax attention over chunks (memory O(Sq·kv_chunk)).

    ``causal_skip`` runs only the kv chunks that intersect a query chunk's
    mask.  q: [B,Sq,H,hd]; k, v: [B,Skv,KV,hd]; GQA expansion happens per
    kv chunk.
    """
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g_rep = h // nkv
    sq_p, skv_p = ceil_to(sq, q_chunk), ceil_to(skv, kv_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
    nq, nkv_chunks = sq_p // q_chunk, skv_p // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    outs = []
    for iq in range(nq):
        qi = qp[:, iq * q_chunk:(iq + 1) * q_chunk]
        q_pos = iq * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, h, q_chunk), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        lo, hi = 0, nkv_chunks
        if causal_skip and (causal or window is not None):
            if causal:
                hi = min((iq * q_chunk + q_chunk + kv_chunk - 1) // kv_chunk,
                         nkv_chunks)
            if window is not None:
                lo = max((iq * q_chunk - window) // kv_chunk, 0)
        for j in range(lo, hi):
            start = j * kv_chunk
            kb = expand_kv(kp[:, start:start + kv_chunk], g_rep)
            vb = expand_kv(vp[:, start:start + kv_chunk], g_rep)
            s = _softcap(_gqa_scores(qi, kb) * scale, softcap)
            k_pos = start + torch.arange(kv_chunk, device=dev)
            mask = (k_pos[None, :] < skv).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhe->bhqe", p, vb.float())
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).transpose(1, 2))   # [B,qc,H,hd]
    out = torch.cat(outs, dim=1)[:, :sq]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *, softcap=None,
                     window: int | None = None, kpos=None):
    """Single-token decode over a [B,Smax,KV,hd] cache. q: [B,1,H,hd].

    ``kpos`` ([Smax], on the device) is the position each slot holds, -1
    for none (a ring buffer's ``pos``); by default slot i holds position i.
    ``cur_len`` (a 0-d tensor) is the query's position + 1: keys at ``kpos
    >= cur_len`` or ``kpos < 0`` (and, with a window, ``kpos <= cur_len -
    1 - window``) are masked to -1e30 and the f32 softmax runs over all
    Smax slots, as the reference's does."""
    b, sq, h, hd = q.shape
    smax, nkv = k_cache.shape[1], k_cache.shape[2]
    # a DTensor query's heads are gathered: the scores then split by the
    # cache's sequence shards, and their batched products merge only the
    # batch's split with the heads
    q = ctx.gather_dim(q, 2)
    kc = expand_kv(k_cache, h // nkv)
    vc = expand_kv(v_cache, h // nkv)
    scores = _softcap(_gqa_scores(q, kc) / math.sqrt(hd), softcap)
    # the score constraints keep a sequence-sharded cache's sharding
    # through the mask and the softmax (the ring decode's two share these)
    scores = constrain(scores, "dec_scores")              # [B,H,1,Smax]
    if kpos is None:
        kpos = torch.arange(smax, device=q.device)
        mask = kpos < cur_len                             # [Smax]
    else:
        mask = (kpos >= 0) & (kpos < cur_len)
    if window is not None:
        mask &= kpos > (cur_len - 1 - window)
    scores = constrain(scores.masked_fill(~mask, NEG_INF), "dec_scores")
    w = constrain(ctx.softmax(scores, dim=-1), "dec_scores")
    # over a sequence-sharded DTensor cache, the shards' sums are reduced
    return ctx.reduce_partial(_gqa_out(w, vc)).to(q.dtype)


# --------------------------------------------------------------------------
# attention layer (proj + rope + core + out-proj), GQA with KV cache
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float | None = 10000.0   # None → no rope
    softcap: float | None = None
    window: int | None = None            # sliding window (local attention)
    causal: bool = True
    blockwise_threshold: int = 1024      # switch to online-softmax above this
    q_chunk: int = 512
    kv_chunk: int = 1024
    causal_skip: bool = False
    use_flash: bool = False              # the hand-written flash kernel


def attn_init(gen: torch.Generator, cfg: AttnConfig, *, lead: tuple = (),
              dtype=torch.float32, device=None) -> dict:
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim,
                         cfg.qkv_bias, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv * cfg.head_dim,
                         cfg.qkv_bias, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv * cfg.head_dim,
                         cfg.qkv_bias, **kw),
        "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, **kw),
    }


def _project_qkv(p, x, kv_x, cfg: AttnConfig, policy, bfp, positions,
                 kv_positions=None):
    """q: [B,S,H,hd]; k/v: [B,Skv,KV,hd]."""
    q = ctx.split_last(dense(p["wq"], x, policy=policy, bfp=bfp),
                       cfg.n_heads, cfg.head_dim)
    k = ctx.split_last(dense(p["wk"], kv_x, policy=policy, bfp=bfp),
                       cfg.n_kv, cfg.head_dim)
    v = ctx.split_last(dense(p["wv"], kv_x, policy=policy, bfp=bfp),
                       cfg.n_kv, cfg.head_dim)
    if cfg.rope_theta is not None and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        kv_pos = positions if kv_positions is None else kv_positions
        k = rope(k, kv_pos, cfg.rope_theta)
    return (constrain(q, "act_q"), constrain(k, "act_kv"),
            constrain(v, "act_kv"))


def attention_core(q, k, v, cfg: AttnConfig, *, causal: bool):
    """``blockwise_attention`` when the queries or keys pass
    ``cfg.blockwise_threshold``, ``full_attention`` below.  On DTensors
    each rank attends over its own block (``ctx.attention_blocks``), and a
    sequence-sharded q is gathered once before the blockwise chunks, as
    XLA gathers the reference's reshaped chunks once."""
    if max(q.shape[1], k.shape[1]) > cfg.blockwise_threshold:
        return ctx.attention_blocks(
            blockwise_attention, ctx.gather_dim(q, 1), k, v, causal=causal,
            softcap=cfg.softcap, window=cfg.window, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, causal_skip=cfg.causal_skip)
    return ctx.attention_blocks(full_attention, q, k, v, causal=causal,
                                softcap=cfg.softcap, window=cfg.window)


def attention_layer(p, x, cfg: AttnConfig, *, policy=Policy(), bfp=NO_BFP,
                    kv_x=None, positions=None, kv_positions=None):
    """Full-sequence attention (train / prefill).  kv_x ≠ None → cross-attn."""
    b, s, _ = x.shape
    self_attn = kv_x is None
    kv_x = x if self_attn else kv_x
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, kv_x, cfg, policy, bfp, positions,
                           kv_positions)
    causal = cfg.causal and self_attn
    if cfg.use_flash and cfg.window is None:
        from repro_torch.kernels.flash_attention import flash_attention
        qc = min(cfg.q_chunk, s)
        kc = min(cfg.kv_chunk, kv_x.shape[1])

        def flash(q, k, v, **kw):
            return flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                q_chunk=qc, kv_chunk=kc, **kw).transpose(1, 2)

        # on DTensors the kernel runs once per rank on its plain block; it
        # takes no query offset, so a sequence-split q is gathered first
        o = ctx.attention_blocks(flash, ctx.gather_dim(q, 1), k, v,
                                 causal=causal, softcap=cfg.softcap)
    else:
        o = attention_core(q, k, v, cfg, causal=causal)
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return dense(p["wo"], o, policy=policy, bfp=bfp)


def attention_decode(p, x, cache: dict, cfg: AttnConfig, *,
                     policy=Policy()):
    """One-token decode step; cache = {"k","v": [B,Smax,KV,hd], "len": 0-d
    int32}.  k (after rope) and v are written at slot ``len`` into the
    caller's tensors, in place (the reference donates its cache), and
    ``len`` is advanced in place: the same dict comes back.  ``len`` stays
    on the device: no step reads it on the host.

    A cache of ``Smax`` slots holding a P-token prompt takes at most
    ``Smax - P`` steps: the write at ``len == Smax`` raises (``IndexError``
    on the CPU, a device-side assert on the card), where the reference's
    ``dynamic_update_slice`` clamps it onto slot ``Smax - 1``.  Nothing
    checks ``len`` on the host, so a step stays free of syncs."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"a decode step takes one token, got {s}")
    cur = cache["len"]
    q, k, v = _project_qkv(p, x, x, cfg, policy, NO_BFP,
                           cur.view(1, 1).expand(b, 1))
    idx = cur.long().view(1)
    ctx.index_copy_(cache["k"], 1, idx, k.to(cache["k"].dtype))
    ctx.index_copy_(cache["v"], 1, idx, v.to(cache["v"].dtype))
    o = decode_attention(q, cache["k"], cache["v"], cur + 1,
                         softcap=cfg.softcap, window=cfg.window)
    cache["len"].add_(1)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return dense(p["wo"], o, policy=policy), cache


def attn_cache_init(cfg: AttnConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, *, lead: tuple = (),
                    device) -> dict:
    """Zero cache: k, v ``[*lead, B, max_len, KV, hd]``, len ``[*lead]``
    int32; ``lead`` prepends the stack's ``n_rep`` axis."""
    shape = (*lead, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros(lead, dtype=torch.int32, device=device)}


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, *, lead: tuple = (), dtype=torch.float32,
             device=None) -> dict:
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {"wi": dense_init(gen, d_model, d_ff, **kw),
         "wo": dense_init(gen, d_ff, d_model, **kw)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, **kw)
    return p


def mlp(p: dict, x: torch.Tensor, *, policy=Policy(), bfp=NO_BFP,
        act: Callable = F.silu) -> torch.Tensor:
    h = dense(p["wi"], x, policy=policy, bfp=bfp)
    if "wg" in p:
        h = act(dense(p["wg"], x, policy=policy, bfp=bfp)) * h
    else:
        h = act(h)
    return dense(p["wo"], h, policy=policy, bfp=bfp)
