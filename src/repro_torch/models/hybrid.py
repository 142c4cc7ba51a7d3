"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of ``repro/models/hybrid.py``:

    r_t = σ(W_r x_t)                 (recurrence gate)
    i_t = σ(W_i x_t)                 (input gate)
    log a_t = −c · softplus(Λ) · r_t
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Training/prefill runs an inclusive scan of ``(a, b) ∘ (a', b') = (a'a,
a'b + b')`` along seq.  torch has no ``associative_scan``, so ``_scan`` is
the odd-even recursion ``lax.associative_scan`` itself uses: combine
adjacent pairs, scan the half-length sequence, fill in the even positions.
That is about 2·log2(S) levels of strided elementwise ops, O(S) work and
O(S) tensors saved for backward (a doubling scan saves O(S log S)), and it
differentiates through autograd.  Decode is the exact one-step recurrence
on the carried state.  The enclosing block is the reference's: gelu gate
branch, ``ssm._causal_conv`` (with its silu) on the recurrent branch, the
elementwise merge, the output projection.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import constrain
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv
from repro_torch.utils import ceil_to

_C = 8.0  # Griffin's fixed exponent scale


@dataclasses.dataclass(frozen=True)
class LRUConfig:
    d_model: int
    lru_width: int
    conv_width: int = 4
    # scan chunk by chunk with a carried state, bounding the scan's
    # temporaries to O(chunk) (None = one full-length scan)
    scan_chunk: int | None = None


def lru_init(gen: torch.Generator, cfg: LRUConfig, *, lead: tuple = (),
             dtype=torch.float32, device=None) -> dict:
    """The reference's leaves and shapes, stacked on ``lead``; each tensor is
    drawn in f32 and stored in ``dtype``."""
    kw = dict(lead=lead, dtype=dtype, device=device)
    d, w = cfg.d_model, cfg.lru_width
    p = {
        "wx": L.dense_init(gen, d, w, **kw),
        "wy": L.dense_init(gen, d, w, **kw),
        "wo": L.dense_init(gen, w, d, **kw),
        "conv_w": L._normal(gen, (*lead, cfg.conv_width, w),
                            1.0 / math.sqrt(cfg.conv_width), dtype, device),
        "conv_b": torch.zeros((*lead, w), dtype=dtype, device=device),
        "wr": L.dense_init(gen, w, w, bias=True, scale=0.02, **kw),
        "wi": L.dense_init(gen, w, w, bias=True, scale=0.02, **kw),
    }
    # Λ so that a ∈ (0.9, 0.999) at r=1 (Griffin appendix): the inverse of
    # a = exp(-c·softplus(Λ))
    u = 0.9 + 0.099 * torch.rand((*lead, w), generator=gen,
                                 dtype=torch.float32, device=device)
    p["lambda"] = torch.log(torch.expm1(-torch.log(u) / _C)).to(dtype)
    return p


def _combine(a1, b1, a2, b2):
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], odd[1], ... along dim 1; ``even`` is as
    long as ``odd`` or one longer."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _scan(a, b):
    """Inclusive scan of ``_combine`` along dim 1 of [B,S,W]: returns
    (cumulative a, cumulative b)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                             a[:, 1::2], b[:, 1::2]))     # odd positions
    k = (n - 1) // 2                      # even positions past the first
    ea, eb = _combine(oa[:, :k], ob[:, :k], a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` op by op in x's dtype:
    each op runs in f32 and rounds to x's dtype, as torch's bf16 ops do, so
    an fp8 Λ, for which torch has no arithmetic, gets its softplus in fp8
    as the reference's does.  In bf16 each op rounds, and ``F.softplus``
    (one rounding) differs from it by an ulp in about a quarter of
    Griffin's Λ."""
    def rnd(t):
        return t.to(x.dtype).float()
    xf = x.float()
    return (torch.clamp(xf, min=0) +
            rnd(torch.log1p(rnd(torch.exp(-xf.abs()))))).to(x.dtype)


def _gates(params, x: torch.Tensor, policy: L.Policy):
    """The recurrence's (a, √(1−a²)·i·x), both [B,S,W] f32.  ``wr`` and
    ``wi`` take the policy only, never BFP, as the reference's do."""
    r = torch.sigmoid(constrain(L.dense(params["wr"], x, policy=policy),
                                "act_lru").float())
    i = torch.sigmoid(constrain(L.dense(params["wi"], x, policy=policy),
                                "act_lru").float())
    # softplus and its product with -C in Λ's stored dtype (bf16 in a cast
    # backbone), as the reference's; the product with r promotes to f32,
    # which an fp8 Λ refuses, as the reference's does
    sp = _softplus(params["lambda"])
    log_a = (-_C * sp.float()).to(sp.dtype)[None, None, :] * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) \
        * i * x.float()
    return a, gated_x


def _rg_lru(params, x: torch.Tensor, policy: L.Policy, h0=None,
            scan_chunk: int | None = None):
    """x: [B,S,W] → (y [B,S,W] f32, h_final [B,W] f32)."""
    a, gated_x = _gates(params, x, policy)
    if x.shape[1] == 1 and h0 is not None:            # decode fast path
        h = a[:, 0] * h0 + gated_x[:, 0]
        return h[:, None, :], h
    return _scan_from(a, gated_x, h0, scan_chunk)


def _scan_from(a, gated_x, h0=None, scan_chunk: int | None = None):
    """``h_t = a_t·h_{t-1} + gated_x_t`` from ``h0`` (zero if None) by the
    scan, over the whole length or chunk by chunk: (y, h_final)."""
    b, s, w = a.shape
    if scan_chunk is None or scan_chunk >= s:
        if h0 is not None:
            # fold the carried state in as a virtual step-0 contribution
            gated_x = torch.cat([gated_x[:, :1] + (a[:, 0] * h0)[:, None],
                                 gated_x[:, 1:]], dim=1)
        _, acc_b = _scan(a, gated_x)
        return acc_b, acc_b[:, -1]

    # chunked: the scan within a chunk, the state carried across chunks
    pad = ceil_to(s, scan_chunk) - s
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        gated_x = F.pad(gated_x, (0, 0, 0, pad))
    h = torch.zeros((b, w), dtype=torch.float32, device=a.device) \
        if h0 is None else h0
    ys = []
    for c in range(0, s + pad, scan_chunk):
        acc_a, acc_b = _scan(a[:, c:c + scan_chunk],
                             gated_x[:, c:c + scan_chunk])
        y = acc_b + acc_a * h[:, None, :]              # fold carried state
        h = y[:, -1]
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, y[:, -1]


def lru_block(params, x: torch.Tensor, cfg: LRUConfig, *,
              policy: L.Policy = L.Policy(), bfp: L.BFPPolicy = L.NO_BFP,
              state: dict | None = None):
    """Griffin recurrent block. x [B,S,D] → (y [B,S,D], new_state|None).

    ``state``: {"h": [B,W] f32, "conv": [B,K-1,W]} enables stateful decode;
    None = stateless train/prefill."""
    cd = policy.compute_dtype
    gate = L.gelu_tanh(L.dense(params["wy"], x, policy=policy, bfp=bfp))
    rec = L.dense(params["wx"], x, policy=policy, bfp=bfp)
    conv_state = None if state is None else state["conv"]
    rec, new_conv = _causal_conv(rec, params["conv_w"].to(cd),
                                 params["conv_b"].to(cd), conv_state)
    h0 = None if state is None else state["h"]
    y, h_fin = _rg_lru(params, rec, policy, h0=h0, scan_chunk=cfg.scan_chunk)
    out = L.dense(params["wo"], y.to(cd) * gate, policy=policy, bfp=bfp)
    new_state = None if state is None else {"h": h_fin, "conv": new_conv}
    return out, new_state


def lru_state_init(cfg: LRUConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
    }


def rg_lru_reference(params, x, policy: L.Policy, h0=None):
    """Naive per-step recurrence oracle for tests."""
    return _recurrence(*_gates(params, x, policy), h0)


def _recurrence(a, gated_x, h0=None):
    """``_scan_from``'s recurrence one step at a time: (y, h_final)."""
    b, s, w = a.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=a.device) \
        if h0 is None else h0
    ys = []
    for t in range(s):
        h = a[:, t] * h + gated_x[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h
