"""Mamba-2 (SSD — state-space duality) blocks.

Counterpart of ``repro/models/ssm.py``.  The training/prefill path is the
chunked SSD algorithm (Dao & Gu 2024): within a chunk everything is batched
matrix products; across chunks a Python loop (the reference's ``lax.scan``)
carries the [H, P, N] state.  A ``state`` turns the same block into the
exact stateful decode; ``ssd_reference`` is the naive recurrent oracle.

Shapes: x [B,S,H,P] (P=headdim), B/C [B,S,G,N] (G router groups, N=d_state),
dt [B,S,H], A scalar per head.  Head h reads router group ``h // (H/G)``,
as ``jnp.repeat`` along the head axis gives it.

The chunked form computes the reference's terms in its f32, in another
order of products.  The reference's three-operand einsums would, taken left
to right, build a ``[B, Nc, Q, H, N, P]`` tensor (12.9 GB a layer at
mamba2-780m's widths, B=2, S=4096); here each is one batched product over
(batch, chunk, group) with the decay folded into ``x`` (chunk states) or
applied to the product (inter-chunk term).  B and C stay per group: a
group's heads are the rows of one product, so no per-head copy of B or C is
made.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.utils import ceil_to


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim


def ssd_init(gen: torch.Generator, cfg: SSDConfig, *, lead: tuple = (),
             dtype=torch.float32, device=None) -> dict:
    """The reference's leaves and shapes, stacked on ``lead``; each tensor
    is drawn in f32 and stored in ``dtype`` (``dt_bias``, ``A_log`` and
    ``D`` too, as the reference's cast of the whole backbone does)."""
    kw = dict(lead=lead, dtype=dtype, device=device)
    d, di, gn = cfg.d_model, cfg.d_inner, cfg.n_groups * cfg.d_state

    def conv(c):
        return {"w": L._normal(gen, (*lead, cfg.conv_width, c),
                               1.0 / math.sqrt(cfg.conv_width), dtype,
                               device),
                "b": torch.zeros((*lead, c), dtype=dtype, device=device)}

    p = {
        "z_proj": L.dense_init(gen, d, di, **kw),
        "x_proj": L.dense_init(gen, d, di, **kw),
        "b_proj": L.dense_init(gen, d, gn, **kw),
        "c_proj": L.dense_init(gen, d, gn, **kw),
        "dt_proj": L.dense_init(gen, d, cfg.n_heads, **kw),
        "out_proj": L.dense_init(gen, di, d, **kw),
        "conv_x": conv(di),
        "conv_b": conv(gn),
        "conv_c": conv(gn),
    }
    heads = (*lead, cfg.n_heads)
    u = torch.rand(heads, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                   + math.log(cfg.dt_min))
    p["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # inv softplus
    p["A_log"] = torch.zeros(heads, dtype=dtype, device=device)  # A = -1
    p["D"] = torch.ones(heads, dtype=dtype, device=device)
    p["norm"] = L.rmsnorm_init(di, **kw)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along seq, then silu. x [B,S,C], w [K,C].

    With ``state`` [B,K-1,C] (decode) the conv continues from it.  Returns
    (y, new_state), the new state the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        xp = ctx.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    return F.silu(y), xp[:, -(k - 1):, :]


def _ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan.

    x [B,S,H,P], dt [B,S,H] (already softplus'ed), A [H] (negative),
    B, C [B,S,G,N].  Returns (y [B,S,H,P], h_final [B,H,P,N])."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    chunk = min(chunk, s)        # decode: no padding waste for tiny s
    sp = ceil_to(s, chunk)
    pad = sp - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc, q = sp // chunk, chunk
    rep = h // g                                   # heads per router group

    # head-major within a chunk: [B,Nc,H,Q,·]; groups [B,Nc,G,Q,N]
    dtc = dt.reshape(b, nc, q, h).transpose(2, 3)             # [B,Nc,H,Q]
    xdt = x.reshape(b, nc, q, h, p).transpose(2, 3) * dtc[..., None]
    Bg = B.reshape(b, nc, q, g, n).transpose(2, 3)            # [B,Nc,G,Q,N]
    Cg = C.reshape(b, nc, q, g, n).transpose(2, 3)

    dA = dtc * A[:, None]                          # [B,Nc,H,Q] (negative)
    dAcs = torch.cumsum(dA, dim=-1)                # within-chunk cumsum

    # --- intra-chunk (quadratic in Q, batched matmul) -----------------
    # L[i,j] = exp(dAcs_i − dAcs_j) for i ≥ j else 0
    li = dAcs[..., :, None]                        # [B,Nc,H,Q,1]
    lj = dAcs[..., None, :]                        # [B,Nc,H,1,Q]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(mask, torch.exp(li - lj), 0.0)        # [B,Nc,H,Q,Q]
    cb = torch.matmul(Cg, Bg.transpose(-1, -2))              # [B,Nc,G,Q,Q]
    scores = (cb[:, :, :, None] * Lmat.reshape(b, nc, g, rep, q, q)) \
        .reshape(b, nc, h, q, q)
    y_intra = torch.matmul(scores, xdt)                      # [B,Nc,H,Q,P]

    # --- chunk states: Σ_q (decay_to_end · x·dt)[q]ᵀ B[q] ----------------
    decay_to_end = torch.exp(dAcs[..., -1:] - dAcs)          # [B,Nc,H,Q]
    xw = (xdt * decay_to_end[..., None]).reshape(b, nc, g, rep, q, p)
    states = torch.matmul(
        xw.transpose(-1, -2).reshape(b, nc, g, rep * p, q), Bg
    ).reshape(b, nc, h, p, n)                                # [B,Nc,H,P,N]

    # --- inter-chunk recurrence ----------------------------------------
    chunk_decay = torch.exp(dAcs[..., -1])                   # [B,Nc,H]
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    prevs = []                                     # the state before chunk c
    for c in range(nc):
        prevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)                      # [B,Nc,H,P,N]

    # --- inter-chunk contribution: (C · h_prev) · exp(dAcs) -------------
    hp = h_prevs.reshape(b, nc, g, rep, p, n).permute(0, 1, 2, 5, 3, 4) \
        .reshape(b, nc, g, n, rep * p)
    y_inter = torch.matmul(Cg, hp).reshape(b, nc, g, q, rep, p) \
        .transpose(3, 4).reshape(b, nc, h, q, p) * torch.exp(dAcs)[..., None]

    y = (y_intra + y_inter).transpose(2, 3).reshape(b, sp, h, p)[:, :s]
    return y, hcur


def _ssd_scan(x, dt, A, B, C, chunk: int, h0=None):
    """``_ssd_chunked``; on DTensors each rank scans its own block of the
    batch and the heads (the scan is independent per sequence and per
    head), with B and C whole but for the batch and cut to the groups of
    its heads, and the results are laid out as ``x``.  DTensor cannot run
    the chunk's batched products itself where both the batch and the heads
    are split: they merge the two dims, and a view may keep only the
    first of a merged group split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return _ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
    mesh = x.device_mesh
    kept = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in x.placements]
    x = x.redistribute(mesh, kept)

    def local(t, dims):
        """``t``'s block as ``x``'s: x's dim d split lands on t's
        ``dims[d]``; t's other dims whole."""
        return t.redistribute(mesh, [
            Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
            else Replicate() for p in kept]).to_local()

    xl = x.to_local()
    heads, groups = x.shape[2], B.shape[2]
    rep, h_l = heads // groups, xl.shape[2]
    first = ctx.block_index(x, 2) * h_l
    if h_l % rep and rep % h_l:
        raise ValueError(f"{h_l} heads a rank split the groups of {rep}")
    cut = slice(first // rep, first // rep + max(h_l // rep, 1))
    y, h_fin = _ssd_chunked(
        xl, local(dt, {0: 0, 2: 2}), local(A, {2: 0}),
        local(B, {0: 0})[:, :, cut], local(C, {0: 0})[:, :, cut], chunk,
        h0=None if h0 is None else local(h0, {0: 0, 2: 1}))
    # laid out contiguously, as the DTensor's strides say (a sequence of
    # one chunk leaves ``y`` a transposed view, whose layout contiguous
    # strides would not describe)
    y = DTensor.from_local(y.contiguous(), mesh, kept, run_check=False,
                           shape=x.shape,
                           stride=ctx.contiguous_stride(x.shape))
    h_pl = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
            else Replicate() for p in kept]
    shape = (x.shape[0], heads, x.shape[3], B.shape[3])
    h_fin = DTensor.from_local(h_fin, mesh, h_pl, run_check=False,
                               shape=shape,
                               stride=ctx.contiguous_stride(shape))
    return y, h_fin


def ssd_block(params, x: torch.Tensor, cfg: SSDConfig, *,
              policy: L.Policy = L.Policy(), bfp: L.BFPPolicy = L.NO_BFP,
              state: dict | None = None):
    """Full mamba2 mixer. x [B,S,D] → (y [B,S,D], new_state|None).

    ``state``: {"h": [B,H,P,N], "conv_x"/"conv_b"/"conv_c": [B,K-1,·]}
    enables stateful decode; None = stateless train/prefill."""
    b, s, _ = x.shape
    cd = policy.compute_dtype
    zgate = L.dense(params["z_proj"], x, policy=policy, bfp=bfp)
    xr = L.dense(params["x_proj"], x, policy=policy, bfp=bfp)
    Br = L.dense(params["b_proj"], x, policy=policy, bfp=bfp)
    Cr = L.dense(params["c_proj"], x, policy=policy, bfp=bfp)
    dt_raw = L.dense(params["dt_proj"], x, policy=policy, bfp=bfp)

    cs = dict.fromkeys(("conv_x", "conv_b", "conv_c")) if state is None \
        else state

    def conv(name, t):
        return _causal_conv(t, params[name]["w"].to(cd),
                            params[name]["b"].to(cd), cs[name])

    xs, ncx = conv("conv_x", xr)
    Bs, ncb = conv("conv_b", Br)
    Cs, ncc = conv("conv_c", Cr)

    xs = xs.reshape(b, s, cfg.n_heads, cfg.headdim)
    Bm = Bs.reshape(b, s, cfg.n_groups, cfg.d_state)
    Cm = Cs.reshape(b, s, cfg.n_groups, cfg.d_state)

    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])

    xs32, B32, C32 = (t.float() for t in (xs, Bm, Cm))
    h0 = None if state is None else state["h"]
    y, h_fin = _ssd_scan(xs32, dt, A, B32, C32, cfg.chunk, h0=h0)
    y = y + xs32 * params["D"][None, None, :, None]

    y = y.reshape(b, s, cfg.d_inner).to(cd)
    y = L.rmsnorm(params["norm"], y) * F.silu(zgate)
    out = L.dense(params["out_proj"], y, policy=policy, bfp=bfp)
    new_state = None if state is None else {
        "h": h_fin, "conv_x": ncx, "conv_b": ncb, "conv_c": ncc}
    return out, new_state


def ssd_state_init(cfg: SSDConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    gn = cfg.n_groups * cfg.d_state
    k = cfg.conv_width - 1
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, k, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((batch, k, gn), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, k, gn), dtype=dtype, device=device),
    }


def ssd_reference(x, dt, A, B, C):
    """Naive O(S·N·P) recurrent oracle for tests. Shapes as _ssd_chunked."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    rep = h // g
    Bf = torch.repeat_interleave(B, rep, dim=2)
    Cf = torch.repeat_interleave(C, rep, dim=2)
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None, :])                 # [B,H]
        hcur = hcur * dA[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bf[:, t], x[:, t], dt[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], hcur))
    return torch.stack(ys, dim=1), hcur                       # [B,S,H,P]
