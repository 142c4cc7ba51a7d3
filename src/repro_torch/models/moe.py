"""GShard-style Mixture-of-Experts layer (dropped tokens, capacity factor).

Counterpart of ``repro/models/moe.py``.  Tokens are routed in fixed-size
groups; each of ``top_k`` passes takes every token's best remaining expert
and gives it the next free slot of that expert's buffer, of ``capacity``
slots per group, so all first choices are placed before any second choice
and a (token, pass) past the last slot is dropped.

The reference moves tokens into and out of the slots with dense one-hot
``[G, g, E, C]`` tensors contracted by einsums (the TPU's way to express a
gather and a scatter as matrix products).  The port keeps each (token,
pass)'s expert, slot and kept flag and moves rows by index instead: a copy
into an ``[E, G·C, D]`` slot buffer, the experts as batched products over
E, and a gather back weighted by the combine weights.  Each slot holds at
most one token, so the dispatch is exact, and the combine sums the same at
most ``top_k`` terms in another order.  At granite-moe-1b's widths a one-hot
tensor is 335 MB, and the reference's loop keeps several of them per layer
under autograd.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.utils import ceil_to, tree_map


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 1024
    gated: bool = True
    shared_expert: bool = False   # llama4-style always-on expert


def _experts_init(gen: torch.Generator, shape: tuple, scale: float, dtype,
                  device) -> torch.Tensor:
    """``[*lead, E, a, b]`` drawn one ``[a, b]`` matrix at a time in f32 and
    stored in ``dtype``: no f32 copy of the whole tensor is ever held
    (llama4-maverick's ``wi`` of one layer is 21.5 GB in f32)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:                  # shapes only: nothing to draw
        return out
    for idx in itertools.product(*map(range, shape[:-2])):
        out[idx] = L._normal(gen, shape[-2:], scale, dtype, device)
    return out


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, lead: tuple = (),
             dtype=torch.float32, device=None) -> dict:
    """The reference's leaves and layout: ``router/w`` ``[*lead, D, E]``,
    ``wi``/``wg`` ``[*lead, E, D, F]``, ``wo`` ``[*lead, E, F, D]`` and, with a
    shared expert, ``shared/{wi,wg,wo}/w``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {
        "router": L.dense_init(gen, d, e, scale=0.02, **kw),
        "wi": _experts_init(gen, (*lead, e, d, f), 1.0 / math.sqrt(d),
                            dtype, device),
        "wo": _experts_init(gen, (*lead, e, f, d), 1.0 / math.sqrt(f),
                            dtype, device),
    }
    if cfg.gated:
        p["wg"] = _experts_init(gen, (*lead, e, d, f), 1.0 / math.sqrt(d),
                                dtype, device)
    if cfg.shared_expert:
        p["shared"] = L.mlp_init(gen, d, f, gated=cfg.gated, **kw)
    return p


def capacity(cfg: MoEConfig, group: int) -> int:
    c = int(math.ceil(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, ceil_to(c, 4))


def router_gates(params, x: torch.Tensor, cfg: MoEConfig, *,
                 policy: L.Policy = L.Policy()):
    """Tokens in groups and their f32 router softmax: ``(xg [G,g,D], gates
    [G,g,E])``.  ``B·S`` tokens are zero-padded up to a multiple of the group
    size ``g = min(group_size, B·S)``; padded rows route like any other."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.group_size, t)
    xg = F.pad(x.reshape(t, d), (0, 0, 0, ceil_to(t, g) - t)).reshape(-1, g, d)
    logits = L.dense(params["router"], xg, policy=policy).float()
    return xg, torch.softmax(logits, dim=-1)


def route(gates: torch.Tensor, top_k: int, cap: int):
    """The reference's ``top_k`` passes over ``gates`` ``[G,g,E]``: each takes
    every token's argmax of the remaining gates (ties to the first index)
    and the slot ``cumsum over the group - 1 + counts`` in that expert's
    buffer, where ``counts`` carries over from the earlier passes; a (token,
    pass) is kept iff its slot is below ``cap``.  Returns ``(expert, slot,
    keep, gate)``, each ``[G,g,top_k]``."""
    n_exp = gates.shape[-1]
    remaining = gates
    counts = torch.zeros((gates.shape[0], 1, n_exp), dtype=torch.long,
                         device=gates.device)
    experts, slots, gate_ks = [], [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                   # [G,g]
        gate_ks.append(torch.gather(remaining, -1, idx[..., None])[..., 0])
        onehot = F.one_hot(idx, n_exp)                          # [G,g,E]
        pos = torch.cumsum(onehot, dim=1) - 1 + counts
        slots.append(torch.gather(pos, -1, idx[..., None])[..., 0])
        counts = counts + onehot.sum(dim=1, keepdim=True)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
        experts.append(idx)
    slot = torch.stack(slots, -1)
    return torch.stack(experts, -1), slot, slot < cap, torch.stack(gate_ks, -1)


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, *,
              policy: L.Policy = L.Policy(), bfp: L.BFPPolicy = L.NO_BFP):
    """x: [B,S,D] → (y [B,S,D], aux_loss f32 scalar); on DTensors,
    ``_moe_placed``."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_placed(params, x, cfg, policy=policy, bfp=bfp)
    y, aux = _moe_experts(params, x, cfg, policy=policy, bfp=bfp)
    if "shared" in params:
        y = y + L.mlp(params["shared"], x, policy=policy, bfp=bfp)
    return y.to(x.dtype), aux


def _moe_placed(params, x, cfg: MoEConfig, *, policy, bfp):
    """The layer on DTensors.  Every rank routes every token (a decode
    group is the whole batch, so the batch is gathered) and runs the
    experts it holds: the expert weights, quantized and cast, keep their
    shards of E (over ``model``) and gather the rest, the router its
    whole.  The combined
    rows are then a sum over the ranks that split E; one redistribution
    sums them and lays them out as ``x``.  The shared expert runs on the
    DTensors (``L.mlp``).  DTensor cannot run the dispatch and the
    experts' batched products itself where the tokens and the experts are
    both split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh

    def own(w):
        # quantized and cast before the gather, as ``dense`` gathers
        w = bfp.q(w).to(policy.compute_dtype)
        return w.redistribute(mesh, [p if p.is_shard(0) else Replicate()
                                     for p in w.placements]).to_local()

    local = {"router": tree_map(lambda w: w.full_tensor(), params["router"]),
             **{k: own(params[k]) for k in ("wi", "wg", "wo") if k in params}}
    first = ctx.block_index(params["wi"], 0) * local["wi"].shape[0]
    y, aux = _moe_experts(local, x.full_tensor(), cfg, policy=policy,
                          bfp=L.NO_BFP, first=first)
    y = DTensor.from_local(
        y, mesh, [Partial() if p.is_shard(0) else Replicate()
                  for p in params["wi"].placements], run_check=False,
        shape=x.shape, stride=ctx.contiguous_stride(x.shape)
    ).redistribute(mesh, x.placements)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if "shared" in params:
        y = y + L.mlp(params["shared"], x, policy=policy, bfp=bfp)
    return y.to(x.dtype), aux


def _moe_experts(params, x: torch.Tensor, cfg: MoEConfig, *, policy, bfp,
                 first: int = 0):
    """The routed experts on plain tensors: ``(y [B,S,D] in the compute
    dtype, aux)``.  ``params``' experts are experts ``first, first + 1,
    ...`` of the ``cfg.n_experts`` (all of them by default); the slots of
    the others are neither run nor combined."""
    b, s, d = x.shape
    cd = policy.compute_dtype
    t, n_exp, k = b * s, cfg.n_experts, cfg.top_k
    xg, gates = router_gates(params, x, cfg, policy=policy)
    n_groups, g = xg.shape[:2]

    # load-balancing aux loss (Switch/GShard): E · Σ_e f_e · P_e
    density = torch.mean(gates, dim=1)                          # [G,E]
    frac = torch.mean(F.one_hot(torch.argmax(gates, -1), n_exp).float(),
                      dim=1)
    aux = n_exp * torch.mean(torch.sum(density * frac, dim=-1))

    cap = capacity(cfg, g)
    expert, slot, keep, gate = route(gates, k, cap)
    # combine weights in the compute dtype, renormalised over the kept
    # choices: a token whose every choice was dropped gets 0
    gate = gate.to(cd) * keep
    combine = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # slot buffer [E, G, C] flattened; dropped (token, pass)es write to a
    # spare row past its end and read slot 0 with weight 0
    n_slots = n_exp * n_groups * cap
    grp = torch.arange(n_groups, device=x.device)[:, None, None]
    flat = (expert * n_groups + grp) * cap + slot
    src = xg.to(cd)[:, :, None, :].expand(n_groups, g, k, d).reshape(-1, d)
    xe = torch.zeros((n_slots + 1, d), dtype=cd, device=x.device).index_copy(
        0, torch.where(keep, flat, n_slots).reshape(-1), src)
    xe = xe[:n_slots].view(n_exp, n_groups * cap, d)
    n_own = params["wi"].shape[-3]
    if n_own != n_exp:
        xe = xe[first:first + n_own]

    wi = bfp.q(params["wi"]).to(cd)
    wo = bfp.q(params["wo"]).to(cd)
    h = torch.bmm(xe, wi)                                       # [E,G·C,F]
    if "wg" in params:
        h = F.silu(torch.bmm(xe, bfp.q(params["wg"]).to(cd))) * h
    else:
        h = F.silu(h)
    ye = torch.bmm(h, wo).reshape(-1, d)

    # index_select, not ye[...]: advanced indexing's backward walks each run
    # of equal indices serially, and every dropped (token, pass) reads slot
    # 0 (10 ms a layer at granite-moe's FR shape on an H100); index_select's
    # backward adds in parallel, and a dropped entry's gradient is exactly 0
    pick = torch.where(keep, flat, 0)
    if n_own != n_exp:       # a (token, pass) routed to another rank's expert
        own = keep & (expert >= first) & (expert < first + n_own)
        pick = torch.where(own, flat - first * n_groups * cap, 0)
        combine = combine * own
    rows = ye.index_select(0, pick.reshape(-1))
    rows = rows.view(-1, k, d)
    y = torch.bmm(combine.reshape(-1, 1, k), rows).reshape(-1, d)
    return y[:t].reshape(b, s, d), aux
