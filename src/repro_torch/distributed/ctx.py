"""Activation-sharding context: models call ``constrain(x, name)`` at
strategic tensors; a launcher installs per-arch rules (``{name: spec}``,
``launch.cells.activation_rules``) on a mesh.

Counterpart of ``repro/distributed/ctx.py``.  ``constrain``:

* with no rules installed, or a name not in them, returns ``x`` itself, so
  model code stays mesh-agnostic and the single-card paths do not change;
* shortens a spec longer than ``x.ndim`` (e.g. decode's S=1 collapsed);
* redistributes a DTensor to the rule's placements on the installed mesh
  (``sharding.placements``); a DTensor on another mesh raises.  A dim
  that its axes do not divide (decode's one query position under the
  sequence-parallel ``act_q``) or a dim of one is replicated: DTensor
  would shard it unevenly, and its views refuse an uneven shard or a
  sharded dim of one;
* returns a plain tensor as it is on a mesh of one rank: it is then the
  whole value, as JAX's constraint on one device changes nothing;
* returns a ``meta`` tensor as it is on an ``AbstractMesh``: a mesh without
  ranks holds no local data, and the tensor is the whole abstract value,
  as a JAX tracer is under an abstract mesh (the dry run,
  ``launch/dryrun.py``, traces the cells so);
* raises on a plain tensor on a mesh of more than one rank.  In eager torch
  a plain tensor there is one rank's local data, with no global layout to
  constrain; passing it through would hide that the models have no
  multi-rank path yet.

The train, prefill and decode steps on DTensors (a cell placed on a
mesh, ``launch/dryrun.py``) also go through the helpers below, where
DTensor's own rule for an op partitions otherwise than the sharding
scheme means, or fails: ``at_use`` (a weight's ZeRO-3 shards gathered),
``reduce_partial``, ``embedding`` (the vocab-parallel lookup),
``index_copy_`` (a decode step's cache slot written in each rank's
block), ``write_slots_`` (a prefill's slots so written), ``full_placed``
(a prefill's cache allocated by blocks), ``attention_blocks`` (a
prefill's attention, or the flash kernel, on each rank's block),
``softmax``, ``gather_dim``, ``split_last``, ``matmul``,
``unit_shards_replicated``, and for the
train step's backward and loss ``grad_laid_out`` (a product's gradients
in their forward layout), ``placed_like``, ``logsumexp_pick`` and
``argmax`` (the vocab-parallel loss), ``tiled`` (BFP groups on each
rank's block), ``pad``, ``take`` and ``total`` (the global norm).  On a
plain tensor each is the op it stands for, so the single-card paths do
not change.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.utils import tree_leaves, tree_map

_MESH: Optional[Any] = None
_RULES: Optional[dict] = None


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """rules: ``{name: spec}`` — installed for the duration; the previous
    pair comes back on exit, also on an exception."""
    global _MESH, _RULES
    prev = (_MESH, _RULES)
    _MESH, _RULES = mesh, rules
    try:
        yield
    finally:
        _MESH, _RULES = prev


def placed(tree) -> bool:
    """Whether any leaf of ``tree`` is a DTensor (a cell placed on a
    mesh)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in tree_leaves(tree))


def replicate_made(tree):
    """DTensor's ``implicit_replication`` where ``tree`` is placed, so that
    the tensors a model makes itself (positions, masks, rope's
    frequencies), equal on every rank, join the DTensors as replicated
    ones; else a context that does nothing."""
    if not placed(tree):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def at_use(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The weight ``w`` as a product with the activation ``x`` reads it.

    On DTensors, a shard of ``w`` over a batch axis (``pod``, ``data``: the
    ZeRO-3 shards of the sharding scheme, ``distributed/sharding.py``) is
    gathered where ``x`` is split over that axis along another dim than
    the contracted one (its batch), and its ``model`` shards
    are kept, so the product splits as the scheme means it (left alone,
    DTensor would rather move the activations to the weight's shards).
    Where ``x`` is not split over the axis (a batch of one), the shard
    stays and the product contracts it, to be summed after (``dense``
    reduces it), as XLA's partitioner does there too.  Where ``x``'s batch
    is split over ``model`` as well (the ``fsdp_pure`` layout: the batch
    over every axis, every large weight ZeRO-3 over every axis), ``w`` is
    gathered over every axis that splits ``x``, whichever of its dims
    the shard cuts.  Any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    last = x.dim() - 1
    split = [isinstance(x, DTensor) and x.placements[m].is_shard() and
             not x.placements[m].is_shard(last) for m in range(len(names))]
    every = any(split[m] and names[m] not in ("pod", "data") and
                x.placements[m].is_shard(0) for m in range(len(names)))
    rows = w.dim() - 2
    want = [Replicate() if split[m] and p.is_shard() and (
        every or names[m] in ("pod", "data") and p.is_shard(rows))
        else p for m, p in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


class _GradLaidOut(torch.autograd.Function):
    """Identity forward; backward lays the incoming gradient out as the
    forward value was (a DTensor's placements)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_laid_out(x: torch.Tensor) -> torch.Tensor:
    """``x``; on a DTensor that requires grad, its gradient is laid out as
    ``x`` is before it flows on, as XLA gives a cotangent its primal's
    sharding.  A product's backward then runs on the blocks of its
    forward (a weight's gradient on the weight's shards, a pending sum
    reduce-scattered there) where the gradient would otherwise arrive
    replicated or summed and be cut or reduced after.  Any other tensor
    as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _GradLaidOut.apply(x)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial`` placements) reduced to
    ``Replicate``, its shards kept; any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or \
            not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def block_index(x, dim: int) -> int:
    """The index of this rank's block of a DTensor ``x`` along ``dim``:
    its coordinates on the mesh dims that shard ``dim``, major to minor in
    mesh order (DTensor's order, and JAX's for a spec in mesh order)."""
    mesh, coord = x.device_mesh, 0
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            coord = coord * mesh.size(m) + mesh.get_local_rank(m)
    return coord


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; on a DTensor table, a vocab-parallel
    lookup laid out as ``tokens`` is.

    Each rank looks up every token (the ids gathered, a few bytes) in its
    own block of the table, with zeros for ids outside its vocab block; the
    rows are then a sum over the ranks that split the vocab, and split
    along their width as the table is.  One redistribution to the tokens'
    layout sums them and lays them out by batch.  (DTensor's own lookup
    leaves a ``_MaskPartial`` whose mask fits one reduction of one shape:
    an op that reads the rows twice, as ``rmsnorm``'s ``x * x`` does, or a
    reduction after the tokens were gathered, fails.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    ids = tokens.redistribute(mesh, [Replicate()] * mesh.ndim).to_local() \
        if isinstance(tokens, DTensor) else tokens
    block = table.to_local()
    n = block.shape[0]
    local = ids - block_index(table, 0) * n
    inside = ((local >= 0) & (local < n))[..., None]
    rows = torch.where(inside, F.embedding(local.clamp(0, n - 1), block),
                       0.0)
    placed = [Partial() if p.is_shard(0) else
              Shard(ids.dim()) if p.is_shard(1) else Replicate()
              for p in table.placements]
    shape = (*ids.shape, table.shape[1])
    out = DTensor.from_local(rows, mesh, placed, run_check=False,
                             shape=shape, stride=contiguous_stride(shape))
    want = tokens.placements if isinstance(tokens, DTensor) else \
        [Replicate()] * mesh.ndim
    return out.redistribute(mesh, want)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def index_copy_(x: torch.Tensor, dim: int, index: torch.Tensor,
                source: torch.Tensor) -> torch.Tensor:
    """``x.index_copy_(dim, index, source)`` of one slot (``index`` holds
    one position), in place, also where ``x`` is a DTensor (a KV cache,
    sequence-sharded or not).

    DTensor's own ``index_copy_`` along a sharded dim gathers the cache,
    writes into the gathered copy and relabels ``x`` as replicated while
    its local data stays a shard (and some versions have no rule for it at
    all).  Here each rank writes its own block: the slot ``index -
    offset`` of its block, clamped into it, gets ``source`` where the slot
    lies in the block and its own old value elsewhere, so one slot of
    traffic per rank and no collective but the one that lays ``source``
    out as ``x`` (replicated along ``dim``); a slot past the end is written
    by no rank, where a plain ``x`` raises."""
    from torch.distributed.tensor import DTensor, Replicate
    if index.numel() != 1:
        raise ValueError(f"index_copy_ writes one slot; got {index.numel()}")
    if not isinstance(x, DTensor):
        return x.index_copy_(dim, index, source)
    mesh = x.device_mesh
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    src = source.redistribute(mesh, want).to_local()
    idx = index.to_local() if isinstance(index, DTensor) else index
    block = x.to_local()
    n = block.shape[dim]
    local = idx - block_index(x, dim) * n
    inside = ((local >= 0) & (local < n)).view(
        [1] * dim + [-1] + [1] * (block.dim() - dim - 1))
    local = local.clamp(0, n - 1)
    block.index_copy_(dim, local, torch.where(
        inside, src, block.index_select(dim, local)))
    return x


def write_slots_(x: torch.Tensor, dim: int, first: int,
                 source: torch.Tensor, ring: bool = False) -> torch.Tensor:
    """``source``'s rows along ``dim`` written into ``x`` in place at the
    slots ``first, first + 1, ...``, or for a ``ring`` at those slots
    modulo ``x.shape[dim]`` (rows that wrap go to the start): a prefill's
    cache writes.  ``first`` is a host int, so each rank of a DTensor
    knows which slots lie in its block.

    On a plain tensor this is the op it stands for: the slice assignment
    ``x[..., first:first + n] = source`` along ``dim``, or for a ring
    ``x.index_copy_(dim, arange(first, first + n) % size, source)``.  On a
    DTensor each rank copies into its own block the rows whose slots lie
    there (at most two runs of consecutive slots), from ``source`` laid
    out as ``x`` with ``dim`` replicated: no gather of ``x``.  (DTensor's
    own slice along a sharded dim gathers ``x``, and the assignment then
    lands in the gathered copy.)"""
    from torch.distributed.tensor import DTensor, Replicate
    n, size = source.shape[dim], x.shape[dim]
    if n > size or (not ring and first + n > size):
        raise ValueError(f"{n} rows from slot {first} do not fit the "
                         f"{size} slots of dim {dim}")
    if not isinstance(x, DTensor):
        if ring:
            return x.index_copy_(dim, torch.arange(
                first, first + n, device=x.device) % size, source)
        x[(slice(None),) * dim + (slice(first, first + n),)] = source
        return x
    mesh = x.device_mesh
    if not isinstance(source, DTensor):
        source = DTensor.from_local(source, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    src = source.redistribute(mesh, [
        Replicate() if p.is_shard(dim) else p for p in x.placements]
    ).to_local()
    block = x.to_local()
    m = block.shape[dim]
    lo = block_index(x, dim) * m
    start = first % size if ring else first
    head = min(n, size - start)
    # (first slot, first row, rows) of each run of consecutive slots
    for slot, row, k in ((start, 0, head), (0, head, n - head)):
        a, b = max(slot, lo), min(slot + k, lo + m)
        if a < b:
            block.narrow(dim, a - lo, b - a).copy_(
                src.narrow(dim, row + a - slot, b - a))
    return x


def full_placed(shape: tuple, value, dtype, named, device) -> torch.Tensor:
    """A new DTensor of ``shape`` filled with ``value``, laid out by the
    ``sharding.NamedSharding`` ``named``, each rank allocating only its
    own block on ``device`` (the local tensors' device, ``meta`` in the
    dry run).  The shardings split each dim evenly (``sharding``'s
    divisibility guards)."""
    from torch.distributed.tensor import DTensor
    mesh, local = named.mesh, list(shape)
    for m, p in enumerate(named.placements):
        if p.is_shard():
            if local[p.dim] % mesh.size(m):
                raise ValueError(f"{named.placements} split dim {p.dim} of "
                                 f"{tuple(shape)} unevenly")
            local[p.dim] //= mesh.size(m)
    block = torch.full(local, value, dtype=dtype, device=device)
    return DTensor.from_local(block, mesh, named.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def pad(x: torch.Tensor, widths: tuple, value: float = 0.0
        ) -> torch.Tensor:
    """``F.pad(x, widths, value=value)`` (constant padding).  On a DTensor
    each rank pads its own block where the padded dims are not split, and
    the result keeps ``x``'s placements; a padded dim that is split is
    gathered first.  (DTensor's own pad miscounts placements in some torch
    versions.)"""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return F.pad(x, widths, value=value)
    x = reduce_partial(x)
    padded = {x.dim() - 1 - i // 2 for i, w in enumerate(widths) if w}
    want = [Replicate() if p.is_shard() and p.dim in padded else p
            for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    out = F.pad(x.to_local(), widths, value=value)
    shape = list(x.shape)
    for i, w in enumerate(widths):
        shape[x.dim() - 1 - i // 2] += w
    return DTensor.from_local(out, x.device_mesh, want, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def placed_like(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``g`` (a gradient) laid out as ``like`` (its leaf) where both are
    DTensors: a pending sum over a mesh dim that shards ``like`` is
    reduce-scattered, one that replicates it all-reduced.  Any other
    ``g`` as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(g, DTensor) or not isinstance(like, DTensor) or \
            tuple(g.placements) == tuple(like.placements):
        return g
    return g.redistribute(like.device_mesh, like.placements)


def total(fn, tensors) -> torch.Tensor:
    """``sum(fn(t) for t in tensors)``, for an ``fn`` that reduces a tensor
    to a 0-d sum over its elements (a sum of squares: any block of the
    elements gives its share).  Over DTensors (all on one mesh): ``fn`` of
    each rank's
    block, counted by one rank of each group of ranks that hold the same
    block (rank 0 of each mesh dim that replicates it), summed on the rank
    and reduced over the ranks in one go, a replicated 0-d DTensor.
    (DTensor's own sum of per-tensor results reduces each one whose
    placements differ from the others'.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    tensors = list(tensors)
    if not isinstance(tensors[0], DTensor):
        return sum(fn(t) for t in tensors)
    mesh = tensors[0].device_mesh
    acc = 0
    for t in tensors:
        part = fn(reduce_partial(t).to_local())
        if any(not p.is_shard() and mesh.get_local_rank(m)
               for m, p in enumerate(t.placements)):
            part = torch.zeros_like(part)
        acc = acc + part
    return DTensor.from_local(acc, mesh, [Partial()] * mesh.ndim,
                              run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def take(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x`` indexed by the integer tensor ``index`` along ``dim`` (``x[:,
    index]`` for ``dim`` 1).  On a DTensor (a 1-d ``index``, a plain
    tensor, equal on every rank) each rank indexes its own block,
    ``dim`` gathered first if it is split, and the result keeps ``x``'s
    placements; the gradient's scatter stays on the rank's block too
    (DTensor's own index and its backward gather the whole of ``x``)."""
    from torch.distributed.tensor import DTensor, Replicate
    at = (slice(None),) * dim + (index,)
    if not isinstance(x, DTensor):
        return x[at]
    if index.dim() != 1:
        raise ValueError(f"take: a 1-d index on a DTensor, got "
                         f"{index.dim()} dims")
    x = gather_dim(reduce_partial(x), dim)
    out = x.to_local()[at]
    shape = (*x.shape[:dim], index.shape[0], *x.shape[dim + 1:])
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with its shards along ``dim`` gathered (its other
    placements kept); any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def attention_blocks(core, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, **kw) -> torch.Tensor:
    """``core(q, k, v, **kw)``, an attention core over q [B, Sq, H, hd] and
    k, v [B, Skv, KV, hd] (``L.full_attention``, ``L.blockwise_attention``,
    or the flash kernel, which then launches once per rank on its block).

    On DTensors each rank runs ``core`` on plain tensors, its own block:
    the batch rows and query heads that q's placements give it, q's rows
    where q is split along the sequence (then ``q_offset``, the block's
    first position, is passed to ``core``), and k and v whole along their
    sequence,
    laid out by batch as q and cut to the kv heads that its query heads
    read (GQA: query head h reads kv head h // (H / KV); kv heads that
    ``model`` splits as the query heads stay split).  The result is laid
    out as q.  Attention is independent per batch row and head, so this
    moves nothing but a split of k and v that q does not share; DTensor's
    own batched products merge the batch with the heads, a view that
    torch 2.11 refuses where both are split.  Plain tensors go to
    ``core`` as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return core(q, k, v, **kw)
    mesh = q.device_mesh
    keep = [p if p.is_shard() and p.dim < 3 else Replicate()
            for p in q.placements]
    q = q.redistribute(mesh, keep)
    kv_heads = k.shape[2]
    want = [Shard(0) if p.is_shard(0) else
            Shard(2) if p.is_shard(2) and kv_heads % mesh.size(m) == 0
            else Replicate() for m, p in enumerate(keep)]
    k, v = (t.redistribute(mesh, want) for t in (k, v))
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    group = q.shape[2] // kv_heads
    heads = ql.shape[2]
    if heads % group and group % heads:
        raise ValueError(f"{heads} query heads a rank split the groups of "
                         f"{group}")
    first = block_index(q, 2) * heads // group - \
        block_index(k, 2) * kl.shape[2]
    cut = slice(first, first + max(heads // group, 1))
    if any(p.is_shard(1) for p in keep):
        kw["q_offset"] = block_index(q, 1) * ql.shape[1]
    out = core(ql, kl[:, :, cut], vl[:, :, cut], **kw)
    # laid out contiguously, as the DTensor's strides say
    return DTensor.from_local(out.contiguous(), mesh, keep, run_check=False,
                              shape=q.shape,
                              stride=contiguous_stride(q.shape))


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *sizes)`` (heads out of a projection).
    A DTensor sharded along its last dim over ranks that do not divide
    ``sizes[0]`` cannot be split so (DTensor refuses the uneven view); it
    is gathered along that dim first, as XLA reshards such a reshape."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and sizes[0] % _ranks_splitting(x, -1):
        x = gather_dim(x, -1)
    return x.reshape(*x.shape[:-1], *sizes)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.softmax(x, dim)``.  On a DTensor split along ``dim`` over
    more than one rank (decode scores over a sequence-sharded cache), the
    max and the sum are reduced across the shards, one value a row each,
    as XLA's partitioner does, where DTensor's own softmax would gather
    the whole dim."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and _ranks_splitting(x, dim) > 1:
        e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
        return e / torch.sum(e, dim=dim, keepdim=True)
    return torch.softmax(x, dim=dim)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)`` of activations ``[..., d]`` and a weight
    ``[d, n]``.  On a DTensor the leading dims are folded into one first,
    as ``torch.matmul`` folds a plain tensor's: DTensor's global strides of
    a dim of one may differ from its local tensor's (an einsum's output),
    and then ``torch.matmul`` takes a batched product instead, which
    rounds otherwise.  A split of a leading dim but the first (a
    sequence-sharded activation) is moved first, to the contracted dim
    where ``w``'s rows split over the same mesh dim, else gathered: torch
    2.11's view folds dims only where none but the first of them is
    split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or x.dim() < 3:
        return torch.matmul(x, w)
    last = x.dim() - 1
    want = [(Shard(last) if isinstance(w, DTensor) and
             w.placements[m].is_shard(w.dim() - 2) else Replicate())
            if p.is_shard() and 0 < p.dim < last else p
            for m, p in enumerate(x.placements)]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return torch.matmul(x.reshape(-1, x.shape[-1]), w).view(
        *x.shape[:-1], w.shape[-1])


def tiled(fn, x: torch.Tensor, tile: tuple) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that works on the ``tile[0] x tile[1]``
    tiles of ``x``'s rows (every dim but the last, flattened) and last dim
    independently, padding the ragged ends itself (BFP quantization's 2D
    groups), and keeps the shape.

    On a DTensor each rank applies ``fn`` to its own block where that
    block holds whole tiles: its rows a contiguous run (no leading dim but
    the first is split) of a multiple of ``tile[0]``, and its columns, if
    split, a multiple of ``tile[1]``.  Otherwise a tile would straddle
    ranks, and the dims split over the ranks that cut one are gathered
    first, then cut back to this rank's block (no collective).  The
    result is laid out as ``x``.  A plain ``x`` goes to ``fn`` as it
    is.  (DTensor's own pad and group reshape of a split dim either
    gather it or, in some torch versions, fail.)"""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    x = reduce_partial(x)
    mesh, last = x.device_mesh, x.dim() - 1
    local = x.to_local()
    rows = math.prod(local.shape[:-1])

    def cuts(p):
        if not p.is_shard():
            return False
        if p.dim == last:
            return local.shape[-1] % tile[1] != 0
        return p.dim != 0 or rows % tile[0] != 0
    want = [Replicate() if cuts(p) else p for p in x.placements]
    if want == list(x.placements):
        out = fn(local)
    else:
        whole = x.redistribute(mesh, want)
        out = DTensor.from_local(fn(whole.to_local()), mesh, want,
                                 run_check=False, shape=x.shape,
                                 stride=whole.stride()
                                 ).redistribute(mesh, x.placements
                                                ).to_local()
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _ranks_splitting(x, dim: int) -> int:
    """The number of ranks among which a DTensor ``x``'s ``dim`` is split."""
    dim %= x.dim()
    return math.prod(x.device_mesh.size(m) for m, p in enumerate(x.placements)
                     if p.is_shard(dim))


class _RowSum(torch.autograd.Function):
    """``reduce(local)`` forward, where ``reduce`` sums each rank's
    ``local`` over ranks (a collective); identity backward: each rank's
    addend moves the sum one for one, so its gradient is the sum's,
    whole on every rank."""

    @staticmethod
    def forward(ctx, local, reduce):
        return reduce(local)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _row_reducer(x):
    """For a DTensor ``x`` split along its last dim: ``(rows, reduce)``,
    the placements of a per-row result (``x``'s, the last dim's splits
    replicated) and ``reduce(local, op)``, which reduces each rank's local
    per-row values by ``op`` over the ranks that split the last dim and
    returns this rank's block of the result, laid out by ``rows``.  The
    gradient of a ``sum`` reaches each rank's local values whole
    (``_RowSum``: DTensor's own backward of a partial value differs
    between torch versions)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, last = x.device_mesh, x.dim() - 1
    rows = [Replicate() if p.is_shard(last) else p for p in x.placements]
    shape = x.shape[:-1]

    def reduced(local, op):
        return DTensor.from_local(
            local, mesh, [Partial(op) if p.is_shard(last) else p
                          for p in x.placements],
            run_check=False, shape=shape, stride=contiguous_stride(shape)
        ).redistribute(mesh, rows).to_local()

    def reduce(local, op="sum"):
        if op == "sum":
            return _RowSum.apply(local, lambda t: reduced(t, op))
        return reduced(local, op)
    return rows, reduce


def _rows_placed(local, x, rows):
    from torch.distributed.tensor import DTensor
    shape = x.shape[:-1]
    return DTensor.from_local(local, x.device_mesh, rows, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def logsumexp_pick(logits: torch.Tensor, labels: torch.Tensor) -> tuple:
    """``(torch.logsumexp(logits, -1), logits[..., labels])``: each row's
    log-sum-exp and its entry at the row's label, for logits ``[..., V]``
    and integer labels ``[...]``.

    On a DTensor whose vocab (the last dim) is split, vocab-parallel: each
    rank's local max, all-reduced by max; each rank's sum of
    ``exp(x - max)``, all-reduced by sum; each rank's pick of the labels
    that lie in its vocab block (zero elsewhere), all-reduced by sum.  The
    results are laid out as ``logits`` less its vocab split, and the
    gradient reaches each rank's logits through the sums (the max is a
    constant of it).  A DTensor whose vocab is whole on each rank runs
    the plain ops on its own rows, with nothing to reduce (so one rank
    gives the plain values bit for bit).  DTensor's own
    ``logsumexp`` and ``gather`` on a split vocab leave a masked partial
    value that the next op fails to reduce, and on a whole vocab may
    gather the rows.  Any other tensor: the two plain ops."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None].long())[..., 0])
    logits = reduce_partial(logits)
    rows, reduce = _row_reducer(logits)
    local = logits.to_local()
    lab = _as_rows(labels, logits.device_mesh, rows).long()
    if _ranks_splitting(logits, -1) == 1:
        # the whole vocab on the rank: the plain ops on its rows
        return (_rows_placed(torch.logsumexp(local, dim=-1), logits, rows),
                _rows_placed(torch.gather(local, -1, lab[..., None])[..., 0],
                             logits, rows))
    m = reduce(torch.amax(local.detach(), dim=-1), "max")
    lse = m + torch.log(reduce(torch.sum(torch.exp(local - m[..., None]),
                                         dim=-1)))
    n = local.shape[-1]
    lab = lab - block_index(logits, logits.dim() - 1) * n
    inside = (lab >= 0) & (lab < n)
    pick = torch.gather(local, -1, lab.clamp(0, n - 1)[..., None])[..., 0]
    ll = reduce(torch.where(inside, pick, torch.zeros_like(pick)))
    return _rows_placed(lse, logits, rows), _rows_placed(ll, logits, rows)


def argmax(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, -1)``, the first index of each row's largest
    entry.  On a DTensor whose last dim is split: each rank's largest
    entry and its first index, then the largest of those by an all-reduce
    of the max and the least index holding it by an all-reduce of the
    min, laid out as ``x`` less that split: two values a row cross the
    ranks, where DTensor's own argmax would gather the whole of ``x``.  A
    DTensor whose last dim is whole on each rank: the plain argmax of its
    own rows."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.argmax(x, dim=-1)
    x = reduce_partial(x)
    rows, reduce = _row_reducer(x)
    local = x.to_local().detach()
    if _ranks_splitting(x, -1) == 1:
        return _rows_placed(torch.argmax(local, dim=-1), x, rows)
    best, at = torch.max(local, dim=-1)
    at = at + block_index(x, x.dim() - 1) * local.shape[-1]
    top = reduce(best, "max")
    first = reduce(torch.where(best == top, at,
                               torch.full_like(at, x.shape[-1])), "min")
    return _rows_placed(first, x, rows)


def _as_rows(t, mesh, rows) -> torch.Tensor:
    """This rank's block of ``t`` laid out by ``rows`` (a plain ``t`` is
    whole on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, rows).to_local()


def unit_shards_replicated(tree: Any) -> Any:
    """Each DTensor of ``tree`` with a shard of a dim of one, over a mesh
    axis of one rank (a one-rank mesh's layout of a batch of one),
    relabelled as replicated there, on the same local tensor: the same
    layout, but DTensor's views refuse to merge a sharded dim of one, as
    a batched product merges its operands' batch dims.  Other leaves as
    they are."""
    from torch.distributed.tensor import DTensor, Replicate

    def relabel(x):
        if not isinstance(x, DTensor):
            return x
        mesh = x.device_mesh
        want = tuple(Replicate() if p.is_shard() and mesh.size(m) == 1 and
                     x.shape[p.dim] == 1 else p
                     for m, p in enumerate(x.placements))
        if want == tuple(x.placements):
            return x
        return DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return tree_map(relabel, tree)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    if _RULES is None or name not in _RULES:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh
    spec = _RULES[name]
    if len(spec) > x.ndim:          # rank-adjust (e.g. decode S=1 collapsed)
        spec = spec[:x.ndim]
    if isinstance(x, DTensor):
        if x.device_mesh != _MESH:
            raise ValueError(f"constrain({name!r}): the DTensor lies on "
                             f"{x.device_mesh}, not on the installed mesh "
                             f"{_MESH}")
        sizes = sh.mesh_shape(_MESH)

        def split(e):
            return math.prod(sizes[a] for a in
                             (e if isinstance(e, tuple) else (e,)))
        spec = tuple(None if e is not None and (
            x.shape[d] == 1 or x.shape[d] % split(e))
            else e for d, e in enumerate(spec))
        return x.redistribute(_MESH, sh.placements(spec, _MESH))
    ranks = math.prod(sh.mesh_shape(_MESH).values())
    if ranks == 1 or (x.is_meta and isinstance(_MESH, sh.AbstractMesh)):
        return x
    raise ValueError(f"constrain({name!r}): a plain tensor on a mesh of "
                     f"{ranks} ranks is one rank's local data; pass a DTensor")
