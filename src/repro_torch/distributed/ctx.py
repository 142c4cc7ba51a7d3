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

The prefill and decode steps on DTensors (a cell placed on a mesh,
``launch/dryrun.py``) also go through the helpers below, where DTensor's
own rule for an op partitions otherwise than the sharding scheme means,
or fails: ``at_use`` (a weight's ZeRO-3 shards gathered),
``reduce_partial``, ``embedding`` (the vocab-parallel lookup),
``index_copy_`` (a decode step's cache slot written in each rank's
block), ``write_slots_`` (a prefill's slots so written), ``full_placed``
(a prefill's cache allocated by blocks), ``attention_blocks`` (a
prefill's attention on each rank's block), ``softmax``, ``gather_dim``,
``split_last``, ``matmul`` and ``unit_shards_replicated``.  On a plain
tensor each is the op it stands for, so the single-card paths do not
change.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.utils import tree_map

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
    reduces it), as XLA's partitioner does there too.  Any other tensor as
    it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    last = x.dim() - 1
    split = [isinstance(x, DTensor) and x.placements[m].is_shard() and
             not x.placements[m].is_shard(last) for m in range(len(names))]
    rows = w.dim() - 2
    want = [Replicate() if names[m] in ("pod", "data") and split[m] and
            p.is_shard(rows) else p for m, p in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


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
    k, v [B, Skv, KV, hd] (``L.full_attention``, ``L.blockwise_attention``).

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
    if isinstance(x, DTensor):
        ranks = math.prod(x.device_mesh.size(m)
                          for m, p in enumerate(x.placements)
                          if p.is_shard(x.dim() - 1))
        if sizes[0] % ranks:
            x = gather_dim(x, -1)
    return x.reshape(*x.shape[:-1], *sizes)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.softmax(x, dim)``.  On a DTensor split along ``dim`` over
    more than one rank (decode scores over a sequence-sharded cache), the
    max and the sum are reduced across the shards, one value a row each,
    as XLA's partitioner does, where DTensor's own softmax would gather
    the whole dim."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and math.prod(
            x.device_mesh.size(m) for m, p in enumerate(x.placements)
            if p.is_shard(dim % x.dim())) > 1:
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
