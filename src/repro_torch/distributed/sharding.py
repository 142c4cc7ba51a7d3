"""Sharding rules: param/optimizer/cache/batch trees → partition specs, and
specs → DTensor placements.

Counterpart of ``repro/distributed/sharding.py``, rule for rule.  Scheme:

* ``model`` axis — tensor parallel (attention heads / MLP hidden / experts /
  vocab) + sequence-sharded KV caches for serving;
* ``data`` axis — batch DP + FSDP weight sharding (ZeRO-3-style: the
  non-TP dim of every large weight is sharded over ``data`` and gathered at
  use);
* ``pod`` axis — pure DP across pods: weights replicated, only gradients
  cross the inter-pod links.

Every rule is divisibility-guarded: if a dim doesn't divide its mesh axis,
that dim falls back to replication (e.g. 36 or 40 attention heads on TP=16
⇒ the head axis replicates).  The guard runs before ``to_named``, so a
DTensor never shards a dim unevenly where the reference replicates it.

A spec is a plain tuple, as ``tuple(jax.sharding.PartitionSpec(...))``:
one entry per leading tensor dim, each ``None`` (replicated), a mesh axis
name, or a tuple of names (the dim split over all of them, major to minor).
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or an ``AbstractMesh``, which carries sizes and names only, so that the
16×16 and 2×16×16 production layouts can be reckoned without their ranks.

Two readings of the reference are kept as they are: ``_is_stacked`` is a
substring test (``branch/blocks/...`` and ``tap_proj/w`` count as stacked),
and ``cache_pspec`` gives a lead dim only to paths that start with
``stack/`` (``rem/...`` caches have none).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from repro_torch.utils import tree_map, tree_map_with_path


def P(*axes) -> tuple:
    """A partition spec: the tuple of its entries."""
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh sizes and axis names without devices or ranks, as
    ``jax.sharding.AbstractMesh``: ``AbstractMesh((16, 16), ("data",
    "model"))``."""
    sizes: tuple
    names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def axis_names(self) -> tuple:
        return tuple(self.names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of an ``AbstractMesh`` or a ``DeviceMesh``, in
    the mesh's dim order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


# (pattern, spec template applied to the *logical* (unstacked) shape)
# first match wins; "data"/"model" are mesh axes, None replicates.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", ("model", "data")),
    (r"attn/w[qkv]/w$", ("data", "model")),
    (r"attn/w[qkv]/b$", ("model",)),
    (r"attn/wo/w$", ("model", "data")),
    (r"moe/router/w$", (None, None)),
    (r"moe/w[ig]$", ("model", "data", None)),
    (r"moe/wo$", ("model", None, "data")),
    (r"(mlp|shared)/w[ig]/w$", ("data", "model")),
    (r"(mlp|shared)/wo/w$", ("model", "data")),
    (r"ssd/(z|x|dt)_proj/w$", ("data", "model")),
    (r"ssd/(b|c)_proj/w$", ("data", None)),
    (r"ssd/out_proj/w$", ("model", "data")),
    (r"ssd/conv_x/w$", (None, "model")),
    (r"ssd/conv_x/b$", ("model",)),
    (r"ssd/conv_[bc]/", (None,)),          # tiny B/C convs: replicate
    (r"ssd/(dt_bias|A_log|D)$", ("model",)),
    (r"ssd/norm/scale$", ("model",)),      # rmsnorm over sharded d_inner
    (r"lru/w[xy]/w$", ("data", "model")),
    (r"lru/wo/w$", ("model", "data")),
    (r"lru/w[ri]/w$", ("model", None)),
    (r"lru/w[ri]/b$", (None,)),
    (r"lru/conv_w$", (None, "model")),
    (r"lru/(conv_b|lambda)$", ("model",)),
    # duplex branch projections follow the generic dense rules below
    (r"(in_proj[12]|out_proj|tap_proj)/w$", ("data", "model")),
    # norms / everything else: replicated
    (r".*", ()),
]

_STACKED_PREFIXES = ("stack/", "blocks/", "tap_proj/")


def _mesh_axis_size(mesh, axis: Optional[str]) -> int:
    return 1 if axis is None else mesh_shape(mesh)[axis]


def _guard(spec: tuple, shape: tuple, mesh) -> tuple:
    out = []
    for i, ax in enumerate(spec):
        if ax is not None and shape[i] % _mesh_axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return tuple(out)


def _is_stacked(path: str) -> bool:
    return any(s in path for s in _STACKED_PREFIXES)


def param_pspec(path: str, shape: tuple, mesh, *, fsdp_pure: bool = False,
                lru_gates_colparallel: bool = False) -> tuple:
    """Param rules with two variants:

    * ``fsdp_pure`` — shard dim-0 of every large weight over the *combined*
      (data, model) axes and replicate nothing else (ZeRO-3); where no dim
      divides the combined size, the axes split across the first two dims.
    * ``lru_gates_colparallel`` — RG-LRU gates W_r/W_i switch from
      row-parallel to column-parallel.
    """
    sizes = mesh_shape(mesh)
    lead = 1 if (_is_stacked(path) and len(shape) >= 1) else 0
    logical = tuple(shape[lead:])
    if fsdp_pure and len(logical) >= 2:
        combined = tuple(a for a in ("data", "model") if a in sizes)
        n = 1
        for a in combined:
            n *= sizes[a]
        spec = [None] * len(logical)
        placed = False
        for d in range(len(logical)):          # prefer a fully-sharded dim
            if logical[d] % n == 0:
                spec[d] = combined
                placed = True
                break
        if not placed:
            # split the axes across two dims (e.g. 29568×8192 on 16×16)
            ax0, ax1 = combined if len(combined) == 2 else (combined[0],) * 2
            if logical[0] % sizes[ax0] == 0 and logical[1] % sizes[ax1] == 0:
                spec[0], spec[1] = ax0, ax1
            elif logical[0] % sizes[ax0] == 0:
                spec[0] = ax0
            elif logical[1] % sizes[ax1] == 0:
                spec[1] = ax1
        return P(*((None,) * lead + tuple(spec)))
    rules = _PARAM_RULES
    if lru_gates_colparallel:
        rules = [(r"lru/w[ri]/w$", (None, "model")),
                 (r"lru/w[ri]/b$", ("model",))] + rules
    for pat, spec in rules:
        if re.search(pat, path):
            spec = spec[:len(logical)]
            spec = spec + (None,) * (len(logical) - len(spec))
            spec = _guard(spec, logical, mesh)
            return P(*((None,) * lead + spec))
    return P()


def dp_axes(mesh, include_model: bool = False):
    """The batch axes in mesh order: a bare name for one, a tuple for more."""
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    axes = tuple(a for a in mesh_shape(mesh) if a in names)
    return axes if len(axes) > 1 else axes[0]


def _guard_dp(batch_dim: int, mesh, include_model: bool = False):
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    sizes = mesh_shape(mesh)
    total = 1
    for a in names:
        if a in sizes:
            total *= sizes[a]
    return dp_axes(mesh, include_model) if batch_dim % total == 0 else None


def cache_pspec(path: str, shape: tuple, mesh) -> tuple:
    """KV caches / recurrent states: batch over DP, seq-or-state over model."""
    lead = 1 if path.startswith("stack/") else 0
    logical = tuple(shape[lead:])
    name = path.rsplit("/", 1)[-1]
    if name in ("len", "step") or not logical:
        return P()
    if name == "pos":
        return P(*((None,) * len(shape)))
    dp = _guard_dp(logical[0], mesh)
    if name in ("k", "v"):
        # [B, S, KV, hd] — sequence-sharded cache (context parallelism)
        spec = (dp, "model", None, None)
    elif name == "h" and len(logical) == 4:       # ssd [B,H,P,N]
        spec = (dp, "model", None, None)
    elif name == "h" and len(logical) == 2:       # lru [B,W]
        spec = (dp, "model")
    elif name.startswith("conv"):                 # [B,K-1,C]
        spec = (dp, None, "model")
    else:
        spec = (dp,) + (None,) * (len(logical) - 1)
    spec = spec[:len(logical)] + (None,) * (len(logical) - len(spec))
    sizes = mesh_shape(mesh)
    guarded = []
    for i, s in enumerate(spec):
        if s is None or s == dp or isinstance(s, tuple):
            guarded.append(s)          # dp already divisibility-guarded
        else:
            guarded.append(s if logical[i] % sizes[s] == 0 else None)
    return P(*((None,) * lead + tuple(guarded)))


def batch_pspec(shape: tuple, mesh, include_model: bool = False) -> tuple:
    """``include_model=True``: batch over ALL axes (the fsdp_pure layout)."""
    dp = _guard_dp(shape[0], mesh, include_model)
    if include_model and dp is None:
        dp = _guard_dp(shape[0], mesh)      # fall back to pod×data
    return P(*((dp,) + (None,) * (len(shape) - 1)))


# --------------------------------------------------------------------------
# tree-level helpers
# --------------------------------------------------------------------------

def tree_pspecs(tree: Any, mesh, rule) -> dict:
    """Map a nested dict of tensors (``meta`` ones too) to specs, by each
    leaf's ``a/b/c`` path and shape, in the tree's own structure: an empty
    subtree (a cache's ``rem: {}``) stays, as the reference's map keeps
    it, so that ``device_put`` finds it."""
    return tree_map_with_path(
        lambda p, x: rule(_strip(p), tuple(x.shape), mesh), tree)


def _strip(path: str) -> str:
    # optimizer state wraps the param tree under mu/nu; strip for matching
    for pre in ("mu/", "nu/", "backbone/", "branch/", "opt/"):
        if path.startswith(pre):
            return _strip(path[len(pre):])
    return path


def state_pspecs(state_shapes: Any, mesh, pspec=None) -> dict:
    pspec = pspec or param_pspec

    def rule(path, shape, m):
        if path in ("step",) or path.endswith("/step") or not shape:
            return P()
        return pspec(path, shape, m)
    return tree_pspecs(state_shapes, mesh, rule)


# --------------------------------------------------------------------------
# specs → DTensor placements
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``: ``placements``
    holds one DTensor placement per mesh dim, and ``spec`` the spec they
    came from (``to_named`` sets it; equality reads the placements)."""
    mesh: Any
    placements: tuple
    spec: Optional[tuple] = dataclasses.field(default=None, compare=False)


def placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` on each mesh dim that
    ``spec`` names at tensor dim ``d``, ``Replicate()`` on the others.
    Tensor dims past the spec's length are replicated.  A tuple entry
    becomes one ``Shard(d)`` per name, which DTensor splits in mesh-dim
    order; that is JAX's major-to-minor order only when the tuple lists
    its axes in the mesh's own order, so a tuple out of that order raises,
    as does an axis named at two dims or one the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {tuple(names)} lacks")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: {entry} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for m in dims:
            if isinstance(out[m], Shard):
                raise ValueError(f"spec {spec} names axis {names[m]!r} at "
                                 f"two dims")
            out[m] = Shard(d)
    return tuple(out)


def to_named(tree_specs: Any, mesh) -> Any:
    """Each spec of a tree (or one spec) as a ``NamedSharding`` on
    ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, placements(s, mesh), s),
                    tree_specs)


def device_put(tree: Any, named: Any) -> Any:
    """Each leaf as a DTensor on its ``NamedSharding`` (``to_named``'s
    tree), as ``jax.device_put(tree, shardings)``: every rank holds the
    whole value, as a host array is, and keeps its own block of it (each
    split dim cut by the rank's coordinates, major to minor in mesh
    order).  No collective runs (the process groups' scatter has no
    float8 type), and a block that is the whole leaf (one rank) is the
    leaf itself, not a copy (``distribute_tensor`` copies it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: device_put(v, named[k]) for k, v in tree.items()}
    mesh, block = named.mesh, tree
    for d in range(tree.dim()):
        k, i = 1, 0
        for m, p in enumerate(named.placements):
            if p.is_shard(d):
                k, i = k * mesh.size(m), i * mesh.size(m) + \
                    mesh.get_local_rank(m)
        if tree.shape[d] % k:
            raise ValueError(f"{named.placements} split dim {d} of "
                             f"{tuple(tree.shape)} unevenly")
        n = tree.shape[d] // k
        block = block.narrow(d, i * n, n)
    return DTensor.from_local(block.contiguous(), mesh, named.placements,
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())
