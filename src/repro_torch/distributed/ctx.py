"""Activation-sharding context: models call ``constrain(x, name)`` at
strategic tensors; a launcher installs per-arch rules (``{name: spec}``,
``launch.cells.activation_rules``) on a mesh.

Counterpart of ``repro/distributed/ctx.py``.  ``constrain``:

* with no rules installed, or a name not in them, returns ``x`` itself, so
  model code stays mesh-agnostic and the single-card paths do not change;
* shortens a spec longer than ``x.ndim`` (e.g. decode's S=1 collapsed);
* redistributes a DTensor to the rule's placements on the installed mesh
  (``sharding.placements``); a DTensor on another mesh raises;
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
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch

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
        return x.redistribute(_MESH, sh.placements(spec, _MESH))
    ranks = math.prod(sh.mesh_shape(_MESH).values())
    if ranks == 1 or (x.is_meta and isinstance(_MESH, sh.AbstractMesh)):
        return x
    raise ValueError(f"constrain({name!r}): a plain tensor on a mesh of "
                     f"{ranks} ranks is one rank's local data; pass a DTensor")
