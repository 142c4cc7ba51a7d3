"""Mesh construction over the default ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``.  Both makers are functions, and
importing this module touches no process group.  Single pod: 16×16 = 256
ranks, ``("data", "model")``; multi-pod adds a leading ``pod`` axis
(2×16×16 = 512 ranks), which carries data-parallel gradient reduction only.
Neither maker starts a group: the caller initialises the default group
(``torch.distributed.init_process_group``) with its own address, world size
and rank, and a maker raises where there is none, or where its world does
not fit the mesh.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def production_layout(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's sizes and axis names without ranks, as the
    reference's dry run sees its mesh: what the dry run traces the cells
    on, with no process group."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    layout = production_layout(multi_pod=multi_pod)
    shape, axes = layout.sizes, layout.names
    world, need = _world(), math.prod(shape)
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the default group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type="cuda"):
    """``(data, model)`` over every rank of the default group, ``data =
    max(world // model, 1)`` (tests pass ``device_type="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    data = max(_world() // model, 1)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
