"""Mesh construction over the default ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``.  Both makers are functions, and
importing this module touches no process group.  Single pod: 16×16 = 256
ranks, ``("data", "model")``; multi-pod adds a leading ``pod`` axis
(2×16×16 = 512 ranks), which carries data-parallel gradient reduction only.
Neither maker starts a group: the caller initialises the default group
(``torch.distributed.init_process_group``) with its own address, world size
and rank, or through ``init_distributed`` from torchrun's environment (the
launchers' ``--distributed``), and a maker raises where there is none, or
where its world does not fit the mesh.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def init_distributed(device_type: str = "cuda") -> torch.device:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), the counterpart of ``jax.distributed.initialize()``,
    and return this rank's device: ``cuda:LOCAL_RANK`` under ``nccl``
    (bound to the group as its ``device_id``), or the CPU under ``gloo``.
    A missing variable raises, naming it.  The caller destroys the group
    (``torch.distributed.destroy_process_group``)."""
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment: "
                           f"{', '.join(missing)} not set (run under "
                           f"torchrun, or set them for a group of one)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", rank=rank,
                                world_size=world, device_id=device)
    elif device_type == "cpu":
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world)
    else:
        raise ValueError(f"no process group backend for {device_type!r}")
    return device


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


@contextlib.contextmanager
def launcher_mesh(name: str, distributed: bool, device: torch.device):
    """``(device, mesh)`` for the launchers' ``--mesh`` and
    ``--distributed``.  Without ``distributed``: ``(device, None)``, one
    process on plain tensors (``host`` on one device is the identity, as
    JAX's one-device mesh is); ``pod`` or ``multipod`` raise, naming the
    ranks they need.  With it: the default group started from torchrun's
    environment (``init_distributed``; this rank's device), the mesh made
    as the reference's launchers make it, and the group destroyed on
    exit, also on an exception.  DTensor's sharding propagation caches are
    cleared then too: they key specs by meshes equal in ranks and names,
    so a later group's mesh would be handed specs naming this one's
    destroyed groups."""
    if not distributed:
        if name != "host":
            need = math.prod(production_layout(
                multi_pod=name == "multipod").sizes)
            raise ValueError(f"--mesh {name} needs {need} ranks: start "
                             f"them with torchrun and pass --distributed")
        yield device, None
        return
    device = init_distributed(device.type)
    try:
        mesh = make_host_mesh(device_type=device.type) if name == "host" \
            else make_production_mesh(multi_pod=name == "multipod",
                                      device_type=device.type)
        yield device, mesh
    finally:
        dist.destroy_process_group()
        from torch.distributed.tensor.debug import _clear_sharding_prop_cache
        _clear_sharding_prop_cache()
