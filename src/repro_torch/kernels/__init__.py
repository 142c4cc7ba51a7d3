"""Hand-written CUDA kernels of the port, each beside its plain version."""
from __future__ import annotations

import torch


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and a float input requires grad.

    The kernels are forward only, as the reference's Pallas kernels are:
    ``jax.grad`` through those raises, and a kernel's output here would
    carry no graph, so a backward pass would leave its inputs without a
    gradient.  Checked on every device, the plain CPU version included.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the kernel has no "
            f"backward (the reference's Pallas kernel defines none); call "
            f"it under torch.no_grad() or on detached tensors")


def refuse_dtensor(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``TypeError`` when an operand is a DTensor.

    A kernel takes one device's memory through its data pointer, so it
    cannot see a DTensor's global layout: handed one, it would run on this
    rank's shard as if it were the whole tensor.  A caller on a mesh runs
    the kernel on each rank's plain local block itself (the flash kernel
    through ``distributed/ctx.py::attention_blocks``)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{kernel}: a DTensor operand; the kernel reads one device's "
            f"memory and cannot see the global layout, so pass each rank's "
            f"local block as a plain tensor")
