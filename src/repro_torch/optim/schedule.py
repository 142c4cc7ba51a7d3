"""Learning-rate schedules: callables on the int32 step tensor that return
an f32 scalar on the step's device.

Counterpart of ``repro/optim/schedule.py``; ``TrainConfig.lr_schedule``
takes any of them.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def step_decay(lr: float, boundaries: tuple[int, ...], factor: float = 0.1):
    """The paper's schedule: divide by 10 at epochs 30/60 (§VI-B)."""
    def fn(step):
        mult = torch.ones((), dtype=torch.float32, device=step.device)
        for b in boundaries:
            mult = torch.where(step >= b, mult * factor, mult)
        return lr * mult
    return fn


def cosine_warmup(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, lr * cos)
    return fn
