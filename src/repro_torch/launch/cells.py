"""Cell construction shared by the launchers (counterpart of
``repro/launch/cells.py``; only ``duplex_tcfg`` is ported)."""
from __future__ import annotations

import torch

from repro_torch.core import duplex as dx
from repro_torch.models import layers as L
from repro_torch.optim import SGDConfig
from repro_torch.train import train_step as ts


def duplex_tcfg(cfg, backbone_dtype=torch.bfloat16) -> ts.TrainConfig:
    """Production duplex config: branch width scales with the backbone."""
    d_branch = max(256, cfg.d_model // 8)
    n_blocks = max(2, min(8, cfg.n_rep))
    return ts.TrainConfig(
        mode="duplex",
        duplex=dx.DuplexConfig(
            n_blocks=n_blocks, d_branch=d_branch, pool_factor=16,
            branch_heads=max(4, d_branch // 128),
            bfp=L.BFPPolicy(enabled=True, group=(32, 32))),
        opt=SGDConfig(), lr=1e-3, backbone_dtype=backbone_dtype)
