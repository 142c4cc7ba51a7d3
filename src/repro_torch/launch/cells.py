"""Cell construction shared by the launchers (counterpart of
``repro/launch/cells.py``; ``duplex_tcfg`` and ``activation_rules`` are
ported)."""
from __future__ import annotations

import torch

from repro_torch.core import duplex as dx
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
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


def activation_rules(cfg, mesh, fsdp_pure: bool = False) -> dict:
    """Per-arch activation specs, ``{name: spec}``, for
    ``distributed.ctx.activation_sharding``.

    Heads divide TP → shard the flat query-head axis; otherwise fall back to
    sequence parallelism (q sharded on seq, kv replicated and all-gathered).
    ``fsdp_pure``: the batch dim spreads over ALL mesh axes and nothing else
    is sharded.
    """
    tp = sh.mesh_shape(mesh)["model"]
    if fsdp_pure:
        dpm = sh.dp_axes(mesh, include_model=True)
        return {"resid": P(dpm, None, None),
                "act_q": P(dpm, None, None, None),
                "act_kv": P(dpm, None, None, None),
                "act_lru": P(dpm, None, None)}
    dp = sh.dp_axes(mesh)
    rules = {"resid": P(dp, None, None),
             "act_lru": P(dp, None, "model"),
             # decode scores follow the seq-sharded KV cache
             "dec_scores": P(dp, None, None, "model")}
    if cfg.n_heads and cfg.n_heads % tp == 0:
        rules["act_q"] = P(dp, None, "model", None)
        rules["act_kv"] = P(dp, None,
                            "model" if cfg.n_kv % tp == 0 else None, None)
    elif cfg.n_heads:
        rules["act_q"] = P(dp, "model", None, None)      # sequence parallel
        rules["act_kv"] = P(dp, None, None, None)
    return rules
