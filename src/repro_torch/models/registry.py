"""Architecture registry: --arch <id> → configs + model API.

Counterpart of ``repro/models/registry.py``.  The port covers the dense
and MoE attention families, local attention included, and the
attention-free Mamba-2 (mamba2-780m); the other architectures of the JAX
registry raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (gemma2_9b, granite_3_8b, granite_moe_1b,
                                 llama4_maverick, mamba2_780m, qwen2_72b,
                                 starcoder2_7b)
from repro_torch.configs.common import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    full: ModelConfig
    smoke: ModelConfig
    module: object                      # transformer

    def config(self, preset: str = "full") -> ModelConfig:
        return self.full if preset == "full" else self.smoke


ARCHS: dict[str, ArchEntry] = {
    name: ArchEntry(name=name, full=mod.FULL, smoke=mod.SMOKE,
                    module=transformer)
    for name, mod in (("granite-3-8b", granite_3_8b),
                      ("qwen2-72b", qwen2_72b),
                      ("granite-moe-1b-a400m", granite_moe_1b),
                      ("llama4-maverick-400b-a17b", llama4_maverick),
                      ("gemma2-9b", gemma2_9b),
                      ("starcoder2-7b", starcoder2_7b),
                      ("mamba2-780m", mamba2_780m))
}

# Architectures of the JAX registry that the port does not cover yet, by
# the layer kind they miss.
NOT_PORTED: dict[str, str] = {
    "recurrentgemma-9b": transformer.roadmap_item("lru"),
    "whisper-base": transformer.roadmap_item("cross"),
    "llama-3.2-vision-90b": transformer.roadmap_item("cross"),
}


def get(name: str) -> ArchEntry:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: "
            f"{NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
