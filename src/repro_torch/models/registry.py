"""Architecture registry: --arch <id> → configs + model API.

Counterpart of ``repro/models/registry.py``.  The port covers the dense
and MoE attention families; the other architectures of the JAX registry raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (granite_3_8b, granite_moe_1b,
                                 llama4_maverick, qwen2_72b)
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
                      ("llama4-maverick-400b-a17b", llama4_maverick))
}

# Architectures of the JAX registry that the port does not cover yet.
_KINDS = "ROADMAP §1 'Modules to port' item 2 (The other layer kinds"
NOT_PORTED: dict[str, str] = {
    "mamba2-780m": f"{_KINDS}: SSD)",
    "recurrentgemma-9b": f"{_KINDS}: RG-LRU, local attention)",
    "whisper-base": f"{_KINDS}: enc-dec)",
    "llama-3.2-vision-90b": f"{_KINDS}: cross-attention frontend)",
    "gemma2-9b": f"{_KINDS}: local attention)",
    "starcoder2-7b": f"{_KINDS}: its layer kinds are ported; its config "
                     f"is not copied or tested yet)",
}


def get(name: str) -> ArchEntry:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: "
            f"{NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
