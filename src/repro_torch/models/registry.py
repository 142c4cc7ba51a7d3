"""Architecture registry: --arch <id> → configs + model API.

Counterpart of ``repro/models/registry.py``, with the same ten archs.
Every entry exposes the same API (``init_params``/``forward``/
``lm_logits``, and for serving ``init_cache``/``prefill``/``decode_step``)
whatever its family: whisper-base dispatches to the enc-dec composition
(``models/encdec.py``), everything else to the generic stack.  The port
trains and serves each of them: the dense, MoE, local-attention, Mamba-2,
hybrid RG-LRU (recurrentgemma-9b), audio (whisper-base) and
vision-language (llama-3.2-vision-90b) archs.  ``ARCHS`` lists them in
the reference's order, so ``cells()`` gives its 40 cells in its order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import (gemma2_9b, granite_3_8b, granite_moe_1b,
                                 llama32_vision_90b, llama4_maverick,
                                 mamba2_780m, qwen2_72b, recurrentgemma_9b,
                                 starcoder2_7b, whisper_base)
from repro_torch.configs.common import ModelConfig, SHAPES
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    full: ModelConfig
    smoke: ModelConfig
    module: object                      # transformer | encdec

    def config(self, preset: str = "full") -> ModelConfig:
        return self.full if preset == "full" else self.smoke

    # frontend stubs -------------------------------------------------------
    def frontend_shape(self, cfg: ModelConfig, batch: int) -> Optional[dict]:
        if cfg.family == "audio":
            return {"frames": (batch, cfg.n_frontend_tokens, cfg.frontend_dim)}
        if cfg.family == "vlm":
            return {"cross_kv": (batch, cfg.n_frontend_tokens,
                                 cfg.frontend_dim)}
        return None


ARCHS: dict[str, ArchEntry] = {
    name: ArchEntry(name=name, full=mod.FULL, smoke=mod.SMOKE, module=api)
    for name, mod, api in (
        ("whisper-base", whisper_base, encdec),
        ("gemma2-9b", gemma2_9b, transformer),
        ("qwen2-72b", qwen2_72b, transformer),
        ("starcoder2-7b", starcoder2_7b, transformer),
        ("granite-3-8b", granite_3_8b, transformer),
        ("llama-3.2-vision-90b", llama32_vision_90b, transformer),
        ("mamba2-780m", mamba2_780m, transformer),
        ("recurrentgemma-9b", recurrentgemma_9b, transformer),
        ("granite-moe-1b-a400m", granite_moe_1b, transformer),
        ("llama4-maverick-400b-a17b", llama4_maverick, transformer))
}


def get(name: str) -> ArchEntry:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


LONG_CONTEXT_SKIP = "quadratic attention cannot serve 500k context"


def cells(include_skips: bool = True):
    """All 40 (arch × shape) cells, ``(arch, ShapeSpec, skip)``, with the
    reason a cell is skipped or ``None``."""
    out = []
    for name, entry in ARCHS.items():
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and \
                    not entry.full.supports_long_context:
                skip = LONG_CONTEXT_SKIP
            if skip is None or include_skips:
                out.append((name, shape, skip))
    return out
