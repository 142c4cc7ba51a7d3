"""Unified model-configuration schema (copy of ``repro/configs/common.py``).

A model is a token embedding + a *pattern* of layer specs repeated
``n_rep`` times + an optional non-repeating ``remainder`` + final norm +
tied unembedding.  The port keeps its own copy so that it imports nothing
of the JAX package; the fields are the same, so configs compare one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                 # attn | local | cross | ssd | lru
    mlp: str = "dense"        # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    vocab: int
    d_model: int
    n_layers: int
    pattern: Tuple[LayerSpec, ...]
    remainder: Tuple[LayerSpec, ...] = ()

    # attention
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    pos_embed: str = "rope"   # rope | sinusoidal | none
    window: Optional[int] = None
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    causal: bool = True
    post_norm: bool = False   # gemma2-style post-sublayer norms
    q_chunk: int = 512
    kv_chunk: int = 1024
    blockwise_threshold: int = 1024
    causal_skip: bool = False  # skip fully-masked kv chunks (blockwise path)
    use_flash: bool = False    # hand-written flash attention kernel

    # mlp
    d_ff: int = 0
    gated_mlp: bool = True
    act: str = "silu"         # silu | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    shared_expert: bool = False

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128

    # lru (recurrentgemma)
    lru_width: int = 0
    conv_width: int = 4
    lru_scan_chunk: Optional[int] = None

    # frontends / enc-dec
    encoder: Optional["ModelConfig"] = None
    n_frontend_tokens: int = 0
    frontend_dim: int = 0

    # norms / vocab
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    vocab_pad_multiple: int = 256
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale

    supports_long_context: bool = False

    @property
    def n_rep(self) -> int:
        body = self.n_layers - len(self.remainder)
        if self.pattern and body % len(self.pattern):
            raise ValueError(
                f"{self.name}: {body} layers not divisible by pattern "
                f"{len(self.pattern)}")
        return body // len(self.pattern) if self.pattern else 0

    def validate(self) -> "ModelConfig":
        _ = self.n_rep
        kinds = {s.kind for s in self.pattern + self.remainder}
        if kinds & {"attn", "local", "cross"}:
            if not (self.n_heads and self.n_kv and self.head_dim):
                raise ValueError(f"{self.name}: attention needs heads")
            if self.n_heads % self.n_kv:
                raise ValueError(f"{self.name}: n_heads % n_kv != 0")
        if any(s.mlp == "moe" for s in self.pattern + self.remainder):
            if not (self.n_experts and self.top_k):
                raise ValueError(f"{self.name}: moe needs experts")
        if "ssd" in kinds and not self.ssm_state:
            raise ValueError(f"{self.name}: ssd needs ssm_state")
        if "lru" in kinds and not self.lru_width:
            raise ValueError(f"{self.name}: lru needs lru_width")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                 # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
