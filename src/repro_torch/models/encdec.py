"""Encoder-decoder composition (whisper family).

Counterpart of ``repro/models/encdec.py``.  The audio conv frontend
is a stub: the caller provides precomputed frame embeddings
``frontend["frames"]`` [B, n_frames, d_model].  The encoder is a
bidirectional stack; the decoder is a causal stack whose pattern
interleaves self-attention and cross-attention to the encoder output.
Serving encodes the frames once, at ``prefill``, whose cross layers cache
the encoder output's keys and values; ``decode_step`` runs the decoder
alone over that cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import ModelConfig
from repro_torch.models import layers as L, transformer as T


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """``{"encoder", "decoder"}``, two stacks' params; the encoder's token
    embedding (``vocab`` 2, padded) is drawn but unused, as in the
    reference, so the trees match leaf for leaf."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.name}: an enc-dec config needs cfg.encoder")
    return {
        "encoder": T.init_params(gen, cfg.encoder, dtype=dtype,
                                 device=device),
        "decoder": T.init_params(gen, cfg, dtype=dtype, device=device),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           policy: L.Policy = L.Policy()) -> torch.Tensor:
    """frames: [B, n_frames, d_model] stub frontend embeddings → the
    encoder's final hidden state."""
    ecfg = cfg.encoder
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device).expand(b, s)
    h = frames.to(policy.compute_dtype)
    if ecfg.pos_embed == "sinusoidal":
        h = h + T.sinusoidal_embed(pos, ecfg.d_model).to(h.dtype)
    tokens = torch.zeros((b, s), dtype=torch.long, device=frames.device)
    out = T.forward(params["encoder"], ecfg, tokens, policy=policy,
                    inputs_embeds=h)
    return out["hidden"]


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: dict, policy: L.Policy = L.Policy(),
            bfp: L.BFPPolicy = L.NO_BFP, collect_taps: bool = False,
            tap_indices=None, tap_pool: int = 1) -> dict:
    """Encode ``frontend["frames"]``, then the decoder over ``tokens`` with
    the encoder's output as its cross layers' keys and values; the taps
    are the decoder's."""
    enc_out = encode(params, cfg, frontend["frames"], policy=policy)
    return T.forward(params["decoder"], cfg, tokens,
                     frontend={"cross_kv": enc_out}, policy=policy, bfp=bfp,
                     collect_taps=collect_taps, tap_indices=tap_indices,
                     tap_pool=tap_pool)


def lm_logits(params, cfg: ModelConfig, hidden: torch.Tensor,
              policy: L.Policy = L.Policy()) -> torch.Tensor:
    return T.lm_logits(params["decoder"], cfg, hidden, policy)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            frontend: dict, max_len: int, policy: L.Policy = L.Policy(),
            cache_dtype=torch.bfloat16, logits_mode: str = "all") -> dict:
    """Encode ``frontend["frames"]`` once, then the decoder's
    ``transformer.prefill`` over ``tokens`` with the encoder's output as
    ``cross_kv``: its cross layers cache that output's k and v, at the
    frames' length."""
    enc_out = encode(params, cfg, frontend["frames"], policy=policy)
    return T.prefill(params["decoder"], cfg, tokens,
                     frontend={"cross_kv": enc_out}, max_len=max_len,
                     policy=policy, cache_dtype=cache_dtype,
                     logits_mode=logits_mode)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device) -> dict:
    """The decoder's zero cache (``transformer.init_cache``)."""
    return T.init_cache(cfg, batch, max_len, dtype, device=device)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                *, policy: L.Policy = L.Policy()) -> tuple:
    """One decoder step (``transformer.decode_step``); the encoder is not
    run: its output lives in the cross layers' cache."""
    return T.decode_step(params["decoder"], cfg, tokens, cache,
                         policy=policy)
