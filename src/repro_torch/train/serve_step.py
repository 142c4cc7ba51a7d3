"""Serving steps: batched prefill and single-token decode (greedy or by
temperature).

Counterpart of ``repro/train/serve_step.py``.  Both steps run under
``torch.inference_mode()``; the decode step updates the cache in place
(the reference jits it with the cache donated) and returns it.  Given
DTensor params (a cell placed on a mesh, ``launch/dryrun.py``), either
step runs under ``torch.no_grad()`` instead, since a view of a DTensor
cannot be made in inference mode, and under DTensor's
``implicit_replication``, so that the tensors the model makes itself
(positions, rope's frequencies, masks), equal on every rank, join the
DTensors as replicated ones; a shard of a dim of one over a one-rank axis
is relabelled replicated first (``ctx.unit_shards_replicated``).  Sampling
draws from an explicit ``torch.Generator``, the counterpart of the
reference's ``rng`` key; it cannot replay JAX's stream.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.common import ModelConfig
from repro_torch.distributed import ctx
from repro_torch.models import layers as L


def _grad_off(params):
    """``torch.inference_mode()`` on plain params; on DTensor params,
    ``torch.no_grad()`` with ``implicit_replication``."""
    if not ctx.placed(params):
        return torch.inference_mode()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(ctx.replicate_made(params))
    return stack


def make_prefill_step(entry, cfg: ModelConfig, *, max_len: int,
                      policy: L.Policy = L.Policy(),
                      cache_dtype=torch.bfloat16, logits_mode: str = "all"):
    module = entry.module

    def prefill_step(params, tokens, frontend=None):
        if ctx.placed(params):
            params, tokens, frontend = map(ctx.unit_shards_replicated,
                                           (params, tokens, frontend))
        kw = {} if frontend is None else {"frontend": frontend}
        with _grad_off(params):
            out = module.prefill(params, cfg, tokens, max_len=max_len,
                                 policy=policy, cache_dtype=cache_dtype,
                                 logits_mode=logits_mode, **kw)
        return {"next_token_logits": out["logits"][:, -1],
                "cache": out["cache"]}

    return prefill_step


def make_decode_step(entry, cfg: ModelConfig, *,
                     policy: L.Policy = L.Policy(), greedy: bool = True,
                     temperature: float = 1.0):
    """``decode_step(params, cache, tokens, generator=None)`` → (next tokens
    [B,1] int32 on the cache's device, cache).  Greedy takes the argmax of
    the last position; otherwise one draw from softmax(logits /
    temperature) with ``generator`` (padded vocab rows have probability 0)."""
    module = entry.module

    def decode_step(params, cache, tokens, generator=None):
        if ctx.placed(params):
            params, cache, tokens = map(ctx.unit_shards_replicated,
                                        (params, cache, tokens))
        with _grad_off(params):
            logits, new_cache = module.decode_step(params, cfg, tokens, cache,
                                                   policy=policy)
            # a vocab-sharded DTensor's logits are gathered for the
            # argmax or the draw
            last = ctx.gather_dim(logits[:, -1], -1)
            if greedy:
                nxt = torch.argmax(last, dim=-1)
            else:
                nxt = torch.multinomial(torch.softmax(last / temperature, -1),
                                        1, generator=generator)[:, 0]
        return nxt[:, None].to(torch.int32), new_cache

    return decode_step
