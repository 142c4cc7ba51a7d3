"""Losses: next-token cross-entropy with padded-vocab masking + z-loss.

Counterpart of ``repro/train/losses.py``."""
from __future__ import annotations

import torch

from repro_torch.distributed import ctx


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor | None = None,
                     z_loss: float = 0.0):
    """logits [B,S,Vp] (padded rows already masked), labels [B,S].

    Returns (loss, metrics).  ``mask`` [B,S] ∈ {0,1} excludes padding tokens.
    """
    logits = logits.float()
    # vocab-parallel where the logits are a DTensor split along the vocab
    lse, ll = ctx.logsumexp_pick(logits, labels)
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        loss = torch.mean(nll)
    else:
        mask = mask.float()
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = torch.sum(nll * mask) / denom
    acc = (ctx.argmax(logits) == labels).float()
    acc = torch.sum(acc * mask) / denom if mask is not None else \
        torch.mean(acc)
    return loss, {"loss": loss, "accuracy": acc}
