"""Losses: next-token cross-entropy with padded-vocab masking + z-loss.

Counterpart of ``repro/train/losses.py``."""
from __future__ import annotations

import torch


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor | None = None,
                     z_loss: float = 0.0):
    """logits [B,S,Vp] (padded rows already masked), labels [B,S].

    Returns (loss, metrics).  ``mask`` [B,S] ∈ {0,1} excludes padding tokens.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        loss = torch.mean(nll)
    else:
        mask = mask.float()
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = torch.sum(nll * mask) / denom
    acc = (torch.argmax(logits, -1) == labels).float()
    acc = torch.sum(acc * mask) / denom if mask is not None else \
        torch.mean(acc)
    return loss, {"loss": loss, "accuracy": acc}
