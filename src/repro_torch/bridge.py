"""Weight bridge: the JAX package's parameters and train state, given as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``),
into the port's tensors — and back to numpy for comparisons.

The port keeps the JAX package's tree layout leaf for leaf: the same dict
keys, dense weights ``(d_in, d_out)``, the backbone's repeated pattern
stacked on a leading ``n_rep`` axis under ``stack/sub<i>/...``, and the
duplex branch's ``tap_proj`` and ``blocks`` stacked on a leading
``n_blocks`` axis.  So the bridge is a leafwise conversion: floats keep
their dtype (bfloat16 and float8_e4m3fn arrays from ``ml_dtypes`` become
``torch.bfloat16`` and ``torch.float8_e4m3fn`` bit for bit), integers keep
theirs.  A whole ``init_state`` crosses over:
``step``, ``backbone``, ``branch`` (duplex mode only) and the optimizer
state (AdamW's ``step`` included once it exists).  ``device`` has no
default: the port runs on ``cuda`` unless a caller names ``cpu``, as the
tests do.  This module imports no JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_map


# the ml_dtypes floats numpy cannot hand to torch, each carried through
# f32, which holds every value of each exactly
_WIDENED = {"bfloat16": torch.bfloat16,
            "float8_e4m3fn": torch.float8_e4m3fn}


def _leaf_to_torch(x: Any, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name in _WIDENED:
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=_WIDENED[a.dtype.name])
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_torch(tree: Any, device) -> Any:
    """Nested dict of numpy arrays → nested dict of tensors on ``device``."""
    return tree_map(lambda x: _leaf_to_torch(x, device), tree)


def to_numpy(tree: Any) -> Any:
    """Nested dict of tensors → numpy (bfloat16 and float8_e4m3fn widened
    exactly to f32)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype in _WIDENED.values() else t).numpy()
    return tree_map(leaf, tree)


def state_from_jax(state: dict, device) -> dict:
    """A JAX ``train_step.init_state`` (or a later state) as the port's:
    duplex ``{step, backbone, branch, opt}`` or full ``{step, backbone,
    opt}``."""
    keys = set(state)
    if keys not in ({"step", "backbone", "branch", "opt"},
                    {"step", "backbone", "opt"}):
        raise ValueError(f"not a duplex or full train state: keys "
                         f"{sorted(keys)}")
    return to_torch(state, device)
