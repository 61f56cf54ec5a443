"""Plain PyTorch version of the per-row cache scatter.

The same function as the JAX package's ``cache_update_ref`` (one
``dynamic_update_slice`` per batch row), written as one indexed
assignment that updates ``cache`` in place.  Out-of-range slots clamp to
the nearest row, as ``dynamic_update_slice`` clamps its start.
"""
from __future__ import annotations

import torch


def cache_update_ref(cache: torch.Tensor, new: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """cache: (B, C, *rest)  new: (B, 1, *rest)  slots: (B,) int.
    Writes ``new[b, 0]`` at ``cache[b, slots[b]]``; returns ``cache``."""
    b, c = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    cache[rows, slots.long().clamp(0, c - 1)] = new[:, 0].to(cache.dtype)
    return cache
