"""Selections whose tie order the rest of the package relies on.

`jax.lax.top_k` returns the lowest index first among equal values, and the
JAX package leans on that: several of its selections are all ties (the
first NS tracked landmarks, equal bin counts, equal qualities).
`torch.topk` promises no order among ties, so every top-k here goes through
a stable descending sort."""
from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values [k], indices [k]) of the k largest entries of `x [n]`,
    largest first, equal values in ascending index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]
