"""Robust-cost constants, the Huber weight and the MAD scale (counterpart of
ygz_slam_tpu/solvers/robust.py)."""
from __future__ import annotations

import torch

# 95% asymptotic efficiency constants (RobustCost.h).
TUKEY_B = 4.6851
HUBER_K = 1.345
MAD_SCALE = 1.4826
# Chi2 inlier threshold at 95% for 2 DoF.
CHI2_2D = 5.991


def huber_weight(r: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    """w = 1 for |r| <= k, k/|r| beyond."""
    a = torch.abs(r)
    return torch.where(a <= k, torch.ones_like(a), k / torch.clamp(a, min=1e-12))


def mad_scale(r: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """sigma = 1.4826 * median(|r - median(r)|), over `mask`ed entries
    (sort-based masked median, as the JAX package computes it)."""
    if mask is None:
        mask = torch.ones_like(r, dtype=torch.bool)
    n_valid = torch.clamp(mask.sum(), min=1)
    n = r.shape[0]

    def masked_median(x):
        s = torch.sort(torch.where(mask, x, torch.inf)).values
        lo = torch.clamp((n_valid - 1) // 2, 0, n - 1)
        hi = torch.clamp(n_valid // 2, 0, n - 1)
        return 0.5 * (s[lo] + s[hi])

    med = masked_median(r)
    return MAD_SCALE * masked_median(torch.abs(r - med))
