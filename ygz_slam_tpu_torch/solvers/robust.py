"""Robust cost weights and scale estimators, batched (counterpart of
ygz_slam_tpu/solvers/robust.py; the reference's robust_cost namespace,
RobustCost.h:11-136): the Unit, Tukey, t-distribution and Huber weights,
the Huber loss, and the t-distribution, MAD and Normal scale estimators.
Each weight maps residual magnitudes [...] to IRLS weights [...]; the
constants are the reference's 95% efficiency tunings."""
from __future__ import annotations

import torch

# 95% asymptotic efficiency constants (RobustCost.h).
TUKEY_B = 4.6851
HUBER_K = 1.345
TDIST_DOF = 5.0
MAD_SCALE = 1.4826
# Chi2 inlier threshold at 95% for 2 DoF.
CHI2_2D = 5.991


def huber_weight(r: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    """w = 1 for |r| <= k, k/|r| beyond."""
    a = torch.abs(r)
    return torch.where(a <= k, torch.ones_like(a), k / torch.clamp(a, min=1e-12))


def tukey_weight(r: torch.Tensor, b: float = TUKEY_B) -> torch.Tensor:
    """Tukey biweight: (1 - (r/b)^2)^2 inside |r| < b, 0 outside."""
    x = r / b
    w = 1.0 - x * x
    return torch.where(torch.abs(x) < 1.0, w * w, torch.zeros_like(w))


def tdist_weight(r: torch.Tensor, dof: float = TDIST_DOF) -> torch.Tensor:
    """Student-t weight: (dof + 1) / (dof + r^2)."""
    return (dof + 1.0) / (dof + r * r)


def unit_weight(r: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(r)


def huber_loss(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber rho of *squared* residuals (the Ceres convention of the
    reference's BA, delta^2 = 5.991)."""
    d2 = delta * delta
    return torch.where(r2 <= d2, r2, 2.0 * delta * torch.sqrt(torch.clamp(r2, min=0.0)) - d2)


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


def tdist_scale(r: torch.Tensor, mask: torch.Tensor | None = None, dof: float = TDIST_DOF,
                iters: int = 5, init_sigma: float = 1.0) -> torch.Tensor:
    """t-distribution scale by `iters` fixed-point steps from init_sigma
    (TDistributionScaleEstimator), over `mask`ed entries."""
    if mask is None:
        mask = torch.ones_like(r, dtype=torch.bool)
    n = torch.clamp(mask.sum(), min=1).to(r.dtype)
    sigma2 = torch.tensor(init_sigma * init_sigma, dtype=r.dtype, device=r.device)
    r2 = r * r
    for _ in range(iters):
        w = (dof + 1.0) / (dof + r2 / torch.clamp(sigma2, min=1e-12))
        sigma2 = torch.sum(torch.where(mask, w * r2, 0.0)) / n
    return torch.sqrt(torch.clamp(sigma2, min=1e-12))


def normal_scale(r: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian scale: the RMS of the `mask`ed residuals
    (NormalDistributionScaleEstimator)."""
    if mask is None:
        mask = torch.ones_like(r, dtype=torch.bool)
    n = torch.clamp(mask.sum(), min=1).to(r.dtype)
    return torch.sqrt(torch.sum(torch.where(mask, r * r, 0.0)) / n)
