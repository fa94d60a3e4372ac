"""Batched closed-form quartic roots in complex64 (counterpart of
ygz_slam_tpu/solvers/quartic.py), the primitive of the P3P solver.

The general radical formula is elementwise complex arithmetic, so a whole
RANSAC batch solves at once with no eigendecomposition and no host
fallback; a few Newton steps on each root recover float32 accuracy.  The
principal branches of `torch.sqrt`, `torch.angle` and the real cube root
of the modulus are `jnp`'s, and cubes are spelled as the product
`jnp`'s `integer_pow` forms (x * (x * x)), so both packages take the same
roots.  (The JAX package also forms the depressed quartic's constant term,
which no root uses; the port leaves it out.)
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _cube(z: torch.Tensor) -> torch.Tensor:
    return z * (z * z)


def _cbrt(z: torch.Tensor) -> torch.Tensor:
    """Principal complex cube root."""
    r = torch.abs(z)
    th = torch.angle(z)
    return (r ** (1.0 / 3.0)) * torch.exp(1j * th / 3.0)


def _floor_abs(z: torch.Tensor, tiny: float) -> torch.Tensor:
    """z, with entries of modulus below `tiny` replaced by tiny + 0j."""
    return torch.where(torch.abs(z) < tiny, torch.full_like(z, tiny), z)


def quartic_roots(c4, c3, c2, c1, c0, polish: int = 3) -> torch.Tensor:
    """All four (complex) roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 for
    real float32 coefficients.

    Inputs broadcast; returns [..., 4] complex64.  Degenerate leading
    coefficients are regularised (RANSAC discards the resulting junk
    hypotheses by inlier count)."""
    c4 = torch.where(torch.abs(c4) < _EPS, _EPS, c4)
    # The monic coefficients as real quotients, which are what XLA's
    # complex division by x + 0j rounds to (torch's complex division
    # multiplies by a reciprocal instead).
    a, b, c, d = ((x / c4).to(torch.complex64) for x in (c3, c2, c1, c0))

    # Depressed quartic y^4 + p y^2 + q y + r, x = y - a/4.
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a * a * a / 8.0

    # General-formula intermediates (Wikipedia "Quartic function").
    D0 = b * b - 3.0 * a * c + 12.0 * d
    D1 = 2.0 * _cube(b) - 9.0 * a * b * c + 27.0 * a * a * d + 27.0 * c * c - 72.0 * b * d
    inner = torch.sqrt(D1 * D1 - 4.0 * _cube(D0))
    Q = _cbrt((D1 + inner) / 2.0)
    # If Q degenerates (D0 ~ 0 and D1 + inner ~ 0), take the other sign.
    Q_alt = _cbrt((D1 - inner) / 2.0)
    Q = torch.where(torch.abs(Q) < 1e-6, Q_alt, Q)
    Q = _floor_abs(Q, 1e-6)
    S2 = -2.0 * p / 3.0 + (Q + D0 / Q) / 3.0
    S = _floor_abs(0.5 * torch.sqrt(S2), 1e-6)

    base = -a / 4.0
    t1 = -4.0 * S * S - 2.0 * p
    t2 = q / S
    r12 = 0.5 * torch.sqrt(t1 + t2)
    r34 = 0.5 * torch.sqrt(t1 - t2)
    roots = torch.stack([base - S + r12, base - S - r12, base + S + r34, base + S - r34], dim=-1)

    # Newton polish in complex64.
    a_, b_, c_, d_ = (x[..., None] for x in (a, b, c, d))
    for _ in range(polish):
        f = (((roots + a_) * roots + b_) * roots + c_) * roots + d_
        df = ((4.0 * roots + 3.0 * a_) * roots + 2.0 * b_) * roots + c_
        df = _floor_abs(df, _EPS)
        roots = roots - f / df
    return roots


def real_roots_mask(roots: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """Boolean [..., 4] mask of numerically real roots (|Im| below tol
    relative to magnitude)."""
    return torch.abs(roots.imag) <= tol * (1.0 + torch.abs(roots.real))
