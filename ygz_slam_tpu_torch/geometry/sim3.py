"""Sim(3) similarity transforms, batched over leading dims.

Counterpart of ygz_slam_tpu/geometry/sim3.py: `Sim3(R, t, s)` with
x_out = s R x + t, tangent xi = (rho, phi, sigma), exp and log through the
closed-form W matrix (Strasdat's thesis, Sophus sim3.hpp).  Monocular loop
closure needs it: a Sim(3) pose graph absorbs the scale drift an SE(3)
graph cannot.  `torch.where` evaluates both sides, so every branch of `_W`
divides by a safe denominator, as the JAX double-`where` guards do.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from . import so3

_EPS = 1e-8


class Sim3(NamedTuple):
    """Similarity transform: x_out = s * R @ x + t."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    s: torch.Tensor  # [...]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Sim3":
        device = resolve_device(device)
        shape = tuple(batch_shape)
        R = torch.eye(3, dtype=dtype, device=device).expand(shape + (3, 3)).clone()
        return Sim3(R, torch.zeros(shape + (3,), dtype=dtype, device=device),
                    torch.ones(shape, dtype=dtype, device=device))

    @staticmethod
    def from_se3(T, s=None) -> "Sim3":
        """An SE3 (optionally with a scale) lifted into Sim3."""
        scale = (torch.ones(T.t.shape[:-1], dtype=T.t.dtype, device=T.t.device) if s is None
                 else torch.as_tensor(s, dtype=T.t.dtype, device=T.t.device))
        return Sim3(T.R, T.t, scale)

    def to_se3(self):
        """The metric camera pose of a corrected S_cw: the scale absorbed
        into the translation, [sR | t] ~ s [R | t / s]."""
        from .se3 import SE3

        return SE3(self.R, self.t / self.s[..., None])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * torch.einsum("...ij,...j->...i", self.R, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        """self * other (apply `other` first)."""
        return Sim3(self.R @ other.R, self.apply(other.t), self.s * other.s)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, self.t), s_inv)

    def params8(self) -> torch.Tensor:
        """[..., 8]: quaternion (wxyz), translation, scale."""
        return torch.cat([so3.to_quaternion(self.R), self.t, self.s[..., None]], dim=-1)

    @staticmethod
    def from_params8(p: torch.Tensor) -> "Sim3":
        return Sim3(so3.from_quaternion(p[..., :4]), p[..., 4:7], p[..., 7])


def _W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) V matrix (t = W rho in exp): W = C I + A hat(phi) +
    B hat(phi)^2, its coefficients branching on theta -> 0 and sigma -> 0;
    every branch is evaluated on safe denominators and the results picked
    by `torch.where`."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small_t = theta2 < _EPS
    theta2_safe = torch.where(small_t, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    small_s = torch.abs(sigma) < 1e-5
    sigma_safe = torch.where(small_s, torch.ones_like(sigma), sigma)
    s = torch.exp(sigma)
    # sigma ~ 0
    C0 = torch.ones_like(sigma)
    A0 = torch.where(small_t, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    B0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (theta2_safe * theta))
    # general sigma
    C1 = (s - 1.0) / sigma_safe
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    c_ = theta2_safe + sigma * sigma
    A1_small_t = ((sigma - 1.0) * s + 1.0) / (sigma_safe * sigma_safe)
    B1_small_t = ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / (sigma_safe ** 3)
    A1_big = (a_ * sigma + (1.0 - b_) * theta) / (theta * c_)
    B1_big = (C1 - ((b_ - 1.0) * sigma + a_ * theta) / c_) / theta2_safe
    A1 = torch.where(small_t, A1_small_t, A1_big)
    B1 = torch.where(small_t, B1_small_t, B1_big)
    A = torch.where(small_s, A0, A1)
    B = torch.where(small_s, B0, B1)
    C = torch.where(small_s, C0, C1)
    Phi = so3.hat(phi)
    return (C[..., None, None] * so3._eye_like(Phi) + A[..., None, None] * Phi
            + B[..., None, None] * (Phi @ Phi))


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate over the determinant,
    floored at 1e-20 in magnitude as the JAX `_inv3` does)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([torch.stack([A, B, C], dim=-1), torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return adj * inv_det[..., None, None]


def exp(xi: torch.Tensor) -> Sim3:
    """sim(3) exponential: [..., 7] = (rho, phi, sigma) -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _W(phi, sigma), rho)
    return Sim3(so3.exp(phi), t, torch.exp(sigma))


def log(S: Sim3) -> torch.Tensor:
    """Sim3 -> tangent [..., 7] = (rho, phi, sigma)."""
    sigma = torch.log(S.s)
    phi = so3.log(S.R)
    rho = torch.einsum("...ij,...j->...i", _inv3(_W(phi, sigma)), S.t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def boxplus(S: Sim3, xi: torch.Tensor) -> Sim3:
    """Left-multiplicative retraction exp(xi) * S (the solver's update)."""
    return exp(xi).compose(S)


def adjoint(S: Sim3) -> torch.Tensor:
    """Adjoint [..., 7, 7], Ad(S) xi = log(S exp(xi) S^-1) to first order:
    [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    sR = S.s[..., None, None] * S.R
    tR = so3.hat(S.t) @ S.R
    batch = S.t.shape[:-1]
    z33 = torch.zeros_like(S.R)
    z31 = torch.zeros(batch + (3, 1), dtype=S.t.dtype, device=S.t.device)
    z13 = torch.zeros(batch + (1, 3), dtype=S.t.dtype, device=S.t.device)
    one = torch.ones(batch + (1, 1), dtype=S.t.dtype, device=S.t.device)
    top = torch.cat([sR, tR, -S.t[..., :, None]], dim=-1)
    mid = torch.cat([z33, S.R, z31], dim=-1)
    bot = torch.cat([z13, z13, one], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def distance(Sa: Sim3, Sb: Sim3) -> torch.Tensor:
    """||log(Sa * Sb^-1)||."""
    return torch.linalg.norm(log(Sa.compose(Sb.inverse())), dim=-1)
