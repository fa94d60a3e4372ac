"""SE(3) poses, batched over leading dims.

Counterpart of ygz_slam_tpu/geometry/se3.py: `SE3(R, t)` with
x_out = R @ x + t, tangent xi = (rho, phi), translation first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from . import so3

_EPS = 1e-8


class SE3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        device = resolve_device(device)
        R = torch.eye(3, dtype=dtype, device=device).expand(
            tuple(batch_shape) + (3, 3)).clone()
        return SE3(R, torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                                  device=device))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return torch.einsum("...ij,...j->...i", self.R, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self * other (apply `other` first)."""
        return SE3(self.R @ other.R, self.apply(other.t))

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    def matrix(self) -> torch.Tensor:
        """Homogeneous [..., 4, 4], the batch shape kept."""
        bottom = torch.zeros(self.t.shape[:-1] + (1, 4), dtype=self.t.dtype,
                             device=self.t.device)
        bottom[..., 0, 3] = 1.0
        return torch.cat([torch.cat([self.R, self.t[..., :, None]], dim=-1), bottom], dim=-2)

    def params7(self) -> torch.Tensor:
        """[..., 7]: quaternion (wxyz) + translation."""
        return torch.cat([so3.to_quaternion(self.R), self.t], dim=-1)

    @staticmethod
    def from_params7(p: torch.Tensor) -> "SE3":
        return SE3(so3.from_quaternion(p[..., :4]), p[..., 4:7])

    def normalize(self) -> "SE3":
        """The rotation projected back onto SO(3) (`so3.normalize`)."""
        return SE3(so3.normalize(self.R), self.t)


def _left_jacobian_so3(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    W = so3.hat(phi)
    return so3._eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _left_jacobian_inv_so3(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = theta * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / theta2_safe)
    W = so3.hat(phi)
    return so3._eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def exp(xi: torch.Tensor) -> SE3:
    """se(3) exponential: [..., 6] = (rho, phi) -> SE3."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    V = _left_jacobian_so3(phi)
    return SE3(so3.exp(phi), torch.einsum("...ij,...j->...i", V, rho))


def log(T: SE3) -> torch.Tensor:
    """SE3 -> tangent [..., 6] = (rho, phi)."""
    phi = so3.log(T.R)
    rho = torch.einsum("...ij,...j->...i", _left_jacobian_inv_so3(phi), T.t)
    return torch.cat([rho, phi], dim=-1)


def boxplus(T: SE3, xi: torch.Tensor) -> SE3:
    """Left-multiplicative retraction exp(xi) * T (the BA solvers' update)."""
    return exp(xi).compose(T)


def adjoint(T: SE3) -> torch.Tensor:
    """Adjoint matrix [..., 6, 6] mapping tangents across frames:
    [[R, hat(t) R], [0, R]]."""
    tR = so3.hat(T.t) @ T.R
    top = torch.cat([T.R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(T.R), T.R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def distance(Ta: SE3, Tb: SE3) -> torch.Tensor:
    """||log(Ta * Tb^-1)||: the tracking gate's pose error."""
    return torch.linalg.norm(log(Ta.compose(Tb.inverse())), dim=-1)
