"""Analytic projection Jacobians (counterpart of
ygz_slam_tpu/geometry/jacobians.py), tangent order (rho, phi)."""
from __future__ import annotations

import torch

from .so3 import hat


def duv_dxyz(pc: torch.Tensor, fx, fy) -> torch.Tensor:
    """d(pixel)/d(camera point): [..., 2, 3] (no distortion)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zinv = 1.0 / torch.clamp(z, min=1e-9)
    zinv2 = zinv * zinv
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * zinv, zero, -fx * x * zinv2], dim=-1)
    row_v = torch.stack([zero, fy * zinv, -fy * y * zinv2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def dxyz_dxi(pc: torch.Tensor) -> torch.Tensor:
    """d(camera point)/d(left se3 tangent): [..., 3, 6] = [I | -hat(p)]."""
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    return torch.cat([eye, -hat(pc)], dim=-1)


def duv_dxi(pc: torch.Tensor, fx, fy) -> torch.Tensor:
    """d(pixel)/d(pose tangent): [..., 2, 6]."""
    return duv_dxyz(pc, fx, fy) @ dxyz_dxi(pc)


def dnorm_dxi(pc: torch.Tensor) -> torch.Tensor:
    """d(normalized x/z, y/z)/d(pose tangent): [..., 2, 6], `duv_dxi` at
    fx = fy = 1 (JacobXYZ2Cam, CVUtils.h:77-100)."""
    return duv_dxi(pc, 1.0, 1.0)


def duv_dpoint(pc: torch.Tensor, R_cw: torch.Tensor, fx, fy) -> torch.Tensor:
    """d(pixel)/d(world point): [..., 2, 3] = duv_dxyz @ R_cw."""
    return duv_dxyz(pc, fx, fy) @ R_cw
