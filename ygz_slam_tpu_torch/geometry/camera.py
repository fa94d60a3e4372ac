"""Pinhole camera with radial-tangential distortion.

Counterpart of ygz_slam_tpu/geometry/camera.py.  The parameters are
host constants (Python floats rounded to float32, so every product with a
float32 tensor sees the value the JAX package holds); the transforms
broadcast over [..., 2] / [..., 3] point tensors on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .se3 import SE3


def _f32(v) -> float:
    return float(np.float32(v))


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> "PinholeCamera":
        return PinholeCamera(*(_f32(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2)))

    @property
    def has_distortion(self) -> bool:
        """True if any distortion coefficient is nonzero; zero-distortion
        cameras skip the (identity) distortion math entirely."""
        return abs(self.k1) + abs(self.k2) + abs(self.p1) + abs(self.p2) > 0.0

    # -- normalized-plane distortion -------------------------------------
    def distort(self, xn: torch.Tensor) -> torch.Tensor:
        if not self.has_distortion:
            return xn
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def undistort(self, xd: torch.Tensor, iters: int = 5) -> torch.Tensor:
        """Fixed-point inversion of `distort` (5 iterations)."""
        if not self.has_distortion:
            return xd
        xn = xd
        for _ in range(iters):
            x, y = xn[..., 0], xn[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            xn = torch.stack([(xd[..., 0] - dx) / radial,
                              (xd[..., 1] - dy) / radial], dim=-1)
        return xn

    def undistort_px(self, px: torch.Tensor) -> torch.Tensor:
        """Raw (distorted-image) pixel -> ideal-pinhole pixel."""
        if not self.has_distortion:
            return px
        xn = torch.stack([(px[..., 0] - self.cx) / self.fx,
                          (px[..., 1] - self.cy) / self.fy], dim=-1)
        xn = self.undistort(xn)
        return torch.stack([self.fx * xn[..., 0] + self.cx,
                            self.fy * xn[..., 1] + self.cy], dim=-1)

    # -- camera <-> pixel ------------------------------------------------
    def camera_to_pixel(self, pc: torch.Tensor, distorted: bool = True) -> torch.Tensor:
        z = pc[..., 2:3]
        xn = pc[..., :2] / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        if distorted:
            xn = self.distort(xn)
        return torch.stack([self.fx * xn[..., 0] + self.cx,
                            self.fy * xn[..., 1] + self.cy], dim=-1)

    def pixel_to_camera(self, px: torch.Tensor, depth=1.0,
                        distorted: bool = True) -> torch.Tensor:
        xn = torch.stack([(px[..., 0] - self.cx) / self.fx,
                          (px[..., 1] - self.cy) / self.fy], dim=-1)
        if distorted:
            xn = self.undistort(xn)
        if isinstance(depth, (int, float)):
            # A number stays on the host: no copy to the device (inside a
            # CUDA-graph capture such a copy is refused).
            return torch.cat([xn * depth, torch.full_like(xn[..., :1], depth)], dim=-1)
        depth = torch.as_tensor(depth, dtype=xn.dtype, device=xn.device)
        return torch.cat([xn * depth[..., None],
                          depth[..., None].expand(xn[..., :1].shape)], dim=-1)

    def pixel_to_bearing(self, px: torch.Tensor, distorted: bool = True) -> torch.Tensor:
        """Pixel [..., 2] -> unit bearing vector [..., 3]."""
        pc = self.pixel_to_camera(px, 1.0, distorted)
        return pc / torch.linalg.norm(pc, dim=-1, keepdim=True)

    # -- world <-> pixel -------------------------------------------------
    def world_to_pixel(self, pw: torch.Tensor, T_cw: SE3,
                       distorted: bool = True) -> torch.Tensor:
        return self.camera_to_pixel(T_cw.apply(pw), distorted)

    def pixel_to_world(self, px: torch.Tensor, T_cw: SE3, depth=1.0,
                       distorted: bool = True) -> torch.Tensor:
        return T_cw.inverse().apply(self.pixel_to_camera(px, depth, distorted))
