"""Two-view triangulation, batched (counterpart of
ygz_slam_tpu/geometry/triangulation.py; `triangulate_dlt` comes with the
initializer)."""
from __future__ import annotations

import torch

from .se3 import SE3


def depth_from_triangulation(T_cur_ref: SE3, f_ref: torch.Tensor, f_cur: torch.Tensor):
    """Depth of a point along the reference bearing ray: solves
    [f_cur, -R f_ref] [d_cur, d_ref]^T = t in least squares
    (DepthFromTriangulation, CVUtils.h:24-38).  f_ref, f_cur [..., 3] need
    not be unit norm.  Returns (depth_ref [...], ok [...]: False where the
    2x2 normal matrix is near-singular, i.e. parallel rays)."""
    Rf = torch.einsum("...ij,...j->...i", T_cur_ref.R, f_ref)
    a00 = torch.sum(f_cur * f_cur, dim=-1)
    a01 = -torch.sum(f_cur * Rf, dim=-1)
    a11 = torch.sum(Rf * Rf, dim=-1)
    b0 = torch.sum(f_cur * T_cur_ref.t, dim=-1)
    b1 = -torch.sum(Rf * T_cur_ref.t, dim=-1)
    det = a00 * a11 - a01 * a01
    ok = torch.abs(det) > 1e-9
    det_safe = torch.where(ok, det, 1.0)
    return (a00 * b1 - a01 * b0) / det_safe, ok


def reprojection_error(pw: torch.Tensor, T_cw: SE3, obs_px: torch.Tensor, cam) -> torch.Tensor:
    """Pixel reprojection error norm [...] for a batch of points."""
    return torch.linalg.norm(cam.world_to_pixel(pw, T_cw) - obs_px, dim=-1)
