"""Two-view triangulation, batched (counterpart of
ygz_slam_tpu/geometry/triangulation.py)."""
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


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) triangulation from two 3x4 projection matrices
    (Initializer::Triangulate, Initializer.cpp:649-668), batched: the 4x4
    design matrix per correspondence and its null vector by SVD.  P1, P2
    [..., 3, 4] (broadcast), x1, x2 [..., 2] in the units of P (the
    initializer passes K-normalised coordinates: at pixel scale the 4x4
    system is too ill-conditioned for float32).  Returns [..., 3]; the
    null vector's free sign cancels in the division by its w."""
    rows = [
        x1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        x1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        x2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        x2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = torch.cat(torch.broadcast_tensors(*rows), dim=-2)      # [..., 4, 4]
    Xh = torch.linalg.svd(A).Vh[..., 3, :]
    w = Xh[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w_safe[..., None]


def reprojection_error(pw: torch.Tensor, T_cw: SE3, obs_px: torch.Tensor, cam) -> torch.Tensor:
    """Pixel reprojection error norm [...] for a batch of points."""
    return torch.linalg.norm(cam.world_to_pixel(pw, T_cw) - obs_px, dim=-1)
