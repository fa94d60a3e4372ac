"""Affine patch warping between views, batched (counterpart of
`warp_affine_matrix` and `best_search_level` in ygz_slam_tpu/ops/warp.py).
The 2x2 determinant and inverse are closed forms."""
from __future__ import annotations

import math

import torch

from ..geometry.se3 import SE3

WARP_HALF = 4  # WarpHalfPatchSize (Basic/Common.h:90-91: 8x8 patches)


def warp_affine_matrix(cam, px_ref: torch.Tensor, depth_ref: torch.Tensor,
                       level_ref: torch.Tensor, T_cur_ref: SE3) -> torch.Tensor:
    """Per-point 2x2 first-order affine A_cur_ref [N, 2, 2]: how a pixel
    offset in the ref image maps to the cur image (GetWarpAffineMatrix,
    Matcher.cpp:420-436).  px_ref [N, 2] level-0 pixels; depth_ref [N];
    level_ref [N] int, the level the feature was detected on, scaling the
    probe offset."""
    scale = (2.0 ** level_ref.to(torch.float32))[:, None]
    e_u = torch.tensor([float(WARP_HALF), 0.0], device=px_ref.device)
    e_v = torch.tensor([0.0, float(WARP_HALF)], device=px_ref.device)
    pt_ref = cam.pixel_to_camera(px_ref, depth_ref)
    du = cam.pixel_to_camera(px_ref + e_u * scale, depth_ref)
    dv = cam.pixel_to_camera(px_ref + e_v * scale, depth_ref)
    px_cur = cam.camera_to_pixel(T_cur_ref.apply(pt_ref))
    px_du = cam.camera_to_pixel(T_cur_ref.apply(du))
    px_dv = cam.camera_to_pixel(T_cur_ref.apply(dv))
    return torch.stack([(px_du - px_cur) / WARP_HALF, (px_dv - px_cur) / WARP_HALF], dim=-1)


def det2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 2, 2] matrices (adjugate over determinant)."""
    d = det2(A)[..., None, None]
    adj = torch.stack([torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
                       torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1)], dim=-2)
    return adj / d


def best_search_level(A_cur_ref: torch.Tensor, max_level: int) -> torch.Tensor:
    """Pyramid level in the current frame where the warped patch is closest
    to unit scale (GetBestSearchLevel: halve until det <= 3), i.e.
    ceil(log4(D / 3)) clamped to [0, max_level]; int32 [N]."""
    D = torch.abs(det2(A_cur_ref))
    lvl = torch.ceil(torch.log(torch.clamp(D / 3.0, min=1e-9)) / math.log(4.0))
    return torch.clamp(lvl, 0, max_level).to(torch.int32)
