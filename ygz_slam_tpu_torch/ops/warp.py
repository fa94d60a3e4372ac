"""Affine patch warping between views, batched (counterpart of
ygz_slam_tpu/ops/warp.py; the reference's Matcher::GetWarpAffineMatrix,
WarpAffine and GetBestSearchLevel, Matcher.cpp:420-466, Matcher.h:123-134).
The 2x2 determinant and inverse are closed forms."""
from __future__ import annotations

import functools
import math

import torch

from ..geometry.se3 import SE3
from .interp import bilinear

WARP_HALF = 4  # WarpHalfPatchSize (Basic/Common.h:90-91: 8x8 patches)


@functools.lru_cache(maxsize=8)
def _probes(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe offsets (WARP_HALF, 0) and (0, WARP_HALF) on `device`, made
    once (no host-to-device copy per call: a CUDA-graph capture of the
    tracking step permits none)."""
    return (torch.tensor([float(WARP_HALF), 0.0], device=device),
            torch.tensor([0.0, float(WARP_HALF)], device=device))


def warp_affine_matrix(cam, px_ref: torch.Tensor, depth_ref: torch.Tensor,
                       level_ref: torch.Tensor, T_cur_ref: SE3) -> torch.Tensor:
    """Per-point 2x2 first-order affine A_cur_ref [N, 2, 2]: how a pixel
    offset in the ref image maps to the cur image (GetWarpAffineMatrix,
    Matcher.cpp:420-436).  px_ref [N, 2] level-0 pixels; depth_ref [N];
    level_ref [N] int, the level the feature was detected on, scaling the
    probe offset."""
    scale = (2.0 ** level_ref.to(torch.float32))[:, None]
    e_u, e_v = _probes(str(px_ref.device))
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


def warp_patches(img_ref: torch.Tensor, px_ref: torch.Tensor, level_ref: torch.Tensor,
                 A_cur_ref: torch.Tensor, search_level: torch.Tensor,
                 half_patch: int = WARP_HALF + 1) -> torch.Tensor:
    """Reference patches warped into the current frame's geometry
    (WarpAffine, the inverse map): output pixel (x, y) reads `img_ref` at
    (A_cur_ref + 1e-6 I)^-1 (x, y) 2^search_level + px_ref / 2^level_ref,
    bilinearly.  img_ref [H, W] is the image of level `level_ref`, px_ref
    [N, 2] level-0 pixels, level_ref and search_level [N] int, A_cur_ref
    [N, 2, 2].  Returns [N, 2 half_patch, 2 half_patch] (by default 10x10:
    an 8x8 patch and the 1-pixel border align2d's gradients read)."""
    size = 2 * half_patch
    Ainv = inv2(A_cur_ref + 1e-6 * torch.eye(2, dtype=A_cur_ref.dtype, device=A_cur_ref.device))
    d = torch.arange(size, dtype=torch.float32, device=px_ref.device) - (size - 1) / 2.0
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    offs = torch.stack([gx, gy], dim=-1)                                   # [s, s, 2]
    offs = offs[None] * (2.0 ** search_level.to(torch.float32))[:, None, None, None]
    src = torch.einsum("nab,nijb->nija", Ainv, offs)
    center = (px_ref / (2.0 ** level_ref.to(torch.float32))[:, None])[:, None, None, :]
    return bilinear(img_ref, src + center)
