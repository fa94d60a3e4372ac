"""Whole-frame sparse-direct image alignment (counterpart of
ygz_slam_tpu/ops/sparse_align.py, kernel paths only).

`prepare_reference` computes the keyframe side once (4x4 reference
patches and inverse-compositional Jacobians per level, through K1's
`bilinear_patches`).  `sparse_image_align` then runs, as the module
constant FUSED_VARIANT says when the call is made:
  3 (the default) every level's GN loop in one launch of K3;
  2 level by level, max -> 0, each level one launch of K9 v2 (substitutions
    against the level-init Hessian) on windows gathered by K1 at that
    level's init pose, the coarser level's result;
  1 the same with K9 v1 (the Hessian recomputed every iteration).
`gather_frame_windows` fetches a frame's level windows (and optionally
align2d's cache windows) in one launch of K6, for callers that hand them
to `sparse_image_align(frame_windows=)`, as the batch path does; variants 1
and 2 ignore them, as the JAX package does.  The JAX package's
`gauss_newton` fallback (`USE_FUSED_LEVEL`) is not ported: off the card
the port runs the kernels' plain versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import jacobians as jac
from ..geometry.se3 import SE3
from .interp import in_bounds
from .kernels.align2d_fused import A2DWindows, a2d_window_origins
from .kernels.align2d_kernel import CACHE_WIN, bilinear_patches, gather_windows_grouped
from .kernels.sparse_align_fused import level_align_fused, level_align_fused_v2
from .kernels.sparse_align_mega import (MegaWindows, mega_window_requests, mega_windows,
                                        sparse_align_mega)

PATCH_HALF = 2
PATCH = 2 * PATCH_HALF          # 4x4 patches (SparseImageAlign.h)
PATCH_AREA = PATCH * PATCH
# Which kernel route sparse_image_align takes (see above); read at each call.
FUSED_VARIANT = 3


class AlignStats(NamedTuple):
    T_cur_ref: SE3
    chi2: torch.Tensor       # final mean squared residual (finest level)
    n_visible: torch.Tensor  # features usable on the finest level
    H: torch.Tensor          # 6x6 Fisher-style information (finest level)


class LevelRef(NamedTuple):
    """Per-level reference data, constant per keyframe."""
    vis: torch.Tensor        # [N] bool: feature usable at this level
    ref_patch: torch.Tensor  # [N, 16] reference patch, (r, c) at 4r + c
    J: torch.Tensor          # [N, 16, 6] inverse-compositional Jacobians


class ReferencePrep(NamedTuple):
    """Reference side of sparse_image_align, constant per keyframe."""
    p_ref: torch.Tensor      # [N, 3] reference-camera points
    levels: tuple            # LevelRef per level, indexed [level]
    mega_refp: torch.Tensor  # [L, N, 16]: ref_patch of every level, stacked
    mega_jl: torch.Tensor    # [L, N, 16, 6]: J of every level, stacked


def _prep_level(ref_img, cam, px_ref, p_ref, visible0, level) -> LevelRef:
    """Reference patches + Jacobians for one pyramid level: one 6x6
    bilinear window per point gives the 4x4 patch and its central
    differences."""
    scale = 1.0 / (2.0 ** level)
    Hh, Ww = ref_img.shape
    u_ref = px_ref * scale
    vis = visible0 & in_bounds(u_ref, Hh, Ww, margin=PATCH_HALF + 2)
    p6 = bilinear_patches(ref_img, u_ref, PATCH + 2)
    ref_patch = p6[:, 1:5, 1:5].reshape(-1, PATCH_AREA)
    dx = (0.5 * (p6[:, 1:5, 2:6] - p6[:, 1:5, 0:4])).reshape(-1, PATCH_AREA)
    dy = (0.5 * (p6[:, 2:6, 1:5] - p6[:, 0:4, 1:5])).reshape(-1, PATCH_AREA)
    J_proj = jac.duv_dxi(p_ref, cam.fx * scale, cam.fy * scale)        # [N, 2, 6]
    J = dx[..., None] * J_proj[:, None, 0, :] + dy[..., None] * J_proj[:, None, 1, :]
    return LevelRef(vis=vis, ref_patch=ref_patch.contiguous(), J=J.contiguous())


def prepare_reference(ref_pyr, cam, px_ref, depth_ref, mask,
                      max_level: int | None = None, distorted: bool = True) -> ReferencePrep:
    """Everything sparse_image_align needs from the reference frame
    (precomputeReferencePatches, SparseImageAlign.cpp:59-122), for levels
    max_level..0."""
    if max_level is None:
        max_level = len(ref_pyr) - 1
    p_ref = cam.pixel_to_camera(px_ref, depth_ref, distorted=distorted)
    visible0 = mask & (depth_ref > 1e-3)
    levels = tuple(_prep_level(ref_pyr[lv], cam, px_ref, p_ref, visible0, lv)
                   for lv in range(max_level + 1))
    return ReferencePrep(
        p_ref=p_ref.contiguous(), levels=levels,
        mega_refp=torch.stack([lr.ref_patch for lr in levels]).contiguous(),
        mega_jl=torch.stack([lr.J for lr in levels]).contiguous())


class FrameWindows(NamedTuple):
    """One frame's window fetches, done by one launch of K6 at the
    frame-init pose (`gather_frame_windows`)."""
    mega_wins: MegaWindows     # every level's windows, their origins, the init projection
    a2d: A2DWindows | None     # align2d's cache windows, if requested


def gather_frame_windows(cur_pyr, cam, ref_prep: ReferencePrep, T_init: SE3,
                         distorted: bool = True,
                         a2d_centers: torch.Tensor | None = None) -> FrameWindows:
    """Every level's sparse-align windows at the frame-init pose and,
    given `a2d_centers [M, 2]` (predicted patch centers on level 0),
    align2d's 32x32 cache windows around them, in one launch of K6."""
    n_levels = len(cur_pyr)
    pc0, px0_l0, reqs = mega_window_requests(cur_pyr, ref_prep.p_ref, T_init.R, T_init.t, cam,
                                             distorted, n_levels)
    if a2d_centers is not None:
        img0 = cur_pyr[0]
        ox, oy = a2d_window_origins(torch.nan_to_num(a2d_centers.to(img0.dtype)), *img0.shape)
        reqs.append((img0, ox, oy, CACHE_WIN))
    outs = gather_windows_grouped(reqs)
    a2d = None if a2d_centers is None else A2DWindows(wins=outs[n_levels], ox=ox, oy=oy)
    return FrameWindows(mega_wins=mega_windows(pc0, px0_l0, reqs[:n_levels], outs[:n_levels]),
                        a2d=a2d)


def sparse_image_align(ref_pyr, cur_pyr, cam, px_ref, depth_ref, mask, T_init: SE3,
                       max_level: int | None = None,
                       distorted: bool = True,
                       ref_prep: ReferencePrep | None = None,
                       frame_windows: FrameWindows | None = None) -> AlignStats:
    """Coarse-to-fine sparse-direct alignment of the current frame to the
    reference frame: levels max_level..0, at most MAX_ITER (12) GN
    iterations each, by the route FUSED_VARIANT names (module docstring).
    Under variant 3 the level windows are gathered by K1, or taken from
    `frame_windows` (gathered by K6 at the same T_init).  Returns
    AlignStats with the refined relative pose T_cur_ref, and chi2 and H of
    the finest level."""
    if max_level is None:
        max_level = len(ref_pyr) - 1
    if ref_prep is None:
        ref_prep = prepare_reference(ref_pyr, cam, px_ref, depth_ref, mask,
                                     max_level=max_level, distorted=distorted)
    n_visible = torch.sum(ref_prep.levels[0].vis)
    variant = FUSED_VARIANT
    if variant == 3:
        R, t, chi2, H = sparse_align_mega(
            cur_pyr, ref_prep.levels, ref_prep.p_ref, T_init.R, T_init.t, cam,
            distorted=distorted, max_level=max_level,
            mega_refp=ref_prep.mega_refp[:max_level + 1],
            mega_jl=ref_prep.mega_jl[:max_level + 1],
            pregathered=None if frame_windows is None else frame_windows.mega_wins)
        return AlignStats(T_cur_ref=SE3(R, t), chi2=chi2, n_visible=n_visible, H=H)
    if variant not in (1, 2):
        raise ValueError(f"FUSED_VARIANT must be 1, 2 or 3, not {variant!r}")
    level_align = level_align_fused_v2 if variant == 2 else level_align_fused
    T = T_init
    for level in range(max_level, -1, -1):
        R, t, chi2, H = level_align(cur_pyr[level], ref_prep.levels[level], ref_prep.p_ref,
                                    T.R, T.t, cam, level, distorted=distorted)
        T = SE3(R, t)
    return AlignStats(T_cur_ref=T, chi2=chi2, n_visible=n_visible, H=H)
