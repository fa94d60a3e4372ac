"""Whole-frame sparse-direct image alignment (counterpart of
ygz_slam_tpu/ops/sparse_align.py, kernel paths only).

`prepare_reference` computes the keyframe side once (4x4 reference
patches and inverse-compositional Jacobians per level, from one 7x7 window
per point and level, every level's in one launch of K1).  `sparse_image_align` then runs, as the module
constant FUSED_VARIANT says when the call is made:
  3 (the default) every level's GN loop in one launch of K3;
  2 level by level, max -> 0, each level one launch of K9 v2 (substitutions
    against the level-init Hessian) on windows gathered by K1 at that
    level's init pose, the coarser level's result;
  1 the same with K9 v1 (the Hessian recomputed every iteration).
`gather_frames_windows` fetches several sequences' frame windows (every
level's, and optionally align2d's cache windows) in one launch of K6, for
callers that hand them to `sparse_image_align(frame_windows=)`
(`gather_frame_windows` is its one-sequence case); variants 1 and 2 ignore
them, as the JAX package does.  The batch path has a route of its own
(`parallel.batch_tracking.batched_sparse_align`: every sequence's windows in
one buffer, one K3 launch for all).  The JAX package's
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
from .kernels.align2d_kernel import (CACHE_WIN, MAX_GROUPS, bilinear_patches_levels,
                                     gather_windows_grouped, level_consts)
from .kernels.sparse_align_fused import level_align_fused, level_align_fused_v2
from .kernels.sparse_align_mega import (CWIN, MAX_ITER, MegaWindows, mega_window_origins,
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


def prepare_reference(ref_pyr, cam, px_ref, depth_ref, mask,
                      max_level: int | None = None, distorted: bool = True) -> ReferencePrep:
    """Everything sparse_image_align needs from the reference frame
    (precomputeReferencePatches, SparseImageAlign.cpp:59-122), for levels
    max_level..0: per level and point, the 4x4 patch and its central
    differences from one 6x6 bilinear patch (every level's 7x7 windows in
    one launch of K1), and the Jacobians."""
    if max_level is None:
        max_level = len(ref_pyr) - 1
    L = max_level + 1
    p_ref = cam.pixel_to_camera(px_ref, depth_ref, distorted=distorted)
    visible0 = mask & (depth_ref > 1e-3)
    scales, _ = level_consts([img.shape for img in ref_pyr[:L]], px_ref.device)   # [L, 1]
    p6 = bilinear_patches_levels(ref_pyr[:L], px_ref * scales[:, :, None], PATCH + 2)
    ref_patch = p6[:, :, 1:5, 1:5].reshape(L, -1, PATCH_AREA)
    dx = (0.5 * (p6[:, :, 1:5, 2:6] - p6[:, :, 1:5, 0:4])).reshape(L, -1, PATCH_AREA)
    dy = (0.5 * (p6[:, :, 2:6, 1:5] - p6[:, :, 0:4, 1:5])).reshape(L, -1, PATCH_AREA)
    levels = []
    for lv in range(L):
        scale = 1.0 / (2.0 ** lv)
        Hh, Ww = ref_pyr[lv].shape
        vis = visible0 & in_bounds(px_ref * scale, Hh, Ww, margin=PATCH_HALF + 2)
        J_proj = jac.duv_dxi(p_ref, cam.fx * scale, cam.fy * scale)    # [N, 2, 6]
        J = (dx[lv][..., None] * J_proj[:, None, 0, :]
             + dy[lv][..., None] * J_proj[:, None, 1, :])
        levels.append(LevelRef(vis=vis, ref_patch=ref_patch[lv], J=J.contiguous()))
    return ReferencePrep(p_ref=p_ref.contiguous(), levels=tuple(levels),
                         mega_refp=ref_patch.contiguous(),
                         mega_jl=torch.stack([lr.J for lr in levels]))


class FrameWindows(NamedTuple):
    """One frame's window fetches, done by K6 at the frame-init pose
    (`gather_frame_windows`, `gather_frames_windows`)."""
    mega_wins: MegaWindows     # every level's windows, their origins, the init projection
    a2d: A2DWindows | None     # align2d's cache windows, if requested


def gather_frames_windows(cur_pyrs, cam, ref_preps, T_inits, distorted: bool = True,
                          a2d_centers=None) -> list:
    """The window fetches of several sequences' frames: for sequence s,
    every level of `cur_pyrs[s]`'s sparse-align windows at the frame-init
    pose `T_inits[s]` (SE3) with `ref_preps[s]` and, given
    `a2d_centers[s] [M, 2]` (predicted patch centers on level 0), align2d's
    32x32 cache windows around them.  Every sequence's origins first, then
    all the requests in one launch of K6; a list of more than MAX_GROUPS
    requests goes in launches of MAX_GROUPS, in order (one launch up to 21
    sequences of three levels).  Returns a FrameWindows per sequence."""
    reqs, spans = [], []
    for s, (cur_pyr, prep, T_init) in enumerate(zip(cur_pyrs, ref_preps, T_inits)):
        n_levels = len(cur_pyr)
        pc0, px0_l0, ox_l, oy_l = mega_window_origins(cur_pyr, prep.p_ref, T_init.R, T_init.t,
                                                      cam, distorted, n_levels)
        first = len(reqs)
        reqs += [(cur_pyr[li], ox_l[li], oy_l[li], CWIN) for li in range(n_levels)]
        a2d = None
        if a2d_centers is not None:
            img0 = cur_pyr[0]
            a2d = a2d_window_origins(torch.nan_to_num(a2d_centers[s].to(img0.dtype)),
                                     *img0.shape)
            reqs.append((img0, *a2d, CACHE_WIN))
        spans.append((first, MegaWindows(None, ox_l, oy_l, pc0, px0_l0), a2d))
    outs = []
    for k in range(0, len(reqs), MAX_GROUPS):
        outs += gather_windows_grouped(reqs[k:k + MAX_GROUPS])
    fws = []
    for first, mw, a2d in spans:
        n_levels = mw.ox.shape[0]
        fws.append(FrameWindows(
            mega_wins=mw._replace(wins=torch.stack(outs[first:first + n_levels])),
            a2d=None if a2d is None else A2DWindows(outs[first + n_levels], *a2d)))
    return fws


def gather_frame_windows(cur_pyr, cam, ref_prep: ReferencePrep, T_init: SE3,
                         distorted: bool = True,
                         a2d_centers: torch.Tensor | None = None) -> FrameWindows:
    """Every level's sparse-align windows at the frame-init pose and,
    given `a2d_centers [M, 2]` (predicted patch centers on level 0),
    align2d's 32x32 cache windows around them, in one launch of K6:
    `gather_frames_windows` on one sequence."""
    return gather_frames_windows([cur_pyr], cam, [ref_prep], [T_init], distorted,
                                 None if a2d_centers is None else [a2d_centers])[0]


def sparse_image_align(ref_pyr, cur_pyr, cam, px_ref, depth_ref, mask, T_init: SE3,
                       max_level: int | None = None,
                       distorted: bool = True,
                       ref_prep: ReferencePrep | None = None,
                       frame_windows: FrameWindows | None = None,
                       n_iter: int = MAX_ITER) -> AlignStats:
    """Coarse-to-fine sparse-direct alignment of the current frame to the
    reference frame: levels max_level..0, at most min(n_iter, MAX_ITER)
    GN iterations each (MAX_ITER = 12, the JAX package's cap), by the route
    FUSED_VARIANT names (module docstring).  Under variant 3 the level
    windows are gathered by K1, or taken from `frame_windows` (gathered by
    K6 at the same T_init), and n_iter reaches K3; variants 1 and 2 run
    MAX_ITER and raise for fewer.  Returns AlignStats with the refined
    relative pose T_cur_ref, and chi2 and H of the finest level."""
    n_iter = min(n_iter, MAX_ITER)
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
            pregathered=None if frame_windows is None else frame_windows.mega_wins,
            n_iter=n_iter)
        return AlignStats(T_cur_ref=SE3(R, t), chi2=chi2, n_visible=n_visible, H=H)
    if variant not in (1, 2):
        raise ValueError(f"FUSED_VARIANT must be 1, 2 or 3, not {variant!r}")
    if n_iter != MAX_ITER:
        raise ValueError(f"FUSED_VARIANT {variant} runs {MAX_ITER} iterations per level, not "
                         f"{n_iter}")
    level_align = level_align_fused_v2 if variant == 2 else level_align_fused
    T = T_init
    for level in range(max_level, -1, -1):
        R, t, chi2, H = level_align(cur_pyr[level], ref_prep.levels[level], ref_prep.p_ref,
                                    T.R, T.t, cam, level, distorted=distorted)
        T = SE3(R, t)
    return AlignStats(T_cur_ref=T, chi2=chi2, n_visible=n_visible, H=H)
