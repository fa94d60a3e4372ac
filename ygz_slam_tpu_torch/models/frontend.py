"""Per-frame compute steps of the VO frontend (counterpart of
ygz_slam_tpu/models/frontend.py).

- detect_multilevel : gridded FAST over the pyramid + ORB
  (FeatureDetector::Detect, FeatureDetector.cpp:345-444)
- track_ref_frame   : sparse-direct alignment + motion gate
  (Matcher::SparseImageAlignment, Matcher.cpp:468-492)
- track_local_map   : project landmarks -> patch alignment at each
  landmark's search level -> pose-only BA (LocalMapping::TrackLocalMap,
  LocalMapping.cpp:24-146)
- reference_patches_for_landmarks : affine-warped reference patches from
  the keyframe images (GetWarpAffineMatrix + WarpAffine, Matcher.cpp:420-466)

`track_local_map` has the kernel route only: the cache windows of all
landmarks come from the pyramid's levels, read in place, in one launch of
K2 (the search level is the image index), then one launch of K4 and one of
K5.  The JAX package copies the levels into a zero-padded stack first,
which only its TPU kernel needs; the windows are the same.  The JAX
package's per-level fallback for other backends is not ported; off the
card the kernels' plain versions run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from ..ops import fast, orb
from ..ops import pyramid as pyr
from ..ops.align import align2d
from ..ops.interp import bilinear_multi
from ..ops.kernels.align2d_fused import A2DWindows, a2d_window_origins
from ..ops.kernels.align2d_kernel import CACHE_WIN, gather_windows_multi
from ..ops.sparse_align import sparse_image_align
from ..ops.warp import best_search_level, inv2, warp_affine_matrix
from ..solvers.ba import pose_only_ba


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (level-0 coordinates)."""
    px: torch.Tensor      # [F, 2]
    level: torch.Tensor   # [F] int32
    score: torch.Tensor   # [F]
    angle: torch.Tensor   # [F]
    desc: torch.Tensor    # [F, 8] int32
    depth: torch.Tensor   # [F] (-1 unknown)
    valid: torch.Tensor   # [F] bool


def detect_multilevel(pyramid, threshold: float, cell: int, budgets,
                      existing_px: torch.Tensor | None = None,
                      existing_mask: torch.Tensor | None = None,
                      min_dist: float = 8.0) -> Features:
    """Gridded FAST per pyramid level with per-level budgets, ORB angle and
    descriptor computed at each feature's detection level, coordinates
    returned at level-0 scale.  With `existing_px`, detections closer than
    `min_dist` to an existing (tracked) feature are suppressed
    (FeatureDetector.cpp:390-426, Detect with overwrite=false)."""
    dev = pyramid[0].device
    px, level, score, angle, desc, valid = [], [], [], [], [], []
    for lvl, budget in enumerate(budgets):
        img = pyramid[lvl]
        c = fast.detect(img, threshold, cell, budget)
        keep = c.mask
        scale = 2.0 ** lvl
        if existing_px is not None:
            d2 = torch.sum((c.xy[:, None, :] * scale - existing_px[None, :, :]) ** 2, dim=-1)
            d2 = torch.where(existing_mask[None, :], d2, torch.inf)
            keep = keep & (torch.amin(d2, dim=1) > min_dist * min_dist)
        ang, dsc = orb.compute(img, c.xy)
        px.append(c.xy * scale)
        level.append(torch.full((budget,), lvl, dtype=torch.int32, device=dev))
        score.append(c.score)
        angle.append(ang)
        desc.append(dsc)
        valid.append(keep)
    F = sum(budgets)
    return Features(px=torch.cat(px), level=torch.cat(level), score=torch.cat(score),
                    angle=torch.cat(angle), desc=torch.cat(desc),
                    depth=torch.full((F,), -1.0, dtype=pyramid[0].dtype, device=dev),
                    valid=torch.cat(valid))


def select_pose(ok: torch.Tensor, good: SE3, bad: SE3) -> SE3:
    """`good` where the 0-d bool `ok`, else `bad`, chosen on the device."""
    return SE3(torch.where(ok, good.R, bad.R), torch.where(ok, good.t, bad.t))


class TrackRefResult(NamedTuple):
    T_cw: SE3
    ok: torch.Tensor         # motion-gate pass
    chi2: torch.Tensor
    n_visible: torch.Tensor


def track_ref_frame(ref_pyr, cur_pyr, cam, ref_T_cw: SE3, feat_px, feat_depth, feat_mask,
                    T_cw_init: SE3, max_motion: float = 0.2) -> TrackRefResult:
    """Sparse-direct frame tracking with the motion sanity gate: when
    ||log T_cur_ref|| > `max_motion` (or fewer than 11 features are usable)
    the init pose is kept (Matcher.cpp:482-488).  The reference side is
    prepared here, from `ref_pyr`, on every call."""
    T_cr_init = T_cw_init.compose(ref_T_cw.inverse())
    stats = sparse_image_align(ref_pyr, cur_pyr, cam, feat_px, feat_depth,
                               feat_mask & (feat_depth > 0), T_cr_init)
    motion = torch.linalg.norm(se3m.log(stats.T_cur_ref))
    ok = (motion <= max_motion) & (stats.n_visible > 10)
    return TrackRefResult(T_cw=select_pose(ok, stats.T_cur_ref.compose(ref_T_cw), T_cw_init),
                          ok=ok, chi2=stats.chi2, n_visible=stats.n_visible)


class TrackMapResult(NamedTuple):
    T_cw: SE3
    n_inliers: torch.Tensor
    candidate: torch.Tensor   # [L] landmark was searched
    found: torch.Tensor       # [L] landmark matched + inlier
    obs_px: torch.Tensor      # [L, 2] refined observation pixel


class LocalMapSearch(NamedTuple):
    """Where `track_local_map` searches each landmark."""
    in_frustum: torch.Tensor   # [L] valid, in front, inside its level's margins, patch ok
    lscale: torch.Tensor       # [L] 2 ** search level
    centers: torch.Tensor      # [L, 2] finite projections at the search level's scale
    k2_args: tuple             # (pyramid levels, image index = search level, ox, oy, CACHE_WIN)


def local_map_search(cur_pyr, cam, T_cw: SE3, pt_pos, pt_valid, patch_ok,
                     search_lvl: torch.Tensor) -> LocalMapSearch:
    """Project the landmarks at T_cw onto their search levels, with K2's
    arguments for their cache windows: origins clamped inside each point's
    search level (its size taken as level 0's over 2^level, as the JAX
    package takes it), and the pyramid's levels as K2's table of images."""
    H, W = cur_pyr[0].shape
    pc = T_cw.apply(pt_pos)
    lscale = 2.0 ** search_lvl.to(pc.dtype)
    px_l = cam.camera_to_pixel(pc) / lscale[:, None]
    Hl, Wl = H / lscale, W / lscale
    m = 8.0
    inb_l = ((px_l[:, 0] >= m) & (px_l[:, 1] >= m)
             & (px_l[:, 0] < Wl - m) & (px_l[:, 1] < Hl - m))
    centers = torch.nan_to_num(px_l)
    ox, oy = a2d_window_origins(centers, Hl, Wl)
    return LocalMapSearch(
        in_frustum=pt_valid & (pc[:, 2] > 0.05) & inb_l & patch_ok, lscale=lscale,
        centers=centers,
        k2_args=(tuple(cur_pyr), search_lvl.contiguous(), ox, oy, CACHE_WIN))


def track_local_map(cur_pyr, cam, T_cw_init: SE3, pt_pos, pt_valid, ref_patches, patch_ok,
                    search_lvl: torch.Tensor, max_step_motion: float = 0.2) -> TrackMapResult:
    """Track against the local map: project the landmarks, refine each
    projection by inverse-compositional patch alignment at the landmark's
    search level, then pose-only BA on the survivors (FindCandidates ->
    ProjectMapPoints -> OptimizeCurrent, LocalMapping.cpp:47-146).

    ref_patches [L, 10, 10] are the warped reference patches, patch_ok [L]
    their validity, search_lvl [L] int32 the level to search on.
    A pose-BA correction beyond `max_step_motion` (twist norm) is rejected
    whole: zero inliers and the init pose, so an aliased solve reports
    failure instead of moving the camera."""
    ls = local_map_search(cur_pyr, cam, T_cw_init, pt_pos, pt_valid, patch_ok, search_lvl)
    wins = A2DWindows(gather_windows_multi(*ls.k2_args), ls.k2_args[2], ls.k2_args[3])
    res = align2d(cur_pyr[0], ref_patches, ls.centers, pregathered=wins)
    xy0 = res.xy * ls.lscale[:, None]            # back to level-0 coordinates
    matched = ls.in_frustum & res.converged
    T_opt, inlier, _ = pose_only_ba(T_cw_init, pt_pos, xy0, matched, cam)
    step = torch.linalg.norm(se3m.log(T_opt.compose(T_cw_init.inverse())))
    sane = step <= max_step_motion
    inlier = inlier & sane
    return TrackMapResult(T_cw=select_pose(sane, T_opt, T_cw_init), n_inliers=torch.sum(inlier),
                          candidate=ls.in_frustum, found=inlier, obs_px=xy0)


def reference_patches_for_landmarks(kf_images, kf_pose7, feat_px_flat, feat_level_flat,
                                    pt_ref_feat, pt_pos, pt_valid, cam, T_cw_cur: SE3,
                                    max_level: int = 0):
    """Affine-warped 10x10 reference patches for every landmark from its
    reference observation, batched over the landmarks.

    kf_images [K, H, W] level-0 keyframe images, kf_pose7 [K, 7],
    feat_px_flat [K*F, 2], feat_level_flat [K*F], pt_ref_feat [L] flat index
    into K*F (-1 invalid), pt_pos [L, 3], pt_valid [L].  With max_level > 0
    each landmark also picks the pyramid level of the current frame where
    the warped patch is closest to unit scale (GetBestSearchLevel), and the
    patch is warped into that level's geometry.  The patch pixels are one
    flat indexed bilinear read over the image stack.

    Returns (patches [L, 10, 10], ok [L], search_level [L] int32)."""
    K = kf_images.shape[0]
    F = feat_px_flat.shape[0] // K
    rf = torch.clamp(pt_ref_feat, 0, feat_px_flat.shape[0] - 1).long()
    kf_of = rf // F
    px_ref = feat_px_flat[rf]
    lvl_ref = feat_level_flat[rf]
    T_ref = SE3.from_params7(kf_pose7[kf_of])              # batched [L]
    p_ref_cam = T_ref.apply(pt_pos)
    depth_ref = torch.clamp(p_ref_cam[:, 2], min=1e-3)
    T_cur_ref = SE3(T_cw_cur.R[None], T_cw_cur.t[None]).compose(T_ref.inverse())
    A = warp_affine_matrix(cam, px_ref, depth_ref, lvl_ref, T_cur_ref)
    search_lvl = best_search_level(A, max_level)
    ok = (pt_valid & (pt_ref_feat >= 0) & (p_ref_cam[:, 2] > 1e-3)
          & torch.isfinite(A).all(dim=2).all(dim=1))
    Ainv = inv2(A + 1e-6 * torch.eye(2, dtype=A.dtype, device=A.device))
    size = 10
    d = torch.arange(size, dtype=torch.float32, device=A.device) - (size - 1) / 2.0
    offs = torch.stack(torch.meshgrid(d, d, indexing="xy"), dim=-1)      # [10, 10, 2]
    # Patch offsets live on the search level: scale to level-0 units
    # before mapping back into the reference image.
    lscale = (2.0 ** search_lvl.to(torch.float32))[:, None, None, None]
    src = torch.einsum("lab,lijb->lija", Ainv, offs[None] * lscale)
    patches = bilinear_multi(kf_images, kf_of, src + px_ref[:, None, None, :])
    return patches, ok, search_lvl


def preprocess(img: torch.Tensor, n_levels: int = 3):
    """Image -> float pyramid (Frame::InitFrame, Frame.cpp:22-40)."""
    return pyr.build_pyramid(img.to(torch.float32), n_levels)
