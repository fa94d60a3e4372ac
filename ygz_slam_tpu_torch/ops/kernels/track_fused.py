"""K11: one whole tracking step (sparse-direct alignment over every level,
align2d of the map points, four-round pose-only BA) in one kernel.

Counterpart of ygz_slam_tpu/ops/pallas/track_fused.py.  The CUDA kernel
(csrc/track_fused.cu) replaces `_kernel`; `track_gn` is its wrapper and
`track_gn_plain` its plain version, whose three stages are the plain
versions of K3 (`mega_gn_plain`), of K4 without its step clamp
(`a2d_gn_plain(clamp_step=False)`) and of K5 (`pose_ba_gn_plain`).
`track_step_fused` fetches the windows (K1: three sparse levels and the
align2d cache, all at the frame-init pose) and makes the one K11 launch.
The kernel runs as one cluster of CTAs; `track_partition` says how the
map points are spread over it.
"""
from __future__ import annotations

import torch

from ..interp import in_bounds
from . import (MAX_CLUSTER, Fl, I, P, Partition, _gn6, cluster_partition, launch, launched,
               on_card, require, stream)
from .align2d_fused import Align2DPrep, a2d_gn_plain, a2d_window_origins
from .align2d_kernel import CACHE_SLACK, CACHE_WIN, PATCH as A2D_PATCH, gather_windows
from .pose_ba_fused import CHI2_2D, pose_ba_gn_plain
from .sparse_align_mega import (CWIN, MAX_ITER, PATCH, STOP_STEP, _distortion, mega_args,
                                mega_gn_plain, project_points)

A2D_EPS = 0.03                 # align2d freezes a point once its step is below this
BA_EPS = 1e-4                  # a BA round stops once max|dx| falls below this
_INIT_MARGIN = A2D_PATCH / 2 + 2                      # 6: in bounds at the start
_FINAL_MARGIN = A2D_PATCH / 2 + 1                     # 5: in bounds at the end
_MAX_DRIFT = min(A2D_PATCH * 2.0, float(CACHE_SLACK))  # 11 px from the start

# The kernel's launch geometry (csrc/track_fused.cu).
THREADS = 512                  # K3's and K5's block, whatever N is
WARPS = THREADS // 32          # stage 2 aligns a point per warp


def track_partition(n2: int) -> Partition:
    """K11's partition of n2 map points: a CTA for every WARPS points (a
    warp per point) up to MAX_CLUSTER."""
    return cluster_partition(n2, WARPS)


def track_gn_plain(wins, refp, jac, p_sp, lvis, ox, oy, pose0, cam, distorted, H0, W0,
                   a2_wins, a2_ref, a2_jx, a2_jy, a2_hinv, a2_ox, a2_oy, p_a2, a2_mask,
                   sp_iter=MAX_ITER, a2d_iter=10, a2d_max_err=30.0, ba_rounds=4,
                   ba_iters=10, chi2_th=CHI2_2D, stats: dict | None = None):
    """Plain version of K11.

    The first twelve arguments are K3's (`mega_gn_plain`): the sparse
    stage's windows [L, N1, 16, 16] at the frame-init pose, patches, Jacobians,
    reference-camera points p_sp [N1, 3], level visibility, window origins,
    pose0 [12], the camera, `distorted`, the level-0 size.  Then the map
    points': windows a2_wins [N2, 32, 32] at the frame-init pose, the
    Align2DPrep fields, window origins [N2] int32, reference-camera points
    p_a2 [N2, 3], a2_mask [N2] bool.

    Returns (out [27]: R, t, chi2 of the sparse stage, chi2 of the last BA
    round, inlier count, then the sparse stage's R, t; xy [N2, 2]; per [3,
    N2]: align2d error, converged 0/1, inlier 0/1).  `stats`, if given,
    receives "passes" (residual passes per sparse level) and "normal_eqs"
    (BA normal equations): the work this input needs."""
    stats = {} if stats is None else stats
    sp = mega_gn_plain(wins, refp, jac, p_sp, lvis, ox, oy, pose0, cam, distorted, H0, W0,
                       stats=stats, n_iter=sp_iter)
    R, t = _gn6.pose_from_tensor(sp)
    # Align2d from the landmarks' projections at the sparse result, unclamped.
    xi, yi, z = project_points(R, t, p_a2, cam, distorted)
    xy0 = torch.stack([xi, yi], dim=1)
    a2 = a2d_gn_plain(a2_wins, a2_ref, a2_jx, a2_jy, a2_hinv, a2_ox, a2_oy, xy0, a2d_iter,
                      A2D_EPS, clamp_step=False)
    xy, err = a2[:, :2].contiguous(), a2[:, 3]
    drift2 = (xy[:, 0] - xi) ** 2 + (xy[:, 1] - yi) ** 2
    conv = ((z > 0.05) & in_bounds(xy0, H0, W0, _INIT_MARGIN)
            & in_bounds(xy, H0, W0, _FINAL_MARGIN) & (err < a2d_max_err)
            & (drift2 < _MAX_DRIFT * _MAX_DRIFT) & (a2_mask > 0.5)).to(torch.float32)
    ba, inl = pose_ba_gn_plain(p_a2, xy, conv * a2_mask, sp[:12], cam, chi2_th, ba_rounds,
                               ba_iters, BA_EPS, stats=stats)
    out = torch.cat([ba[:12], sp[12:], ba[12:], inl.sum()[None], sp[:12]])
    return out, xy, torch.stack([err, conv, inl])


def track_gn(wins, refp, jac, p_sp, lvis, ox, oy, pose0, cam, distorted, H0, W0,
             a2_wins, a2_ref, a2_jx, a2_jy, a2_hinv, a2_ox, a2_oy, p_a2, a2_mask,
             sp_iter=MAX_ITER, a2d_iter=10, a2d_max_err=30.0, ba_rounds=4, ba_iters=10,
             chi2_th=CHI2_2D, *, stamps: torch.Tensor | None = None):
    """K11 on the card, its plain version on the CPU; arguments and results
    as for `track_gn_plain` (a2_mask bool on the card, as K5's msk).

    `stamps`, an int64 tensor [10] on the card, receives the SM clock and
    the global timer (ns) of CTA 0 at the kernel's start, after stage 1,
    after its stage 2, after the cluster barrier and at the end."""
    if not on_card(wins):
        return track_gn_plain(wins, refp, jac, p_sp, lvis, ox, oy, pose0, cam, distorted, H0,
                              W0, a2_wins, a2_ref, a2_jx, a2_jy, a2_hinv, a2_ox, a2_oy, p_a2,
                              a2_mask, sp_iter, a2d_iter, a2d_max_err, ba_rounds, ba_iters,
                              chi2_th)
    L, N1 = lvis.shape
    N2 = p_a2.shape[0]
    dev = wins.device
    require(wins, "wins", torch.float32, (L, N1, CWIN, CWIN), dev)
    require(refp, "refp", torch.float32, (L, N1, PATCH * PATCH), dev)
    require(jac, "jac", torch.float32, (L, N1, PATCH * PATCH, 6), dev)
    require(p_sp, "p_sp", torch.float32, (N1, 3), dev)
    require(lvis, "lvis", torch.float32, (L, N1), dev)
    require(ox, "ox", torch.int32, (L, N1), dev)
    require(oy, "oy", torch.int32, (L, N1), dev)
    require(pose0, "pose0", torch.float32, (12,), dev)
    require(a2_wins, "a2_wins", torch.float32, (N2, CACHE_WIN, CACHE_WIN), dev)
    for name, a in (("a2_ref", a2_ref), ("a2_jx", a2_jx), ("a2_jy", a2_jy)):
        require(a, name, torch.float32, (N2, A2D_PATCH, A2D_PATCH), dev)
    require(a2_hinv, "a2_hinv", torch.float32, (N2, 3, 3), dev)
    require(a2_ox, "a2_ox", torch.int32, (N2,), dev)
    require(a2_oy, "a2_oy", torch.int32, (N2,), dev)
    require(p_a2, "p_a2", torch.float32, (N2, 3), dev)
    require(a2_mask, "a2_mask", torch.bool, (N2,), dev)
    if stamps is not None:
        require(stamps, "stamps", torch.int64, (10,), dev)
    out = torch.empty(27, dtype=torch.float32, device=dev)
    xy = torch.empty((N2, 2), dtype=torch.float32, device=dev)
    per = torch.empty((5, N2), dtype=torch.float32, device=dev)    # rows 3, 4: scratch
    part = track_partition(N2)
    launch("track_fused", "track_fused_launch",
           [P] * 7 + [I, I] + [P] * 9 + [I] + [P] * 4 + [I, I] + [Fl] * 8
           + [I, Fl, I, Fl, Fl, I, I, Fl, Fl, I, I, P, P],
           wins.data_ptr(), refp.data_ptr(), jac.data_ptr(), p_sp.data_ptr(), lvis.data_ptr(),
           ox.data_ptr(), oy.data_ptr(), N1, L, a2_wins.data_ptr(), a2_ref.data_ptr(),
           a2_jx.data_ptr(), a2_jy.data_ptr(), a2_hinv.data_ptr(), a2_ox.data_ptr(),
           a2_oy.data_ptr(), p_a2.data_ptr(), a2_mask.data_ptr(), N2, pose0.data_ptr(),
           out.data_ptr(), xy.data_ptr(), per.data_ptr(), H0, W0, cam.fx, cam.fy, cam.cx,
           cam.cy, *_distortion(cam, distorted), sp_iter, STOP_STEP, a2d_iter,
           A2D_EPS * A2D_EPS, a2d_max_err, ba_rounds, ba_iters, BA_EPS, chi2_th, part.cluster,
           part.per_cta, None if stamps is None else stamps.data_ptr(), stream(dev))
    launched(track_gn, wins, refp, jac, p_sp, lvis, ox, oy, pose0, cam, distorted, H0, W0,
             a2_wins, a2_ref, a2_jx, a2_jy, a2_hinv, a2_ox, a2_oy, p_a2, a2_mask, sp_iter,
             a2d_iter, a2d_max_err, ba_rounds, ba_iters, chi2_th)
    return out, xy, per[:3]


track_gn.launches = 0


def track_args(cur_pyr, level_refs, p_ref_sp, a2d_prep: Align2DPrep, p_ref_a2, a2_mask, R0,
               t0, cam, distorted: bool, max_level: int) -> tuple:
    """K11's first 21 arguments for one frame: K3's (every level's windows
    gathered by K1 at the frame-init pose) and one 32x32 window per map
    point gathered by K1 around its frame-init projection."""
    n_levels = max_level + 1
    mega_refp = torch.stack([level_refs[li].ref_patch for li in range(n_levels)])
    mega_jl = torch.stack([level_refs[li].J for li in range(n_levels)])
    a3, _ = mega_args(cur_pyr, level_refs, p_ref_sp, R0, t0, cam, distorted, n_levels,
                      mega_refp, mega_jl)
    img0 = cur_pyr[0]
    pxa0 = torch.nan_to_num(cam.camera_to_pixel(p_ref_a2 @ R0.T + t0, distorted=distorted))
    ox, oy = a2d_window_origins(pxa0, *img0.shape)
    # K3's arguments without its iteration cap (K11 takes `sp_iter`).
    return a3[:12] + (gather_windows(img0, ox, oy, CACHE_WIN), a2d_prep.ref, a2d_prep.jx,
                 a2d_prep.jy, a2d_prep.hinv, ox, oy, p_ref_a2.contiguous(),
                 a2_mask.to(torch.bool).contiguous())


def track_step_fused(cur_pyr, level_refs, p_ref_sp, a2d_prep: Align2DPrep, p_ref_a2, a2_mask,
                     R0, t0, cam, distorted: bool, max_level: int, sp_iter: int = MAX_ITER,
                     a2d_iter: int = 10, a2d_max_err: float = 30.0, ba_rounds: int = 4,
                     ba_iters: int = 10, chi2_th: float = CHI2_2D):
    """One whole tracking step in one kernel launch (after K1's four
    window fetches).

    cur_pyr: the current pyramid (level 0 full resolution); level_refs:
    the sparse stage's LevelRef per level; p_ref_sp [N1, 3] its points in
    the reference camera; a2d_prep: the map points' Align2DPrep; p_ref_a2
    [N2, 3] the map points in the reference camera; a2_mask [N2] their
    validity; R0, t0: the frame-init T_cur_ref.

    Returns (R, t, chi2_sparse, chi2_ba, n_inliers, a2d_xy [N2, 2],
    a2d_err [N2], a2d_converged [N2] bool, ba_inlier [N2] bool)."""
    args = track_args(cur_pyr, level_refs, p_ref_sp, a2d_prep, p_ref_a2, a2_mask, R0, t0, cam,
                      distorted, max_level)
    out, xy, per = track_gn(*args, sp_iter, a2d_iter, a2d_max_err, ba_rounds, ba_iters,
                            chi2_th)
    return (out[:9].reshape(3, 3), out[9:12], out[12], out[13], out[14], xy, per[0],
            per[1] > 0.5, per[2] > 0.5)
