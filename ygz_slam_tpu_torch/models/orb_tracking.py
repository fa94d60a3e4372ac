"""Feature-based (SPARSE_ORB) frame tracking (counterpart of
ygz_slam_tpu/models/orb_tracking.py).

ORB-SLAM's TrackWithMotionModel: detect ORB features on the current frame,
project the map's landmarks at the motion-model pose, match each
landmark's descriptor (`MapState.pt_desc`) against the detections inside a
pixel window around its projection, then pose-only BA; a second, tighter
match and BA at the refined pose.  The [L, F] Hamming matrix replaces
per-landmark grid buckets and the search window is a mask on it, so the
matrix is one K10 launch on the card (`ops/hamming.distance_matrix`) and
each pose solve one K5 launch (`solvers/ba.pose_only_ba`).

Ties decide matches here (Hamming distances are integers): every argmin
takes the smallest index that reaches the minimum, as `jnp.argmin` does,
computed explicitly (`first_argmin`) rather than left to `torch.argmin`,
whose tie rule PyTorch does not document.
"""
from __future__ import annotations

import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from ..ops.hamming import distance_matrix, rotation_consistency
from ..ops.interp import in_bounds
from ..solvers.ba import pose_only_ba
from .frontend import Features, TrackMapResult, select_pose

_BIG = 1 << 14      # distance of a pair outside the window


def first_argmin(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the minimum of integer `d` along `dim`, the smallest index
    among equal minima."""
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    ar = torch.arange(n, device=d.device).reshape(shape)
    hit = d == torch.amin(d, dim=dim, keepdim=True)
    return torch.amin(torch.where(hit, ar, n), dim=dim)


def match_by_projection(cam, T_cw: SE3, pt_pos, pt_valid, pt_desc, feats: Features,
                        radius: float = 15.0, max_dist: int = 50, ratio: float = 0.9,
                        pt_angle=None):
    """SearchByProjection: landmark -> best detected feature in a pixel
    window around its projection at T_cw (the window's radius scaled by
    the feature's pyramid level, 2^level).

    The best distance must be at most `max_dist` and below `ratio` times
    the second best (Matcher.cpp:250-283), and each feature keeps only the
    landmark that matches it best (the cross-check).  With `pt_angle` [L]
    the rotation-histogram gate also applies (Matcher.cpp:294-336).

    pt_pos [L, 3], pt_valid [L], pt_desc [L, 8] int32.  Returns (matched
    [L] bool, obs_px [L, 2]: the best feature's pixel, in_view [L] bool)."""
    pc = T_cw.apply(pt_pos)
    px_proj = cam.camera_to_pixel(pc)
    in_view = pt_valid & (pc[:, 2] > 0.05)
    d = distance_matrix(pt_desc, feats.desc)                       # [L, F]
    r = radius * (2.0 ** feats.level.to(torch.float32))            # [F]
    d2px = torch.sum((px_proj[:, None, :] - feats.px[None, :, :]) ** 2, dim=-1)
    ok_pair = in_view[:, None] & feats.valid[None, :] & (d2px <= (r * r)[None, :])
    d = torch.where(ok_pair, d, _BIG)
    best_idx = first_argmin(d, 1)                                  # [L]
    best = torch.amin(d, dim=1)
    second = torch.amin(d.scatter(1, best_idx[:, None], _BIG), dim=1)
    matched = (best <= max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if pt_angle is not None:
        matched = rotation_consistency(pt_angle, feats.angle[best_idx], matched)
    # Cross-check: a feature keeps the landmark that matches it best, the
    # lowest landmark index among ties.
    best_rev = first_argmin(torch.where(matched[:, None], d, _BIG), 0)   # [F]
    matched = matched & (best_rev[best_idx] == torch.arange(d.shape[0], device=d.device))
    return matched, feats.px[best_idx], in_view


def _visible(cam, T_cw: SE3, pt_pos, pt_valid, shape):
    H, W = shape
    pc = T_cw.apply(pt_pos)
    return pt_valid & (pc[:, 2] > 0.05) & in_bounds(cam.camera_to_pixel(pc), H, W, margin=8.0)


def track_map_orb(cur_shape, cam, T_pred: SE3, pt_pos, pt_valid, pt_desc, feats: Features,
                  radius_coarse: float = 15.0, radius_fine: float = 6.0, max_dist: int = 50,
                  pt_angle=None, max_step_motion: float = 0.2) -> TrackMapResult:
    """Two-pass projection matching and pose-only BA (the SPARSE_ORB frame
    tracker): match at T_pred in the coarse window, BA; match again at the
    refined pose in the fine window, keeping a landmark's pass-1
    observation where pass 2 lost it, BA again.  A result more than
    `max_step_motion` (twist norm) from T_pred is rejected whole: no
    inliers and T_pred.  The `frontend.track_local_map` contract, so the VO
    state machine does not depend on the tracker."""
    vis = _visible(cam, T_pred, pt_pos, pt_valid, cur_shape)
    m1, obs1, _ = match_by_projection(cam, T_pred, pt_pos, pt_valid, pt_desc, feats,
                                      radius=radius_coarse, max_dist=max_dist, pt_angle=pt_angle)
    m1 = m1 & vis
    T1, _, _ = pose_only_ba(T_pred, pt_pos, obs1, m1, cam)
    m2, obs2, _ = match_by_projection(cam, T1, pt_pos, pt_valid, pt_desc, feats,
                                      radius=radius_fine, max_dist=max_dist, pt_angle=pt_angle)
    vis2 = _visible(cam, T1, pt_pos, pt_valid, cur_shape)
    m2 = m2 & vis2
    obs = torch.where(m2[:, None], obs2, obs1)
    matched = m2 | m1
    T2, inlier, _ = pose_only_ba(T1, pt_pos, obs, matched, cam)
    step = torch.linalg.norm(se3m.log(T2.compose(T_pred.inverse())))
    sane = step <= max_step_motion
    inlier = inlier & sane
    return TrackMapResult(T_cw=select_pose(sane, T2, T_pred), n_inliers=torch.sum(inlier),
                          candidate=vis | vis2, found=inlier, obs_px=obs)
