"""Bundle adjustment (counterpart of ygz_slam_tpu/solvers/ba.py): pose-only
BA on K5, and the windowed local BA with the Schur complement over
landmark blocks that two-view BA and the mapping pass use.

The observation graph is a fixed-capacity table (kf_idx [O], pt_idx [O],
px [O, 2], mask [O]) over poses SE3[K] and landmarks [L, 3]; per-observation
analytic Jacobians are built in one batched pass, and the camera and
landmark blocks are summed per segment (camera, landmark, camera-landmark
pair) in a canonical order: the table is sorted once per BA call, by
(camera, landmark) and by (landmark, camera), and every sum is a segmented
reduction over the sorted rows.  No float atomics, so a run repeats bit for
bit on the card, and any order of the table's rows gives the same sums.
The reduced camera system is one dense [6K, 6K] solve.
Not ported: point_only_ba, optimize_current.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import jacobians as jac
from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from ..ops.kernels.pose_ba_fused import CHI2_2D, pose_only_ba_fused
from . import robust

MIN_DEPTH = 1e-2


def pose_only_ba(T_cw: SE3, points: torch.Tensor, px: torch.Tensor,
                 mask: torch.Tensor, cam, rounds: int = 4,
                 iters_per_round: int = 10, chi2_th: float = CHI2_2D):
    """Optimize one camera pose against fixed 3D points: 4 rounds of
    robust Gauss-Newton with chi2 inlier reclassification (BA.cpp:188-264).
    `px` are raw detections; they are undistorted once here.  Returns
    (pose, inlier mask [N] bool, final chi2)."""
    if points.dtype != torch.float32:
        raise ValueError(f"pose_only_ba takes float32 points, got {points.dtype}")
    return pose_only_ba_fused(T_cw, points, cam.undistort_px(px), mask, cam,
                              rounds=rounds, iters_per_round=iters_per_round,
                              chi2_th=chi2_th)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate over determinant) of a
    float32 M, computed in float64 and rounded to float32; |det| < 1e-20 is
    clamped.  The damped block of a landmark seen by one keyframe (a
    promoted depth-filter seed) is rank 2 plus the damping, and in float32
    its cofactors cancel catastrophically (a determinant of 1.7e14 for a
    true 2.3e7): the inverse is then noise, and local BA can send such a
    landmark along its ray to ~1e20, a step that leaves its reprojection
    alone and so passes the LM test (the JAX package's float32 adjugate
    gives the same noise on the same blocks)."""
    out_dtype = M.dtype
    M = M.double()
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack([torch.stack([A, B, C], dim=-1), torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return (adj * inv_det[..., None, None]).to(out_dtype)


class Observations(NamedTuple):
    """Fixed-capacity observation table (invalid rows masked out)."""
    kf_idx: torch.Tensor  # [O] int index into the pose array
    pt_idx: torch.Tensor  # [O] int index into the landmark array
    px: torch.Tensor      # [O, 2] measured pixel
    mask: torch.Tensor    # [O] bool


def reproject(poses: SE3, points: torch.Tensor, obs: Observations, cam):
    """Residuals and analytic Jacobians of every observation: (r [O, 2],
    J_pose [O, 2, 6], J_point [O, 2, 3], valid [O]); r = projection -
    measurement, and an observation behind its camera is invalid.  obs.px
    must be ideal-pinhole pixels (every public entry undistorts once)."""
    k = obs.kf_idx.long()
    T = SE3(poses.R[k], poses.t[k])
    pc = T.apply(points[obs.pt_idx.long()])
    valid = obs.mask & (pc[..., 2] > MIN_DEPTH)
    pc_safe = torch.cat([pc[..., :2], torch.clamp(pc[..., 2:], min=MIN_DEPTH)], dim=-1)
    r = cam.camera_to_pixel(pc_safe, distorted=False) - obs.px
    Jp = jac.duv_dxi(pc_safe, cam.fx, cam.fy)
    Jl = jac.duv_dpoint(pc_safe, T.R, cam.fx, cam.fy)
    return r, Jp, Jl, valid


def _irls_weights(r: torch.Tensor, valid: torch.Tensor, huber_delta: float):
    """Per-observation Huber IRLS weight of the 2D residual norm, zero on
    invalid rows."""
    return torch.where(valid, robust.huber_weight(torch.linalg.norm(r, dim=-1), huber_delta),
                       0.0)


class BAResult(NamedTuple):
    poses: SE3
    points: torch.Tensor
    chi2: torch.Tensor
    inlier: torch.Tensor  # [O] final per-observation inlier mask


class Segments(NamedTuple):
    """Observation rows grouped by one index: `order` lists the rows sorted by
    it, segment s at sorted positions offsets[s]..offsets[s + 1]; the last
    segment holds the masked rows, which no sum reads."""
    order: torch.Tensor    # [O] int64
    offsets: torch.Tensor  # [n + 2] int64


def _sorted_by(major, minor, n_major: int, n_minor: int, mask):
    """Rows sorted by (major, minor), masked rows last: (keys, order)."""
    key = torch.where(mask, major * n_minor + minor, n_major * n_minor)
    return torch.sort(key, stable=True)


def _segments(key, order, bounds) -> Segments:
    end = torch.full((1,), key.shape[0], dtype=torch.int64, device=key.device)
    return Segments(order, torch.cat([torch.searchsorted(key, bounds), end]))


class BlockSegments(NamedTuple):
    """The observations grouped by camera, by landmark and by
    camera-landmark pair: the segments of `_assemble`'s block sums."""
    kf: Segments
    pt: Segments
    pair: Segments


def block_segments(obs: Observations, K: int, L: int) -> BlockSegments:
    """Each segment's rows in a canonical order, whatever the table's: a
    camera's by landmark, a landmark's by camera (rows of one camera and
    landmark, which the map never holds, keep table order).  Two sorts per
    BA call; the table does not change inside it."""
    kf, pt = obs.kf_idx.long(), obs.pt_idx.long()
    dev = kf.device
    key_c, order_c = _sorted_by(kf, pt, K, L, obs.mask)
    key_l, order_l = _sorted_by(pt, kf, L, K, obs.mask)
    return BlockSegments(
        kf=_segments(key_c, order_c, torch.arange(K + 1, device=dev) * L),
        pt=_segments(key_l, order_l, torch.arange(L + 1, device=dev) * K),
        pair=_segments(key_c, order_c, torch.arange(K * L + 1, device=dev)))


def segment_sum(v: torch.Tensor, seg: Segments) -> torch.Tensor:
    """[n, ...] sums of v's rows [O, ...] over each segment, in its order (an
    empty segment sums to 0): a segmented reduction, no atomics, so the
    result is the same bit for bit whatever order the rows come in and on
    every run."""
    return torch.segment_reduce(v[seg.order], "sum", offsets=seg.offsets, axis=0,
                                unsafe=True)[:-1]


def _assemble(poses, points, obs, cam, fixed_pose, huber_delta, seg: BlockSegments,
              w_frozen=None):
    """Every Hessian block and gradient at the current state, summed over
    `seg` (`block_segments` of obs).  With `w_frozen` (already masked) the
    IRLS weights are held, so an LM accept compares chi2 under one
    objective.  Fixed cameras get zero Jacobians."""
    r, Jp, Jl, valid = reproject(poses, points, obs, cam)
    if w_frozen is None:
        w = _irls_weights(r, valid, huber_delta)
    else:
        w = torch.where(valid, w_frozen, 0.0)
    K, L = fixed_pose.shape[0], points.shape[0]
    kf = obs.kf_idx.long()
    Jp = Jp * (~fixed_pose)[kf].to(Jp.dtype)[:, None, None]
    Hcc = segment_sum(torch.einsum("oia,o,oib->oab", Jp, w, Jp), seg.kf)
    Hll = segment_sum(torch.einsum("oia,o,oib->oab", Jl, w, Jl), seg.pt)
    bc = segment_sum(-torch.einsum("oia,o,oi->oa", Jp, w, r), seg.kf)
    bl = segment_sum(-torch.einsum("oia,o,oi->oa", Jl, w, r), seg.pt)
    # Camera-landmark coupling blocks W[k, l, 6, 3].
    W = segment_sum(torch.einsum("oia,o,oib->oab", Jp, w, Jl), seg.pair).reshape(K, L, 6, 3)
    chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
    return Hcc, Hll, W, bc, bl, chi2


def _schur_solve(Hcc, Hll, W, bc, bl, fixed_pose, lam):
    """Marginalize the landmarks and solve the reduced camera system:
    S = Hcc - W Hll^-1 W^T (dense [6K, 6K]), then dl = Hll^-1 (bl - W^T dc).
    `lam` (LM damping) is added to both diagonals; fixed cameras get
    identity blocks, so their update is exactly zero.  A solve that fails
    gives a zero step (jnp.linalg.solve's non-finite result, masked)."""
    K, L = W.shape[0], W.shape[1]
    eye3 = torch.eye(3, dtype=Hcc.dtype, device=Hcc.device)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hll_inv = inv3x3(Hll + (lam + 1e-6) * eye3)                        # [L, 3, 3]
    A = torch.einsum("klab,lbc->klac", W, Hll_inv)                     # [K, L, 6, 3]
    S = -torch.einsum("klac,mlbc->kmab", A, W)                         # [K, K, 6, 6]
    ar = torch.arange(K, device=Hcc.device)
    S[ar, ar] += Hcc + lam * eye6
    b_red = bc - torch.einsum("klac,lc->ka", A, bl)                    # [K, 6]
    free = (~fixed_pose).to(Hcc.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[ar, ar] += eye6[None] * fixed_pose.to(Hcc.dtype)[:, None, None]
    b_red = b_red * free[:, None]
    S_mat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dc, info = torch.linalg.solve_ex(S_mat + 1e-8 * torch.eye(K * 6, dtype=Hcc.dtype,
                                                              device=Hcc.device),
                                     b_red.reshape(K * 6))
    dc = torch.where((info == 0) & torch.isfinite(dc), dc, 0.0).reshape(K, 6)
    dl = torch.einsum("lab,lb->la", Hll_inv, bl - torch.einsum("klab,ka->lb", W, dc))
    return dc, torch.where(torch.isfinite(dl), dl, 0.0)


def local_ba(poses: SE3, points: torch.Tensor, obs: Observations, cam,
             fixed_pose: torch.Tensor, n_iter: int = 10,
             huber_delta: float = math.sqrt(CHI2_2D), chi2_th: float = CHI2_2D) -> BAResult:
    """Windowed BA over SE3[K] poses and [L, 3] landmarks with an LM
    accept/reject schedule (LocalBAG2O, BA.cpp:386-543: Huber delta
    sqrt(5.991), marginalized landmark blocks, outlier marking at the end).
    fixed_pose [K] bool: gauge-fixed cameras.  obs.px are raw detections,
    undistorted here."""
    obs = obs._replace(px=cam.undistort_px(obs.px))
    return _local_ba(poses, points, obs, cam, fixed_pose, n_iter, huber_delta, chi2_th)


def _local_ba(poses, points, obs, cam, fixed_pose, n_iter, huber_delta, chi2_th):
    seg = block_segments(obs, fixed_pose.shape[0], points.shape[0])
    T, pts = poses, points
    lam = torch.tensor(1e-4, dtype=points.dtype, device=points.device)
    chi2 = _assemble(T, pts, obs, cam, fixed_pose, huber_delta, seg)[5]
    for _ in range(n_iter):
        # IRLS weights frozen at the iteration's start state.
        r, _, _, valid = reproject(T, pts, obs, cam)
        w_frozen = _irls_weights(r, valid, huber_delta)
        Hcc, Hll, W, bc, bl, chi2_old = _assemble(T, pts, obs, cam, fixed_pose, huber_delta,
                                                  seg, w_frozen)
        dc, dl = _schur_solve(Hcc, Hll, W, bc, bl, fixed_pose, lam)
        T_new = se3m.boxplus(T, dc)
        pts_new = pts + dl
        chi2_new = _assemble(T_new, pts_new, obs, cam, fixed_pose, huber_delta, seg,
                             w_frozen)[5]
        accept = chi2_new < chi2_old
        T = SE3(torch.where(accept, T_new.R, T.R), torch.where(accept, T_new.t, T.t))
        pts = torch.where(accept, pts_new, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        chi2 = torch.where(accept, chi2_new, chi2_old)
    # Final outlier marking (BA.cpp:519-537).
    r, _, _, valid = reproject(T, pts, obs, cam)
    inlier = valid & (torch.sum(r * r, dim=-1) < chi2_th)
    return BAResult(poses=T, points=pts, chi2=chi2, inlier=inlier)


def two_view_ba(T_ref: SE3, T_cur: SE3, points: torch.Tensor, px_ref: torch.Tensor,
                px_cur: torch.Tensor, mask: torch.Tensor, cam, n_iter: int = 10) -> BAResult:
    """Two-view refinement after monocular initialization (TwoViewBACeres,
    BA.cpp:11-89): reference pose fixed, current pose and all points free;
    the inlier mask is per point, both views agreeing at chi2 5.991."""
    N = points.shape[0]
    dev = points.device
    poses = SE3(torch.stack([T_ref.R, T_cur.R]), torch.stack([T_ref.t, T_cur.t]))
    ar = torch.arange(N, dtype=torch.int32, device=dev)
    obs = Observations(
        kf_idx=torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                          torch.ones(N, dtype=torch.int32, device=dev)]),
        pt_idx=torch.cat([ar, ar]), px=torch.cat([px_ref, px_cur]), mask=torch.cat([mask, mask]))
    fixed = torch.tensor([True, False], device=dev)
    res = local_ba(poses, points, obs, cam, fixed, n_iter=n_iter)
    return res._replace(inlier=res.inlier[:N] & res.inlier[N:])
