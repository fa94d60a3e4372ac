"""Relocalization against the active keyframe window over the BoW
vocabulary (counterpart of `RelocResult` and `relocalize` of
ygz_slam_tpu/models/relocalization.py; its archive tier and loop closing
are not ported yet).

The ORB-SLAM recipe the reference left as a TODO
(src/Module/VisualOdometry.cpp:101-104): BoW similarity against every
keyframe, descriptor matching against the best candidates' landmark-bearing
features, a P3P-RANSAC pose seed and a robust pose-only BA, the best
candidate by inliers.  The JAX package `vmap`s the candidates; here they
are one batch, with two kernel launches per attempt: every candidate's
Hamming matrix in one K10 launch (the candidates' features gathered into
one contiguous table, each matcher handed its column block, as the
keyframe cycle's triangulation does) and every candidate's pose solve in
one K8 launch (K5's body once per candidate).  Nothing waits for the
device until the caller reads `success`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geometry.se3 import SE3
from ..map import vocabulary as voc
from ..ops.hamming import distance_matrix, match_nn, rotation_consistency
from ..ops.kernels.pose_ba_fused_batch import pose_only_ba_fused_batch
from ..ops.select import top_k
from ..solvers import pnp

MATCH_MAX_DIST = 64     # Hamming bound of the candidates' matching
PNP_MIN_INLIERS = 6     # a P3P-RANSAC seed needs this many inliers, else the stored pose


class RelocResult(NamedTuple):
    success: torch.Tensor   # bool
    T_cw: SE3
    n_inliers: torch.Tensor
    kf_slot: torch.Tensor   # the matched keyframe


class RelocAttempt(NamedTuple):
    """The stages of one attempt, for the checks that hold two runs of it
    against each other: BoW scores [K], candidate slots [C], the matches
    kept [C, Nq] (index into the candidate's F features or -1), the P3P draws [C,
    H, 3] (None without P3P), per-candidate poses (SE3 [C]) and inlier
    counts [C]."""
    scores: torch.Tensor
    cand: torch.Tensor
    match_idx: torch.Tensor
    draws: torch.Tensor
    T_cand: SE3
    n_inl: torch.Tensor


def candidate_matches(q_desc, q_valid, c_desc, c_valid, q_angle=None, c_angle=None):
    """Query descriptors [Nq, 8] against each of C candidates' F features
    (c_desc [C, F, 8], c_valid [C, F]): nearest neighbour within
    MATCH_MAX_DIST with a cross-check and no ratio test, then, with angles
    given, the rotation-histogram filter.  The [Nq, C*F] Hamming matrix is
    one K10 launch over the candidates' rows, gathered into one contiguous
    table (aligned as K10 wants); candidate c's matcher reads its column
    block.  Returns (idx [C, Nq] int32 or -1, ok [C, Nq])."""
    C, F = c_valid.shape
    d = distance_matrix(q_desc, c_desc.reshape(C * F, 8).contiguous())
    idx, ok = [], []
    for c in range(C):
        i, k = match_nn(q_desc, None, q_valid, c_valid[c], max_dist=MATCH_MAX_DIST, ratio=1.0,
                        cross_check=True, d=d[:, c * F:(c + 1) * F])
        if q_angle is not None and c_angle is not None:
            k = rotation_consistency(q_angle, c_angle[c][torch.clamp(i, 0, F - 1).long()], k)
        idx.append(i)
        ok.append(k)
    return torch.stack(idx), torch.stack(ok)


def relocalize(vocab: voc.Vocabulary, cam,
               q_desc, q_px, q_valid,       # the query frame's features
               kf_bow,                      # [K, W] BoW vectors per keyframe
               kf_valid,                    # [K]
               kf_pose7,                    # [K, 7]
               feat_desc_flat,              # [K*F, 8]
               feat_nodes_flat,             # [K*F] vocabulary nodes (the matcher has no node gate)
               feat_point_flat,             # [K*F] landmark links
               feat_valid_flat,             # [K*F]
               pt_pos,                      # [L, 3]
               pt_valid,                    # [L]
               min_inliers: int = 20, feat_angle_flat=None, q_angle=None, top_c: int = 3,
               use_pnp: bool = True, pnp_hyps: int = 256,
               generator: torch.Generator | None = None,
               draws: torch.Tensor | Callable | None = None,
               stages: dict | None = None) -> RelocResult:
    """One relocalization attempt, the JAX signature plus the draw:

    1. BoW-score the query against every keyframe, take the `top_c` best
       (invalid keyframes score -1; ties go to the lower slot, as
       `jax.lax.top_k` does).
    2. Match the query against each candidate's landmark-bearing features
       (`candidate_matches`: one K10 launch).
    3. Seed each candidate's pose by P3P-RANSAC over its 2D-3D matches
       (`use_pnp`), falling back to the stored keyframe pose where the seed
       is unusable or has fewer than PNP_MIN_INLIERS inliers, and refine
       every candidate by pose-only BA (one K8 launch).
    4. The candidate with the most BA inliers (the first on ties) wins; the
       attempt succeeds at `min_inliers`.

    The P3P triples [C, pnp_hyps, 3] come from `draws` if given (a tensor,
    or a function of (match masks [C, Nq], candidate slots [C]) returning
    one), else from `pnp.sample_triples` with `generator` (a fresh one
    seeded 17 if none is given).  `stages`, a dict if given, receives the
    attempt's RelocAttempt under "attempt"."""
    K = kf_valid.shape[0]
    F = feat_valid_flat.shape[0] // K
    dev = q_desc.device
    words, _ = voc.transform(vocab, q_desc, q_valid)
    q_bow = voc.bow_vector(vocab, words, q_valid)
    scores = torch.where(kf_valid, voc.score_l1(q_bow[None, :], kf_bow), -1.0)
    C = min(top_c, K)
    _, cand = top_k(scores, C)
    rows = cand[:, None] * F + torch.arange(F, device=dev)[None, :]         # [C, F]
    c_point = feat_point_flat[rows]
    pt_safe = torch.clamp(c_point, 0, pt_pos.shape[0] - 1).long()
    c_valid = feat_valid_flat[rows] & (c_point >= 0) & pt_valid[pt_safe]
    # Permissive matching (the JAX package's choice): no ratio test and no
    # node gate; the robust pose solve does the rejection.
    c_angle = None if feat_angle_flat is None else feat_angle_flat[rows]
    idx, ok = candidate_matches(q_desc, q_valid, feat_desc_flat[rows], c_valid, q_angle, c_angle)
    idx_safe = torch.clamp(idx, 0, F - 1).long()
    match_pts = pt_pos[torch.gather(pt_safe, 1, idx_safe)]                   # [C, Nq, 3]
    q_px_c = q_px[None].expand(C, -1, -1)
    T_stored = SE3.from_params7(kf_pose7[cand])
    if use_pnp:
        if callable(draws):
            draws = draws(ok, cand)
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(17)
            draws = pnp.sample_triples(ok, pnp_hyps, generator)
        pr = pnp.ransac_pnp_from_samples(match_pts, q_px_c, ok, cam, draws)
        seed_ok = (pr.ok & (pr.n_inliers >= PNP_MIN_INLIERS))[:, None]
        T_init = SE3(torch.where(seed_ok[..., None], pr.T_cw.R, T_stored.R),
                     torch.where(seed_ok, pr.T_cw.t, T_stored.t))
    else:
        T_init, draws = T_stored, None
    # Pose-only BA takes ideal-pinhole pixels (as solvers.ba.pose_only_ba).
    T_opt, inlier, _ = pose_only_ba_fused_batch(T_init, match_pts,
                                                cam.undistort_px(q_px_c), ok, cam)
    cand_inl = inlier.sum(dim=1)
    best = torch.argmax(cand_inl)
    n_inl = cand_inl[best]
    if stages is not None:
        stages["attempt"] = RelocAttempt(scores=scores, cand=cand,
                                         match_idx=torch.where(ok, idx, -1), draws=draws,
                                         T_cand=T_opt, n_inl=cand_inl)
    return RelocResult(success=n_inl >= min_inliers, T_cw=SE3(T_opt.R[best], T_opt.t[best]),
                       n_inliers=n_inl, kf_slot=cand[best])
