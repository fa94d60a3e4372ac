"""Relocalization and active-window loop closing over the BoW vocabulary
(counterpart of ygz_slam_tpu/models/relocalization.py: `RelocResult`,
`relocalize`, `relocalize_archive`, `LoopResult`, `detect_loop` and
`close_loop`; the archive loops, `detect_loop_archive`, `close_loop_global`
and `apply_global_correction`, are not ported yet).

The ORB-SLAM recipe the reference left as a TODO
(src/Module/VisualOdometry.cpp:101-104): BoW similarity against every
keyframe, descriptor matching against the best candidates' landmark-bearing
features, a P3P-RANSAC pose seed and a robust pose-only BA, the best
candidate by inliers.  The JAX package `vmap`s the candidates; here they
are one batch, with two kernel launches per attempt: every candidate's
Hamming matrix in one K10 launch (the candidates' features gathered into
one contiguous table, each matcher handed its column block, as the
keyframe cycle's triangulation does) and every candidate's pose solve in
one K8 launch (K5's body once per candidate).  The archive tier
(`relocalize_archive`) ranks the archived keyframes by descriptor match
counts (K10 again, `hamming.archive_match_scores`) before the same two
launches.  Loop detection verifies one candidate per keyframe with one K10
and one K5 launch, and a found loop is closed by the SE(3) pose graph
(`solvers/pose_graph.py`).  Nothing waits for the device until the caller
reads `success` or `found`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geometry.se3 import SE3
from ..map import state as ms
from ..map import vocabulary as voc
from ..map.archive import ArchiveView
from ..ops.hamming import archive_match_scores, distance_matrix, match_nn, rotation_consistency
from ..ops.kernels.pose_ba_fused_batch import pose_only_ba_fused_batch
from ..ops.select import top_k
from ..solvers import pnp
from ..solvers import pose_graph as pg
from ..solvers.ba import pose_only_ba

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
    match_pts = pt_pos[torch.gather(pt_safe, 1, torch.clamp(idx, 0, F - 1).long())]  # [C, Nq, 3]
    T_opt, cand_inl, draws = _solve_candidates(cam, match_pts, q_px, ok, kf_pose7[cand], cand,
                                               use_pnp, pnp_hyps, generator, draws, 17)
    best = torch.argmax(cand_inl)
    n_inl = cand_inl[best]
    if stages is not None:
        stages["attempt"] = RelocAttempt(scores=scores, cand=cand,
                                         match_idx=torch.where(ok, idx, -1), draws=draws,
                                         T_cand=T_opt, n_inl=cand_inl)
    return RelocResult(success=n_inl >= min_inliers, T_cw=SE3(T_opt.R[best], T_opt.t[best]),
                       n_inliers=n_inl, kf_slot=cand[best])


def _solve_candidates(cam, match_pts, q_px, ok, stored_pose7, cand, use_pnp: bool,
                      pnp_hyps: int, generator, draws, seed: int):
    """Every candidate's pose from its matches (match_pts [C, Nq, 3], the
    query pixels q_px [Nq, 2], the match masks ok [C, Nq]): a P3P-RANSAC
    seed (`use_pnp`; the stored pose `stored_pose7 [C, 7]` where the seed is
    unusable or has fewer than PNP_MIN_INLIERS inliers), then pose-only BA,
    all candidates in one K8 launch on undistorted pixels.  The triples come
    from `draws` (a tensor, or a function of (ok, cand)), else from
    `generator` (a fresh one seeded `seed` if none).  Returns (poses SE3
    [C], BA inlier counts [C], the draws or None)."""
    C = ok.shape[0]
    q_px_c = q_px[None].expand(C, -1, -1)
    T_stored = SE3.from_params7(stored_pose7)
    if use_pnp:
        if callable(draws):
            draws = draws(ok, cand)
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=ok.device).manual_seed(seed)
            draws = pnp.sample_triples(ok, pnp_hyps, generator)
        pr = pnp.ransac_pnp_from_samples(match_pts, q_px_c, ok, cam, draws)
        seed_ok = (pr.ok & (pr.n_inliers >= PNP_MIN_INLIERS))[:, None]
        T_init = SE3(torch.where(seed_ok[..., None], pr.T_cw.R, T_stored.R),
                     torch.where(seed_ok, pr.T_cw.t, T_stored.t))
    else:
        T_init, draws = T_stored, None
    # Pose-only BA takes ideal-pinhole pixels (as solvers.ba.pose_only_ba).
    T_opt, inlier, _ = pose_only_ba_fused_batch(T_init, match_pts, cam.undistort_px(q_px_c), ok,
                                                cam)
    return T_opt, inlier.sum(dim=1), draws


# Above this many archive rows a BoW prefilter keeps the best this many for
# the brute-force match-count scoring.
ARCHIVE_PREFILTER = 1024


def _archive_retrieval_scores(vocab: voc.Vocabulary, q_desc, q_valid, arc: ArchiveView,
                              row_mask) -> torch.Tensor:
    """[A] float retrieval scores of a query frame over the archive: the
    descriptor match count (`hamming.archive_match_scores`, K10), masked
    rows at -1.  Above ARCHIVE_PREFILTER rows the BoW L1 score preselects
    the best ARCHIVE_PREFILTER rows (ties to the lower row, as
    `jax.lax.top_k`), and only those are scored."""
    A = arc.bow.shape[0]
    c_valid = arc.feat_valid & arc.pt_ok
    if A > ARCHIVE_PREFILTER:
        words, _ = voc.transform(vocab, q_desc, q_valid)
        q_bow = voc.bow_vector(vocab, words, q_valid)
        bow_s = voc.score_l1(q_bow[None, :], arc.bow)
        _, pre = top_k(torch.where(row_mask, bow_s, -1.0), ARCHIVE_PREFILTER)
        m = archive_match_scores(q_desc, q_valid, arc.desc[pre], c_valid[pre])
        scores = torch.full((A,), -1.0, dtype=torch.float32, device=q_desc.device).index_copy(
            0, pre, m.to(torch.float32))
        return torch.where(row_mask, scores, -1.0)
    m = archive_match_scores(q_desc, q_valid, arc.desc, c_valid)
    return torch.where(row_mask, m.to(torch.float32), -1.0)


def relocalize_archive(vocab: voc.Vocabulary, cam, q_desc, q_px, q_valid, arc: ArchiveView,
                       min_inliers: int = 20, q_angle=None, top_c: int = 3,
                       use_pnp: bool = True, pnp_hyps: int = 256,
                       generator: torch.Generator | None = None,
                       draws: torch.Tensor | Callable | None = None,
                       stages: dict | None = None) -> RelocResult:
    """Relocalization against the archived keyframes (the JAX
    `relocalize_archive`): `relocalize`'s recipe with the candidates ranked
    by `_archive_retrieval_scores` over the rows `arc.valid` admits and
    their landmarks taken from the snapshot (`arc.pt_pos`, `arc.pt_ok`).
    The candidates' matching is one K10 launch on their gathered
    descriptors, their pose solves one K8 launch; a candidate whose score
    is below 0 (a masked row) counts 0 inliers, so it never wins.  The
    returned kf_slot is the archive row.  `generator` (a fresh one seeded
    23 if none is given), `draws` and `stages` as in `relocalize` (the
    attempt's `scores` are the retrieval scores)."""
    F = arc.nodes.shape[1]
    scores = _archive_retrieval_scores(vocab, q_desc, q_valid, arc, arc.valid)
    c_scores, cand = top_k(scores, min(top_c, scores.shape[0]))
    c_valid = arc.feat_valid[cand] & arc.pt_ok[cand]
    c_angle = None if q_angle is None else arc.angle[cand]
    idx, ok = candidate_matches(q_desc, q_valid, arc.desc[cand], c_valid, q_angle, c_angle)
    match_pts = torch.gather(arc.pt_pos[cand], 1,
                             torch.clamp(idx, 0, F - 1).long()[..., None].expand(-1, -1, 3))
    T_opt, cand_inl, draws = _solve_candidates(cam, match_pts, q_px, ok, arc.pose7[cand], cand,
                                               use_pnp, pnp_hyps, generator, draws, 23)
    cand_inl = torch.where(c_scores >= 0, cand_inl, 0)
    best = torch.argmax(cand_inl)
    n_inl = cand_inl[best]
    if stages is not None:
        stages["attempt"] = RelocAttempt(scores=scores, cand=cand,
                                         match_idx=torch.where(ok, idx, -1), draws=draws,
                                         T_cand=T_opt, n_inl=cand_inl)
    return RelocResult(success=n_inl >= min_inliers, T_cw=SE3(T_opt.R[best], T_opt.t[best]),
                       n_inliers=n_inl, kf_slot=cand[best])


class LoopResult(NamedTuple):
    found: torch.Tensor     # bool
    loop_kf: torch.Tensor   # the candidate keyframe slot
    T_loop7: torch.Tensor   # verified relative pose T_new * T_loop^-1
    scale: torch.Tensor     # relative map scale (1: active-window loops share one landmark array)
    n_inl: torch.Tensor | int = 0   # the candidate's pose-BA inliers


def detect_loop(vocab: voc.Vocabulary, cam, new_slot,
                kf_bow, kf_valid, kf_pose7, cov_weight,
                feat_desc_flat, feat_nodes_flat, feat_px_flat, feat_point_flat, feat_valid_flat,
                pt_pos, pt_valid, min_inliers: int = 25, min_score_ratio: float = 0.75,
                feat_angle_flat=None) -> LoopResult:
    """Loop detection and geometric verification for the newly inserted
    keyframe `new_slot` against the active window (the JAX `detect_loop`).

    The candidate is the keyframe not covisible with the new one whose BoW
    score is best; it is plausible above `min_score_ratio` x the best
    covisible score (at least 0.05).  Verification matches the new
    keyframe's features against the candidate's landmark-bearing features
    (nearest neighbour within MATCH_MAX_DIST, cross-checked, no ratio test
    or node gate; one K10 launch, [F, F]), filters them by the rotation
    histogram and solves the new keyframe's pose against the candidate's
    landmarks by pose-only BA (one K5 launch); found at `min_inliers`."""
    K = kf_valid.shape[0]
    F = feat_valid_flat.shape[0] // K
    dev = kf_valid.device
    v_new = ms.row(kf_bow, new_slot)
    scores = voc.score_l1(v_new[None, :], kf_bow)
    covis = ms.row(cov_weight, new_slot) > 0
    is_self = torch.arange(K, device=dev) == new_slot
    s_cov = torch.where(covis & kf_valid & ~is_self, scores, -1.0)
    s_ref = torch.clamp(torch.amax(s_cov), min=0.05)
    cand_scores = torch.where(kf_valid & ~covis & ~is_self, scores, -1.0)
    best = torch.argmax(cand_scores)
    plausible = cand_scores[best] > min_score_ratio * s_ref
    ar = torch.arange(F, device=dev)
    q_rows = new_slot * F + ar
    c_rows = best * F + ar
    c_point = feat_point_flat[c_rows]
    pt_safe = torch.clamp(c_point, 0, pt_pos.shape[0] - 1).long()
    c_valid = feat_valid_flat[c_rows] & (c_point >= 0) & pt_valid[pt_safe]
    q_desc = feat_desc_flat[q_rows]
    idx, ok = match_nn(q_desc, None, feat_valid_flat[q_rows], c_valid, max_dist=MATCH_MAX_DIST,
                       ratio=1.0, cross_check=True,
                       d=distance_matrix(q_desc, feat_desc_flat[c_rows]))
    idx_safe = torch.clamp(idx, 0, F - 1).long()
    if feat_angle_flat is not None:
        ok = rotation_consistency(feat_angle_flat[q_rows], feat_angle_flat[c_rows][idx_safe], ok)
    match_pts = pt_pos[pt_safe[idx_safe]]
    T_opt, inlier, _ = pose_only_ba(SE3.from_params7(ms.row(kf_pose7, new_slot)), match_pts,
                                    feat_px_flat[q_rows], ok, cam)
    n_inl = inlier.sum()
    found = plausible & (n_inl >= min_inliers)
    T_loop = T_opt.compose(SE3.from_params7(kf_pose7[best]).inverse())
    return LoopResult(found=found, loop_kf=best, T_loop7=T_loop.params7(),
                      scale=torch.ones((), dtype=torch.float32, device=dev), n_inl=n_inl)


def close_loop(kf_pose7, kf_valid, cov_weight, pt_pos, pt_valid, pt_first_kf, new_slot,
               loop: LoopResult, n_iter: int = 20, feat_point=None, feat_valid=None):
    """Apply a verified loop (the JAX `close_loop`): a pose graph over the
    covisibility edges plus the loop edge (loop_kf -> new_slot, weight 10,
    masked by `loop.found`; `loop_kf` fixed), then every landmark re-anchored
    by the correction of a keyframe that observes it (the highest such slot;
    its first keyframe where none does): p' = T_new^-1 T_old p.  Returns
    (kf_pose7, pt_pos, chi2), the inputs unchanged where `loop.found` is
    false; no host sync."""
    K = kf_valid.shape[0]
    dev = kf_valid.device
    edges = pg.edges_from_covisibility(kf_pose7, cov_weight, kf_valid)
    i_loop = loop.loop_kf.reshape(1).to(torch.int32)
    edges = pg.PoseGraphEdges(
        i=torch.cat([edges.i, i_loop]),
        j=torch.cat([edges.j, torch.full((1,), new_slot, dtype=torch.int32, device=dev)]),
        T_ji7=torch.cat([edges.T_ji7, loop.T_loop7[None]]),
        weight=torch.cat([edges.weight, torch.full((1,), 10.0, device=dev)]),
        mask=torch.cat([edges.mask, loop.found.reshape(1)]))
    poses_old = SE3.from_params7(kf_pose7)
    fixed = torch.zeros(K, dtype=torch.bool, device=dev).index_fill(0, i_loop.long(), True)
    poses_new, chi2 = pg.optimize(poses_old, edges, fixed, n_iter=n_iter)
    anchor = torch.clamp(pt_first_kf, 0, K - 1).long()
    if feat_point is not None and feat_valid is not None:
        L = pt_pos.shape[0]
        link_ok = feat_valid & (feat_point >= 0) & kf_valid[:, None]
        fp_safe = torch.clamp(feat_point, 0, L - 1).long()
        slot_of = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand_as(feat_point)
        obs_anchor = torch.full((L,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, fp_safe.reshape(-1), torch.where(link_ok, slot_of, -1).reshape(-1), "amax")
        anchor = torch.where(obs_anchor >= 0, obs_anchor.long(), anchor)
    p_cam = SE3(poses_old.R[anchor], poses_old.t[anchor]).apply(pt_pos)
    pt_new = SE3(poses_new.R[anchor], poses_new.t[anchor]).inverse().apply(p_cam)
    pt_new = torch.where(pt_valid[:, None], pt_new, pt_pos)
    pose7_out = torch.where(loop.found, poses_new.params7(), kf_pose7)
    pt_out = torch.where(loop.found, pt_new, pt_pos)
    return pose7_out, pt_out, chi2
