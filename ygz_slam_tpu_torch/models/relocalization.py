"""Relocalization and loop closing over the BoW vocabulary (counterpart of
ygz_slam_tpu/models/relocalization.py: `RelocResult`, `relocalize`,
`relocalize_archive`, `LoopResult`, `detect_loop`, `close_loop`,
`detect_loop_archive`, `apply_global_correction`, `close_loop_global` and
`close_loop_global_sim3`).

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
launches.  Loop detection within the window verifies one candidate per
keyframe with one K10 and one K5 launch, and a found loop is closed by the
SE(3) pose graph (`solvers/pose_graph.py`).  Loop detection against the
archive (`detect_loop_archive`) is `relocalize_archive`'s recipe for a new
keyframe (its retrieval, one K10 launch for the candidates' matching, one
K8 launch for their pose solves) plus each candidate's relative map scale;
a found archive loop is closed by the global pose graph over the archived
and active keyframes (`close_loop_global_sim3`, Sim(3), or
`close_loop_global`, SE(3): the graph assembled on the host in numpy as the
JAX package does, the padded solve on the device), and the map follows the
corrected keyframes (`apply_global_correction`).  Nothing waits for the
device until the caller reads `success` or `found`, but the global closures,
which return numpy.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry.se3 import SE3
from ..geometry.sim3 import Sim3
from ..map import state as ms
from ..map import vocabulary as voc
from ..map.archive import ArchiveView
from ..ops.hamming import archive_match_scores, distance_matrix, match_nn, rotation_consistency
from ..ops.kernels.pose_ba_fused_batch import pose_only_ba_fused_batch
from ..ops.select import top_k
from ..solvers import pnp
from ..solvers import pose_graph as pg
from ..solvers.ba import pose_only_ba
from ..utils import np_se3

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
    T_opt, inlier, draws = _solve_candidates(cam, match_pts, q_px, ok, kf_pose7[cand], cand,
                                             use_pnp, pnp_hyps, generator, draws, 17)
    cand_inl = inlier.sum(dim=1)
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
    [C], BA inlier masks [C, Nq], the draws or None)."""
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
    return T_opt, inlier, draws


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
    T_opt, inlier, draws = _solve_candidates(cam, match_pts, q_px, ok, arc.pose7[cand], cand,
                                             use_pnp, pnp_hyps, generator, draws, 23)
    cand_inl = torch.where(c_scores >= 0, inlier.sum(dim=1), 0)
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


LOOP_ARC_SEED = 29      # the P3P draws' generator seed of `detect_loop_archive`
MIN_SCALE_PAIRS = 16    # matched landmark pairs the loop's scale estimate needs


def detect_loop_archive(vocab: voc.Vocabulary, cam, new_slot, new_frame_id,
                        kf_bow, kf_valid, cov_weight,
                        feat_desc_flat, feat_nodes_flat, feat_px_flat, feat_valid_flat,
                        kf_pose7, arc: ArchiveView, min_frame_gap: int = 50,
                        min_inliers: int = 25, min_score_ratio: float = 0.75,
                        feat_angle_flat=None, feat_point_flat=None, pt_pos=None, pt_valid=None,
                        use_pnp: bool = True, top_c: int = 8, pnp_hyps: int = 256,
                        generator: torch.Generator | None = None,
                        draws: torch.Tensor | Callable | None = None,
                        stages: dict | None = None) -> LoopResult:
    """Loop detection for the new keyframe `new_slot` (frame
    `new_frame_id`) against the archive (the JAX `detect_loop_archive`): the
    long loops the active window cannot hold.  The returned loop_kf is the
    archive row.

    1. Archive rows at least `min_frame_gap` frames older than the keyframe
       are ranked by `_archive_retrieval_scores` (the descriptor match
       count: one K10 launch per 512 rows); the `top_c` best are the
       candidates, plausible where the score reaches `min_inliers`
       (`min_score_ratio` is the JAX signature's, unused there too).
    2. The keyframe's features are matched against each candidate's
       landmark-bearing features (`candidate_matches`: one K10 launch), the
       rotation histogram filtering them where angles are given.
    3. Each candidate's pose of the keyframe: a P3P-RANSAC seed (`use_pnp`;
       the keyframe's stored pose where the seed is unusable), then pose-only
       BA, all candidates in one K8 launch (`_solve_candidates`, draws from
       a generator seeded LOOP_ARC_SEED unless `generator` or `draws` are
       given).  T_loop7 = T_opt * T_arc^-1.
    4. Each candidate's relative map scale, the spread ratio of the BA
       inliers' live landmarks (`feat_point_flat`, `pt_pos`, `pt_valid`)
       against their archived positions (Horn's closed-form similarity
       scale), 1 without the live links or where fewer than
       MIN_SCALE_PAIRS pairs, a degenerate spread or a non-finite ratio.
    5. The plausible candidate with the most BA inliers (the first on ties)
       wins; found at `min_inliers`.

    `stages`, a dict if given, receives the attempt's RelocAttempt (its
    `scores` are the retrieval scores) and the candidates' scales under
    "scale"."""
    K = kf_valid.shape[0]
    F = arc.nodes.shape[1]
    Fq = feat_valid_flat.shape[0] // K
    dev = kf_valid.device
    q_rows = new_slot * Fq + torch.arange(Fq, device=dev)
    q_desc, q_px, q_valid = feat_desc_flat[q_rows], feat_px_flat[q_rows], feat_valid_flat[q_rows]
    gap_ok = arc.frame_id < (new_frame_id - min_frame_gap)
    scores = _archive_retrieval_scores(vocab, q_desc, q_valid, arc, arc.valid & gap_ok)
    c_scores, cand = top_k(scores, min(top_c, scores.shape[0]))
    plausible = c_scores >= float(min_inliers)
    c_valid = arc.feat_valid[cand] & arc.pt_ok[cand]
    q_angle = None if feat_angle_flat is None else feat_angle_flat[q_rows]
    c_angle = None if feat_angle_flat is None else arc.angle[cand]
    idx, ok = candidate_matches(q_desc, q_valid, arc.desc[cand], c_valid, q_angle, c_angle)
    match_pts = torch.gather(arc.pt_pos[cand], 1,
                             torch.clamp(idx, 0, F - 1).long()[..., None].expand(-1, -1, 3))
    C = cand.shape[0]
    stored = ms.row(kf_pose7, new_slot)[None].expand(C, -1)
    T_opt, inlier, draws = _solve_candidates(cam, match_pts, q_px, ok, stored, cand, use_pnp,
                                             pnp_hyps, generator, draws, LOOP_ARC_SEED)
    T_loop = T_opt.compose(SE3.from_params7(arc.pose7[cand]).inverse())
    scale = torch.ones(C, dtype=q_px.dtype, device=dev)
    if feat_point_flat is not None and pt_pos is not None:
        q_point = feat_point_flat[q_rows]
        q_safe = torch.clamp(q_point, 0, pt_pos.shape[0] - 1).long()
        q_lm_ok = q_valid & (q_point >= 0)
        if pt_valid is not None:
            q_lm_ok = q_lm_ok & pt_valid[q_safe]
        wp = (inlier & q_lm_ok[None]).to(q_px.dtype)                      # [C, Nq]
        n_pair = torch.clamp(wp.sum(dim=1), min=1.0)
        q_pts = pt_pos[q_safe][None]                                      # [1, Nq, 3]
        cq = (q_pts * wp[..., None]).sum(dim=1) / n_pair[:, None]
        cc = (match_pts * wp[..., None]).sum(dim=1) / n_pair[:, None]
        var_q = (wp * ((q_pts - cq[:, None]) ** 2).sum(dim=-1)).sum(dim=1)
        var_c = (wp * ((match_pts - cc[:, None]) ** 2).sum(dim=-1)).sum(dim=1)
        raw = torch.sqrt(var_q / torch.clamp(var_c, min=1e-12))
        usable = (wp.sum(dim=1) >= MIN_SCALE_PAIRS) & (var_c > 1e-9) & torch.isfinite(raw)
        scale = torch.where(usable, raw, 1.0)
    cand_inl = torch.where(plausible, inlier.sum(dim=1), 0)
    best = torch.argmax(cand_inl)
    n_inl = cand_inl[best]
    if stages is not None:
        stages["attempt"] = RelocAttempt(scores=scores, cand=cand,
                                         match_idx=torch.where(ok, idx, -1), draws=draws,
                                         T_cand=T_opt, n_inl=cand_inl)
        stages["scale"] = scale
    return LoopResult(found=n_inl >= min_inliers, loop_kf=cand[best],
                      T_loop7=T_loop.params7()[best], scale=scale[best], n_inl=n_inl)


def apply_global_correction(mstate: ms.MapState, new_pose7, new_scale=None) -> ms.MapState:
    """Globally corrected keyframe poses `new_pose7` [K, 7] written into the
    map, each landmark moved with the correction of a keyframe that observes
    it (the highest such slot; its first keyframe where none does, a window
    slot that may have been recycled), p' = T_new^-1 T_old p; with
    `new_scale` [K] (the Sim(3) correction scale per keyframe, `new_pose7`
    holding t / s) the anchor is a similarity, p' = S_new^-1(T_old(p)) with
    S_new = (R_new, s t_new, s).  The JAX `apply_global_correction`; no host
    sync."""
    m = mstate
    K = m.kf_pose7.shape[0]
    L = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    fp = m.feat_point
    link_ok = m.feat_valid & (fp >= 0) & m.kf_valid[:, None]
    fp_safe = torch.clamp(fp, 0, L - 1).long()
    slot_of = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand_as(fp)
    obs_anchor = torch.full((L,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, fp_safe.reshape(-1), torch.where(link_ok, slot_of, -1).reshape(-1), "amax")
    anchor = torch.where(obs_anchor >= 0, obs_anchor,
                         torch.clamp(m.pt_first_kf, 0, K - 1)).long()
    T_old = SE3.from_params7(m.kf_pose7[anchor])
    T_new = SE3.from_params7(new_pose7[anchor])
    p_cam = T_old.apply(m.pt_pos)
    if new_scale is None:
        p = T_new.inverse().apply(p_cam)
    else:
        s_a = new_scale[anchor]
        p = Sim3(T_new.R, T_new.t * s_a[:, None], s_a).inverse().apply(p_cam)
    p = torch.where(m.pt_valid[:, None], p, m.pt_pos)
    return m._replace(kf_pose7=new_pose7, pt_pos=p)


def _next_pow2(n: int, lo: int = 16) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _global_graph(arc_pose7, arc_frame_id, act_pose7, act_frame_id, act_cov, loop_arc_idx: int,
                  new_act_idx: int, T_loop7):
    """The global pose graph's nodes and edges on the host (the JAX numpy
    assembly): the archived then the active poses [N, 7]; sequential
    odometry edges between temporally consecutive keyframes at their
    current relative poses (weight 1), active covisibility edges of at
    least 10 (weight sqrt(cov)), the loop edge (archive row -> the new
    keyframe, weight 10).  Returns (pose7 [N, 7], e_i, e_j, e_T7 [E, 7],
    e_w), the loop edge last."""
    A = arc_pose7.shape[0]
    ids = np.concatenate([arc_frame_id, act_frame_id])
    pose7 = np.concatenate([arc_pose7, act_pose7]).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    si, sj = order[:-1].astype(np.int32), order[1:].astype(np.int32)
    T_ji_seq = np_se3.relative7(pose7[sj], pose7[si]).astype(np.float32)
    w_seq = np.full(len(si), 1.0, np.float32)
    ai, aj = np.nonzero(np.triu(act_cov, 1) >= 10)
    ci, cj = (A + ai).astype(np.int32), (A + aj).astype(np.int32)
    T_ji_cov = np_se3.relative7(pose7[cj], pose7[ci]).astype(np.float32)
    w_cov = np.sqrt(np.maximum(act_cov[ai, aj], 1.0)).astype(np.float32)
    e_i = np.concatenate([si, ci, np.asarray([loop_arc_idx], np.int32)])
    e_j = np.concatenate([sj, cj, np.asarray([A + new_act_idx], np.int32)])
    e_T7 = np.concatenate([T_ji_seq, T_ji_cov, np.asarray(T_loop7, np.float32)[None]])
    e_w = np.concatenate([w_seq, w_cov, np.asarray([10.0], np.float32)])
    return pose7, e_i, e_j, e_T7, e_w


def _padded(nodes: np.ndarray, ident: np.ndarray, e_i, e_j, e_meas, e_w, loop_arc_idx: int):
    """Nodes and edges padded to power-of-two capacities (P, EP), as the
    JAX package pads them for its shape-cached jit: padding nodes at the
    identity and fixed, the loop's archive node fixed, padding edges masked
    at the identity.  Returns numpy (nodes [P, d], e_i, e_j, e_meas, e_w,
    e_mask, fixed)."""
    N, E = nodes.shape[0], len(e_i)
    P, EP = _next_pow2(N), _next_pow2(E)
    nodes_p = np.tile(ident, (P, 1))
    nodes_p[:N, :nodes.shape[1]] = nodes
    fixed = np.ones(P, bool)
    fixed[:N] = False
    fixed[loop_arc_idx] = True
    e_mask = np.zeros(EP, bool)
    e_mask[:E] = True

    def pad(a, fill):
        return np.concatenate([a, np.full((EP - E,) + a.shape[1:], fill, a.dtype)])

    return (nodes_p, pad(e_i, 0), pad(e_j, 0), np.concatenate([e_meas, np.tile(ident, (EP - E, 1))]),
            pad(e_w, 0.0), e_mask, fixed)


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def close_loop_global(arc_pose7, arc_frame_id, act_pose7, act_frame_id, act_cov,
                      loop_arc_idx: int, new_act_idx: int, T_loop7, n_iter: int = 25,
                      device=None, stats: dict | None = None):
    """Global SE(3) pose graph over the whole trajectory, archived and
    active keyframes (the JAX `close_loop_global`): `_global_graph`'s nodes
    and edges, assembled on the host in numpy, padded to power-of-two node
    and edge capacities and solved by `pose_graph.optimize` on `device` (the
    card unless named), anchored on the archived loop keyframe.  Returns
    numpy (arc_pose7_new [A, 7], act_pose7_new [Ka, 7]) and the final chi2
    as a float; `stats`, a dict if given, receives the capacities (P, EP)."""
    dev = resolve_device(device)
    A = arc_pose7.shape[0]
    pose7, e_i, e_j, e_T7, e_w = _global_graph(arc_pose7, arc_frame_id, act_pose7, act_frame_id,
                                               act_cov, loop_arc_idx, new_act_idx, T_loop7)
    N = pose7.shape[0]
    ident7 = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    padded = _padded(pose7, ident7, e_i, e_j, e_T7, e_w, loop_arc_idx)
    pose7_p, i_p, j_p, T7_p, w_p, mask_p, fixed_p = _on(dev, *padded)
    if stats is not None:
        stats.update(P=pose7_p.shape[0], EP=i_p.shape[0])
    p, chi2 = pg.optimize(SE3.from_params7(pose7_p), pg.PoseGraphEdges(i_p, j_p, T7_p, w_p, mask_p),
                          fixed_p, n_iter=n_iter)
    out7 = p.params7()[:N].cpu().numpy()
    return out7[:A], out7[A:], float(chi2)


def close_loop_global_sim3(arc_pose7, arc_frame_id, act_pose7, act_frame_id, act_cov,
                           loop_arc_idx: int, new_act_idx: int, T_loop7, loop_scale: float = 1.0,
                           n_iter: int = 30, device=None, stats: dict | None = None):
    """The 7-DoF global pose graph (the JAX `close_loop_global_sim3`): the
    monocular loop closure that also absorbs scale drift.  `_global_graph`'s
    edges lifted into Sim(3) with unit relative scale; the loop edge the
    measured similarity S_ji = (R_loop, lambda t_loop, lambda), lambda =
    `loop_scale` (the matched landmarks' spread ratio).  Solved by
    `pose_graph.optimize_sim3` on `device` after the same padding, anchored
    on the archived loop keyframe (the rigid gauge and the global scale).
    Returns numpy (arc_pose7_new, act_pose7_new: SE(3) poses, t / s), their
    correction scales (arc_scale [A], act_scale [Ka]) and the chi2 as a
    float; `stats` as in `close_loop_global`."""
    dev = resolve_device(device)
    A = arc_pose7.shape[0]
    pose7, e_i, e_j, e_T7, e_w = _global_graph(arc_pose7, arc_frame_id, act_pose7, act_frame_id,
                                               act_cov, loop_arc_idx, new_act_idx, T_loop7)
    N = pose7.shape[0]
    lam = float(loop_scale)
    T_loop = e_T7[-1]
    S_loop8 = np.concatenate([T_loop[:4], lam * T_loop[4:7], [lam]]).astype(np.float32)
    e_S8 = np.concatenate([np.concatenate([e_T7[:-1], np.ones((len(e_T7) - 1, 1), np.float32)],
                                          axis=1), S_loop8[None]])
    ident8 = np.asarray([1, 0, 0, 0, 0, 0, 0, 1], np.float32)
    padded = _padded(pose7, ident8, e_i, e_j, e_S8, e_w, loop_arc_idx)
    pose8_p, i_p, j_p, S8_p, w_p, mask_p, fixed_p = _on(dev, *padded)
    if stats is not None:
        stats.update(P=pose8_p.shape[0], EP=i_p.shape[0])
    p, chi2 = pg.optimize_sim3(Sim3.from_params8(pose8_p),
                               pg.Sim3Edges(i_p, j_p, S8_p, w_p, mask_p), fixed_p, n_iter=n_iter)
    out8 = p.params8()[:N].cpu().numpy()
    scale = out8[:, 7]
    out7 = out8[:, :7].copy()
    out7[:, 4:7] /= scale[:, None]
    return out7[:A], out7[A:], scale[:A], scale[A:], float(chi2)
