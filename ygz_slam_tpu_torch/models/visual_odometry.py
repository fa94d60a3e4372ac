"""VisualOdometry: the monocular frontend state machine over the VO's
per-frame map-tracking step and keyframe cycle (counterpart of
ygz_slam_tpu/models/visual_odometry.py, SPARSE_DIRECT, synchronous mapping,
with the depth filter, without vocabulary or keyframe archive).

The device steps are plain functions over MapState (`track`,
`triangulate`, `free_rows`, `assemble_keyframe`, `kf_cycle`: the JAX
package's `_track`, `_triangulate`, `_free_rows_device`, `_assemble_core`
and `_kf_cycle`; `mapping_pass`: its `_map_pass` without loop closing).
`VisualOdometry` is the host state machine around them
(NOT_READY/INITING/GOOD/LOST, VisualOdometry.cpp:38-107): monocular
initialization (KLT, descriptor re-check, RANSAC H/F, two-view BA, mean
depth 1, the first local BA), tracking with inlier-gate hysteresis, the
keyframe decision, keyframe insertion and the mapping pass, and lost
handling with a retry and a reset.  Its host syncs (`int(...)`,
`bool(...)`) are the JAX package's own.

Per frame (`track`): sparse-direct alignment of NS selected landmarks
against the previous frame (K1 x 2, K3), the NSV best visible landmarks'
affine-warped reference patches from the keyframe images, their patch
search on the pyramid's levels (K2, K4), pose-only BA (K5), and the landmark
statistics; then, with depth-filter seeds, their update at the refined pose
(`update_seeds`: align1d along each seed's epipolar line in the frame,
triangulation, the Gaussian-Beta posterior; `map/depth_filter.py`).  Per
keyframe (`kf_cycle`): slot allocation or eviction, detection,
triangulation against two neighbour keyframes (their two Hamming matrices
in one K10 launch) and fusion with the map (K10), insertion, the converged
seeds promoted to landmarks and new seeds on the depthless detections.
Everything stays on the device: selections that the JAX version makes with
`jnp.where` are `torch.where` here, and slots are 0-d tensors.

Chunked tracking (`VisualOdometry.add_frames`, the JAX package's scan over
ordinary frames) runs `ChunkStep`, the per-frame step over static buffers:
a CUDA graph replayed per frame on the card, eager on the CPU; the host
decides each frame as the per-frame path does, so the two equal bit for
bit.
"""
from __future__ import annotations

import collections
import dataclasses
import enum

import numpy as np
import torch

from .. import resolve_device
from ..geometry.se3 import SE3
from ..map import depth_filter as dfilt
from ..map import state as ms
from ..map.memory import MapServer, refresh_covisibility
from ..ops import kernels, orb, sparse_align
from ..ops.align import klt_pyramidal
from ..ops.hamming import distance_matrix, hamming_distance
from ..ops.select import top_k
from ..solvers import ba as bam
from ..solvers import initializer as init_mod
from ..utils import np_se3
from . import frontend as fe
from . import local_mapping as lm

INT32_MAX = 2 ** 31 - 1


class Status(enum.Enum):
    NOT_READY = 0
    INITING = 1
    GOOD = 2
    LOST = 3


class VOType(enum.Enum):
    """Frontend method (system.h:26-30); the port runs SPARSE_DIRECT."""
    SPARSE_DIRECT = 0
    SPARSE_ORB = 1
    SEMI_DENSE_DIRECT = 2


@dataclasses.dataclass(frozen=True)
class VOOptions:
    """The fields of the JAX package's VOOptions that the port reads, with
    its defaults (config/default.yaml, VisualOdometry.h:32-45).  Of the
    last five, the port runs `use_depth_filter`; the other four name parts
    of the JAX package it does not run: `VisualOdometry` raises unless each
    is off (False, SPARSE_DIRECT)."""
    n_levels: int = 3
    detect_threshold: float = 20.0
    grid_cell: int = 16
    feat_budgets: tuple = (160, 64, 32)   # per-level detection budgets
    init_min_features: int = 80           # init.min_features
    init_check_descriptors: bool = True   # CheckFrameDescriptors (Matcher.cpp:45-84)
    init_desc_max_dist: int = 100
    init_min_disparity: float = 20.0      # init.min_disparity, px
    init_min_inliers: int = 40            # init.min_inliers
    min_track_inliers: int = 30           # TrackLocalMap gate
    track_confirm_frames: int = 2         # sub-gate frames in a row before LOST
    track_inlier_floor: int = 0           # immediate-LOST floor (0: min_track_inliers // 2)
    kf_min_frames: int = 10               # keyframe.min_frames
    kf_max_rot: float = 0.1               # keyframe.max_rot, rad
    kf_max_trans: float = 0.1             # keyframe.max_trans, map units
    max_alignment_motion: float = 0.2     # Matcher.h:30
    max_step_motion: float = 0.2          # gate on the pose-BA correction
    map_K: int = 10
    map_F: int = 256
    map_L: int = 3072                     # >= map_K * map_F
    local_ba_iters: int = 8
    lost_reset_frames: int = 10
    lost_desc_max_dist: int = 64          # Hamming bound of the lost-retry re-check
    kf_cull_min_window: int = 4           # KeyFrameCulling keeps at least this many
    chunk_frames: int = 32                # add_frames: frames per chunk
    use_depth_filter: bool = True
    use_vocabulary: bool = True
    archive_map: bool = True
    async_mapping: bool = True
    vo_type: VOType = VOType.SPARSE_DIRECT

    @property
    def n_select(self) -> int:
        """NS: landmarks sparse alignment runs on."""
        return min(256, self.map_L)

    @property
    def n_visible(self) -> int:
        """NSV: visible landmarks the patch search runs on."""
        return min(512, self.map_L)


def tracked_selection(o: VOOptions, mstate: ms.MapState, prev_T_cw: SE3, prev_found):
    """The NS landmark rows sparse alignment runs on: last frame's
    observations with depth = landmark z in the previous camera.  A
    fixed-size selection, the first NS tracked rows (it is all ties).
    Returns (rows [NS], their depths [NS], their mask [NS])."""
    z_prev = prev_T_cw.apply(mstate.pt_pos)[:, 2]
    ref_mask = prev_found & mstate.pt_valid & (z_prev > 0.05)
    _, sel = top_k(ref_mask.float(), o.n_select)
    return sel, z_prev[sel], ref_mask[sel]


def visible_selection(cam, o: VOOptions, mstate: ms.MapState, T_cw: SE3, shape):
    """The NSV best landmark rows inside the frustum of an image of `shape`
    at pose T_cw, proven landmarks first ((found+1)/(visible+1);
    FindCandidates, LocalMapping.cpp:47-80).  Returns (rows [NSV], mask
    [NSV]: the row is in the frustum)."""
    pc = T_cw.apply(mstate.pt_pos)
    px = cam.camera_to_pixel(pc)
    H0, W0 = shape
    mb = 8.0
    vis = (mstate.pt_valid & (pc[:, 2] > 0.05) & (px[:, 0] >= mb) & (px[:, 1] >= mb)
           & (px[:, 0] < W0 - mb) & (px[:, 1] < H0 - mb))
    qual = (mstate.pt_found + 1).float() / (mstate.pt_visible + 1).float()
    _, sel = top_k(torch.where(vis, 1.0 + qual, 0.0), o.n_visible)
    return sel, vis[sel]


def visible_patches(cam, o: VOOptions, mstate: ms.MapState, kf_images, sel, sel_ok, T_cw: SE3):
    """`frontend.reference_patches_for_landmarks` for the landmark rows
    `sel`: (patches [NSV, 10, 10], ok [NSV], search level [NSV])."""
    return fe.reference_patches_for_landmarks(
        kf_images, mstate.kf_pose7, mstate.feat_px.reshape(-1, 2), mstate.feat_level.reshape(-1),
        mstate.pt_ref_feat[sel], mstate.pt_pos[sel], sel_ok, cam, T_cw,
        max_level=o.n_levels - 1)


def track(cam, o: VOOptions, prev_pyr, cur_pyr, prev_T_cw7, T_pred7, mstate: ms.MapState,
          kf_images, prev_found, prev_obs_px, on_stage=None):
    """One ordinary frame.  Returns (TrackMapResult over all L landmark
    rows, MapState with updated statistics, the alignment's motion-gate
    flag).  `on_stage(name)`, if given, is called as each stage ends
    ("sparse_align", "visible_patches", "local_map"): a caller that
    synchronises there reads the stages' times off the step itself."""
    stage_done = on_stage or (lambda name: None)
    prev_T_cw = SE3.from_params7(prev_T_cw7)
    L = o.map_L
    dev = mstate.pt_pos.device
    # (a) Sparse-direct alignment against the previous frame.
    sel, z_sel, mask_sel = tracked_selection(o, mstate, prev_T_cw, prev_found)
    tr = fe.track_ref_frame(prev_pyr, cur_pyr, cam, prev_T_cw, prev_obs_px[sel], z_sel, mask_sel,
                            SE3.from_params7(T_pred7), max_motion=o.max_alignment_motion)
    stage_done("sparse_align")
    # (b) The visible subset and its affine-warped reference patches.
    sel2, sel_ok = visible_selection(cam, o, mstate, tr.T_cw, cur_pyr[0].shape)
    patches, patch_ok, search_lvl = visible_patches(cam, o, mstate, kf_images, sel2, sel_ok,
                                                    tr.T_cw)
    stage_done("visible_patches")
    # (c) Map tracking + pose-only BA on the subset.
    tm_s = fe.track_local_map(cur_pyr, cam, tr.T_cw, mstate.pt_pos[sel2], sel_ok, patches,
                              patch_ok, search_lvl, max_step_motion=o.max_step_motion)
    # Scatter the subset's results back to map-capacity rows.
    tm = fe.TrackMapResult(
        T_cw=tm_s.T_cw, n_inliers=tm_s.n_inliers,
        candidate=torch.zeros(L, dtype=torch.bool, device=dev).index_copy(
            0, sel2, tm_s.candidate & sel_ok),
        found=torch.zeros(L, dtype=torch.bool, device=dev).index_copy(
            0, sel2, tm_s.found & sel_ok),
        obs_px=torch.zeros((L, 2), dtype=torch.float32, device=dev).index_copy(
            0, sel2, tm_s.obs_px))
    stage_done("local_map")
    # (d) Landmark statistics (MapPoint _cnt_visible / _cnt_found).
    mstate = mstate._replace(pt_visible=mstate.pt_visible + tm.candidate.to(torch.int32),
                             pt_found=mstate.pt_found + tm.found.to(torch.int32))
    return tm, mstate, tr.ok


def triangulate(cam, mstate: ms.MapState, feats_px, feats_valid, feats_angle, T_new7,
                nbr_slot, dist):
    """Match the new keyframe's detections against the unlinked features of
    keyframe `nbr_slot` and triangulate: (pos_world [N, 3], good [N],
    ref_idx [N]).  `dist` is the detections' Hamming distance matrix against
    that keyframe's F descriptors (`neighbour_distances`), so neither side's
    descriptors are read."""
    ref_free = ms.row(mstate.feat_valid, nbr_slot) & (ms.row(mstate.feat_point, nbr_slot) < 0)
    return lm.match_new_features_for_triangulation(
        cam, None, feats_px, feats_valid, SE3.from_params7(T_new7),
        None, ms.row(mstate.feat_px, nbr_slot), ref_free,
        mstate.kf_pose(nbr_slot), angle_new=feats_angle,
        angle_ref=ms.row(mstate.feat_angle, nbr_slot), dist=dist)


def neighbour_distances(mstate: ms.MapState, feats_desc, nbr_slots):
    """The detections' Hamming distances against each neighbour keyframe's
    F descriptors, from one K10 launch over the neighbours' rows stacked:
    a [N, F] column block of one [N, F * len(nbr_slots)] matrix each."""
    F = mstate.feat_desc.shape[1]
    d = distance_matrix(feats_desc, torch.cat([ms.row(mstate.feat_desc, s) for s in nbr_slots]))
    return [d[:, k * F:(k + 1) * F] for k in range(len(nbr_slots))]


def free_rows(pt_valid: torch.Tensor, want: int):
    """The first `want` free landmark rows in ascending order (padded with
    L - 1) and how many of them are free: (rows [want] int32, n_free)."""
    L = pt_valid.shape[0]
    free = ~pt_valid
    ar = torch.arange(L, dtype=torch.int32, device=pt_valid.device)
    _, rows = top_k(torch.where(free, L - ar, 0), want)
    n_free = torch.clamp(free.sum(), max=want).to(torch.int32)
    rows = torch.where(ar[:want] < n_free, rows.to(torch.int32), L - 1)
    return rows, n_free


def assemble_keyframe(cam, o: VOOptions, mstate: ms.MapState, pyr, found, obs_px, T_cw7,
                      last_kf_slot, rows, n_free, slot, fid, kf_images, nbr2_slot=None):
    """The keyframe-assembly pass: feature table (half landmark
    observations, half new detections), triangulation of the detections
    against the last keyframe and a longer-baseline neighbour, descriptors
    recomputed on this image, registration, landmark creation and fusion
    with the map (SetKeyframe + CreateNewMapPoints + SearchInNeighbors).

    Returns (MapState, kf_images, new_px [Fn, 2]: the detections,
    depthless [Fn]: valid detections left without a landmark, mean_d: the
    mean camera z of the valid landmarks of `mstate` seen from keyframe
    `last_kf_slot`, the depth filter's prior)."""
    Fl = o.map_F // 2
    Fn = o.map_F - Fl
    dev = found.device
    T_cw = SE3.from_params7(T_cw7)
    _, top_rows = top_k(found.to(torch.int32) * (1 + mstate.pt_obs), Fl)
    lm_rows = top_rows.to(torch.int32)
    lm_ok = found[top_rows]
    lm_px = obs_px[top_rows]
    z = T_cw.apply(mstate.pt_pos[top_rows])[:, 2]
    feats = fe.detect_multilevel(pyr, o.detect_threshold, o.grid_cell, o.feat_budgets,
                                 lm_px, lm_ok)
    new_px, new_valid, new_desc = feats.px[:Fn], feats.valid[:Fn], feats.desc[:Fn]
    new_level, new_angle = feats.level[:Fn], feats.angle[:Fn]
    # Both neighbours' matrices in one launch: they read the map before the
    # keyframe is inserted.
    nbrs = [last_kf_slot] if nbr2_slot is None else [last_kf_slot, nbr2_slot]
    dists = neighbour_distances(mstate, new_desc, nbrs)
    pos_w, good, _ = triangulate(cam, mstate, new_px, new_valid, new_angle, T_cw7,
                                 last_kf_slot, dists[0])
    if nbr2_slot is not None:
        # Where both baselines pass, the longer one wins.
        pos_w2, good2, _ = triangulate(cam, mstate, new_px, new_valid, new_angle, T_cw7,
                                       nbr2_slot, dists[1])
        pos_w = torch.where(good2[:, None], pos_w2, pos_w)
        good = good | good2
    ar_n = torch.arange(Fn, dtype=torch.int32, device=dev)
    can_write = good & (ar_n < n_free)
    lm_angle, lm_desc = orb.compute(pyr[0], lm_px)
    z_new = T_cw.apply(pos_w)[:, 2]
    st = ms.insert_keyframe(
        mstate, slot, fid, T_cw,
        feat_px=torch.cat([lm_px, new_px]),
        feat_level=torch.cat([torch.zeros(Fl, dtype=torch.int32, device=dev), new_level]),
        feat_angle=torch.cat([lm_angle, new_angle]),
        feat_desc=torch.cat([lm_desc, new_desc]),
        feat_depth=torch.cat([torch.where(lm_ok, z, -1.0), torch.where(can_write, z_new, -1.0)]),
        feat_point=torch.cat([torch.where(lm_ok, lm_rows, -1), torch.where(can_write, rows, -1)]),
        feat_valid=torch.cat([lm_ok, new_valid]))
    # Tracked landmarks take the descriptor seen in this keyframe.
    st = st._replace(pt_desc=st.pt_desc.index_copy(
        0, top_rows, torch.where(lm_ok[:, None], lm_desc, st.pt_desc[top_rows])))
    slot_t = torch.as_tensor(slot, dtype=torch.int32, device=dev)
    st = ms.add_landmarks(st, rows, can_write, pos_w, new_desc, slot_t,
                          ref_feat=slot_t * o.map_F + Fl + ar_n)
    kf_images = ms.set_row(kf_images, slot, pyr[0])
    st = lm.search_in_neighbors(st, cam, slot)
    fp_now = ms.row(st.feat_point, slot)[Fl:]
    depthless = new_valid & ~can_write & (fp_now < 0)
    z_map = torch.where(mstate.pt_valid, mstate.kf_pose(last_kf_slot).apply(mstate.pt_pos)[:, 2],
                        0.0)
    mean_d = z_map.sum() / torch.clamp(mstate.pt_valid.sum(), min=1).to(z_map.dtype)
    return st, kf_images, new_px, depthless, mean_d


def kf_cycle(cam, o: VOOptions, mstate: ms.MapState, pyr, found, obs_px, T_cw7, last_kf_slot,
             nbr2_slot, fid, kf_images, seeds: dfilt.Seeds | None = None, seed_slot=0,
             seed_feat_idx=None):
    """The synchronous half of keyframe insertion, all on the device: slot
    allocation or the choice of a victim (the used slot least covisible
    with the newest keyframe), the victim's archive snapshot, its
    invalidation, the covisibility refresh and orphan sweep that follow an
    eviction (landmarks the tracker currently observes are spared),
    landmark-row allocation, `assemble_keyframe`, then the depth filter:
    the converged `seeds` of keyframe `seed_slot` (features
    `seed_feat_idx` [Fn]) become landmarks linked to their features, and
    new seeds start on this keyframe's depthless detections.

    Returns (MapState, kf_images, new seeds, host_block): host_block is
    (slot, evicted, evict_fid, any depthless detection) followed by the
    snapshot (pose7, feat_desc, feat_px, feat_valid, landmark positions,
    their validity, feat_angle, feat_level, image), garbage rows when
    nothing was evicted, and the number of seeds promoted; fetching it is
    the one host transfer of a keyframe."""
    K = o.map_K
    Fn = o.map_F - o.map_F // 2
    dev = mstate.kf_valid.device
    # --- slot allocation ---
    used = mstate.kf_valid
    first_free = torch.argmin(used.to(torch.int32))
    newest = torch.as_tensor(last_kf_slot, device=dev)
    w = torch.where(used & (torch.arange(K, device=dev) != newest),
                    ms.row(mstate.cov_weight, newest), INT32_MAX)
    victim = torch.argmin(w)
    evicted = ~torch.any(~used)
    slot = torch.where(evicted, victim, first_free)
    evict_fid = ms.row(mstate.kf_id, slot)
    # --- archive snapshot (before the slot is invalidated) ---
    fp = ms.row(mstate.feat_point, slot)
    f_valid = ms.row(mstate.feat_valid, slot)
    ptsafe = torch.clamp(fp, 0, mstate.L - 1).long()
    snapshot = (ms.row(mstate.kf_pose7, slot), ms.row(mstate.feat_desc, slot),
                ms.row(mstate.feat_px, slot), f_valid, mstate.pt_pos[ptsafe],
                f_valid & (fp >= 0) & mstate.pt_valid[ptsafe],
                ms.row(mstate.feat_angle, slot), ms.row(mstate.feat_level, slot),
                ms.row(kf_images, slot))
    # --- invalidate the victim; refresh + sweep only on eviction ---
    m2 = mstate._replace(
        kf_valid=ms.set_row(mstate.kf_valid, slot, ms.row(mstate.kf_valid, slot) & ~evicted),
        feat_valid=ms.set_row(mstate.feat_valid, slot, f_valid & ~evicted),
        feat_point=ms.set_row(mstate.feat_point, slot, torch.where(evicted, -1, fp)))
    swept = ms.update_covisibility(m2)
    orphaned = swept.pt_valid & (swept.pt_obs == 0) & ~found
    swept = swept._replace(pt_valid=swept.pt_valid & ~orphaned)
    m2 = ms.MapState(*(torch.where(evicted, a, b) for a, b in zip(swept, m2)))
    # --- landmark rows + assembly ---
    rows, n_free = free_rows(m2.pt_valid, Fn)
    st, kf_images, new_px, depthless, mean_d = assemble_keyframe(
        cam, o, m2, pyr, found, obs_px, T_cw7, last_kf_slot, rows, n_free, slot, fid, kf_images,
        nbr2_slot=nbr2_slot)
    # --- depth filter: promote the last keyframe's converged seeds, re-seed ---
    n_promoted = torch.zeros((), dtype=torch.int64, device=dev)
    if seeds is not None:
        st, n_promoted = promote_seeds(cam, o, st, seeds, seed_slot, seed_feat_idx)
    mean_safe = torch.clamp(torch.where(mean_d > 0, mean_d, 1.0), min=0.5)
    new_seeds = dfilt.Seeds.init(new_px, depthless, depth_mean=1.0, depth_min=0.1)
    new_seeds = new_seeds._replace(mu=new_seeds.mu / mean_safe)
    host_block = (slot, evicted, evict_fid, torch.any(depthless)) + snapshot + (n_promoted,)
    return st, kf_images, new_seeds, host_block


def promote_seeds(cam, o: VOOptions, st: ms.MapState, seeds: dfilt.Seeds, seed_slot,
                  seed_feat_idx):
    """Converged seeds (sigma < z_range / 100) of keyframe `seed_slot`
    become landmarks in free rows, linked to their features
    `seed_feat_idx` [N] with the seed's depth, where the feature is still
    unlinked (the JAX package's `_kf_cycle` depth-filter block).  Returns
    (MapState, number promoted)."""
    conv = seeds.converged(ratio=100.0) & seeds.valid
    n_s = conv.shape[0]
    rows, n_free = free_rows(st.pt_valid, n_s)
    idx = seed_feat_idx.long()
    fp = ms.row(st.feat_point, seed_slot)
    still_free = fp[idx] < 0
    can = conv & still_free & (torch.arange(n_s, device=conv.device) < n_free)
    depth = seeds.depth()
    pos_w = cam.pixel_to_world(seeds.px, st.kf_pose(seed_slot), depth=depth)
    st = ms.add_landmarks(st, rows, can, pos_w, ms.row(st.feat_desc, seed_slot)[idx], seed_slot,
                          ref_feat=seed_slot * o.map_F + seed_feat_idx.to(torch.int32))
    fd = ms.row(st.feat_depth, seed_slot)
    st = st._replace(
        feat_point=ms.set_row(st.feat_point, seed_slot,
                              fp.index_copy(0, idx, torch.where(can, rows, fp[idx]))),
        feat_depth=ms.set_row(st.feat_depth, seed_slot,
                              fd.index_copy(0, idx, torch.where(can, depth, fd[idx]))))
    return st, can.sum()


def update_seeds(cam, seeds: dfilt.Seeds, kf_pose7, kf_images, seed_slot, cur_img,
                 T_cw: SE3) -> dfilt.Seeds:
    """The depth filter's per-frame step (the JAX package's
    `_track_with_seeds` after `_track`): the seeds of keyframe `seed_slot`
    (a Python int or a device index) updated against a frame's level 0 at
    its refined pose T_cw."""
    T_seed = SE3.from_params7(ms.row(kf_pose7, seed_slot))
    return dfilt.update_seeds_from_frame(seeds, ms.row(kf_images, seed_slot), cur_img, cam,
                                         T_cw.compose(T_seed.inverse()))


def desc_check(ref_desc: torch.Tensor, img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Hamming distance [N] between each reference descriptor and one
    computed afresh at its tracked position (CheckFrameDescriptors,
    Matcher.cpp:45-84)."""
    return hamming_distance(ref_desc, orb.compute(img, px)[1])


def kf_redundancy(m: ms.MapState, min_obs: int = 4, maxlvl: int = 8) -> torch.Tensor:
    """[K] scale-aware keyframe-redundancy scores (KeyFrameCulling,
    LocalMapping.cpp:579-618): the share of a keyframe's linked features
    whose landmark is observed at least `min_obs` times at its own or a
    finer level."""
    K, F = m.feat_valid.shape
    L = m.L
    p = m.feat_point.reshape(-1)
    okf = m.feat_valid.reshape(-1) & (p >= 0) & (p < L)
    psafe = torch.clamp(p, 0, L - 1).long()
    lvl_raw = m.feat_level.reshape(-1)
    lvl = torch.clamp(lvl_raw, 0, maxlvl - 1).long()
    counts = torch.zeros((L, maxlvl), dtype=torch.int32, device=p.device).index_put_(
        (psafe, lvl), okf.to(torch.int32), accumulate=True)
    cum = torch.cumsum(counts, dim=1)
    l1 = torch.clamp(lvl_raw + 1, 0, maxlvl - 1).long()
    red = okf & (cum[psafe, l1] >= min_obs)
    linked = okf.reshape(K, F).sum(1)
    redundant = red.reshape(K, F).sum(1)
    return torch.where(linked > 0, redundant.float() / torch.clamp(linked, min=1).float(), 0.0)


def mapping(cam, o: VOOptions, mstate: ms.MapState, fixed: torch.Tensor):
    """Covisibility, local BA over the map (fixed [K] gauge slots),
    landmark culling, covisibility.  Returns (MapState, BA chi2)."""
    mstate = ms.update_covisibility(mstate)
    mstate, chi2 = lm.local_ba_on_map(mstate, cam, fixed, n_iter=o.local_ba_iters)
    mstate = lm.map_point_culling(mstate)
    return ms.update_covisibility(mstate), chi2


def mapping_pass(cam, o: VOOptions, mstate: ms.MapState, fixed: torch.Tensor):
    """The keyframe mapping pass on the device: covisibility refresh and
    orphan sweep, `mapping`, and the keyframe-redundancy scores.  Returns
    (MapState, scores [K])."""
    mstate, _ = mapping(cam, o, refresh_covisibility(mstate), fixed)
    return mstate, kf_redundancy(mstate)


def accept_counters(mstate: ms.MapState, cand: torch.Tensor, found: torch.Tensor, j: int):
    """The landmark statistics after the first `j` frames of a chunk, from
    the chunk's per-frame candidate and found masks [C, L] (the JAX
    package's `_accept_counters`): integer sums, so they equal the per-frame
    path's frame-by-frame increments."""
    return mstate._replace(
        pt_visible=mstate.pt_visible + torch.sum(cand[:j], dim=0, dtype=torch.int32),
        pt_found=mstate.pt_found + torch.sum(found[:j], dim=0, dtype=torch.int32))


# Chunk frames queued on the device before the host reads the oldest one's
# outcome: the card has the next frame queued while the host decides.
IN_FLIGHT = 2


class ChunkStep:
    """One ordinary frame of `VisualOdometry.add_frames` over static
    buffers: image `slot` of the chunk through `preprocess`, the motion
    model's prediction, `track` and the velocity update (the per-frame
    path's `_track_frame` without its host decisions) and, when the VO holds
    depth-filter seeds, their update at the refined pose against the seed
    keyframe's image (a device index into `kf_images`); the carry (previous
    pyramid, pose, velocity, landmark statistics, last frame's found set and
    observations, the seeds) is written back in place, the frame's outcome
    into row `slot` of the chunk's records, and `slot` advances.

    On a CUDA device the first frame runs eagerly on a side stream (the
    warm-up: lazily made constants and library handles exist before the
    capture), the step is then captured once as a CUDA graph, and every
    later frame replays it; a capture failure raises.  On the CPU the step
    runs eagerly.  The buffers' shapes are fixed by the map capacity, the
    frame size, `n_levels` and the chunk length; the graph also fixes
    `sparse_align.FUSED_VARIANT` as it was at capture, and whether the step
    updates seeds (the VO's seeds at construction)."""

    def __init__(self, vo: "VisualOdometry", chunk: int):
        dev = vo.device
        self.cam, self.o = vo.cam, vo.o
        L = vo.o.map_L
        H, W = vo.prev_pyr[0].shape
        self.imgs = torch.zeros((chunk, H, W), dtype=torch.float32, device=dev)
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)
        # The carry's static homes.
        self.prev_pyr = tuple(torch.zeros_like(p) for p in vo.prev_pyr)
        self.prev_R, self.prev_t = torch.zeros((3, 3), device=dev), torch.zeros(3, device=dev)
        self.vel_R, self.vel_t = torch.zeros((3, 3), device=dev), torch.zeros(3, device=dev)
        self.mstate = ms.MapState(*(torch.zeros_like(t) for t in vo.server.state))
        self.kf_images = torch.zeros_like(vo.kf_images)
        self._kf_src = None            # the eager kf_images last copied in
        self.prev_found = torch.zeros(L, dtype=torch.bool, device=dev)
        self.prev_obs_px = torch.zeros((L, 2), dtype=torch.float32, device=dev)
        # Per-frame records: pose, velocity, found / candidate sets,
        # observations; `out` rows are (params7, inliers) for the host.
        self.rec_R = torch.zeros((chunk, 3, 3), device=dev)
        self.rec_t = torch.zeros((chunk, 3), device=dev)
        self.rec_vR = torch.zeros((chunk, 3, 3), device=dev)
        self.rec_vt = torch.zeros((chunk, 3), device=dev)
        self.rec_found = torch.zeros((chunk, L), dtype=torch.bool, device=dev)
        self.rec_cand = torch.zeros((chunk, L), dtype=torch.bool, device=dev)
        self.rec_obs = torch.zeros((chunk, L, 2), device=dev)
        self.rec_out = torch.zeros((chunk, 8), device=dev)
        # The seed table's homes, the seed keyframe's slot and the table
        # after each frame (a cut chunk takes the frame before the cut's).
        self.seeds = self.rec_seeds = self.seed_slot = None
        if vo.seeds is not None:
            self.seeds = dfilt.Seeds(*(torch.zeros_like(t) for t in vo.seeds))
            self.rec_seeds = dfilt.Seeds(*(torch.zeros((chunk,) + tuple(t.shape), dtype=t.dtype,
                                                       device=dev) for t in vo.seeds))
            self.seed_slot = torch.zeros(1, dtype=torch.long, device=dev)
        self.on_card = dev.type == "cuda"
        if self.on_card:
            self.host_out = torch.zeros((chunk, 8), pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(chunk)]
        else:
            self.host_out, self.events = self.rec_out, None
        self.graph = None
        self.captured = []             # wrappers that launch into the graph
        self.replays = 0

    def load(self, vo: "VisualOdometry", frames) -> None:
        """Copy the VO's state and the chunk's frames into the static
        buffers, and set `slot` to 0 (all device copies, no host wait but
        the frames' upload)."""
        for dst, src in zip(self.prev_pyr, vo.prev_pyr):
            dst.copy_(src)
        self.prev_R.copy_(vo.prev_T_cw.R)
        self.prev_t.copy_(vo.prev_T_cw.t)
        self.vel_R.copy_(vo.velocity.R)
        self.vel_t.copy_(vo.velocity.t)
        for dst, src in zip(self.mstate, vo.server.state):
            dst.copy_(src)
        if vo.kf_images is not self._kf_src:      # replaced by a keyframe since
            self.kf_images.copy_(vo.kf_images)
            self._kf_src = vo.kf_images
        self.prev_found.copy_(vo.prev_found)
        self.prev_obs_px.copy_(vo.prev_obs_px)
        if self.seeds is not None:
            for dst, src in zip(self.seeds, vo.seeds):
                dst.copy_(src)
            self.seed_slot.fill_(vo.seed_kf_slot)
        if not isinstance(frames, torch.Tensor):
            frames = torch.stack([torch.as_tensor(f, dtype=torch.float32) for f in frames])
        self.imgs.copy_(frames)
        self.slot.zero_()

    def _step(self) -> None:
        img = self.imgs.index_select(0, self.slot)[0]
        pyr = fe.preprocess(img, self.o.n_levels)
        prev_T = SE3(self.prev_R, self.prev_t)
        T_pred = SE3(self.vel_R, self.vel_t).compose(prev_T)
        tm, st, _ = track(self.cam, self.o, self.prev_pyr, pyr, prev_T.params7(),
                          T_pred.params7(), self.mstate, self.kf_images, self.prev_found,
                          self.prev_obs_px)
        T_cw = tm.T_cw
        vel = T_cw.compose(prev_T.inverse())
        recs = [(self.rec_R, T_cw.R), (self.rec_t, T_cw.t), (self.rec_vR, vel.R),
                (self.rec_vt, vel.t), (self.rec_found, tm.found), (self.rec_cand, tm.candidate),
                (self.rec_obs, tm.obs_px),
                (self.rec_out, torch.cat([T_cw.params7(), tm.n_inliers.to(torch.float32)[None]]))]
        carry = [(self.prev_R, T_cw.R), (self.prev_t, T_cw.t), (self.vel_R, vel.R),
                 (self.vel_t, vel.t), (self.mstate.pt_visible, st.pt_visible),
                 (self.mstate.pt_found, st.pt_found), (self.prev_found, tm.found),
                 (self.prev_obs_px, tm.obs_px)]
        if self.seeds is not None:
            seeds = update_seeds(self.cam, self.seeds, st.kf_pose7, self.kf_images,
                                 self.seed_slot, pyr[0], T_cw)
            recs += list(zip(self.rec_seeds, seeds))
            carry += list(zip(self.seeds, seeds))
        s = self.slot
        for rec, x in recs:
            rec.index_copy_(0, s, x[None])
        for dst, src in zip(self.prev_pyr, pyr):
            dst.copy_(src)
        for dst, src in carry:
            dst.copy_(src)
        s.add_(1)

    def run(self, k: int) -> None:
        """Frame k of the chunk (the slot the step is at): eagerly on the
        CPU; on the card the warm-up and capture the first time, a replay
        after; then its outcome row on its way to the host."""
        if not self.on_card:
            self._step()
            return
        if self.graph is None:
            cur = torch.cuda.current_stream(self.imgs.device)
            side = torch.cuda.Stream(self.imgs.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._step()                      # the warm-up frame, a real one
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with kernels.capture_launches() as captured, torch.cuda.graph(graph, stream=side):
                self._step()
            self.graph, self.captured = graph, captured
        else:
            self.graph.replay()
            kernels.replayed(self.captured)
            self.replays += 1
        self.host_out[k].copy_(self.rec_out[k], non_blocking=True)
        self.events[k].record()

    def outcome(self, k: int) -> tuple[np.ndarray, int]:
        """Frame k's (params7 [7] float32, inliers), waiting for its event
        on the card."""
        if self.events is not None:
            self.events[k].synchronize()
        row = self.host_out[k].numpy()
        return row[:7].copy(), int(row[7])


@dataclasses.dataclass
class TrackResult:
    status: Status
    T_cw: SE3 | None
    n_inliers: int = 0


def _unsupported(o: VOOptions) -> list:
    return [name for name in ("use_vocabulary", "archive_map", "async_mapping")
            if getattr(o, name)] + (
        [f"vo_type={o.vo_type.name}"] if o.vo_type is not VOType.SPARSE_DIRECT else [])


class VisualOdometry:
    """Monocular VO over a fixed-capacity tensor map, on `device` (the card
    unless the caller names another)."""

    def __init__(self, cam, opts: VOOptions | None = None, device=None):
        o = opts or VOOptions()
        bad = _unsupported(o)
        if bad:
            raise ValueError(f"VOOptions not supported by the port: {', '.join(bad)} "
                             "(it runs SPARSE_DIRECT without vocabulary, keyframe archive "
                             "or async mapping)")
        self.cam = cam
        self.o = o
        self.device = resolve_device(device)
        self.server = MapServer(o.map_K, o.map_F, o.map_L, device=self.device)
        self.status = Status.NOT_READY
        self.kf_images = None          # [K, H, W]
        self.T_cw = self._identity()
        self.velocity = self._identity()
        self.prev_pyr = None
        self.prev_T_cw = self._identity()
        self.prev_found = None         # [L] bool landmarks seen last frame
        self.prev_obs_px = None        # [L, 2]
        self.init_pyr = None
        self.init_feats = None
        self.init_track_px = None
        self._init_ref_fid = -1
        self.init_used_h = None        # which RANSAC model bootstrapped the map
        self.frames_since_kf = 0
        self.last_kf_slot = -1
        self.seeds: dfilt.Seeds | None = None   # depth-filter seeds of the last keyframe
        self.seed_kf_slot = -1
        self.seed_feat_idx = None      # [Fn] their feature rows in that keyframe
        self.frame_id = -1
        self.lost_count = 0
        self._low_streak = 0           # consecutive sub-gate GOOD frames
        self.stats = collections.Counter()
        # Keyframe-anchored trajectory: each frame records (ts, anchor
        # keyframe id, pose relative to it), so refined keyframe poses
        # propagate to the exported trajectory.
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self.traj_rel: list[tuple[float, int, np.ndarray]] = []
        self.kf_pose_log: dict[int, np.ndarray] = {}
        self._last_kf_fid = -1
        self._last_kf_pose7 = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
        # (frame shape, chunk, FUSED_VARIANT, seeds present) -> ChunkStep
        self._chunk_steps: dict = {}
        # add_frames' work: chunks, frame steps computed, and of those the
        # ones discarded at or after a chunk's flagged frame.
        self.chunk_stats = collections.Counter()

    def _identity(self) -> SE3:
        return SE3.identity(device=self.device)

    # ------------------------------------------------------------------
    def add_frame(self, img, timestamp: float = 0.0) -> TrackResult:
        """Track one monocular image [H, W] (VisualOdometry::AddFrame,
        :38-107)."""
        self.frame_id += 1
        if self.status is not Status.GOOD:
            self._low_streak = 0       # hysteresis counts GOOD frames only
        pyr = fe.preprocess(torch.as_tensor(img, dtype=torch.float32, device=self.device),
                            self.o.n_levels)
        if self.kf_images is None:
            self.kf_images = torch.zeros((self.o.map_K,) + tuple(pyr[0].shape),
                                         dtype=torch.float32, device=self.device)
        if self.status is Status.NOT_READY:
            res = self._start_init(pyr)
        elif self.status is Status.INITING:
            res = self._try_init(pyr)
        elif self.status is Status.GOOD:
            res = self._track_frame(pyr)
        else:
            res = self._handle_lost(pyr)
        self.stats["frames"] += 1
        if res.status is Status.GOOD:
            self.stats["frames_good"] += 1
            self.stats["inliers_total"] += res.n_inliers
        elif res.status is Status.LOST:
            self.stats["frames_lost"] += 1
        abs7 = res.T_cw.params7().cpu().numpy()
        self.trajectory.append((timestamp, abs7))
        if res.status is Status.GOOD and self._last_kf_fid >= 0:
            self.traj_rel.append((timestamp, self._last_kf_fid,
                                  np_se3.relative7(abs7, self._last_kf_pose7).astype(np.float32)))
        else:
            self.traj_rel.append((timestamp, -1, abs7))
        return res

    def add_frames(self, imgs, timestamps=None, chunk: int | None = None) -> list:
        """Chunked tracking (the JAX package's `add_frames`): spans of
        `chunk` ordinary frames (`VOOptions.chunk_frames` by default) run as
        `ChunkStep`s, a CUDA-graph replay each on the card, with no host wait
        per frame but for the outcome of the frame IN_FLIGHT frames back.
        The host decides each frame as the per-frame path does (the inlier
        hysteresis and the keyframe need, from the fetched pose and inlier
        count); the chunk is cut before the first frame that would go LOST,
        need descriptor verification or become a keyframe, and that frame
        runs through `add_frame`.  Frames while not GOOD, a tail shorter
        than `chunk`, or a confirmed sub-gate streak take the per-frame
        path.  The results, trajectory and map equal repeated `add_frame`
        bit for bit.  Returns a TrackResult per frame."""
        n = len(imgs)
        ts = list(timestamps) if timestamps is not None else [0.0] * n
        chunk = chunk or self.o.chunk_frames
        results: list[TrackResult] = []
        i = 0
        while i < n:
            if (self.status is not Status.GOOD or n - i < chunk
                    or self._low_streak >= self.o.track_confirm_frames):
                results.append(self.add_frame(imgs[i], ts[i]))
                i += 1
                continue
            done = self._track_chunk(imgs[i:i + chunk], ts[i:i + chunk])
            results += done
            i += len(done)
            if len(done) < chunk:          # the flagged frame: the per-frame path
                results.append(self.add_frame(imgs[i], ts[i]))
                i += 1
        return results

    def _track_chunk(self, frames, ts) -> list:
        """One chunk of GOOD frames; returns the TrackResults of the frames
        before the first flagged one (all of them if none is flagged), whose
        state the VO then holds."""
        o = self.o
        C = len(ts)
        key = (tuple(self.prev_pyr[0].shape), C, sparse_align.FUSED_VARIANT,
               self.seeds is not None)
        step = self._chunk_steps.get(key)
        if step is None:
            step = self._chunk_steps[key] = ChunkStep(self, C)
        start = self.server.state
        step.load(self, frames)
        hard = self._hard_inlier_floor()
        streak, fsk = self._low_streak, self.frames_since_kf
        outcomes = []
        launched = 0
        while len(outcomes) < C:
            while launched < C and launched - len(outcomes) < IN_FLIGHT:
                step.run(launched)
                launched += 1
            abs7, n_inl = step.outcome(len(outcomes))
            # _track_frame's hysteresis and keyframe decision, on the host.
            low = n_inl < o.min_track_inliers
            s_next = streak + 1 if low else 0
            if (n_inl < hard or s_next >= o.track_confirm_frames
                    or (not low and self._keyframe_due(fsk + 1, abs7))):
                break
            streak, fsk = s_next, fsk + 1
            outcomes.append((abs7, n_inl))
        j = len(outcomes)
        self.chunk_stats.update(chunks=1, frames_computed=launched,
                                frames_discarded=launched - j)
        if j == 0:
            return []
        last = j - 1
        self.server.state = accept_counters(start, step.rec_cand, step.rec_found, j)
        self.prev_found = step.rec_found[last].clone()
        self.prev_obs_px = step.rec_obs[last].clone()
        R, t = step.rec_R[:j].clone(), step.rec_t[:j].clone()
        self.prev_T_cw = self.T_cw = SE3(R[last], t[last])
        self.velocity = SE3(step.rec_vR[last].clone(), step.rec_vt[last].clone())
        if step.seeds is not None:
            self.seeds = dfilt.Seeds(*(r[last].clone() for r in step.rec_seeds))
        self.prev_pyr = fe.preprocess(step.imgs[last].clone(), o.n_levels)
        self.frames_since_kf, self._low_streak = fsk, streak
        results = []
        for k, (abs7, n_inl) in enumerate(outcomes):
            self.frame_id += 1
            self.stats.update(frames=1, frames_good=1, inliers_total=n_inl)
            self.trajectory.append((ts[k], abs7))
            if self._last_kf_fid >= 0:
                self.traj_rel.append((ts[k], self._last_kf_fid, np_se3.relative7(
                    abs7, self._last_kf_pose7).astype(np.float32)))
            else:
                self.traj_rel.append((ts[k], -1, abs7))
            results.append(TrackResult(Status.GOOD, SE3(R[k], t[k]), n_inl))
        return results

    def _detect(self, pyr, existing_px=None, existing_mask=None):
        o = self.o
        return fe.detect_multilevel(pyr, o.detect_threshold, o.grid_cell, o.feat_budgets,
                                    existing_px, existing_mask)

    # -- NOT_READY ------------------------------------------------------
    def _start_init(self, pyr) -> TrackResult:
        feats = self._detect(pyr)
        if int(feats.valid.sum()) < self.o.init_min_features:
            return TrackResult(Status.NOT_READY, self._identity())
        self.init_pyr = pyr
        self.init_feats = feats
        self.init_track_px = feats.px
        # Keyframe 0 of the map is registered under the init reference
        # frame's id.
        self._init_ref_fid = self.frame_id
        self.status = Status.INITING
        return TrackResult(Status.INITING, self._identity())

    # -- INITING --------------------------------------------------------
    def _try_init(self, pyr) -> TrackResult:
        o, cam = self.o, self.cam
        feats = self.init_feats
        klt = klt_pyramidal(self.init_pyr, pyr, feats.px, self.init_track_px)
        tracked = feats.valid & klt.converged
        if o.init_check_descriptors:
            cand = tracked & (desc_check(feats.desc, pyr[0], klt.xy) <= o.init_desc_max_dist)
            # The re-check itself never starves initialization.
            if int(cand.sum()) >= o.init_min_features:
                tracked = cand
        n_tracked = int(tracked.sum())
        if n_tracked < o.init_min_features:
            self.status = Status.NOT_READY          # lost the reference: restart here
            return self._start_init(pyr)
        self.init_track_px = klt.xy                 # warm start for the next frame
        disp = torch.linalg.norm(klt.xy - feats.px, dim=-1)
        if float(torch.where(tracked, disp, 0.0).sum() / n_tracked) < o.init_min_disparity:
            return TrackResult(Status.INITING, self._identity())
        K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                         dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.frame_id)
        out = init_mod.initialize_two_view(cam.undistort_px(feats.px), cam.undistort_px(klt.xy),
                                           tracked, K, gen, min_good=o.init_min_inliers)
        if not bool(out.success):
            return TrackResult(Status.INITING, self._identity())
        self.init_used_h = bool(out.used_h)
        self.stats["init_model_h" if self.init_used_h else "init_model_f"] += 1
        # Two-view BA, then the map rescaled to mean depth 1 (:148-151, :261-275).
        res = bam.two_view_ba(self._identity(), out.T21, out.points3d, feats.px, klt.xy,
                              out.good, cam)
        inl = res.inlier
        n_inl = int(inl.sum())
        if n_inl < o.init_min_inliers:
            return TrackResult(Status.INITING, self._identity())
        mean_depth = float(torch.where(inl, res.points[:, 2], 0.0).sum() / max(n_inl, 1))
        scale = 1.0 / max(mean_depth, 1e-6)
        T2 = SE3(res.poses.R[1], res.poses.t[1] * scale)
        self._create_initial_map(pyr, klt.xy, res.points * scale, inl, T2)
        self.status = Status.GOOD
        return TrackResult(Status.GOOD, T2, n_inl)

    def _create_initial_map(self, pyr, cur_px, pts, inl, T2: SE3) -> None:
        o, srv = self.o, self.server
        feats = self.init_feats
        N = feats.px.shape[0]
        pad = o.map_F - N
        dev = self.device

        def padded(x, fill=0):
            return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                            device=dev)])

        rows = torch.arange(N, dtype=torch.int32, device=dev)   # the map is empty
        T1 = self._identity()
        slot0 = srv.register_keyframe(
            self._init_ref_fid, T1, padded(feats.px), padded(feats.level), padded(feats.angle),
            padded(feats.desc), padded(torch.where(inl, T1.apply(pts)[:, 2], -1.0), -1.0),
            padded(torch.where(inl, rows, -1), -1), padded(inl, False))
        # Landmark descriptors come from the current frame (tracking
        # continues from here).
        ang2, desc2 = orb.compute(pyr[0], cur_px)
        srv.state = ms.add_landmarks(srv.state, rows, inl, pts, desc2, slot0,
                                     ref_feat=slot0 * o.map_F + rows)
        slot1 = srv.register_keyframe(
            self.frame_id, T2, padded(cur_px), padded(feats.level), padded(ang2),
            padded(desc2), padded(torch.where(inl, T2.apply(pts)[:, 2], -1.0), -1.0),
            padded(torch.where(inl, rows, -1), -1), padded(inl, False))
        self.kf_images = ms.set_row(ms.set_row(self.kf_images, slot0, self.init_pyr[0]),
                                    slot1, pyr[0])
        srv.refresh_covisibility()
        # First local BA with both keyframes fixed (gauge and scale).
        fixed = torch.zeros(o.map_K, dtype=torch.bool, device=dev)
        fixed[[slot0, slot1]] = True
        srv.state, _ = mapping(self.cam, o, srv.state, fixed)
        L = o.map_L
        self.prev_pyr = pyr
        self.prev_T_cw = T2
        self.T_cw = T2
        self.prev_found = torch.zeros(L, dtype=torch.bool, device=dev).index_copy(
            0, rows.long(), inl)
        self.prev_obs_px = torch.zeros((L, 2), dtype=torch.float32, device=dev).index_copy(
            0, rows.long(), cur_px)
        self.velocity = self._identity()
        self.last_kf_slot = slot1
        self._last_kf_fid = self.frame_id
        self._last_kf_pose7 = srv.state.kf_pose7[slot1].cpu().numpy()
        self.frames_since_kf = 0

    # -- GOOD -----------------------------------------------------------
    def _run_tracker(self, pyr, T_pred: SE3):
        return track(self.cam, self.o, self.prev_pyr, pyr, self.prev_T_cw.params7(),
                     T_pred.params7(), self.server.state, self.kf_images, self.prev_found,
                     self.prev_obs_px)

    def _hard_inlier_floor(self) -> int:
        """Below this a frame goes LOST at once, hysteresis or not."""
        o = self.o
        return o.track_inlier_floor or max(1, o.min_track_inliers // 2)

    def _descriptors_agree(self, pyr, tm, need: int) -> bool:
        """At least `need` found landmarks whose descriptor matches one
        computed at the tracked position (the lost-retry re-check)."""
        d = desc_check(self.server.state.pt_desc, pyr[0], tm.obs_px)
        return int((tm.found & (d <= self.o.lost_desc_max_dist)).sum()) >= need

    def _track_frame(self, pyr) -> TrackResult:
        o = self.o
        T_pred = self.velocity.compose(self.prev_T_cw)
        tm, new_state, _ = self._run_tracker(pyr, T_pred)
        n_inl = int(tm.n_inliers)
        marginal = n_inl < o.min_track_inliers
        if marginal:
            # Hysteresis: a single sub-gate frame is tracked through; a
            # sub-gate streak must pass the descriptor re-check; below the
            # hard floor the frame is LOST at once.
            self._low_streak += 1
            hard = self._hard_inlier_floor()
            streak = self._low_streak >= o.track_confirm_frames
            verified = n_inl >= hard and streak and self._descriptors_agree(pyr, tm, hard)
            if n_inl < hard or (streak and not verified):
                self.status = Status.LOST
                self.lost_count = 0
                self._low_streak = 0
                return TrackResult(Status.LOST, self.T_cw, n_inl)
        else:
            self._low_streak = 0
        self.server.state = new_state
        T_cw = tm.T_cw
        if self.seeds is not None:
            # The depth filter at the refined pose; a LOST frame keeps the seeds.
            self.seeds = update_seeds(self.cam, self.seeds, new_state.kf_pose7, self.kf_images,
                                      self.seed_kf_slot, pyr[0], T_cw)
        self.velocity = T_cw.compose(self.prev_T_cw.inverse())
        self.prev_pyr = pyr
        self.prev_T_cw = T_cw
        self.T_cw = T_cw
        self.prev_found = tm.found
        self.prev_obs_px = tm.obs_px
        self.frames_since_kf += 1
        # A frame tracked through on hysteresis never becomes a keyframe.
        if not marginal and self._need_keyframe(T_cw):
            self._insert_keyframe(pyr, T_cw, tm)
        return TrackResult(Status.GOOD, T_cw, n_inl)

    def _need_keyframe(self, T_cw: SE3) -> bool:
        return self._keyframe_due(self.frames_since_kf, T_cw.params7().cpu().numpy())

    def _keyframe_due(self, frames_since_kf: int, abs7: np.ndarray) -> bool:
        """NeedNewKeyFrame (:304-321): at least kf_min_frames since the last
        keyframe and motion beyond the rotation or translation threshold,
        computed on the host (float64) from the frame's params7 and the
        cached keyframe pose."""
        o = self.o
        if frames_since_kf < o.kf_min_frames:
            return False
        delta = np_se3.log6(np_se3.relative7(abs7, self._last_kf_pose7))
        return (float(np.linalg.norm(delta[3:])) > o.kf_max_rot
                or float(np.linalg.norm(delta[:3])) > o.kf_max_trans)

    def _insert_keyframe(self, pyr, T_cw: SE3, tm) -> None:
        """SetKeyframe (:182-218): the keyframe cycle on the device (slot
        allocation or eviction, assembly, triangulation and fusion, seed
        promotion and re-seeding), one host fetch of the slot, the eviction
        and depth-filter flags, then the mapping pass."""
        o, srv = self.o, self.server
        self.stats["keyframes"] += 1
        used = srv.kf_used
        nbr2 = used[-4] if len(used) >= 4 else used[0]
        with_seeds = self.seeds is not None
        srv.state, self.kf_images, new_seeds, host_block = kf_cycle(
            self.cam, o, srv.state, pyr, tm.found, tm.obs_px, T_cw.params7(),
            self.last_kf_slot, nbr2, self.frame_id, self.kf_images,
            seeds=self.seeds, seed_slot=self.seed_kf_slot if with_seeds else 0,
            seed_feat_idx=self.seed_feat_idx)
        slot, evicted, d_any, n_promoted = torch.stack(
            [host_block[0].long(), host_block[1].long(), host_block[3].long(),
             host_block[-1]]).tolist()
        if evicted:
            self.stats["evictions"] += 1
            srv.kf_used.remove(slot)
        srv.kf_used.append(slot)
        if o.use_depth_filter:
            self.stats["seeds_promoted"] += n_promoted
            self.seeds = new_seeds if d_any else None
            self.seed_kf_slot = slot
            Fl = o.map_F // 2
            self.seed_feat_idx = Fl + torch.arange(o.map_F - Fl, dtype=torch.int32,
                                                   device=self.device)
        self._finish_insert(T_cw, slot)

    def _finish_insert(self, T_cw: SE3, slot: int) -> None:
        """Bookkeeping and the mapping pass; tracking continues from the
        refined keyframe pose."""
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        pose7 = self._keyframe_mapping_pass(slot, self.frame_id)
        self.prev_T_cw = SE3.from_params7(torch.as_tensor(pose7, device=self.device))
        self.T_cw = self.prev_T_cw
        self._last_kf_pose7 = np.asarray(pose7, np.float32)

    def _keyframe_mapping_pass(self, slot: int, kf_fid: int) -> np.ndarray:
        """Local BA and culling for a just-inserted keyframe
        (LocalMapping::Run, LocalMapping.cpp:301-336): one device pass, one
        host fetch of the scores and keyframe poses, keyframe culling.
        Returns the keyframe's refined params7."""
        o, srv = self.o, self.server
        fixed = torch.zeros(o.map_K, dtype=torch.bool)
        oldest = srv.kf_used[0]
        fixed[srv.kf_used[:2]] = True
        srv.state, scores = mapping_pass(self.cam, o, srv.state, fixed.to(self.device))
        scores, pose7, ids = (t.cpu().numpy() for t in (scores, srv.state.kf_pose7,
                                                         srv.state.kf_id))
        self._cull_keyframes(protect={slot, oldest}, scores=scores)
        for s in srv.kf_used:
            self.kf_pose_log[int(ids[s])] = pose7[s].copy()
        self._last_kf_fid = int(ids[slot])
        return pose7[slot].copy()

    def _cull_keyframes(self, protect, scores: np.ndarray, redundancy_th: float = 0.9) -> None:
        """KeyFrameCulling (LocalMapping.cpp:579-618): evict keyframes more
        than 90% of whose landmarks are seen by at least 3 other keyframes,
        keeping at least `kf_cull_min_window`."""
        srv = self.server
        min_win = self.o.kf_cull_min_window
        if len(srv.kf_used) <= min_win:
            return
        evicted = False
        for slot in list(srv.kf_used):
            if slot in protect or len(srv.kf_used) <= min_win:
                continue
            if scores[slot] > redundancy_th:
                srv.evict_kf(slot)
                self.stats["keyframes_culled"] += 1
                evicted = True
        if evicted:
            srv.refresh_covisibility()

    # -- LOST -----------------------------------------------------------
    def _handle_lost(self, pyr) -> TrackResult:
        """Retry tracking from the last pose with the motion model reset;
        a retry must pass the full inlier gate and the descriptor re-check.
        After `lost_reset_frames` failures the map is reset."""
        o = self.o
        self.lost_count += 1
        self.velocity = self._identity()
        tm, new_state, _ = self._run_tracker(pyr, self.prev_T_cw)
        n_inl = int(tm.n_inliers)
        if n_inl >= o.min_track_inliers and self._descriptors_agree(pyr, tm,
                                                                      o.min_track_inliers):
            self.status = Status.GOOD
            self.server.state = new_state
            self.prev_pyr = pyr
            self.prev_T_cw = tm.T_cw
            self.T_cw = tm.T_cw
            self.prev_found = tm.found
            self.prev_obs_px = tm.obs_px
            return TrackResult(Status.GOOD, tm.T_cw, n_inl)
        if self.lost_count > o.lost_reset_frames:
            self.reset()
        return TrackResult(Status.LOST, self.T_cw)

    def reset(self) -> None:
        """Full reset (System::Reset): an empty map, NOT_READY."""
        o = self.o
        self.server = MapServer(o.map_K, o.map_F, o.map_L, device=self.device)
        self.status = Status.NOT_READY
        self.T_cw = self._identity()
        self.velocity = self._identity()
        self.prev_pyr = None
        self.init_pyr = None
        self.frames_since_kf = 0
        self.last_kf_slot = -1
        self.lost_count = 0
        self.seeds = None
        self.seed_kf_slot = -1
        self.seed_feat_idx = None
        self._last_kf_fid = -1

    def trajectory_poses(self, corrected: bool = True) -> list:
        """(ts, params7) per frame.  corrected=True re-composes each GOOD
        frame from its anchor keyframe's current pose and the stored
        relative pose (SaveTrajectory); False gives the poses as tracked."""
        if not corrected:
            return list(self.trajectory)
        out = []
        for (ts, abs7), (_, fid, rel7) in zip(self.trajectory, self.traj_rel):
            if fid >= 0 and fid in self.kf_pose_log:
                out.append((ts, np_se3.compose7(rel7, self.kf_pose_log[fid]).astype(np.float32)))
            else:
                out.append((ts, abs7))
        return out
