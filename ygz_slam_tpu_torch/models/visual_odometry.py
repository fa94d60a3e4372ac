"""The VO's per-frame map-tracking step and its keyframe cycle, as plain
functions over MapState (counterpart of `_track`, `_triangulate`,
`_free_rows_device`, `_assemble_core` and `_kf_cycle` inside
`VisualOdometry._build_jits`, ygz_slam_tpu/models/visual_odometry.py).

This is the JAX package's configuration `VOOptions(use_vocabulary=False,
use_depth_filter=False)`: no BoW rows, no depth-filter seeds.  The host
state machine (initialisation, lost handling, the keyframe decision) is not
here; `models/vo_workload.py` drives these functions on a bootstrapped map.

Per frame (`track`): sparse-direct alignment of NS selected landmarks
against the previous frame (K1 x 6, K3), the NSV best visible landmarks'
affine-warped reference patches from the keyframe images, their patch
search on the pyramid stack (K2, K4), pose-only BA (K5), and the landmark
statistics.  Per keyframe (`kf_cycle`): slot allocation or eviction,
detection, triangulation against two neighbour keyframes and fusion with the
map (K10 x 3), insertion.  Everything stays on the device: selections that
the JAX version makes with `jnp.where` are `torch.where` here, and slots are
0-d tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry.se3 import SE3
from ..map import state as ms
from ..ops import orb
from ..ops.select import top_k
from . import frontend as fe
from . import local_mapping as lm

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class VOOptions:
    """The fields of the JAX package's VOOptions that this slice reads,
    with its defaults (config/default.yaml, VisualOdometry.h:32-45)."""
    n_levels: int = 3
    detect_threshold: float = 20.0
    grid_cell: int = 16
    feat_budgets: tuple = (160, 64, 32)   # per-level detection budgets
    min_track_inliers: int = 30           # TrackLocalMap gate
    kf_min_frames: int = 10               # keyframe.min_frames
    max_alignment_motion: float = 0.2     # Matcher.h:30
    max_step_motion: float = 0.2          # gate on the pose-BA correction
    map_K: int = 10
    map_F: int = 256
    map_L: int = 3072                     # >= map_K * map_F

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


def triangulate(cam, mstate: ms.MapState, feats_px, feats_desc, feats_valid, feats_angle,
                T_new7, nbr_slot):
    """Match the new keyframe's detections against the unlinked features of
    keyframe `nbr_slot` and triangulate: (pos_world [N, 3], good [N],
    ref_idx [N])."""
    ref_free = ms.row(mstate.feat_valid, nbr_slot) & (ms.row(mstate.feat_point, nbr_slot) < 0)
    return lm.match_new_features_for_triangulation(
        cam, feats_desc, feats_px, feats_valid, SE3.from_params7(T_new7),
        ms.row(mstate.feat_desc, nbr_slot), ms.row(mstate.feat_px, nbr_slot), ref_free,
        mstate.kf_pose(nbr_slot), angle_new=feats_angle,
        angle_ref=ms.row(mstate.feat_angle, nbr_slot))


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

    Returns (MapState, kf_images, depthless [Fn]: valid detections left
    without a landmark)."""
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
    pos_w, good, _ = triangulate(cam, mstate, new_px, new_desc, new_valid, new_angle, T_cw7,
                                 last_kf_slot)
    if nbr2_slot is not None:
        # Where both baselines pass, the longer one wins.
        pos_w2, good2, _ = triangulate(cam, mstate, new_px, new_desc, new_valid, new_angle,
                                       T_cw7, nbr2_slot)
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
    return st, kf_images, depthless


def kf_cycle(cam, o: VOOptions, mstate: ms.MapState, pyr, found, obs_px, T_cw7, last_kf_slot,
             nbr2_slot, fid, kf_images):
    """The synchronous half of keyframe insertion, all on the device: slot
    allocation or the choice of a victim (the used slot least covisible
    with the newest keyframe), the victim's archive snapshot, its
    invalidation, the covisibility refresh and orphan sweep that follow an
    eviction (landmarks the tracker currently observes are spared),
    landmark-row allocation, and `assemble_keyframe`.

    Returns (MapState, kf_images, host_block): host_block is (slot, evicted,
    evict_fid, any depthless detection) followed by the snapshot (pose7,
    feat_desc, feat_px, feat_valid, landmark positions, their validity,
    feat_angle, feat_level, image), garbage rows when nothing was evicted;
    fetching it is the one host transfer of a keyframe."""
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
    st, kf_images, depthless = assemble_keyframe(
        cam, o, m2, pyr, found, obs_px, T_cw7, last_kf_slot, rows, n_free, slot, fid, kf_images,
        nbr2_slot=nbr2_slot)
    host_block = (slot, evicted, evict_fid, torch.any(depthless)) + snapshot
    return st, kf_images, host_block
