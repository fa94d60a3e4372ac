"""VisualOdometry: the monocular frontend state machine over the VO's
per-frame map-tracking step and keyframe cycle (counterpart of
ygz_slam_tpu/models/visual_odometry.py: the three frontends and map types,
with the JAX package's defaults, the depth filter, the BoW vocabulary,
relocalization against the active keyframe window and the keyframe archive,
loop closing within the window and against the archive, epoch merging and
async mapping).

The device steps are plain functions over MapState (`track`,
`triangulate`, `free_rows`, `assemble_keyframe`, `kf_cycle`,
`arc_snapshot`, `mapping_pass`: the JAX package's `_track`, `_triangulate`,
`_free_rows_device`, `_assemble_core`, `_kf_cycle`, `_arc_snapshot` and
`_map_pass`).
`VisualOdometry` is the host state machine around them
(NOT_READY/INITING/GOOD/LOST, VisualOdometry.cpp:38-107): monocular
initialization (KLT, descriptor re-check, RANSAC H/F, two-view BA, mean
depth 1, the first local BA), tracking with inlier-gate hysteresis, the
keyframe decision, keyframe insertion and the mapping pass, and lost
handling with a retry, relocalization (`models/relocalization.py`: BoW
candidates, one K10 launch for their matching, P3P-RANSAC seeds, one K8
launch for their pose solves), then against the archive of keyframes the
window evicted or culled (`map/archive.py`; a hit reactivates the archived
keyframe into the window), and a reset (the window archived into its
epoch), and the NOT_READY resume against a surviving map.  Its host syncs
(`int(...)`, `bool(...)`) are the JAX package's own.

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
seeds promoted to landmarks and new seeds on the depthless detections;
with a vocabulary, the new keyframe's BoW row (`keyframe_bow`).  The
mapping pass then runs, with loop closing, `detect_loop` (one K10 and one
K5 launch) and `close_loop` (the SE(3) pose graph) before local BA, and,
against the archive, `detect_loop_archive` (K10 per 512 archive rows, one
K10 and one K8 launch) after it; a found archive loop merges an older epoch
into the current one (`_merge_epochs`), or, where its correction is
significant, is closed by the global Sim(3) pose graph (`_close_loop_global`).
With `async_mapping` the pass runs on a worker thread, on the caller's
stream, and every consumer of the map joins it first (`_join_mapping`).
With a depth sensor (`add_frame(depth=)`, `add_frame(right=)`: the JAX
package's RGBD and STEREO modes) the map starts on the first frame from the
sensor's depths (`_init_rgbd`), and keyframes take the JAX package's eager
branch (`_insert_sensor_keyframe`: triangulation against the last keyframe,
one K10 launch, overridden by the sensor; host-side seed promotion); the
DENSE map type collects each sensor keyframe's back-projected depth image.
`set_vocabulary` / `refresh_vocabulary` swap the BoW vocabulary (a loaded
map's, or one retrained on the run's descriptors).
The other frontends replace the per-frame step (`_run_tracker`):
SPARSE_ORB (`track_orb`: detection, then `models/orb_tracking.py`'s
projection matching and pose BA twice, two K10 and two K5 launches, and a
widened second-chance pass, `track_orb_wide`, for a frame under the inlier
gate) and SEMI_DENSE_DIRECT (`track_sd`: alignment against the last
keyframe over its features and gradient pixels, `models/semidense.py`,
then map tracking over all landmarks and the gradient pixels' seed
update).  With SEMI_DENSE_DIRECT or the SEMI_DENSE map every keyframe
seeds a gradient-pixel set (`sd_init`) and exports the last one's
converged seeds into the semi-dense cloud (`_refresh_semidense`).
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
import contextlib
import dataclasses
import enum
import os
import threading

import numpy as np
import torch

from .. import resolve_device
from ..geometry.se3 import SE3
from ..map import depth_filter as dfilt
from ..map import state as ms
from ..map import vocabulary as voc
from ..map.archive import ArchiveView, KeyframeArchive
from ..map.memory import MapServer, refresh_covisibility
from ..ops import kernels, orb, sparse_align
from ..ops.align import klt_pyramidal
from ..ops.hamming import distance_matrix, hamming_distance
from ..ops.select import top_k
from ..ops.stereo import match_stereo
from ..solvers import ba as bam
from ..solvers import initializer as init_mod
from ..utils import np_se3
from . import frontend as fe
from . import local_mapping as lm
from . import orb_tracking as orbt
from . import relocalization as reloc
from . import semidense as sdm

INT32_MAX = 2 ** 31 - 1

_VOCAB_CACHE: dict = {}


def _shared_vocabulary(prefer_asset: bool = True, device=None):
    """The process-wide ORB vocabulary on `device` (the card unless named):
    the packaged 10^4-word asset (`map/vocabulary.ASSET`, the role of DBoW3's
    pretrained ORBvoc.bin), or, with prefer_asset=False or without the
    asset, a 512-word bootstrap (k=8, depth 3) trained on four PlaneScene
    renders with the port's FAST and ORB (the JAX package's
    `_shared_vocabulary`)."""
    dev = resolve_device(device)
    key = ("asset" if prefer_asset and os.path.exists(voc.ASSET) else "bootstrap", dev)
    if key in _VOCAB_CACHE:
        return _VOCAB_CACHE[key]
    if key[0] == "asset":
        _VOCAB_CACHE[key] = voc.load(voc.ASSET, device=dev)
    else:
        from ..geometry.camera import PinholeCamera
        from ..ops import fast
        from ..utils.synthetic import PlaneScene

        cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
        descs = []
        for i in range(4):
            img = PlaneScene(cam, plane_z=3.0, seed=1000 + i, device=dev).render(
                SE3.identity(device=dev), (240, 320))
            c = fast.detect(img, 20.0, cell=12, max_corners=200)
            _, d = orb.compute(img, c.xy)
            descs.append(d[c.mask])
        _VOCAB_CACHE[key] = voc.train(torch.cat(descs), k=8, depth=3, iters=4, device=dev)
    return _VOCAB_CACHE[key]


class Status(enum.Enum):
    NOT_READY = 0
    INITING = 1
    GOOD = 2
    LOST = 3


class VOType(enum.Enum):
    """Frontend method (system.h:26-30): SPARSE_DIRECT (photometric
    alignment, then map patch tracking), SPARSE_ORB (descriptor matching by
    projection, `models/orb_tracking.py`) or SEMI_DENSE_DIRECT (alignment
    over the keyframe's features and gradient pixels, `models/semidense.py`)."""
    SPARSE_DIRECT = 0
    SPARSE_ORB = 1
    SEMI_DENSE_DIRECT = 2


class MapType(enum.Enum):
    """Map content (system.h:33-37).  SPARSE: landmarks only; SEMI_DENSE:
    with each keyframe's converged gradient-pixel seeds back-projected; DENSE:
    with each sensor keyframe's depth image back-projected (RGBD)."""
    SPARSE = 0
    SEMI_DENSE = 1
    DENSE = 2


@dataclasses.dataclass(frozen=True)
class VOOptions:
    """The fields of the JAX package's VOOptions that the port reads, with
    its defaults (config/default.yaml, VisualOdometry.h:32-45).  The port
    runs every switch at the end: `use_depth_filter`, `use_vocabulary` (BoW
    rows per keyframe, relocalization when lost and the NOT_READY resume),
    `archive_map` (the keyframe archive and its relocalization),
    `loop_closing` (within the active window and, with the archive, against
    it: the global pose graph, Sim(3) with `sim3_loops`, and epoch merging)
    and `async_mapping` (the mapping pass on a worker thread), every
    `vo_type` (the `orb_*` fields: SPARSE_ORB's windows, Hamming bound and
    second-chance search; the `sd_*` fields: the gradient pixels of
    SEMI_DENSE_DIRECT and of the SEMI_DENSE map) and every `map_type`."""
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
    lost_reloc_after: int = 3             # failed retries before relocalization is tried
    lost_desc_max_dist: int = 64          # Hamming bound of the lost-retry re-check
    kf_cull_min_window: int = 4           # KeyFrameCulling keeps at least this many
    chunk_frames: int = 32                # add_frames: frames per chunk
    use_depth_filter: bool = True
    use_vocabulary: bool = True
    vocab_asset: bool = True              # the packaged 10^4-word vocabulary; False: a bootstrap
    reloc_min_inliers: int = 20
    reloc_top_c: int = 10                 # BoW candidates verified per relocalization attempt
    reloc_use_pnp: bool = True            # P3P-RANSAC pose seed (else the stored keyframe pose)
    loop_closing: bool = True
    loop_min_inliers: int = 25            # detect_loop's verification gate
    archive_map: bool = True
    loop_min_frame_gap: int = 50          # archive loop candidates are this many frames older
    loop_top_c: int = 8                   # archive loop candidates verified per keyframe
    loop_min_corr_trans: float = 0.02     # an archive loop is applied only when its correction
    loop_min_corr_rot: float = 0.01       # at the new keyframe exceeds one of these (map units,
    loop_min_corr_scale: float = 0.02     # rad, |ln scale|); else it counts as a confirmation
    loop_cooldown_frames: int = 30        # frames after an applied closure before the next
    global_pg_iters: int = 25             # global pose-graph Gauss-Newton iterations
    sim3_loops: bool = True               # the global pose graph over Sim(3) (else SE(3))
    async_mapping: bool = True
    stereo_baseline: float = 0.1          # metres (STEREO sensor)
    vo_type: VOType = VOType.SPARSE_DIRECT
    map_type: MapType = MapType.SPARSE
    orb_match_radius: float = 15.0        # SPARSE_ORB projection window, px at level 0
    orb_second_chance: bool = True        # a widened re-search before a sub-gate frame counts
    orb_wide_radius_mult: float = 3.0     # its window multiplier
    orb_max_hamming: int = 80             # projection matching bound (ORB-SLAM's TH_HIGH)
    sd_budget: int = 512                  # gradient pixels per keyframe (semi-dense)
    sd_cell: int = 8                      # their grid cell, px
    sd_min_grad: float = 8.0              # their gradient magnitude floor

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
    return tm, count_landmarks(mstate, tm), tr.ok


def count_landmarks(mstate: ms.MapState, tm: fe.TrackMapResult) -> ms.MapState:
    """The landmark statistics after a tracked frame: candidates counted
    visible, inliers found (MapPoint _cnt_visible / _cnt_found)."""
    return mstate._replace(pt_visible=mstate.pt_visible + tm.candidate.to(torch.int32),
                           pt_found=mstate.pt_found + tm.found.to(torch.int32))


def _orb_pass(cam, o: VOOptions, cur_pyr, T_pred7, mstate: ms.MapState, **kw):
    """Detection over the pyramid with the keyframe budgets, then
    `orb_tracking.track_map_orb` of the map's landmarks from T_pred7 (two
    K10 and two K5 launches) with the windows and bounds `kw`; no
    rotation-histogram gate (a landmark's creation-time ORB angle drifts
    across views)."""
    feats = fe.detect_multilevel(cur_pyr, o.detect_threshold, o.grid_cell, o.feat_budgets)
    return orbt.track_map_orb(tuple(cur_pyr[0].shape), cam, SE3.from_params7(T_pred7),
                              mstate.pt_pos, mstate.pt_valid, mstate.pt_desc, feats, **kw)


def track_orb(cam, o: VOOptions, cur_pyr, T_pred7, mstate: ms.MapState):
    """One SPARSE_ORB frame from the motion model's pose (the JAX package's
    `_track_orb`; no photometric alignment).  Returns (TrackMapResult over
    all L landmark rows, MapState with updated statistics)."""
    tm = _orb_pass(cam, o, cur_pyr, T_pred7, mstate, radius_coarse=o.orb_match_radius,
                   max_dist=o.orb_max_hamming, max_step_motion=o.max_step_motion)
    return tm, count_landmarks(mstate, tm)


def track_orb_wide(cam, o: VOOptions, cur_pyr, T_pred7, mstate: ms.MapState):
    """SPARSE_ORB's second-chance pass (the JAX `_track_orb_wide`), for a
    frame whose motion-model window missed: windows `orb_wide_radius_mult`
    times wider (coarse and fine), the Hamming bound relaxed by 20 (at most
    128) and the step gate doubled, from the pose the caller gives (the
    previous frame's).  The landmark statistics are left to the caller (a
    failed wide pass must not lower found ratios).  Returns the
    TrackMapResult."""
    return _orb_pass(cam, o, cur_pyr, T_pred7, mstate,
                     radius_coarse=o.orb_match_radius * o.orb_wide_radius_mult,
                     radius_fine=6.0 * o.orb_wide_radius_mult,
                     max_dist=min(o.orb_max_hamming + 20, 128),
                     max_step_motion=2.0 * o.max_step_motion)


def track_sd(cam, o: VOOptions, sd: sdm.SemiDensePoints, kf_img, cur_pyr, T_pred7,
             mstate: ms.MapState, kf_images):
    """One SEMI_DENSE_DIRECT frame (the JAX `_track_sd`): the keyframe's
    pyramid built from `kf_img` (its level 0), sparse-direct alignment
    against it over its features with a depth and its usable gradient
    pixels (`track_ref_frame`: K1 x 2 and K3 at map_F + sd_budget points),
    the affine-warped reference patches of all L landmarks, map tracking
    over all of them (K2, K4, K5 at L rows) and their statistics, then the
    gradient pixels' seeds updated at the refined pose.  Returns
    (TrackMapResult, MapState, the alignment's motion-gate flag, the
    updated SemiDensePoints)."""
    slot = sd.kf_slot
    T_kf = mstate.kf_pose(slot)
    kf_pyr = fe.preprocess(kf_img, o.n_levels)
    px, depth, pmask = sdm.alignment_point_set(sd, ms.row(mstate.feat_px, slot),
                                               ms.row(mstate.feat_depth, slot),
                                               ms.row(mstate.feat_valid, slot))
    tr = fe.track_ref_frame(kf_pyr, cur_pyr, cam, T_kf, px, depth, pmask,
                            SE3.from_params7(T_pred7), max_motion=o.max_alignment_motion)
    patches, patch_ok, search_lvl = fe.reference_patches_for_landmarks(
        kf_images, mstate.kf_pose7, mstate.feat_px.reshape(-1, 2), mstate.feat_level.reshape(-1),
        mstate.pt_ref_feat, mstate.pt_pos, mstate.pt_valid, cam, tr.T_cw,
        max_level=o.n_levels - 1)
    tm = fe.track_local_map(cur_pyr, cam, tr.T_cw, mstate.pt_pos, mstate.pt_valid, patches,
                            patch_ok, search_lvl, max_step_motion=o.max_step_motion)
    sd = sdm.update(sd, kf_img, cur_pyr[0], cam, tm.T_cw.compose(T_kf.inverse()))
    return tm, count_landmarks(mstate, tm), tr.ok, sd


def sd_init(o: VOOptions, img, slot: int, depth_mean: float) -> sdm.SemiDensePoints:
    """The gradient pixels of keyframe `slot` (image `img`, its level 0)
    with unit-depth seeds rescaled to the scene's mean depth `depth_mean`
    (the JAX `_sd_init`, in its order and float32 arithmetic: mu / d,
    z_range / max(d, 1e-3), sigma2 / max(d, 1e-3)^2)."""
    px, valid = sdm.select_gradient_pixels(img, cell=o.sd_cell, budget=o.sd_budget,
                                           min_grad=o.sd_min_grad)
    seeds = dfilt.Seeds.init(px, valid, depth_mean=1.0, depth_min=0.1)
    d = torch.tensor(depth_mean, dtype=torch.float32, device=img.device)
    dc = torch.clamp(d, min=1e-3)
    seeds = seeds._replace(mu=seeds.mu / d, z_range=seeds.z_range / dc, sigma2=seeds.sigma2 / dc ** 2)
    return sdm.SemiDensePoints(px=px, seeds=seeds, kf_slot=int(slot))


def sd_export(cam, sd: sdm.SemiDensePoints, mstate: ms.MapState):
    """The converged gradient-pixel seeds of `sd` as world points at its
    keyframe's current pose: (points [M, 3], valid [M])."""
    return sdm.export_points(sd, mstate.kf_pose(sd.kf_slot), cam)


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


def presweep(mstate: ms.MapState, found: torch.Tensor) -> ms.MapState:
    """After an eviction: covisibility refreshed and the landmarks no
    keyframe observes any more invalidated, sparing those the tracker
    observes in this frame (`found` [L]; the feature table re-links them to
    the new keyframe)."""
    swept = ms.update_covisibility(mstate)
    return swept._replace(pt_valid=swept.pt_valid & ((swept.pt_obs != 0) | found))


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
    snapshot = arc_snapshot(mstate, kf_images, slot)
    fp = ms.row(mstate.feat_point, slot)
    f_valid = ms.row(mstate.feat_valid, slot)
    # --- invalidate the victim; refresh + sweep only on eviction ---
    m2 = mstate._replace(
        kf_valid=ms.set_row(mstate.kf_valid, slot, ms.row(mstate.kf_valid, slot) & ~evicted),
        feat_valid=ms.set_row(mstate.feat_valid, slot, f_valid & ~evicted),
        feat_point=ms.set_row(mstate.feat_point, slot, torch.where(evicted, -1, fp)))
    m2 = ms.MapState(*(torch.where(evicted, a, b) for a, b in zip(presweep(m2, found), m2)))
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


def arc_snapshot(mstate: ms.MapState, kf_images, slot):
    """Keyframe `slot`'s archive record, gathered on the device before the
    slot is invalidated (the JAX `_arc_snapshot`, shared with `kf_cycle`):
    (pose7, feat_desc, feat_px, feat_valid, the world position of each
    feature's landmark, whether the feature has a live landmark, feat_angle,
    feat_level, the keyframe image)."""
    fp = ms.row(mstate.feat_point, slot)
    f_valid = ms.row(mstate.feat_valid, slot)
    ptsafe = torch.clamp(fp, 0, mstate.L - 1).long()
    return (ms.row(mstate.kf_pose7, slot), ms.row(mstate.feat_desc, slot),
            ms.row(mstate.feat_px, slot), f_valid, mstate.pt_pos[ptsafe],
            f_valid & (fp >= 0) & mstate.pt_valid[ptsafe],
            ms.row(mstate.feat_angle, slot), ms.row(mstate.feat_level, slot),
            ms.row(kf_images, slot))


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
                 T_cw: SE3, via_params7: bool = False) -> dfilt.Seeds:
    """The depth filter's per-frame step (the JAX package's
    `_track_with_seeds` after `_track`): the seeds of keyframe `seed_slot`
    (a Python int or a device index) updated against a frame's level 0 at
    its refined pose T_cw.  With `via_params7` the keyframe-to-frame motion
    goes through its params7 first, as the JAX package's separate dispatch
    for the other frontends (`_update_seeds`) takes it."""
    T_seed = SE3.from_params7(ms.row(kf_pose7, seed_slot))
    T_cur_ref = T_cw.compose(T_seed.inverse())
    if via_params7:
        T_cur_ref = SE3.from_params7(T_cur_ref.params7())
    return dfilt.update_seeds_from_frame(seeds, ms.row(kf_images, seed_slot), cur_img, cam,
                                         T_cur_ref)


def keyframe_bow(vocab: voc.Vocabulary, mstate: ms.MapState, slot):
    """The BoW row [W] and vocabulary nodes [F] of keyframe `slot` (a Python
    int or a device index), from its feature table (Frame::ComputeBoW,
    Frame.cpp:190-201; the JAX package's `_kf_bow`), on the device."""
    desc, valid = ms.row(mstate.feat_desc, slot), ms.row(mstate.feat_valid, slot)
    words, nodes = voc.transform(vocab, desc, valid)
    return voc.bow_vector(vocab, words, valid), nodes


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


def mapping_pass(cam, o: VOOptions, mstate: ms.MapState, fixed: torch.Tensor, loop=None):
    """The keyframe mapping pass on the device: covisibility refresh and
    orphan sweep; with `loop` = (vocabulary, new keyframe slot, kf_bow,
    kf_nodes), active-window loop closing (`relocalization.detect_loop`,
    then `close_loop`, whose corrected poses and points are kept where a
    loop was found); `mapping`; the keyframe-redundancy scores.  Returns
    (MapState, scores [K], found: a 0-d bool, False without `loop`); nothing
    waits for the device."""
    mstate = refresh_covisibility(mstate)
    found = torch.zeros((), dtype=torch.bool, device=mstate.pt_pos.device)
    if loop is not None:
        vocab, slot, kf_bow, kf_nodes = loop
        lp = reloc.detect_loop(
            vocab, cam, slot, kf_bow, mstate.kf_valid, mstate.kf_pose7, mstate.cov_weight,
            mstate.feat_desc.reshape(-1, 8), kf_nodes.reshape(-1), mstate.feat_px.reshape(-1, 2),
            mstate.feat_point.reshape(-1), mstate.feat_valid.reshape(-1), mstate.pt_pos,
            mstate.pt_valid, min_inliers=o.loop_min_inliers,
            feat_angle_flat=mstate.feat_angle.reshape(-1))
        pose7, pts, _ = reloc.close_loop(
            mstate.kf_pose7, mstate.kf_valid, mstate.cov_weight, mstate.pt_pos, mstate.pt_valid,
            mstate.pt_first_kf, slot, lp, feat_point=mstate.feat_point,
            feat_valid=mstate.feat_valid)
        mstate = mstate._replace(kf_pose7=pose7, pt_pos=pts)
        found = lp.found
    mstate, _ = mapping(cam, o, mstate, fixed)
    return mstate, kf_redundancy(mstate), found


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


class VisualOdometry:
    """VO over a fixed-capacity tensor map, on `device` (the card unless the
    caller names another): monocular, or with a depth image (RGBD) or a
    rectified right image (STEREO) per frame (`add_frame(depth=, right=)`)."""

    def __init__(self, cam, opts: VOOptions | None = None, device=None):
        o = opts or VOOptions()
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
        self.cur_depth = None          # this frame's depth image [H, W] (RGBD)
        self.cur_right = None          # this frame's rectified right image (STEREO)
        self.semidense_cloud: list = []   # [_, 3] arrays: earlier keyframes' converged seeds,
                                          # or a loaded map's `__aux_cloud`
        self.dense_cloud: list = []       # DENSE map: one [_, 3] array per sensor keyframe
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
        # The last keyframe's gradient pixels and their seeds
        # (SEMI_DENSE_DIRECT or the SEMI_DENSE map).
        self.sd: sdm.SemiDensePoints | None = None
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
        # The vocabulary, and per keyframe slot its BoW row and vocabulary
        # nodes (rows of invalid slots are masked by kf_valid).
        self.vocab = (_shared_vocabulary(prefer_asset=o.vocab_asset, device=self.device)
                      if o.use_vocabulary else None)
        self.kf_bow = self.kf_nodes = None
        if self.vocab is not None:
            self.kf_bow = torch.zeros((o.map_K, self.vocab.n_words), dtype=torch.float32,
                                      device=self.device)
            self.kf_nodes = torch.full((o.map_K, o.map_F), -1, dtype=torch.int32,
                                       device=self.device)
        # The keyframe archive: every keyframe the window evicts or culls,
        # tagged with its map epoch (a reset starts a new one).
        self.epoch = 0
        self._fid_epoch: dict[int, int] = {}     # logged keyframe id -> epoch
        self._last_reloc_arc_idx = None          # archive row of the last archive relocalization
        self.archive = (KeyframeArchive(o.map_F, self.vocab.n_words if self.vocab else 1,
                                        device=self.device) if o.archive_map else None)
        if self.archive is not None:
            self.server.on_evict = self._archive_kf
        self._last_loop_fid = -10 ** 9           # keyframe of the last applied archive loop
        # Async mapping: the worker running the keyframe's mapping pass, its
        # result or exception, and the first trajectory entry appended while
        # it runs (re-anchored at the join).
        self._map_thread: threading.Thread | None = None
        self._map_pending_pose7 = None
        self._map_exc: BaseException | None = None
        self._map_fixup_start = 0

    def _identity(self) -> SE3:
        return SE3.identity(device=self.device)

    # ------------------------------------------------------------------
    def add_frame(self, img, timestamp: float = 0.0, depth=None, right=None) -> TrackResult:
        """Track one image [H, W] (VisualOdometry::AddFrame, :38-107), with
        its depth image [H, W] in metres (RGBD) or its rectified right image
        (STEREO) if given: the map then starts from the first frame with
        depth-initialized landmarks (no two-view bootstrap), and keyframes
        take new features' depths from the sensor."""
        self._join_mapping()
        self.frame_id += 1
        if self.status is not Status.GOOD:
            self._low_streak = 0       # hysteresis counts GOOD frames only
        pyr = fe.preprocess(torch.as_tensor(img, dtype=torch.float32, device=self.device),
                            self.o.n_levels)
        self.cur_depth = (None if depth is None else
                          torch.as_tensor(depth, dtype=torch.float32, device=self.device))
        self.cur_right = (None if right is None else
                          torch.as_tensor(right, dtype=torch.float32, device=self.device))
        if self.kf_images is None:
            self.kf_images = torch.zeros((self.o.map_K,) + tuple(pyr[0].shape),
                                         dtype=torch.float32, device=self.device)
        if self.status is Status.NOT_READY:
            # A surviving (or loaded) map: resume by relocalizing against it;
            # else a sensor frame starts the map, a monocular one the bootstrap.
            res = (self._resume(pyr) if self.server.kf_used and self.vocab is not None
                   else None)
            if res is None:
                res = (self._init_rgbd(pyr) if depth is not None or right is not None
                       else self._start_init(pyr))
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
        path, and so does every frame of a frontend other than SPARSE_DIRECT
        or a map type other than SPARSE.
        The results, trajectory and map equal repeated `add_frame` bit for
        bit.  Returns a TrackResult per frame."""
        n = len(imgs)
        ts = list(timestamps) if timestamps is not None else [0.0] * n
        chunk = chunk or self.o.chunk_frames
        eligible = self.o.vo_type is VOType.SPARSE_DIRECT and self.o.map_type is MapType.SPARSE
        results: list[TrackResult] = []
        i = 0
        while i < n:
            # No chunk (nor its graph capture) starts while a mapping pass runs.
            self._join_mapping()
            if (not eligible or self.status is not Status.GOOD or n - i < chunk
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
    def _resume(self, pyr) -> TrackResult | None:
        """Relocalize against the map instead of re-initializing (the JAX
        package's NOT_READY branch, :1299-1333); None if the attempt fails.
        Tracking continues from the recovered pose, anchored at the
        reactivated keyframe after an archive hit, else at the newest
        keyframe with an empty last-frame set."""
        r = self._try_relocalize(pyr)
        if r is None:
            return None
        srv = self.server
        self._relocalized(pyr, r.T_cw)
        if self._last_reloc_arc_idx is None:
            self.last_kf_slot = srv.kf_used[-1]
            self.frames_since_kf = 0
            self._last_kf_fid = int(srv.state.kf_id[self.last_kf_slot])
            self._last_kf_pose7 = srv.state.kf_pose7[self.last_kf_slot].cpu().numpy()
        return TrackResult(Status.GOOD, r.T_cw, int(r.n_inliers))

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

    def _sensor_depths(self, pyr, px, valid):
        """Depths [N] of the pixels px [N, 2] and where they hold, from this
        frame's sensor: the depth image at the truncated, clipped pixel (z >
        0.05 and finite), or rectified stereo matching (`ops.stereo`); none
        without a sensor."""
        H, W = pyr[0].shape
        if self.cur_depth is not None:
            ui = torch.clamp(px[:, 0].to(torch.int32), 0, W - 1).long()
            vi = torch.clamp(px[:, 1].to(torch.int32), 0, H - 1).long()
            z = self.cur_depth[vi, ui]
            return z, valid & (z > 0.05) & torch.isfinite(z)
        if self.cur_right is not None:
            sd = match_stereo(pyr[0], self.cur_right, px, valid, self.cam.fx,
                              self.o.stereo_baseline)
            return sd.depth, sd.ok
        return torch.full_like(px[:, 0], -1.0), torch.zeros_like(valid)

    def _init_rgbd(self, pyr) -> TrackResult:
        """The depth-sensor start (RGBD or stereo): the frame becomes keyframe
        0 at the identity, its detections with a sensor depth landmarks
        (TrackRGBD / TrackStereo, system.h:49-57); NOT_READY with fewer than
        init_min_features / 2 of them."""
        o, srv, dev = self.o, self.server, self.device
        feats = self._detect(pyr)
        z, ok = self._sensor_depths(pyr, feats.px, feats.valid)
        n_ok = int(ok.sum())
        if n_ok < o.init_min_features // 2:
            return TrackResult(Status.NOT_READY, self._identity())
        T1 = self._identity()
        pts = self.cam.pixel_to_world(feats.px, T1, depth=z)
        N = feats.px.shape[0]
        pad = o.map_F - N

        def padded(x, fill=0):
            return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                            device=dev)])

        rows = torch.arange(N, dtype=torch.int32, device=dev)
        slot0 = srv.register_keyframe(
            self.frame_id, T1, padded(feats.px), padded(feats.level), padded(feats.angle),
            padded(feats.desc), padded(torch.where(ok, z, -1.0), -1.0),
            padded(torch.where(ok, rows, -1), -1), padded(ok, False))
        srv.state = ms.add_landmarks(srv.state, rows, ok, pts, feats.desc, slot0,
                                     ref_feat=slot0 * o.map_F + rows)
        self.kf_images = ms.set_row(self.kf_images, slot0, pyr[0])
        self._store_bow(slot0)
        srv.refresh_covisibility()
        L = o.map_L
        self.prev_pyr = pyr
        self.prev_T_cw = self.T_cw = T1
        self.prev_found = torch.zeros(L, dtype=torch.bool, device=dev).index_copy(
            0, rows.long(), ok)
        self.prev_obs_px = torch.zeros((L, 2), dtype=torch.float32, device=dev).index_copy(
            0, rows.long(), feats.px)
        self.velocity = self._identity()
        self.last_kf_slot = slot0
        self._last_kf_fid = self.frame_id
        self._last_kf_pose7 = srv.state.kf_pose7[slot0].cpu().numpy()
        self.frames_since_kf = 0
        self.status = Status.GOOD
        self._refresh_semidense(pyr, slot0)
        return TrackResult(Status.GOOD, T1, n_ok)

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
        self._store_bow(slot0)
        self._store_bow(slot1)
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
        self._refresh_semidense(pyr, slot1)

    # -- GOOD -----------------------------------------------------------
    def _run_tracker(self, pyr, T_pred: SE3):
        """One frame through the configured frontend from T_pred: (its
        TrackMapResult, the MapState with the landmark statistics, the
        alignment's motion-gate flag).  SEMI_DENSE_DIRECT updates its
        gradient pixels' seeds here, whatever the frame's outcome, and runs
        the SPARSE_DIRECT step until its first keyframe holds a set."""
        o = self.o
        if o.vo_type is VOType.SPARSE_ORB:
            tm, new_state = track_orb(self.cam, o, pyr, T_pred.params7(), self.server.state)
            return tm, new_state, True
        if o.vo_type is VOType.SEMI_DENSE_DIRECT and self.sd is not None:
            tm, new_state, ok, self.sd = track_sd(
                self.cam, o, self.sd, ms.row(self.kf_images, self.sd.kf_slot), pyr,
                T_pred.params7(), self.server.state, self.kf_images)
            return tm, new_state, ok
        return track(self.cam, o, self.prev_pyr, pyr, self.prev_T_cw.params7(),
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
        if n_inl < o.min_track_inliers and o.vo_type is VOType.SPARSE_ORB and o.orb_second_chance:
            # The widened search from the previous pose (the motion model is
            # what just failed); a pass that clears the gate replaces the frame's.
            tm2 = track_orb_wide(self.cam, o, pyr, self.prev_T_cw.params7(), self.server.state)
            n2 = int(tm2.n_inliers)
            if n2 >= o.min_track_inliers:
                self.stats["orb_second_chance_hits"] += 1
                tm, n_inl = tm2, n2
                new_state = count_landmarks(self.server.state, tm2)
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
                                      self.seed_kf_slot, pyr[0], T_cw,
                                      via_params7=o.vo_type is not VOType.SPARSE_DIRECT)
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
        and depth-filter flags and the victim's pose, the victim archived
        from the cycle's snapshot, then the mapping pass.  A frame with a
        depth sensor takes the eager branch (`_insert_sensor_keyframe`)."""
        o, srv = self.o, self.server
        self.stats["keyframes"] += 1
        if self.cur_depth is not None or self.cur_right is not None:
            self._insert_sensor_keyframe(pyr, T_cw, tm)
            return
        used = srv.kf_used
        nbr2 = used[-4] if len(used) >= 4 else used[0]
        with_seeds = self.seeds is not None
        srv.state, self.kf_images, new_seeds, host_block = kf_cycle(
            self.cam, o, srv.state, pyr, tm.found, tm.obs_px, T_cw.params7(),
            self.last_kf_slot, nbr2, self.frame_id, self.kf_images,
            seeds=self.seeds, seed_slot=self.seed_kf_slot if with_seeds else 0,
            seed_feat_idx=self.seed_feat_idx)
        snap_bow = None
        if self.archive is not None and self.vocab is not None:
            # The victim's BoW row, before the new keyframe's overwrites it.
            snap_bow = (ms.row(self.kf_bow, host_block[0]), ms.row(self.kf_nodes, host_block[0]))
        self._store_bow(host_block[0])
        host = torch.cat([torch.stack([host_block[0].long(), host_block[1].long(),
                                       host_block[2].long(), host_block[3].long(),
                                       host_block[-1]]).double(),
                          host_block[4].double()]).tolist()
        slot, evicted, efid, d_any, n_promoted = map(int, host[:5])
        if evicted:
            self.stats["evictions"] += 1
            if efid >= 0 and self.archive is not None:
                self._archive_row(efid, host_block[4:13], snap_bow,
                                  np.asarray(host[5:12], np.float32))
            srv.kf_used.remove(slot)
        srv.kf_used.append(slot)
        self._refresh_semidense(pyr, slot)
        if o.use_depth_filter:
            self.stats["seeds_promoted"] += n_promoted
            self.seeds = new_seeds if d_any else None
            self.seed_kf_slot = slot
            Fl = o.map_F // 2
            self.seed_feat_idx = Fl + torch.arange(o.map_F - Fl, dtype=torch.int32,
                                                   device=self.device)
        self._finish_insert(T_cw, slot)

    def _insert_sensor_keyframe(self, pyr, T_cw: SE3, tm) -> None:
        """Keyframe insertion with a depth sensor (the JAX package's eager
        branch of `_insert_keyframe`, :1920-2036, in its order): with a full
        window, a slot evicted (and archived) first and the presweep; the
        feature table (the Fl most observed tracked landmarks, Fn new
        detections away from them); triangulation of the detections against
        the last keyframe (one K10 launch), overridden where the sensor gives
        a depth; landmark rows from the host; registration, the BoW row,
        the tracked landmarks' descriptors refreshed, the new landmarks,
        the image, fusion with the neighbours (K10); the DENSE cloud; then
        the depth filter: the last keyframe's converged seeds promoted on the
        host (`_promote_seeds`) and new seeds on the depthless detections at
        the map's mean depth; then the mapping pass (`_finish_insert`)."""
        o, srv, cam, dev = self.o, self.server, self.cam, self.device
        L, F = o.map_L, o.map_F
        Fl = F // 2
        Fn = F - Fl
        if len(srv.kf_used) >= o.map_K:
            # Evict now, so the evictee's orphaned landmark rows are free for
            # this keyframe; landmarks tracked in this frame are spared.
            srv.alloc_kf_slot()
            self.stats["evictions"] += 1
            srv.state = presweep(srv.state, tm.found)
        mstate = srv.state
        T_cw7 = T_cw.params7()
        _, top_rows = top_k(tm.found.to(torch.int32) * (1 + mstate.pt_obs), Fl)
        lm_rows = top_rows.to(torch.int32)
        lm_ok = tm.found[top_rows]
        lm_px = tm.obs_px[top_rows]
        z = T_cw.apply(mstate.pt_pos[top_rows])[:, 2]
        feats = self._detect(pyr, lm_px, lm_ok)
        new_px, new_valid, new_desc = feats.px[:Fn], feats.valid[:Fn], feats.desc[:Fn]
        new_level, new_angle = feats.level[:Fn], feats.angle[:Fn]
        dist = neighbour_distances(mstate, new_desc, [self.last_kf_slot])[0]
        pos_w, good, _ = triangulate(cam, mstate, new_px, new_valid, new_angle, T_cw7,
                                     self.last_kf_slot, dist)
        zd, dok = self._sensor_depths(pyr, new_px, new_valid)
        pos_w = torch.where(dok[:, None], cam.pixel_to_world(new_px, T_cw, depth=zd), pos_w)
        good = dok | good
        rows_np = srv.alloc_landmark_rows(Fn)
        n_free = len(rows_np)
        rows = torch.full((Fn,), L - 1, dtype=torch.int32, device=dev)
        rows[:n_free] = torch.as_tensor(rows_np, device=dev)
        ar_n = torch.arange(Fn, dtype=torch.int32, device=dev)
        can_write = good & (ar_n < n_free)
        lm_angle, lm_desc = orb.compute(pyr[0], lm_px)
        z_new = T_cw.apply(pos_w)[:, 2]
        slot = srv.register_keyframe(
            self.frame_id, T_cw, torch.cat([lm_px, new_px]),
            torch.cat([torch.zeros(Fl, dtype=torch.int32, device=dev), new_level]),
            torch.cat([lm_angle, new_angle]), torch.cat([lm_desc, new_desc]),
            torch.cat([torch.where(lm_ok, z, -1.0), torch.where(can_write, z_new, -1.0)]),
            torch.cat([torch.where(lm_ok, lm_rows, -1), torch.where(can_write, rows, -1)]),
            torch.cat([lm_ok, new_valid]))
        self._store_bow(slot)
        st = srv.state
        st = st._replace(pt_desc=st.pt_desc.index_copy(
            0, top_rows, torch.where(lm_ok[:, None], lm_desc, st.pt_desc[top_rows])))
        srv.state = ms.add_landmarks(st, rows, can_write, pos_w, new_desc, slot,
                                     ref_feat=slot * F + Fl + ar_n)
        self.kf_images = ms.set_row(self.kf_images, slot, pyr[0])
        # Fusion before seeding: a fused feature must not also start a seed.
        srv.state = lm.search_in_neighbors(srv.state, cam, slot)
        self._refresh_semidense(pyr, slot)
        if o.use_depth_filter:
            self._promote_seeds()
            depthless = new_valid & ~can_write & (ms.row(srv.state.feat_point, slot)[Fl:] < 0)
            if bool(depthless.any()):
                n_valid = max(int(mstate.pt_valid.sum()), 1)
                z_map = torch.where(mstate.pt_valid,
                                    mstate.kf_pose(self.last_kf_slot).apply(mstate.pt_pos)[:, 2],
                                    0.0)
                mean_d = float(z_map.sum() / torch.tensor(float(n_valid), device=dev)) or 1.0
                self.seeds = dfilt.Seeds.init(new_px, depthless, depth_mean=max(mean_d, 0.5),
                                              depth_min=0.1)
                self.seed_kf_slot = slot
                self.seed_feat_idx = Fl + ar_n
        self._finish_insert(T_cw, slot)

    def _promote_seeds(self) -> None:
        """The sensor branch's seed promotion, on the host (the JAX
        `_promote_seeds`, :2295-2341): seeds converged at sigma < z_range /
        100 become landmarks in rows the server hands out, linked to their
        still unlinked features of the seed keyframe with the seed's depth;
        the seeds are dropped either way."""
        seeds = self.seeds
        if seeds is None:
            return
        self.seeds = None
        conv = seeds.converged(ratio=100.0) & seeds.valid
        if int(conv.sum()) == 0:
            return
        o, srv, dev = self.o, self.server, self.device
        n = conv.shape[0]
        rows_np = srv.alloc_landmark_rows(n)
        rows = torch.full((n,), o.map_L - 1, dtype=torch.int32, device=dev)
        rows[:len(rows_np)] = torch.as_tensor(rows_np, device=dev)
        slot, idx = self.seed_kf_slot, self.seed_feat_idx.long()
        m = srv.state
        fp = ms.row(m.feat_point, slot)
        can = conv & (fp[idx] < 0) & (torch.arange(n, device=dev) < len(rows_np))
        depth = seeds.depth()
        pos_w = self.cam.pixel_to_world(seeds.px, m.kf_pose(slot), depth=depth)
        m = ms.add_landmarks(m, rows, can, pos_w, ms.row(m.feat_desc, slot)[idx], slot,
                             ref_feat=slot * o.map_F + self.seed_feat_idx.to(torch.int32))
        fd = ms.row(m.feat_depth, slot)
        srv.state = m._replace(
            feat_point=ms.set_row(m.feat_point, slot,
                                  fp.index_copy(0, idx, torch.where(can, rows, fp[idx]))),
            feat_depth=ms.set_row(m.feat_depth, slot,
                                  fd.index_copy(0, idx, torch.where(can, depth, fd[idx]))))
        self.stats["seeds_promoted"] += int(can.sum())

    def _mean_map_depth(self, slot: int) -> float:
        """The mean camera z, in keyframe `slot`, of the valid landmarks in
        front of it (z > 0.05); 1.0 without one."""
        m = self.server.state
        z = m.kf_pose(slot).apply(m.pt_pos)[:, 2]
        sel = m.pt_valid & (z > 0.05)
        n = int(sel.sum())
        if n == 0:
            return 1.0
        return float(torch.where(sel, z, 0.0).sum() / n)

    def _refresh_semidense(self, pyr, slot: int) -> None:
        """At each new keyframe `slot` (the JAX `_refresh_semidense`): with
        the DENSE map and a depth image, its back-projection joins the
        cloud; with SEMI_DENSE_DIRECT or the SEMI_DENSE map, the outgoing
        keyframe's converged gradient-pixel seeds join the semi-dense cloud
        and a fresh gradient-pixel set is seeded on this keyframe's image at
        the map's mean depth."""
        o = self.o
        if o.map_type is MapType.DENSE and self.cur_depth is not None:
            self._accumulate_dense(slot)
        if o.vo_type is not VOType.SEMI_DENSE_DIRECT and o.map_type is not MapType.SEMI_DENSE:
            return
        if self.sd is not None:
            pts, ok = sd_export(self.cam, self.sd, self.server.state)
            if bool(ok.any()):
                self.semidense_cloud.append(pts[ok].cpu().numpy())
        self.sd = sd_init(o, pyr[0], slot, max(self._mean_map_depth(slot), 1e-2))

    def _accumulate_dense(self, slot: int, stride: int = 4) -> None:
        """Every `stride`-th pixel of the depth image in both directions with
        z > 0.05, back-projected from keyframe `slot`'s pose, appended to
        `dense_cloud` as an [N, 3] host array."""
        d = self.cur_depth
        H, W = d.shape
        ys, xs = torch.meshgrid(torch.arange(0, H, stride, device=self.device),
                                torch.arange(0, W, stride, device=self.device), indexing="ij")
        z = d[::stride, ::stride].reshape(-1)
        ok = torch.isfinite(z) & (z > 0.05)
        if not bool(ok.any()):
            return
        px = torch.stack([xs.reshape(-1)[ok], ys.reshape(-1)[ok]], dim=-1).to(torch.float32)
        pts = self.cam.pixel_to_world(px, self.server.state.kf_pose(slot), depth=z[ok])
        self.dense_cloud.append(pts.cpu().numpy())

    def _store_bow(self, slot) -> None:
        """The BoW row and nodes of keyframe `slot` (an int or a device
        index) written at the slot, on the device (the JAX `_store_bow`)."""
        if self.vocab is None:
            return
        bow, nodes = keyframe_bow(self.vocab, self.server.state, slot)
        self.kf_bow = ms.set_row(self.kf_bow, slot, bow)
        self.kf_nodes = ms.set_row(self.kf_nodes, slot, nodes)

    def _finish_insert(self, T_cw: SE3, slot: int) -> None:
        """Bookkeeping and the mapping pass, synchronous or, with
        `async_mapping`, on a worker thread that the next consumer of the
        state joins (`_join_mapping`); tracking continues from the refined
        keyframe pose.  The worker launches on the stream this thread
        launches on, so the card runs the same kernels in the same order as
        the synchronous pass; until the join the keyframe's provisional
        pose anchors the trajectory."""
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        kf_fid = self.frame_id
        if not self.o.async_mapping:
            self._finish_keyframe(self._keyframe_mapping_pass(slot, kf_fid))
            return
        self._last_kf_fid = kf_fid
        self._last_kf_pose7 = T_cw.params7().cpu().numpy()
        self._map_fixup_start = len(self.traj_rel)
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def work():
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    self._map_pending_pose7 = self._keyframe_mapping_pass(slot, kf_fid)
            except BaseException as e:            # re-raised at the join
                self._map_exc = e

        # Not a daemon: the pass is bounded work, and an exit joins it.
        self._map_thread = threading.Thread(target=work, name="ygz-mapping", daemon=False)
        self._map_thread.start()

    def _finish_keyframe(self, pose7: np.ndarray) -> None:
        """Tracking continues from the keyframe's refined pose."""
        self.prev_T_cw = SE3.from_params7(torch.as_tensor(pose7, device=self.device))
        self.T_cw = self.prev_T_cw
        self._last_kf_pose7 = np.asarray(pose7, np.float32)

    def _join_mapping(self) -> None:
        """Wait for the async mapping pass, if one runs; re-raise its
        exception, or publish its refined keyframe pose and re-anchor the
        trajectory entries appended while it ran on that pose (the
        synchronous path's records)."""
        th = self._map_thread
        if th is None:
            return
        th.join()
        self._map_thread = None
        exc, self._map_exc = self._map_exc, None
        if exc is not None:
            raise exc
        self._finish_keyframe(self._map_pending_pose7)
        for i in range(self._map_fixup_start, len(self.traj_rel)):
            ts, fid, _ = self.traj_rel[i]
            if fid == self._last_kf_fid:
                self.traj_rel[i] = (ts, fid, np_se3.relative7(
                    self.trajectory[i][1], self._last_kf_pose7).astype(np.float32))

    def _keyframe_mapping_pass(self, slot: int, kf_fid: int) -> np.ndarray:
        """Loop closing, local BA and culling for a just-inserted keyframe
        (LocalMapping::Run, LocalMapping.cpp:301-336): one device pass (the
        active-window loop block runs with the vocabulary, `loop_closing` and
        at least 4 keyframes), then, where the host allows it before the
        pass (the vocabulary, `loop_closing`, a non-empty archive, the
        cooldown since the last applied archive loop passed), the archive
        loop detection on the pass's state; one host fetch of the scores,
        keyframe poses and ids, whether the window's loop closed and the
        archive detection's outcome; where the window's loop did not close
        and the archive one is found, the archive loop handled
        (`_handle_archive_loop`); keyframe culling.  Returns the keyframe's
        refined params7."""
        o, srv = self.o, self.server
        K = o.map_K
        enable_loop = self.vocab is not None and o.loop_closing and len(srv.kf_used) >= 4
        arc_loop = (self.vocab is not None and o.loop_closing and self.archive is not None
                    and self.archive.count > 0
                    and kf_fid - self._last_loop_fid >= o.loop_cooldown_frames)
        fixed = torch.zeros(K, dtype=torch.bool)
        oldest = srv.kf_used[0]
        fixed[srv.kf_used[:2]] = True
        loop = (self.vocab, slot, self.kf_bow, self.kf_nodes) if enable_loop else None
        srv.state, scores, found = mapping_pass(self.cam, o, srv.state, fixed.to(self.device),
                                                loop=loop)
        parts = [scores.double(), srv.state.kf_pose7.reshape(-1).double(),
                 srv.state.kf_id.double(), found.double().reshape(1)]
        if arc_loop:
            lpa = self._detect_loop_archive(slot, kf_fid, self.archive.device_view())
            parts += [torch.stack([lpa.found.double(), lpa.loop_kf.double(),
                                   lpa.n_inl.double(), lpa.scale.double()]),
                      lpa.T_loop7.double()]
        host = torch.cat(parts).cpu().numpy()
        scores = host[:K].astype(np.float32)
        pose7 = host[K:8 * K].reshape(K, 7).astype(np.float32)
        ids = host[8 * K:9 * K].astype(np.int64)
        closed = bool(host[9 * K])
        if closed:
            self.stats["loops_closed_active"] += 1
        if arc_loop and not closed and host[9 * K + 1]:
            a = host[9 * K + 1:]
            lpa = reloc.LoopResult(found=True, loop_kf=int(a[1]),
                                   T_loop7=a[4:11].astype(np.float32),
                                   scale=float(np.float32(a[3])), n_inl=int(a[2]))
            if self._handle_archive_loop(slot, kf_fid, lpa):
                # The correction rewrote the window's poses after the fetch.
                pose7 = srv.state.kf_pose7.cpu().numpy()
                ids = srv.state.kf_id.cpu().numpy().astype(np.int64)
        self._cull_keyframes(protect={slot, oldest}, scores=scores)
        for s in srv.kf_used:
            fid_s = int(ids[s])
            self.kf_pose_log[fid_s] = pose7[s].copy()
            self._fid_epoch.setdefault(fid_s, self.epoch)
        self._last_kf_fid = int(ids[slot])
        return pose7[slot].copy()

    def _detect_loop_archive(self, slot, kf_fid, arc: ArchiveView) -> reloc.LoopResult:
        """`relocalization.detect_loop_archive` for keyframe `slot` (frame
        `kf_fid`) on the current map against `arc`, with the options' gap,
        gate and candidates (the JAX `_jit_loop_arc`); no host sync."""
        o, m = self.o, self.server.state
        return reloc.detect_loop_archive(
            self.vocab, self.cam, slot, kf_fid, self.kf_bow, m.kf_valid, m.cov_weight,
            m.feat_desc.reshape(-1, 8), self.kf_nodes.reshape(-1), m.feat_px.reshape(-1, 2),
            m.feat_valid.reshape(-1), m.kf_pose7, arc, min_frame_gap=o.loop_min_frame_gap,
            min_inliers=o.loop_min_inliers, feat_angle_flat=m.feat_angle.reshape(-1),
            feat_point_flat=m.feat_point.reshape(-1), pt_pos=m.pt_pos, pt_valid=m.pt_valid,
            top_c=o.loop_top_c)

    def _handle_archive_loop(self, slot: int, kf_fid: int, lp: reloc.LoopResult) -> bool:
        """A found archive loop (host values): a row of another epoch merges
        this epoch into it (`_merge_epochs`); a significant correction is
        applied by the global pose graph (`_close_loop_global`); else the
        loop only confirms the map.  Returns whether the map was corrected
        (which restarts the cooldown)."""
        row_epoch = self.archive.epoch_of(int(lp.loop_kf))
        if row_epoch != self.epoch:
            self._merge_epochs(slot, lp, row_epoch)
            self.stats["maps_merged"] += 1
        elif self._loop_correction_significant(slot, lp):
            self._close_loop_global(slot, lp)
            self.stats["loops_closed_global"] += 1
        else:
            self.stats["loops_confirmed"] += 1
            return False
        self._last_loop_fid = kf_fid
        return True

    def _merge_epochs(self, slot: int, lp: reloc.LoopResult, row_epoch: int) -> None:
        """Rebase the current epoch's map into `row_epoch`'s world frame by
        the Sim(3) the cross-epoch loop measured (the JAX `_merge_epochs`,
        its float64 host arithmetic): with T_opt = T_loop T_arc (this
        keyframe's pose in the old frame) and lambda the loop's scale
        (clipped to [0.2, 5]), points map by p -> T_opt^-1((R_new p + t_new)
        / lambda) and poses rebase rigidly, so the keyframe lands on T_opt.
        The window's poses, landmarks and feature depths, the tracked pose,
        this epoch's logged keyframe poses and archive rows move; the
        velocity resets and the depth filter's seeds are dropped."""
        srv = self.server
        st = srv.state
        dev = self.device
        lam = float(np.clip(float(lp.scale), 0.2, 5.0))
        T_arc7 = self.archive.poses7()[int(lp.loop_kf)]
        T_opt7 = np_se3.compose7(np.asarray(lp.T_loop7), T_arc7)
        R_opt, t_opt = np_se3.params7_to_Rt(T_opt7)
        R_new, t_new = np_se3.params7_to_Rt(st.kf_pose7[slot].cpu().numpy())
        R_B = R_opt.T @ R_new
        t_B = R_opt.T @ (t_new / lam - t_opt)

        def fn_points(p):
            return ((np.asarray(p, np.float64) @ R_new.T + t_new) / lam - t_opt) @ R_opt

        def fn_pose7(p7):
            R_T, t_T = np_se3.params7_to_Rt(np.asarray(p7))
            R_p = R_T @ R_B.T
            return np_se3.Rt_to_params7(R_p, t_T / lam - R_p @ t_B).astype(np.float32)

        kf7 = st.kf_pose7.cpu().numpy().copy()
        for sl in srv.kf_used:
            kf7[sl] = fn_pose7(kf7[sl])
        pts = st.pt_pos.cpu().numpy().copy()
        pv = st.pt_valid.cpu().numpy()
        pts[pv] = fn_points(pts[pv]).astype(np.float32)
        depth = st.feat_depth.cpu().numpy()
        depth = np.where(depth > 0, depth / lam, depth).astype(np.float32)
        srv.state = st._replace(kf_pose7=torch.from_numpy(kf7).to(dev),
                                pt_pos=torch.from_numpy(pts).to(dev),
                                feat_depth=torch.from_numpy(depth).to(dev))
        self.prev_T_cw = SE3.from_params7(torch.as_tensor(
            fn_pose7(self.prev_T_cw.params7().cpu().numpy()), device=dev))
        self.T_cw = SE3.from_params7(torch.as_tensor(
            fn_pose7(self.T_cw.params7().cpu().numpy()), device=dev))
        self.velocity = self._identity()
        if self._last_kf_fid >= 0:
            self._last_kf_pose7 = fn_pose7(self._last_kf_pose7)
        # Logged poses of this epoch only: other epochs live in other frames.
        for fid, p7 in list(self.kf_pose_log.items()):
            if self._fid_epoch.get(fid, self.epoch) == self.epoch:
                self.kf_pose_log[fid] = fn_pose7(p7)
                self._fid_epoch[fid] = row_epoch
        self.archive.rebase_epoch(self.epoch, fn_pose7, fn_points)
        self.archive.set_epoch(self.epoch, row_epoch)
        self.seeds = None                  # scale-dependent
        self.sd = None
        self.epoch = row_epoch

    def _loop_correction_significant(self, slot: int, lp: reloc.LoopResult) -> bool:
        """Whether the correction an archive loop implies for the keyframe
        (T_meas = T_loop T_arc against its current pose) exceeds the
        verifier's noise floor: translation, rotation or |ln scale| above
        `loop_min_corr_trans` / `_rot` / `_scale` (the JAX
        `_loop_correction_significant`)."""
        o = self.o
        T_meas7 = np_se3.compose7(np.asarray(lp.T_loop7), self.archive.poses7()[int(lp.loop_kf)])
        d7 = np_se3.relative7(T_meas7, self.server.state.kf_pose7[slot].cpu().numpy())
        dt = float(np.linalg.norm(d7[4:7]))
        dr = 2.0 * float(np.arccos(np.clip(abs(d7[0]), 0.0, 1.0)))
        ds = abs(float(np.log(max(float(lp.scale), 1e-6))))
        return (dt > o.loop_min_corr_trans or dr > o.loop_min_corr_rot
                or ds > o.loop_min_corr_scale)

    def _close_loop_global(self, slot: int, lp: reloc.LoopResult) -> None:
        """Apply an archive loop (the JAX `_close_loop_global`): the global
        pose graph over the archived and active keyframes
        (`close_loop_global_sim3` with `sim3_loops`, else `close_loop_global`,
        solved on the VO's device), then the archived poses and their
        landmark snapshots, the window's poses and landmarks
        (`apply_global_correction`) and the logged keyframe poses
        corrected."""
        o, srv = self.o, self.server
        st = srv.state
        act = list(srv.kf_used)
        pose7_np = st.kf_pose7.cpu().numpy()
        id_np = st.kf_id.cpu().numpy()
        cov_np = st.cov_weight.cpu().numpy()
        args = (self.archive.poses7(), self.archive.frame_ids(), pose7_np[act], id_np[act],
                cov_np[np.ix_(act, act)], int(lp.loop_kf), act.index(slot),
                np.asarray(lp.T_loop7, np.float32))
        new7 = pose7_np.copy()
        if o.sim3_loops:
            arc_new, act_new, arc_s, act_s, _ = reloc.close_loop_global_sim3(
                *args, loop_scale=float(lp.scale), n_iter=o.global_pg_iters, device=self.device)
            self.archive.set_poses7(arc_new, scale=arc_s)
            new7[act] = act_new
            scale = np.ones(new7.shape[0], np.float32)
            scale[act] = act_s
            srv.state = reloc.apply_global_correction(
                st, torch.from_numpy(new7).to(self.device), torch.from_numpy(scale).to(self.device))
        else:
            arc_new, act_new, _ = reloc.close_loop_global(*args, n_iter=o.global_pg_iters,
                                                          device=self.device)
            self.archive.set_poses7(arc_new)
            new7[act] = act_new
            srv.state = reloc.apply_global_correction(st, torch.from_numpy(new7).to(self.device))
        for fid, p in zip(self.archive.frame_ids(), arc_new):
            self.kf_pose_log[int(fid)] = np.asarray(p, np.float32)
        for fid, p in zip(id_np[act], act_new):
            self.kf_pose_log[int(fid)] = np.asarray(p, np.float32)

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
        From the `lost_reloc_after`-th failed retry on, relocalization is
        tried too (a retry recovers without a pose jump, so it gets the
        first frames alone); after `lost_reset_frames` failures the map is
        reset."""
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
        r = self._try_relocalize(pyr) if self.lost_count >= o.lost_reloc_after else None
        if r is not None:
            self._relocalized(pyr, r.T_cw)
            return TrackResult(Status.GOOD, r.T_cw, int(r.n_inliers))
        if self.lost_count > o.lost_reset_frames:
            self.reset()
        return TrackResult(Status.LOST, self.T_cw)

    def _try_relocalize(self, pyr) -> reloc.RelocResult | None:
        """One relocalization attempt (the JAX `_try_relocalize`): detection
        on the frame, then `relocalization.relocalize` against the active
        window and, if that fails, `relocalize_archive` against the archive
        rows of the current epoch (`_last_reloc_arc_idx` is then the row
        that matched), each with P3P triples drawn from a generator seeded
        with the frame id, so a run repeats.  Returns the result if one
        succeeded, else None; reading each `success` is a host sync."""
        self._last_reloc_arc_idx = None
        if self.vocab is None:
            return None
        o, m = self.o, self.server.state
        feats = self._detect(pyr)
        gen = torch.Generator(device=self.device).manual_seed(self.frame_id)
        r = reloc.relocalize(
            self.vocab, self.cam, feats.desc, feats.px, feats.valid, self.kf_bow, m.kf_valid,
            m.kf_pose7, m.feat_desc.reshape(-1, 8), self.kf_nodes.reshape(-1),
            m.feat_point.reshape(-1), m.feat_valid.reshape(-1), m.pt_pos, m.pt_valid,
            min_inliers=o.reloc_min_inliers, feat_angle_flat=m.feat_angle.reshape(-1),
            q_angle=feats.angle, top_c=o.reloc_top_c, use_pnp=o.reloc_use_pnp, generator=gen)
        self.stats["reloc_attempts"] += 1
        if bool(r.success):
            self.stats["relocalizations"] += 1
            return r
        if self.archive is None or self.archive.count == 0:
            return None
        # The archive cascade: only current-epoch rows are candidates (older
        # epochs live in other world frames).
        arc = self.archive.device_view()
        ep = np.full(arc.valid.shape[0], -1, np.int32)
        ep[:self.archive.count] = self.archive.epochs()
        arc = arc._replace(valid=arc.valid & torch.as_tensor(ep == self.epoch, device=self.device))
        gen = torch.Generator(device=self.device).manual_seed(self.frame_id)
        ra = reloc.relocalize_archive(
            self.vocab, self.cam, feats.desc, feats.px, feats.valid, arc,
            min_inliers=o.reloc_min_inliers, q_angle=feats.angle, top_c=o.reloc_top_c,
            use_pnp=o.reloc_use_pnp, generator=gen)
        self.stats["reloc_archive_attempts"] += 1
        if not bool(ra.success):
            return None
        self.stats["relocalizations"] += 1
        self.stats["relocs_archive"] += 1
        self._last_reloc_arc_idx = int(ra.kf_slot)
        return ra

    def _relocalized(self, pyr, T_cw: SE3) -> None:
        """GOOD at a relocalized pose, the motion model reset.  After an
        archive hit the matched keyframe is reactivated and its landmarks,
        projected at T_cw, are the last frame's observations; else there
        are none."""
        L = self.o.map_L
        self.status = Status.GOOD
        self.prev_pyr = pyr
        self.prev_T_cw = self.T_cw = T_cw
        if self._last_reloc_arc_idx is not None:
            self.prev_found, self.prev_obs_px = self._reactivate_archived(
                self._last_reloc_arc_idx, T_cw)
        else:
            self.prev_found = torch.zeros(L, dtype=torch.bool, device=self.device)
            self.prev_obs_px = torch.zeros((L, 2), dtype=torch.float32, device=self.device)
        self.velocity = self._identity()

    # -- the keyframe archive -------------------------------------------
    def _archive_row(self, fid: int, snap, bow_nodes, pose7: np.ndarray) -> None:
        """Append keyframe `fid`'s snapshot (`arc_snapshot`'s tuple, device
        tensors; `bow_nodes` its BoW row and nodes, None without a
        vocabulary; `pose7` its pose on the host) to the archive in the
        current epoch, and log its pose."""
        pose7_d, desc, px, fvalid, pt_pos, pt_ok, angle, level, img = snap
        if bow_nodes is None:
            bow_nodes = (torch.zeros(1), torch.full((self.o.map_F,), -1, dtype=torch.int32))
        self.archive.append(fid, pose7_d, bow_nodes[0], bow_nodes[1], desc, px, fvalid, pt_pos,
                            pt_ok, angle=angle, level=level, image=img, epoch=self.epoch)
        self.kf_pose_log[fid] = pose7.copy()
        self._fid_epoch.setdefault(fid, self.epoch)
        self.stats["keyframes_archived"] += 1

    def _archive_kf(self, slot: int) -> None:
        """MapServer's eviction hook (culling, reactivation, reset): keyframe
        `slot` archived before its window slot is invalidated (the JAX
        `_archive_kf`)."""
        m = self.server.state
        fid = int(m.kf_id[slot])
        if fid < 0 or self.archive is None:
            return
        snap = arc_snapshot(m, self.kf_images, slot)
        bow_nodes = ((self.kf_bow[slot], self.kf_nodes[slot]) if self.vocab is not None
                     else None)
        self._archive_row(fid, snap, bow_nodes, snap[0].cpu().numpy())

    def _reactivate_archived(self, arc_idx: int, T_cur: SE3):
        """Restore archive row `arc_idx` into the window after an archive
        relocalization (the JAX `_reactivate_archived`, in its order): pop
        the row; allocate a slot (an eviction archives its victim); allocate
        landmark rows for the features with a landmark snapshot; insert the
        keyframe (feature depths in its own camera) and its landmarks (each
        referenced to its feature); its image where the shape matches; its
        BoW row; refresh covisibility.  Returns (found [L], obs_px [L, 2]):
        the reactivated landmarks and every landmark projected at T_cur, the
        sparse aligner's reference set for the next frame."""
        o, srv = self.o, self.server
        F, L = o.map_F, o.map_L
        dev = self.device
        row = self.archive.pop(arc_idx)
        n_used = len(srv.kf_used)
        slot = srv.alloc_kf_slot()
        if len(srv.kf_used) < n_used:            # the window was full: a slot was evicted
            self.stats["evictions"] += 1
        ok = (row["pt_ok"] & row["feat_valid"]).cpu().numpy()
        rows_np = srv.alloc_landmark_rows(int(ok.sum()))
        take = np.where(ok)[0][:len(rows_np)]
        fp = np.full(F, -1, np.int32)
        fp[take] = rows_np[:len(take)]
        pose7 = row["pose7"].cpu().numpy()
        R, t = np_se3.params7_to_Rt(pose7)
        z = (row["pt_pos"].cpu().numpy() @ R.T + t)[:, 2].astype(np.float32)
        fd = np.where(fp >= 0, z, -1.0).astype(np.float32)
        fp_t = torch.as_tensor(fp, device=dev)
        srv.state = ms.insert_keyframe(
            srv.state, slot, row["frame_id"], SE3.from_params7(row["pose7"]), row["px"],
            row["level"], row["angle"], row["desc"], torch.as_tensor(fd, device=dev), fp_t,
            row["feat_valid"])
        srv.kf_used.append(slot)
        srv.state = ms.add_landmarks(
            srv.state, torch.clamp(fp_t, 0, L - 1), fp_t >= 0, row["pt_pos"], row["desc"], slot,
            ref_feat=slot * F + torch.arange(F, dtype=torch.int32, device=dev))
        img = row["image"]
        if tuple(img.shape) == tuple(self.kf_images.shape[1:]):
            self.kf_images = ms.set_row(self.kf_images, slot, img.to(torch.float32))
        if self.vocab is not None:
            self.kf_bow = ms.set_row(self.kf_bow, slot, row["bow"])
            self.kf_nodes = ms.set_row(self.kf_nodes, slot, row["nodes"])
        srv.refresh_covisibility()
        self.last_kf_slot = slot
        self.frames_since_kf = 0
        self.seeds = None
        self._last_kf_fid = row["frame_id"]
        self._last_kf_pose7 = pose7.astype(np.float32)
        self.kf_pose_log[self._last_kf_fid] = self._last_kf_pose7.copy()
        self._fid_epoch[self._last_kf_fid] = row["epoch"]
        self.stats["keyframes_reactivated"] += 1
        found = torch.zeros(L, dtype=torch.bool, device=dev)
        if len(take):
            found[torch.as_tensor(rows_np[:len(take)], dtype=torch.long, device=dev)] = True
        return found, self.cam.world_to_pixel(srv.state.pt_pos, T_cur)

    def _arc_dummy_view(self, cap: int) -> ArchiveView:
        """An all-invalid ArchiveView of capacity `cap` (warmup input)."""
        F, W, dev = self.o.map_F, self.archive.W, self.device
        return ArchiveView(
            frame_id=torch.full((cap,), -1, dtype=torch.int32, device=dev),
            pose7=torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=dev).repeat(cap, 1),
            bow=torch.zeros((cap, W), device=dev),
            nodes=torch.full((cap, F), -1, dtype=torch.int32, device=dev),
            desc=torch.zeros((cap, F, 8), dtype=torch.int32, device=dev),
            px=torch.zeros((cap, F, 2), device=dev), angle=torch.zeros((cap, F), device=dev),
            feat_valid=torch.zeros((cap, F), dtype=torch.bool, device=dev),
            pt_pos=torch.zeros((cap, F, 3), device=dev),
            pt_ok=torch.zeros((cap, F), dtype=torch.bool, device=dev),
            valid=torch.zeros((cap,), dtype=torch.bool, device=dev))

    def warmup_archive(self, max_capacity: int = 128) -> None:
        """Run the archive retrieval, `relocalize_archive` and
        `detect_loop_archive` (keyframe slot 0, frame 0) once on an
        all-invalid view of every capacity 16, 32, ... up to `max_capacity`
        (results discarded), so the kernels they launch (K10, K8) are built
        and their first launches paid before the archive needs them (the
        JAX package compiles its capacity buckets ahead here)."""
        self._join_mapping()
        if self.archive is None or self.vocab is None:
            return
        F, dev = self.o.map_F, self.device
        qd = torch.zeros((F, 8), dtype=torch.int32, device=dev)
        qpx = torch.zeros((F, 2), device=dev)
        qv = torch.zeros((F,), dtype=torch.bool, device=dev)
        qa = torch.zeros((F,), device=dev)
        cap = 16
        while cap <= max_capacity:
            arc = self._arc_dummy_view(cap)
            reloc._archive_retrieval_scores(self.vocab, qd, qv, arc, arc.valid)
            ra = reloc.relocalize_archive(
                self.vocab, self.cam, qd, qpx, qv, arc, min_inliers=self.o.reloc_min_inliers,
                q_angle=qa, top_c=self.o.reloc_top_c, use_pnp=self.o.reloc_use_pnp,
                generator=torch.Generator(device=dev).manual_seed(0))
            bool(ra.success)
            bool(self._detect_loop_archive(0, 0, arc).found)
            cap *= 2

    def reset(self) -> None:
        """Full reset (System::Reset): the window's keyframes archived into
        the closing epoch, an empty map (the eviction hook wired to the new
        server), NOT_READY, and a new epoch."""
        self._join_mapping()
        o = self.o
        if self.archive is not None:
            for slot in list(self.server.kf_used):
                self._archive_kf(slot)
        self.server = MapServer(o.map_K, o.map_F, o.map_L, device=self.device)
        if self.archive is not None:
            self.server.on_evict = self._archive_kf
            self.epoch += 1
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
        self.sd = None
        self.semidense_cloud = []
        self.dense_cloud = []
        self._last_kf_fid = -1
        if self.vocab is not None:           # the vocabulary stays
            self.kf_bow = torch.zeros_like(self.kf_bow)
            self.kf_nodes = torch.full_like(self.kf_nodes, -1)

    def trajectory_poses(self, corrected: bool = True) -> list:
        """(ts, params7) per frame.  corrected=True re-composes each GOOD
        frame from its anchor keyframe's current pose and the stored
        relative pose (SaveTrajectory); False gives the poses as tracked."""
        self._join_mapping()
        if not corrected:
            return list(self.trajectory)
        out = []
        for (ts, abs7), (_, fid, rel7) in zip(self.trajectory, self.traj_rel):
            if fid >= 0 and fid in self.kf_pose_log:
                out.append((ts, np_se3.compose7(rel7, self.kf_pose_log[fid]).astype(np.float32)))
            else:
                out.append((ts, abs7))
        return out

    def export_point_cloud(self) -> np.ndarray:
        """The map's points as [N, 3] world positions (float32, on the host):
        the valid landmarks, the last keyframe's converged gradient-pixel
        seeds (semi-dense), the earlier keyframes' (or a loaded map's
        auxiliary cloud), then the DENSE map's back-projected keyframe depth
        images."""
        self._join_mapping()
        m = self.server.state
        clouds = [m.pt_pos[m.pt_valid].cpu().numpy()]
        if self.sd is not None:
            pts, ok = sd_export(self.cam, self.sd, m)
            clouds.append(pts[ok].cpu().numpy())
        return np.concatenate(clouds + self.semidense_cloud + self.dense_cloud, axis=0)

    def set_vocabulary(self, vocab: voc.Vocabulary, recompute: bool = True) -> None:
        """Swap in another BoW vocabulary (one loaded with a map, or
        retrained; the JAX `set_vocabulary`, :2828-2858).  With `recompute`,
        every valid slot's BoW row and vocabulary nodes are computed again
        under it, and every archive row's (`KeyframeArchive.recompute_bow`);
        without it the window's rows are cleared for the caller to set, and
        the archive's rows are recomputed only if the vocabulary's width
        changes (its fixed-width buffers cannot hold rows of another).  No
        ChunkStep holds the vocabulary (the tracking step does not read it)."""
        self._join_mapping()
        o, m, dev = self.o, self.server.state, self.device
        self.vocab = vocab
        W = vocab.n_words
        if recompute:
            bows, nodes = zip(*(keyframe_bow(vocab, m, s) for s in range(o.map_K)))
            valid = m.kf_valid[:, None]
            self.kf_bow = torch.where(valid, torch.stack(bows), 0.0)
            self.kf_nodes = torch.where(valid, torch.stack(nodes), -1)
        else:
            self.kf_bow = torch.zeros((o.map_K, W), dtype=torch.float32, device=dev)
            self.kf_nodes = torch.full((o.map_K, o.map_F), -1, dtype=torch.int32, device=dev)
        arc = self.archive
        if arc is not None and (recompute or arc.W != W):
            def fn(desc, valid):
                words, nodes_ = voc.transform(vocab, desc, valid)
                return voc.bow_vector(vocab, words, valid), nodes_

            arc.recompute_bow(fn, W)

    def refresh_vocabulary(self, k: int | None = None, depth: int | None = None,
                           min_descriptors: int = 200) -> bool:
        """Retrain the vocabulary (`vocabulary.train`, 4 iterations) on this
        run's keyframe descriptors, the window's valid features then every
        archive row's, and swap it in with every BoW row recomputed (the JAX
        `refresh_vocabulary`, :2860-2890).  Returns False, changing nothing,
        without a vocabulary or with fewer than `min_descriptors`."""
        if self.vocab is None:
            return False
        self._join_mapping()
        m = self.server.state
        descs = [m.feat_desc[m.feat_valid & m.kf_valid[:, None]]]
        if self.archive is not None and self.archive.count:
            n = self.archive.count
            buf = self.archive.device_view()
            descs.append(buf.desc[:n][buf.feat_valid[:n]])
        all_desc = torch.cat(descs).cpu().numpy()
        if all_desc.shape[0] < min_descriptors:
            return False
        new = voc.train(all_desc, k=k or self.vocab.k, depth=depth or self.vocab.depth, iters=4,
                        device=self.device)
        self.set_vocabulary(new, recompute=True)
        self.stats["vocab_refreshes"] += 1
        return True
