"""The VO slice's workload and frame loop: the tracking workload's scene,
camera and trajectory (`tracking.make_workload`), a map bootstrapped on
frame 0 from the scene's depth, then `visual_odometry.track` on every frame
and `visual_odometry.kf_cycle` every `kf_min_frames` frames.

The loop stands in for the part of the JAX package's host state machine
that this slice needs: a constant-velocity pose prediction, the frame-count
half of the keyframe decision (its motion half belongs to the state
machine), the list of used slots that names the second triangulation
neighbour, and the covisibility refresh of the mapping pass.  Local BA,
landmark culling, the depth filter and the vocabulary are not run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..map import state as ms
from ..utils.synthetic import PlaneScene
from . import frontend as fe
from . import visual_odometry as vo
from .tracking import NOISE, _pose

H, W = 480, 640


class VOState(NamedTuple):
    """What the frame loop carries from frame to frame."""
    cam: PinholeCamera
    opts: vo.VOOptions
    mstate: ms.MapState
    kf_images: torch.Tensor    # [K, H, W] level-0 keyframe images
    prev_pyr: tuple            # pyramid of the last tracked frame
    prev_T_cw7: torch.Tensor   # [7] its pose
    velocity7: torch.Tensor    # [7] last inter-frame motion
    prev_found: torch.Tensor   # [L] bool landmarks seen in it
    prev_obs_px: torch.Tensor  # [L, 2] where
    last_kf_slot: int
    kf_used: tuple             # used keyframe slots, oldest insertion first
    frame_id: int


def bootstrap_map(cam, o: vo.VOOptions, pyr, T_cw: SE3, depth_of):
    """A map holding one keyframe (slot 0, frame id 0): detections of `pyr`
    on every level, each a landmark at the depth `depth_of(px)` gives.
    Returns (MapState, kf_images, found [L], obs_px [L, 2])."""
    dev = pyr[0].device
    F, L = o.map_F, o.map_L
    feats = fe.detect_multilevel(pyr, o.detect_threshold, o.grid_cell, o.feat_budgets)
    depth = depth_of(feats.px)
    rows = torch.arange(F, dtype=torch.int32, device=dev)
    m = ms.empty_map(o.map_K, F, L, device=dev)
    m = ms.insert_keyframe(m, 0, 0, T_cw, feats.px, feats.level, feats.angle, feats.desc,
                           torch.where(feats.valid, depth, -1.0),
                           torch.where(feats.valid, rows, -1), feats.valid)
    m = ms.add_landmarks(m, rows, feats.valid, cam.pixel_to_world(feats.px, T_cw, depth=depth),
                         feats.desc, 0, ref_feat=rows)
    kf_images = torch.zeros((o.map_K,) + tuple(pyr[0].shape), dtype=torch.float32, device=dev)
    kf_images[0] = pyr[0]
    found = torch.zeros(L, dtype=torch.bool, device=dev)
    found[:F] = feats.valid
    obs_px = torch.zeros((L, 2), dtype=torch.float32, device=dev)
    obs_px[:F] = feats.px
    return m, kf_images, found, obs_px


def make_vo_workload(n_frames: int, device=None, shape=(H, W), opts: vo.VOOptions | None = None):
    """`tracking.make_workload`'s scene (seed 0, 220 texels per metre),
    camera, trajectory and sensor noise, rendered on `device` (the card
    unless the caller names another) at `shape` (the camera is scaled with
    the image), with the map bootstrapped on frame 0 at its ground-truth
    pose.

    Returns (VOState after frame 0, frames [n_frames, H, W], T_gt7
    [n_frames, 7]); `track_vo_frames(state, frames[1:])` tracks the rest."""
    dev = resolve_device(device)
    o = opts or vo.VOOptions()
    h, w = shape
    cam = PinholeCamera.create(517.3 * w / W, 516.5 * h / H, w / 2, h / 2)
    scene = PlaneScene(cam, plane_z=3.0, seed=0, tex_per_meter=220.0, device=dev)
    Ts = [_pose(i, dev) for i in range(n_frames)]
    frames = torch.empty((n_frames, h, w), dtype=torch.float32, device=dev)
    for i, T in enumerate(Ts):
        noise = np.random.default_rng(100 + i).normal(0, NOISE, (h, w)).astype(np.float32)
        frames[i] = scene.render(T, (h, w)) + torch.from_numpy(noise).to(dev)
    pyr = fe.preprocess(frames[0], o.n_levels)
    m, kf_images, found, obs_px = bootstrap_map(cam, o, pyr, Ts[0],
                                                lambda px: scene.depth(px, Ts[0]))
    state = VOState(cam=cam, opts=o, mstate=m, kf_images=kf_images, prev_pyr=pyr,
                    prev_T_cw7=Ts[0].params7(), velocity7=SE3.identity(device=dev).params7(),
                    prev_found=found, prev_obs_px=obs_px, last_kf_slot=0, kf_used=(0,),
                    frame_id=0)
    return state, frames, torch.stack([T.params7() for T in Ts])


def track_vo_frame(state: VOState, img: torch.Tensor, on_stage=None):
    """One frame through `visual_odometry.track`, predicted by constant
    velocity.  Returns (VOState, pyramid, TrackMapResult).  `on_stage(name)`
    is called after "pyramid" and then as `track` calls it."""
    o = state.opts
    pyr = fe.preprocess(img, o.n_levels)
    if on_stage is not None:
        on_stage("pyramid")
    prev_T = SE3.from_params7(state.prev_T_cw7)
    T_pred = SE3.from_params7(state.velocity7).compose(prev_T)
    tm, mstate, _ = vo.track(state.cam, o, state.prev_pyr, pyr, state.prev_T_cw7,
                             T_pred.params7(), state.mstate, state.kf_images,
                             state.prev_found, state.prev_obs_px, on_stage=on_stage)
    state = state._replace(
        mstate=mstate, prev_pyr=pyr, prev_T_cw7=tm.T_cw.params7(),
        velocity7=tm.T_cw.compose(prev_T.inverse()).params7(), prev_found=tm.found,
        prev_obs_px=tm.obs_px, frame_id=state.frame_id + 1)
    return state, pyr, tm


def insert_vo_keyframe(state: VOState, pyr, tm):
    """The frame just tracked becomes a keyframe: `visual_odometry.kf_cycle`
    with the last keyframe and the fourth-last used slot (the oldest, while
    fewer are used) as triangulation neighbours, the slot bookkeeping from
    the one host fetch, and the mapping pass's covisibility refresh.
    Returns (VOState, counts: the slot, whether it was evicted, landmarks
    triangulated and detections fused with older landmarks, valid
    landmarks)."""
    used = state.kf_used
    o = state.opts
    nbr2 = used[-4] if len(used) >= 4 else used[0]
    mstate, kf_images, _, host_block = vo.kf_cycle(
        state.cam, o, state.mstate, pyr, tm.found, tm.obs_px, state.prev_T_cw7,
        state.last_kf_slot, nbr2, state.frame_id, state.kf_images)
    mstate = ms.update_covisibility(mstate)
    slot_t, evicted_t = host_block[:2]
    # A detection's landmark is new if it names that detection as its
    # reference observation; any other link was made by the fusion.
    Fl = o.map_F // 2
    fp_new = ms.row(mstate.feat_point, slot_t)[Fl:]
    own = slot_t * o.map_F + Fl + torch.arange(o.map_F - Fl, device=fp_new.device)
    linked = fp_new >= 0
    created = linked & (mstate.pt_ref_feat[torch.clamp(fp_new, min=0).long()] == own)
    slot, evicted, n_created, n_linked, n_valid = torch.stack(
        [slot_t, evicted_t.long(), created.sum(), linked.sum(), mstate.pt_valid.sum()]).tolist()
    if evicted:
        used = tuple(s for s in used if s != slot)
    counts = dict(frame=state.frame_id, slot=slot, evicted=bool(evicted),
                  triangulated=n_created, fused=n_linked - n_created, landmarks=n_valid)
    return state._replace(mstate=mstate, kf_images=kf_images, last_kf_slot=slot,
                          kf_used=used + (slot,)), counts


def track_vo_frames(state: VOState, frames: torch.Tensor, kf_every: int | None = None):
    """Track frames [F, H, W] in order; every `kf_every` frames
    (`opts.kf_min_frames` by default) the frame just tracked is inserted as a
    keyframe.  Returns (VOState, poses params7 [F, 7], inlier counts [F],
    one dict of counts per keyframe)."""
    kf_every = kf_every or state.opts.kf_min_frames
    poses, inliers, kf_log = [], [], []
    for img in frames:
        state, pyr, tm = track_vo_frame(state, img)
        poses.append(state.prev_T_cw7)
        inliers.append(tm.n_inliers)
        if state.frame_id % kf_every == 0:
            state, counts = insert_vo_keyframe(state, pyr, tm)
            kf_log.append(counts)
    return state, torch.stack(poses), torch.stack(inliers), kf_log


def vo_gate(T7_all: torch.Tensor, inliers: torch.Tensor, T_gt7: torch.Tensor,
            opts: vo.VOOptions | None = None):
    """Per-frame gate of the slice: every pose within 2e-2 of its ground
    truth (the tracking step's bound) and at least `min_track_inliers`
    inliers.  Returns (max_err, min_inliers, ok)."""
    o = opts or vo.VOOptions()
    d = se3.distance(SE3.from_params7(T7_all), SE3.from_params7(T_gt7))
    max_err = float(torch.max(d))
    min_inl = int(torch.min(inliers))
    ok = max_err < 2e-2 and min_inl >= o.min_track_inliers    # False for a NaN error
    return max_err, min_inl, ok
