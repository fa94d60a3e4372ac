"""The keyframe-archive workloads: tests/test_archive.py's sweeps and
tests/test_map_merge.py's reset-and-revisit through the monocular
VisualOdometry with the archive on.

- World and path: PlaneScene (seed 3, the plane at z = 3) and a one-way
  sideways sweep of 3.4 m over `N_SWEEP` frames (the end view shares no
  pixel with the start view), with test_archive.py's map of 6 keyframe
  slots and fast keyframe cadence (`ARC_OPTS`), so the window evicts and
  culls the start of the sweep into the archive.
- `kidnapped_sweep`: the sweep, then `N_NOISE` frames of uniform noise (the
  sensor blacked out: tracking is lost from the images themselves), then
  the view of the oldest archived keyframe again and the frames after it.
  Neither the lost-frame retry nor the active window can recover there:
  only relocalization against the archive, which reactivates the keyframe
  into the window, after which the frames track on.
- `out_and_back_frames`: test_archive.py's out-and-back sweep (1.3 m out
  and back over `N_OUT_BACK` frames): more keyframes than the window holds
  pass before the camera returns, so the return closes a loop against the
  archive (`loop_options`: the JAX defaults with ARC_OPTS; loop
  candidates at least 30 frames older).
- `reset_and_revisit`: test_map_merge.py's run: a 1.6 m sweep of
  `N_MERGE` frames, a reset (the window archived into epoch 0), then the
  start region again; the young map's keyframe loop against an epoch-0
  row merges the epochs (`merge_options`).

`archive_options` are mono_workload's options with the vocabulary and the
archive on and loop closing off.  The camera scales with the frame shape
from tests/test_archive.py's 240x320 (f = 320, c = (160, 120));
chip_smoke.py runs 640x480.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..utils import np_se3
from ..system import trajectory as traj
from ..utils.synthetic import PlaneScene
from .mono_workload import mono_options
from .reloc_workload import noise_frames
from .visual_odometry import Status, VOOptions

N_SWEEP = 52        # frames of the one-way sweep
SWEEP_M = 3.4       # its length along x, world units
N_NOISE = 4         # noise frames
N_AFTER = 8         # frames after the revisited view, all GOOD
TOL_REVISIT = 5e-2  # recovered pose against the archived keyframe's, map units
# tests/test_archive.py's ARC_OPTS: a small window and a fast keyframe cadence.
ARC_OPTS = dict(init_min_disparity=15.0, kf_min_frames=4, kf_max_trans=0.03, kf_max_rot=0.04,
                map_K=6, loop_min_frame_gap=30)
N_OUT_BACK = 110    # frames of the out-and-back sweep
OUT_BACK_M = 1.3    # how far it goes along x, world units
N_MERGE = 36        # frames of test_map_merge.py's sweep ...
MERGE_M = 1.6       # ... and its length along x
N_REVISIT = 26      # frames of its start region fed again after the reset
# test_map_merge.py's options (the JAX defaults besides).
MERGE_OPTS = dict(init_min_disparity=15.0, kf_min_frames=4, kf_max_trans=0.03,
                  loop_min_frame_gap=8)
# A relocalization must find this many inliers (the default is 20).  At the
# sweep's start the window's oldest keyframe (~1.5 m along, half the view in
# common) relocalizes the revisit with ~27 inliers, too few to track on: the
# next frames fall below the tracking gate and are lost again, and the archive
# recovers them some frames later (so both packages, with the default).
RELOC_MIN_INLIERS = 50


def archive_options(**overrides) -> VOOptions:
    """mono_workload's options with ARC_OPTS, the vocabulary and the archive
    on, loop closing off, relocalization at RELOC_MIN_INLIERS."""
    return mono_options(**{**dict(use_vocabulary=True, archive_map=True, loop_closing=False,
                                  reloc_min_inliers=RELOC_MIN_INLIERS),
                           **ARC_OPTS, **overrides})


def loop_options(**overrides) -> VOOptions:
    """test_archive.py's `VOOptions(**ARC_OPTS)`: the JAX defaults (the
    depth filter, the vocabulary, relocalization, the archive, loop closing
    against the window and the archive, async mapping) with ARC_OPTS."""
    return VOOptions(**{**ARC_OPTS, **overrides})


def merge_options(**overrides) -> VOOptions:
    """test_map_merge.py's options: the JAX defaults with MERGE_OPTS."""
    return VOOptions(**{**MERGE_OPTS, **overrides})


def camera(shape) -> PinholeCamera:
    h, w = shape
    return PinholeCamera.create(320.0 * w / 320, 320.0 * h / 240, w / 2, h / 2)


def _twist_poses(rows, dev) -> list:
    """SE3 exp of each twist row (float32, made on the CPU), on `dev`."""
    return [SE3(*(x.to(dev) for x in se3.exp(torch.tensor(r, dtype=torch.float32))))
            for r in rows]


def _render(cam, Ts, shape, seed: int, dev):
    """(frames [n, h, w], T_gt7 [n, 7]) of PlaneScene `seed` at z = 3."""
    scene = PlaneScene(cam, plane_z=3.0, seed=seed, device=dev)
    return (torch.stack([scene.render(T, tuple(shape)) for T in Ts]),
            torch.stack([T.params7() for T in Ts]))


def sweep_poses(n: int = N_SWEEP, device=None) -> list:
    """T_cw of frame k of the sweep (test_archive.py's kidnapped test)."""
    ts = [k / (n - 1) for k in range(n)]
    return _twist_poses([[SWEEP_M * t, 0.1 * np.sin(2 * np.pi * t), 0.0, 0.0,
                          -0.05 * np.sin(np.pi * t), 0.0] for t in ts], resolve_device(device))


def sweep_frames(shape=(240, 320), n: int = N_SWEEP, device=None):
    """(camera, frames [n, h, w] on `device`, T_gt7 [n, 7])."""
    dev = resolve_device(device)
    cam = camera(shape)
    return (cam, *_render(cam, sweep_poses(n, dev), shape, 3, dev))


def out_and_back_frames(shape=(240, 320), n: int = N_OUT_BACK, seed: int = 3, device=None):
    """(camera, frames [n, h, w] on `device`, T_gt7 [n, 7]) of
    test_archive.py's `out_and_back_trajectory`: x = OUT_BACK_M sin(pi t),
    0 -> 1.3 -> 0, with a sway in y and a yaw, over PlaneScene `seed`."""
    dev = resolve_device(device)
    ts = [k / max(n - 1, 1) for k in range(n)]
    Ts = _twist_poses([[OUT_BACK_M * np.sin(np.pi * t), 0.1 * np.sin(2 * np.pi * t), 0.0, 0.0,
                        -0.08 * np.sin(np.pi * t), 0.0] for t in ts], dev)
    cam = camera(shape)
    return (cam, *_render(cam, Ts, shape, seed, dev))


def merge_frames(shape=(240, 320), n: int = N_MERGE, device=None):
    """(camera, frames [n, h, w], T_gt7 [n, 7]) of test_map_merge.py's
    sweep: x = MERGE_M t, a sway in y and a yaw, PlaneScene seed 3."""
    dev = resolve_device(device)
    ts = [k / (n - 1) for k in range(n)]
    Ts = _twist_poses([[MERGE_M * t, 0.1 * np.sin(2 * np.pi * t), 0.0, 0.0,
                        -0.06 * np.sin(np.pi * t), 0.0] for t in ts], dev)
    cam = camera(shape)
    return (cam, *_render(cam, Ts, shape, 3, dev))


def corrected_ate(vo, T_gt7) -> float:
    """test_archive.py's accuracy metric: the Sim(3)-aligned ATE of every
    frame's corrected (keyframe-anchored) camera centre against the ground
    truth, frame k fed at timestamp k."""
    entries = vo.trajectory_poses()
    gt = np.asarray(T_gt7.detach().cpu() if hasattr(T_gt7, "detach") else T_gt7)
    est = np.stack([p for _, p in entries])
    return traj.ate_rmse(traj.camera_centers(est),
                         traj.camera_centers(gt[[int(ts) for ts, _ in entries]]))


def out_and_back_gates(vo, T_gt7) -> dict:
    """test_archive.py's gates of the out-and-back sweep: more archived
    keyframes than window slots, at least one global loop closed, the
    corrected trajectory's ATE below 0.10 (test_out_and_back_closes_global_loop);
    and the end-start gap of the corrected trajectory below 0.35 of its span
    along x, or, where no loop was applied, at least one confirmed
    (test_loop_correction_improves_or_keeps_consistency)."""
    ate = corrected_ate(vo, T_gt7)
    centres = traj.camera_centers(np.stack([p for _, p in vo.trajectory_poses()]))
    span = float(np.ptp(centres[:, 0]))
    gap = float(np.linalg.norm(centres[-1] - centres[0]))
    st = vo.stats
    out = dict(archived=vo.archive.count, closed=st["loops_closed_global"],
               confirmed=st["loops_confirmed"], ate=ate, gap=gap, span=span)
    out["closes"] = vo.archive.count > vo.o.map_K and out["closed"] >= 1 and ate < 0.10
    out["consistent"] = ((out["closed"] >= 1 or out["confirmed"] >= 1)
                         and gap < 0.35 * max(span, 1e-6))
    return out


def reset_and_revisit(vo, frames, n_revisit: int = N_REVISIT, feed=None) -> dict:
    """test_map_merge.py's run through `vo`: the sweep `frames` (epoch 0),
    `vo.reset()`, then its first `n_revisit` frames again, each through
    `feed(img, timestamp)` (default `vo.add_frame`; the revisit's
    timestamps start at 200).  Returns the epoch-0 poses by frame
    (`pose0`), the epoch and archive rows after the reset, the revisit's
    statuses and last pose, and the gates of the JAX test: merged
    (`maps_merged` >= 1 and the epoch 0 again), the last pose within
    0.12 map units and 0.1 rad of epoch 0's pose at the same view."""
    feed = feed or vo.add_frame
    pose0 = {}
    for k in range(frames.shape[0]):
        r = feed(frames[k], float(k))
        if r.status is Status.GOOD:
            pose0[k] = r.T_cw.params7().cpu().numpy()
    good0 = vo.status is Status.GOOD
    vo.reset()
    after_reset = dict(epoch=vo.epoch, rows=vo.archive.count,
                       epochs=sorted(set(vo.archive.epochs().tolist())))
    results = [feed(frames[k], float(200 + j)) for j, k in enumerate(range(n_revisit))]
    statuses = [r.status for r in results]
    r_last = results[-1].T_cw.params7().cpu().numpy()
    ref = pose0.get(n_revisit - 1)
    if ref is not None and statuses[-1] is Status.GOOD:
        rel = np_se3.relative7(r_last, ref)
        dt = float(np.linalg.norm(rel[4:7]))
        ang = float(2 * np.arccos(np.clip(abs(rel[0]), 0, 1)))
    else:
        dt = ang = float("inf")
    merged = vo.stats["maps_merged"] >= 1 and vo.epoch == 0
    out = dict(pose0=pose0, good0=good0, after_reset=after_reset, statuses=statuses,
               last_pose7=r_last, dt=dt, ang=ang, merged=merged)
    out["ok"] = (good0 and after_reset["epoch"] == 1 and after_reset["rows"] >= 3
                 and after_reset["epochs"] == [0] and merged and dt < 0.12 and ang < 0.1)
    return out


def kidnapped_sweep(vo, frames, n_noise: int = N_NOISE, n_after: int = N_AFTER,
                    feed=None) -> dict:
    """Drive `vo` (the port's VisualOdometry) through the sweep `frames`,
    `n_noise` noise frames, then the oldest archived keyframe's view and the
    `n_after` frames after it, each through `feed(img, timestamp)` (default
    `vo.add_frame`; pass `System.track_monocular` to go through the System).
    Returns the run and its gates:

    statuses, T7 [n, 7] as tracked, fed (the source frame of each fed
    frame, -1 for noise), revisit_fid (the archived keyframe whose view
    comes back), revisit_pose7 (its archived pose), archived_before (the
    archive's rows when the noise starts), reloc_frame (the first GOOD fed
    frame after the noise, or None), reloc_error (its pose against the
    archived one, map units), and the gates: relocalized (that frame GOOD
    through an archive relocalization that reactivated a keyframe, no
    reset), near (reloc_error < TOL_REVISIT), after_good (the n_after
    frames GOOD), ok (all three)."""
    feed = feed or vo.add_frame
    statuses, fed = [], []

    def step(img, src):
        r = feed(img, float(len(statuses)))
        statuses.append(r.status)
        fed.append(src)
        return r

    for k in range(frames.shape[0]):
        step(frames[k], k)
    ids = vo.archive.frame_ids()
    a = int(np.argmin(ids))
    fid = int(ids[a])
    pose7 = vo.archive.poses7()[a].copy()
    archived_before = vo.archive.count
    for img in noise_frames(n_noise, tuple(frames.shape[1:]), device=frames.device):
        step(img, -1)
    before = dict(vo.stats)
    r = step(frames[fid], fid)
    k_rev = len(statuses) - 1
    T_arc = SE3.from_params7(torch.as_tensor(pose7, device=frames.device))
    reloc_error = (float(se3.distance(r.T_cw, T_arc)) if r.status is Status.GOOD
                   else float("inf"))
    relocalized = (r.status is Status.GOOD
                   and vo.stats["relocs_archive"] == before.get("relocs_archive", 0) + 1
                   and vo.stats["keyframes_reactivated"]
                   == before.get("keyframes_reactivated", 0) + 1)
    for k in range(fid + 1, min(fid + 1 + n_after, frames.shape[0])):
        step(frames[k], k)
    after = statuses[k_rev + 1:]
    ever_reset = any(x in (Status.GOOD, Status.LOST) and y in (Status.NOT_READY, Status.INITING)
                     for x, y in zip(statuses, statuses[1:]))
    out = dict(statuses=statuses, T7=np.stack([p for _, p in vo.trajectory[-len(statuses):]]),
               fed=fed, revisit_fid=fid, revisit_pose7=pose7, archived_before=archived_before,
               reloc_frame=k_rev if r.status is Status.GOOD else None, reloc_error=reloc_error,
               relocalized=relocalized and not ever_reset, near=reloc_error < TOL_REVISIT,
               after_good=len(after) == n_after and all(s is Status.GOOD for s in after))
    out["ok"] = out["relocalized"] and out["near"] and out["after_good"]
    return out


def fed_frames(frames, fed) -> torch.Tensor:
    """The images `kidnapped_sweep` fed, from its `fed` list (noise frames
    drawn again, in order)."""
    noise = iter(noise_frames(sum(1 for s in fed if s < 0), tuple(frames.shape[1:]),
                              device=frames.device))
    return torch.stack([frames[s] if s >= 0 else next(noise) for s in fed])
