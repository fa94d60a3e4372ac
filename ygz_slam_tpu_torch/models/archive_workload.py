"""The keyframe-archive workload: tests/test_archive.py's kidnapped sweep
through the monocular VisualOdometry with the archive on.

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

`archive_options` are mono_workload's options with the vocabulary and the
archive on and loop closing off (the archive loops are not ported).  The
camera scales with the frame shape from tests/test_archive.py's 240x320
(f = 320, c = (160, 120)); chip_smoke.py runs 640x480.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
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
                map_K=6)
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


def camera(shape) -> PinholeCamera:
    h, w = shape
    return PinholeCamera.create(320.0 * w / 320, 320.0 * h / 240, w / 2, h / 2)


def sweep_poses(n: int = N_SWEEP, device=None) -> list:
    """T_cw of frame k of the sweep (test_archive.py's kidnapped test)."""
    dev = resolve_device(device)
    out = []
    for k in range(n):
        t = k / (n - 1)
        xi = torch.tensor([SWEEP_M * t, 0.1 * np.sin(2 * np.pi * t), 0.0, 0.0,
                           -0.05 * np.sin(np.pi * t), 0.0], dtype=torch.float32)
        out.append(SE3(*(x.to(dev) for x in se3.exp(xi))))
    return out


def sweep_frames(shape=(240, 320), n: int = N_SWEEP, device=None):
    """(camera, frames [n, h, w] on `device`, T_gt7 [n, 7])."""
    dev = resolve_device(device)
    cam = camera(shape)
    scene = PlaneScene(cam, plane_z=3.0, seed=3, device=dev)
    Ts = sweep_poses(n, dev)
    return cam, torch.stack([scene.render(T, tuple(shape)) for T in Ts]), torch.stack(
        [T.params7() for T in Ts])


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
