"""The monocular System's non-planar workloads, rendered by the port.

- `two_plane_workload`: tests/test_nonplanar.py's TwoPlaneScene run, a near
  plane (z = 2, x < 0.15) occluding a far one (z = 4.5), 40 frames 240x320,
  camera f = 320, a sideways and forward sweep with a small rotation.  The
  world is far from one plane, so initialisation must take the F/E model;
  the occlusion boundary moves across the view.
- `box_workload`: bench_accuracy.py's benchmark world, the inside of a box
  room with six textured walls (BoxScene, 2048-texel faces, vignette 0.25,
  exposure gain and bias drift), on its loop (`loop_trajectory`, radius 1.8,
  2.2 laps, facing out).  At 240x320 (f = 320) over a horizon of 2000 frames
  it is tests/test_accuracy_gate.py's run; at 480x640 the camera scales
  with the image (f = 640) and the horizon doubles to 4000, so the image
  moves as many pixels per frame as in the 320x240 benchmark.  With
  bench_accuracy.py's keyframe gates a keyframe falls every few frames and
  culling keeps most of them, so all ten slots of the map fill and slots
  are evicted (from about frame 230 at 480x640).

`box_options` are bench_accuracy.py's options in the port's configuration
(no vocabulary, depth filter, archive or async mapping).  `box_df_options`
are the same with the depth filter on (`box_options(use_depth_filter=True)`):
the keyframes' depthless detections carry inverse-depth seeds that every
frame refines and the next keyframe promotes to landmarks, which keeps
the map from starving where the keyframes' baselines give too little
parallax to triangulate.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..utils.synthetic import BoxScene, TwoPlaneScene, loop_trajectory
from .mono_workload import mono_options
from .visual_odometry import Status, VOOptions

TWO_PLANE_FRAMES = 40
TWO_PLANE_SHAPE = (240, 320)
# bench_accuracy.py:85-109 (min_track_inliers 15, a 40-frame lost budget).
BOX_OPTS = dict(init_min_disparity=15.0, kf_min_frames=5, kf_max_trans=0.04, kf_max_rot=0.05,
                n_levels=3, min_track_inliers=15, lost_reset_frames=40)


def two_plane_workload(n: int = TWO_PLANE_FRAMES, device=None):
    """(camera, frames [n, 240, 320], T_gt7 [n, 7]) of test_nonplanar's run."""
    dev = resolve_device(device)
    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    scene = TwoPlaneScene(cam, z_near=2.0, z_far=4.5, x_split=0.15, seed=0, device=dev)
    Ts = []
    for k in range(n):
        t = k / max(n - 1, 1)
        Ts.append(se3.exp(torch.tensor([0.9 * t, 0.15 * np.sin(2 * t), 0.2 * t,
                                        0.02 * np.sin(3 * t), -0.12 * t, 0.02 * t],
                                       dtype=torch.float32, device=dev)))
    return (cam, torch.stack([scene.render(T, TWO_PLANE_SHAPE) for T in Ts]),
            torch.stack([T.params7() for T in Ts]))


def box_workload(n: int, device=None, shape=(240, 320)):
    """(camera, frames [n, H, W], T_gt7 [n, 7]): the first n frames of
    bench_accuracy.render_benchmark (seed 0) at `shape`, the camera and the
    horizon (2000 frames at 240x320) scaled with the image width."""
    dev = resolve_device(device)
    s = shape[1] / 320
    cam = PinholeCamera.create(320.0 * s, 320.0 * s, 160.0 * s, 120.0 * s)
    scene = BoxScene(cam, seed=0, vignette=0.25, device=dev)
    Ts = loop_trajectory(round(2000 * s), radius=1.8, laps=2.2, seed=0, face="out",
                         device=dev)[:n]
    frames = []
    for k, T in enumerate(Ts):
        gain = 1.0 + 0.08 * np.sin(2 * np.pi * k / 400.0)
        bias = 4.0 * np.sin(2 * np.pi * k / 270.0)
        frames.append(scene.render(T, shape, gain=gain, bias=bias))
    return cam, torch.stack(frames), torch.stack([T.params7() for T in Ts])


def box_options(**overrides) -> VOOptions:
    """bench_accuracy.py's options in the port's configuration."""
    return mono_options(**{**BOX_OPTS, **overrides})


def box_df_options(**overrides) -> VOOptions:
    """`box_options` with the depth filter on."""
    return box_options(**{"use_depth_filter": True, **overrides})


def segments(statuses) -> int:
    """Tracked segments: 1 + re-initialisations (a GOOD or LOST frame
    followed by NOT_READY or INITING, a reset) after the first GOOD frame."""
    return 1 + sum(a in (Status.GOOD, Status.LOST) and b in (Status.NOT_READY, Status.INITING)
                   for a, b in zip(statuses, statuses[1:]))
