"""The monocular system's workload and gate: a rendered 640x480 sequence
through `System.track_monocular`, from raw frames (no depth, no
bootstrap map).

Scene: the port's PlaneScene (seed 0) at 640x480 with the camera
fx = fy = 640, cx = 320, cy = 240 (tests/test_vo.py's 240x320 camera,
doubled).  Trajectory: tests/test_vo.py's smooth sideways and forward
sweep with a small rotation, its parameter u advancing 1/64 per frame, so
160 frames reach u = 2.48: about 2-3 px of image motion per frame, the
plane filling the view throughout, and a keyframe every ~0.11 of u (21
keyframes).  Keyframe culling retires most of them (19 of the 21), which
holds the active window at about 4 of the map's map_K=10 slots, so no slot
is ever evicted here; `chip_smoke.py`'s main paths 6b and 6c run the
System on BoxScene (`models/nonplanar_workload.py`), and 6c gates its
evictions.  Options:
tests/test_vo.py's keyframe gates on the port's configuration (no
vocabulary, depth filter, archive or async mapping).  The same frames
with `VOOptions()` and another frontend (`frontend_options`,
`frontend_report`) are `chip_smoke.py`'s path 13.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..system import trajectory as traj
from ..system.system import System
from ..utils.synthetic import PlaneScene
from .visual_odometry import MapType, Status, VOOptions, VOType

H, W = 480, 640
N_FRAMES = 160
DU = 1.0 / 64.0              # trajectory parameter per frame
# The reference's bound on the Sim(3)-aligned ATE (tests/test_vo.py:99).
ATE_FLOOR = 0.05
INIT_WITHIN = 30             # GOOD within this many frames
# tests/test_vo.py's gates: the map is at mean depth 1 (the scene at ~3 m),
# so the metric keyframe gates shrink by ~3x.
VO_OPTS = dict(init_min_disparity=15.0, kf_min_frames=5, kf_max_trans=0.04, kf_max_rot=0.05)


def mono_options(**overrides) -> VOOptions:
    """The workload's VOOptions (the port's configuration + VO_OPTS)."""
    return VOOptions(**{**dict(use_vocabulary=False, use_depth_filter=False, archive_map=False,
                               async_mapping=False), **VO_OPTS, **overrides})


def trajectory(n_frames: int, du: float = DU, device=None) -> list:
    """T_cw of frame k: exp of tests/test_vo.py's twist at u = k * du."""
    dev = resolve_device(device)
    out = []
    for k in range(n_frames):
        u = k * du
        xi = torch.tensor([1.1 * u, 0.18 * np.sin(2 * u), 0.3 * u, 0.03 * np.sin(3 * u),
                           -0.16 * u, 0.03 * u], dtype=torch.float32, device=dev)
        out.append(se3.exp(xi))
    return out


def make_mono_workload(n_frames: int = N_FRAMES, device=None, shape=(H, W), du: float = DU):
    """(camera, frames [n_frames, h, w] rendered on `device`, T_gt7
    [n_frames, 7]); the camera scales with `shape` from 640x480."""
    dev = resolve_device(device)
    h, w = shape
    cam = PinholeCamera.create(640.0 * w / W, 640.0 * h / H, w / 2, h / 2)
    scene = PlaneScene(cam, plane_z=3.0, seed=0, device=dev)
    Ts = trajectory(n_frames, du, dev)
    frames = torch.stack([scene.render(T, (h, w)) for T in Ts])
    return cam, frames, torch.stack([T.params7() for T in Ts])


def run_mono(system: System, frames, on_frame=None):
    """Every frame through `system.track_monocular` (timestamp = index).
    Returns (statuses [n] Status, T7 [n, 7] numpy poses as tracked, wall
    seconds).  `on_frame(k, result)`, if given, is called after each."""
    statuses = []
    t0 = time.perf_counter()
    for k in range(frames.shape[0]):
        r = system.track_monocular(frames[k], float(k))
        statuses.append(r.status)
        if on_frame is not None:
            on_frame(k, r)
    wall = time.perf_counter() - t0
    return statuses, np.stack([p for _, p in system.vo.trajectory]), wall


def init_frame(statuses) -> int:
    """The first GOOD frame (-1 if none)."""
    return next((k for k, s in enumerate(statuses) if s is Status.GOOD), -1)


def good_ate(statuses, T7, T_gt7) -> float:
    """Sim(3)-aligned ATE of the GOOD frames' camera centres."""
    good = [k for k, s in enumerate(statuses) if s is Status.GOOD]
    gt = np.asarray(T_gt7.detach().cpu() if hasattr(T_gt7, "detach") else T_gt7)
    return traj.ate_rmse(traj.camera_centers(T7[good]), traj.camera_centers(gt[good]))


def mono_gate(statuses, T7, T_gt7, ate_bound: float = ATE_FLOOR):
    """The workload's gate: GOOD within the first INIT_WITHIN frames, no
    LOST frame after that, and the GOOD frames' Sim(3)-aligned ATE below
    `ate_bound`.  Returns (init frame, ATE, ok)."""
    k0 = init_frame(statuses)
    if k0 < 0:
        return k0, float("inf"), False
    ate = good_ate(statuses, T7, T_gt7)
    ok = (k0 < INIT_WITHIN and all(s is not Status.LOST for s in statuses[k0:])
          and ate < ate_bound)                  # False for a NaN ATE
    return k0, ate, ok


def frontend_options(vo_type: VOType, map_type: MapType = MapType.SPARSE) -> VOOptions:
    """The other frontends' configuration (`chip_smoke.py` path 13):
    `VOOptions()` with only the frontend and the map type changed, so the
    JAX defaults otherwise (the depth filter, the vocabulary, the archive,
    loop closing, async mapping) at the map's full width (map_K=10,
    map_F=256, map_L=3072, sd_budget=512)."""
    return VOOptions(vo_type=vo_type, map_type=map_type)


def seed_depth_spread(sd_px, usable, depths, kf_frame: int, cam) -> float:
    """The relative spread (std / mean) of the usable gradient-pixel seeds'
    depths over the plane's true depths at their keyframe (frame
    `kf_frame` of the workload): one global scale, so a small spread means
    the seeds converged to the scene (tests/test_vo_types.py's gate: <
    0.15).  Host arrays in, computed on the CPU."""
    T = trajectory(kf_frame + 1, DU, "cpu")[kf_frame]
    scene = PlaneScene(cam, plane_z=3.0, seed=0, device="cpu")
    px = torch.as_tensor(np.asarray(sd_px)[np.asarray(usable)])
    ratio = np.asarray(depths)[np.asarray(usable)] / scene.depth(px, T).numpy()
    return float(np.std(ratio) / np.mean(ratio))


def frontend_report(names, T7, T_gt7, cloud, n_landmarks: int, stats: dict, sd, kf_id,
                    cam) -> dict:
    """A frontend run's outcome on the workload: the GOOD share, the
    Sim(3)-aligned ATE of the GOOD frames' camera centres, the first LOST
    frame, keyframes, the exported cloud's size beside the valid
    landmarks, SPARSE_ORB's second-chance hits and, with a gradient-pixel
    set `sd` = (px, usable, depths, keyframe slot) on the host, its usable
    seeds and their depth spread on the plane (`seed_depth_spread`)."""
    statuses = [n if isinstance(n, Status) else Status[n] for n in names]
    out = dict(frames=len(statuses), good=statuses.count(Status.GOOD) / len(statuses),
               ate=good_ate(statuses, np.asarray(T7), T_gt7),
               first_lost=statuses.index(Status.LOST) if Status.LOST in statuses else None,
               init_frame=init_frame(statuses), keyframes=int(stats.get("keyframes", 0)),
               cloud=int(cloud.shape[0]), landmarks=n_landmarks,
               second_chance_hits=int(stats.get("orb_second_chance_hits", 0)),
               reloc_attempts=int(stats.get("reloc_attempts", 0)))
    if sd is not None:
        px, usable, depths, slot = sd
        kf_frame = int(np.asarray(kf_id)[slot])
        out.update(sd_usable=int(np.asarray(usable).sum()), sd_kf_frame=kf_frame,
                   seed_spread=(seed_depth_spread(px, usable, depths, kf_frame, cam)
                                if np.asarray(usable).sum() else float("nan")))
    return out
