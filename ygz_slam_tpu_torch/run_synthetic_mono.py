"""Monocular VO on a rendered synthetic sequence (counterpart of the JAX
package's examples/run_synthetic_mono.py; the reference's test_vo_track.cpp
driver, with exact ground truth and an ATE report instead of windows):

    python -m ygz_slam_tpu_torch.run_synthetic_mono [--frames 40] [--out DIR]
        [--device cuda|cpu]

It renders `SyntheticDataset`'s textured plane at 240x320, tracks every
frame with `VisualOdometry`, prints each frame's status, inliers and
window keyframes and the Sim(3)-aligned ATE over the GOOD frames, and
writes trajectory_tum.txt and, where matplotlib is installed,
trajectory.png and map.png to DIR.  It runs on the card unless --device
names another device; with no card and no --device it raises.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np

from .geometry.camera import PinholeCamera
from .geometry.se3 import SE3
from .models.visual_odometry import Status, VisualOdometry, VOOptions
from .system import trajectory as traj
from .system import viewer
from .utils.datasets import SyntheticDataset

SHAPE = (240, 320)


class FrameRecord(NamedTuple):
    """One frame of a run."""
    timestamp: float
    status: str                  # the Status name
    n_inliers: int
    keyframes: int               # keyframes in the window after the frame
    center: np.ndarray | None    # estimated camera centre in the world [3], GOOD frames only
    center_gt: np.ndarray        # the ground-truth camera centre [3]
    ms: float                    # host wall time of `add_frame`


def _center(T: SE3) -> np.ndarray:
    return (-(T.R.T @ T.t)).cpu().numpy()


def ate(records) -> float | None:
    """Sim(3)-aligned ATE RMSE over the GOOD frames, m; None below 3."""
    good = [r for r in records if r.center is not None]
    if len(good) < 3:
        return None
    return traj.ate_rmse(np.array([r.center for r in good]),
                         np.array([r.center_gt for r in good]), with_scale=True)


def main(argv=None) -> list[FrameRecord]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default="ygz_demo")
    ap.add_argument("--device", default=None, help="the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    ds = SyntheticDataset(cam, n_frames=args.frames, shape=SHAPE, device=args.device)
    vo = VisualOdometry(cam, VOOptions(init_min_disparity=15.0, kf_min_frames=4,
                                       kf_max_trans=0.03, kf_max_rot=0.04), device=args.device)
    records = []
    for fd in ds:
        t0 = time.perf_counter()
        r = vo.add_frame(fd.gray, fd.timestamp)
        ms = 1e3 * (time.perf_counter() - t0)
        n_kf = len(vo.server.kf_used)
        print(f"t={fd.timestamp:6.2f}  {r.status.name:8s} inliers={r.n_inliers:4d} kfs={n_kf}")
        records.append(FrameRecord(fd.timestamp, r.status.name, int(r.n_inliers), n_kf,
                                   _center(r.T_cw) if r.status is Status.GOOD else None,
                                   _center(fd.T_cw_gt), ms))
    vo._join_mapping()          # the last keyframe's mapping pass, before the map is read
    err = ate(records)
    if err is not None:
        n_good = sum(r.center is not None for r in records)
        print(f"\nSim3-aligned ATE over {n_good} frames: {err * 1000:.1f} mm")
    poses = [p for _, p in vo.trajectory]
    traj.save_tum(os.path.join(args.out, "trajectory_tum.txt"), [t for t, _ in vo.trajectory],
                  poses)
    try:
        viewer.plot_trajectory(os.path.join(args.out, "trajectory.png"), poses)
        viewer.plot_map(os.path.join(args.out, "map.png"), vo.server.state, poses)
        print(f"wrote trajectory + figures to {args.out}")
    except ImportError:
        print(f"matplotlib not installed: wrote the trajectory to {args.out}, no figures")
    return records


if __name__ == "__main__":
    main()
