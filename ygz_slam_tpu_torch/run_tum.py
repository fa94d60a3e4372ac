"""Run the port on a TUM RGB-D sequence (counterpart of the JAX package's
examples/run_tum.py; the reference's test_vo_init.cpp / test_tum_vo.cpp
programs):

    python -m ygz_slam_tpu_torch.run_tum DATASET [--sensor rgbd|monocular]
        [--vo sparse_direct|sparse_orb|semi_dense_direct]
        [--map sparse|semi_dense|dense] [--config CFG.yaml]
        [--out DIR] [--device cuda|cpu]

DATASET is the standard TUM layout (rgb/, depth/, rgb.txt, depth.txt,
optionally associate.txt and groundtruth.txt).  It tracks every frame
(RGBD: `track_rgbd` where the frame has a depth image; monocular: chunked
streaming), writes trajectory_tum.txt, map.npz, cloud.ply and, where
matplotlib is installed, trajectory.png and map.png to DIR, and prints the
ATE RMSE against groundtruth.txt when present (rigid for RGBD, Sim(3) for
monocular).  The camera defaults to TUM freiburg1's intrinsics; a config
file's camera.* keys replace them.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .geometry.camera import PinholeCamera
from .models.visual_odometry import MapType, VOOptions, VOType
from .system import trajectory as traj
from .system import viewer
from .system.config import Config
from .system.system import Sensor, System
from .utils.datasets import TumDataset

# TUM freiburg1 intrinsics (the reference's config/default.yaml values).
FR1 = dict(fx=517.3, fy=516.5, cx=325.1, cy=249.7, k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("--sensor", default="rgbd", choices=["rgbd", "monocular"])
    ap.add_argument("--vo", default="sparse_direct",
                    choices=["sparse_direct", "sparse_orb", "semi_dense_direct"],
                    help="frontend method (system.vo)")
    ap.add_argument("--map", default="sparse", dest="map_type",
                    choices=["sparse", "semi_dense", "dense"], help="map content (system.map)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default="ygz_tum_out")
    ap.add_argument("--device", default=None, help="the card unless named (e.g. cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    sensor = Sensor.RGBD if args.sensor == "rgbd" else Sensor.MONOCULAR
    try:
        slam = System(config_file=args.config, camera=PinholeCamera.create(**FR1), sensor=sensor,
                      options=VOOptions(vo_type=VOType[args.vo.upper()],
                                        map_type=MapType[args.map_type.upper()]),
                      device=args.device)
    finally:
        Config.clear()
    ds = TumDataset(args.dataset)
    print(f"{len(ds)} frames")
    if slam.sensor is Sensor.MONOCULAR:
        results = slam.track_monocular_stream((fd.gray, fd.timestamp) for fd in ds)
        for i in range(0, len(results), 30):
            print(f"[{i}] {results[i].status.name} inliers={results[i].n_inliers}")
    else:
        for i, fd in enumerate(ds):
            if fd.depth is not None:
                r = slam.track_rgbd(fd.gray, fd.depth, fd.timestamp)
            else:
                r = slam.vo.add_frame(fd.gray, fd.timestamp)
            if i % 30 == 0:
                print(f"[{i}] {r.status.name} inliers={r.n_inliers}")
    slam.save_trajectory(os.path.join(args.out, "trajectory_tum.txt"))
    slam.save_map(os.path.join(args.out, "map.npz"))
    est = slam.vo.trajectory
    if ds.groundtruth is not None:
        stamps, gt_poses = ds.groundtruth
        est_stamps = np.asarray([t for t, _ in est])
        idx = np.argmin(np.abs(stamps[None, :] - est_stamps[:, None]), axis=1)
        with_scale = slam.sensor is Sensor.MONOCULAR
        ate = traj.ate_rmse(traj.camera_centers([p for _, p in est]),
                            traj.camera_centers(gt_poses[idx]), with_scale=with_scale)
        print(f"ATE RMSE: {ate * 100:.2f} cm ({'Sim3' if with_scale else 'SE3'} alignment)")
    try:
        poses = [p for _, p in est]
        viewer.plot_trajectory(os.path.join(args.out, "trajectory.png"), poses)
        viewer.plot_map(os.path.join(args.out, "map.png"), slam.vo.server.state, poses)
    except ImportError:
        print("matplotlib not installed: no figures")
    viewer.save_ply(os.path.join(args.out, "cloud.ply"), slam.export_point_cloud())
    slam.shutdown()
    print(f"outputs in {args.out}")


if __name__ == "__main__":
    main()
