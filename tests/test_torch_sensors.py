"""Depth sensors in the VO (RGBD and the DENSE map type) on the CPU, the
port against the JAX package (the STEREO sensor's run is in
tests/test_torch_stereo.py; both on `_torch_port.sensor_runs`).

Both `VisualOdometry` classes run the same frames (rendered by the port,
handed to the JAX package as numpy arrays) in the port's configuration
without the vocabulary, archive and async mapping (the depth filter on):
tests/test_system.py's RGBD sequence (`SyntheticDataset`, 240x320, motion
0.5, its first 8 frames: the depth-image start on frame 0 and one sensor
keyframe at frame 5) with the DENSE map.  The start's map is
compared feature by feature: Shi-Tomasi's float32 integral image may pick
another corner (ROADMAP section 3), so >= 95% of the features must
coincide by pixel, and where they do, their depths and landmarks within
`_torch_port.SENSOR_TOL_POS`.  The runs: statuses and keyframe frames equal, camera centres
within SENSOR_TOL_TRAJ (test_torch_mono_vo.py's bound).  Then the JAX tests'
own gates on the port with their options (the JAX defaults with faster
keyframes): RGBD over 16 frames, at least 12 GOOD, rigid ATE < 0.03 m,
and the DENSE cloud on the plane within 0.05 m
(test_vo_types.py::test_rgbd_dense_cloud)."""
import dataclasses

import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.system.system import Sensor, System
from ygz_slam_tpu_torch.utils.datasets import SyntheticDataset

from _torch_port import (SENSOR_GATE_OPTS, SENSOR_PARITY_OPTS, compare_sensor_run,
                         compare_sensor_start, sensor_gate, sensor_runs)

torch.set_num_threads(1)

CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
SHAPE = (240, 320)
N_PARITY = 8               # RGBD frames run through both packages
TOL_CLOUD = 1e-5           # the start's DENSE cloud, metres


@pytest.fixture(scope="module")
def rgbd_frames():
    """tests/test_system.py's RGBD sequence: (gray, depth, timestamp, T_cw_gt)."""
    ds = SyntheticDataset(CAM, n_frames=16, shape=SHAPE, with_depth=True, motion_scale=0.5,
                          device="cpu")
    return [(fd.gray, fd.depth, fd.timestamp, fd.T_cw_gt) for fd in ds]


@pytest.fixture(scope="module")
def rgbd_runs(rgbd_frames):
    return sensor_runs(CAM, rgbd_frames[:N_PARITY], lambda f: dict(img=f[0], depth=f[1]),
                       dataclasses.replace(SENSOR_PARITY_OPTS, map_type=tvo.MapType.DENSE))


def test_init_rgbd_map_matches_jax(rgbd_runs):
    compare_sensor_start(rgbd_runs["port"][3], rgbd_runs["jax"][3], "RGBD")


def test_rgbd_run_matches_jax(rgbd_runs):
    compare_sensor_run(rgbd_runs, "RGBD")


def test_dense_cloud(rgbd_runs):
    """One cloud per sensor keyframe, on the plane z = 3 within 0.05 m; the
    start's equal to the JAX package's within TOL_CLOUD."""
    vo, jv = rgbd_runs["port"][4], rgbd_runs["jax"][4]
    z = np.concatenate(vo.dense_cloud)[:, 2]
    d0 = float(np.abs(vo.dense_cloud[0] - jv.dense_cloud[0]).max())
    cloud = vo.export_point_cloud()
    print(f"DENSE: {len(vo.dense_cloud)} clouds (JAX {len(jv.dense_cloud)}) of "
          f"{[len(c) for c in vo.dense_cloud]} points, z in [{z.min():.4f}, {z.max():.4f}]; the "
          f"start's within {d0:.3e} m of the JAX one; exported {cloud.shape[0]} points")
    assert len(vo.dense_cloud) == len(jv.dense_cloud) == 2
    assert vo.dense_cloud[0].shape == jv.dense_cloud[0].shape and d0 <= TOL_CLOUD
    assert cloud.shape[0] > 1000 and np.allclose(z, 3.0, atol=0.05)
    vo.reset()
    assert vo.dense_cloud == [] and vo.export_point_cloud().shape == (0, 3)


def test_rgbd_tracks(rgbd_frames):
    """tests/test_system.py::test_rgbd_tracks on the port."""
    s = System(camera=CAM, sensor=Sensor.RGBD, options=SENSOR_GATE_OPTS, device="cpu")
    res = [s.track_rgbd(g, d, ts) for g, d, ts, _ in rgbd_frames]
    s.shutdown()
    sensor_gate(res, [T for *_, T in rgbd_frames], 12, "RGBD System")
