"""Configuration files, dataset loaders, the viewer and the TUM script of
the port on the CPU.

- `system/config.py`: tests/test_system.py's `TestConfig` (a YAML round
  trip, flat keys, `camera_from_config`); `apply_to` with `VO_CONFIG_KEYS`
  equal to the JAX package's on the same YAML; `System(config_file=...)`
  with system.sensor / system.vo / system.map, refusing only the step-6
  modes.  `Config` is process-global: every test that sets it clears it.
- `utils/datasets.py`: `TumDataset` (associate.txt, and nearest-timestamp
  pairing), `EurocDataset` and `SyntheticDataset` yield the same frames,
  depths, stamps and ground truth as the JAX loaders on fixtures written
  here (test_tum_path.py's and test_euroc_path.py's layouts, rendered by
  the port): images and depths equal, stamps equal, poses within TOL_POSE
  (the JAX loader converts quaternions in float32, the port's EuRoC loader
  too, each with its own rounding).  SyntheticDataset's poses come from
  each package's SE(3) exp, an ulp apart, and its renders differ by what
  that moves (TOL_RENDER, TOL_RENDER_MEAN).
- `system/viewer.py`: the PLY file and the three figures.
- `python -m ygz_slam_tpu_torch.run_tum` on a 20-frame TUM folder on the
  CPU: test_tum_path.py's `test_run_tum_main_end_to_end` gates (ATE < 5 cm,
  the outputs written, the trajectory covering every frame)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ygz_slam_tpu.system import config as jcfg
from ygz_slam_tpu.utils import datasets as jds
from ygz_slam_tpu.models import visual_odometry as jvo

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry import so3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.system import viewer
from ygz_slam_tpu_torch.system.config import VO_CONFIG_KEYS, Config, apply_to, camera_from_config
from ygz_slam_tpu_torch.system.system import Sensor, System
from ygz_slam_tpu_torch.utils import datasets as ds_mod
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_camera, jax_vo_options

torch.set_num_threads(1)

CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
SHAPE = (240, 320)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_POSE = 1e-6           # ground-truth params7 against the JAX loaders'
TOL_RENDER = 1e-2         # SyntheticDataset renders: everywhere ...
TOL_RENDER_MEAN = 2e-4    # ... and on average (the poses differ by an ulp of exp; 8.0e-5 seen)
TOL_DEPTH = 1e-5          # SyntheticDataset depths, relative
YAML = ("camera:\n  fx: 321.0\n  fy: 322.0\n  cx: 160.0\n  cy: 120.0\n"
        "frame:\n  pyramid: 3\n"
        "feature:\n  detection_threshold: 18\n  grid_size: 12\n"
        "init:\n  min_features: 55\n  min_disparity: 12\n  min_inliers: 33\n"
        "localmapping:\n  min_track_localmap_inliers: 25\n  num_local_keyframes: 8\n"
        "keyframe:\n  min_frames: 6\n  max_rot: 0.2\n  max_trans: 0.07\n")


@pytest.fixture
def clear_config():
    yield
    Config.clear()
    jcfg.Config.clear()


def test_yaml_roundtrip(tmp_path, clear_config):
    p = tmp_path / "cfg.yaml"
    p.write_text("camera:\n  fx: 321.0\n  fy: 322.0\n  cx: 160.0\n  cy: 120.0\n"
                 "init:\n  min_features: 55\n")
    Config.set_parameter_file(str(p))
    assert Config.get("camera.fx") == 321.0 and Config.get("init.min_features") == 55
    assert Config.get("missing.key", 7) == 7
    assert camera_from_config().fx == 321.0
    assert apply_to(tvo.VOOptions(), VO_CONFIG_KEYS).init_min_features == 55


def test_flat_keys(clear_config):
    Config.set_dict({"camera.fx": 500.0})
    assert Config.get("camera.fx") == 500.0
    assert camera_from_config(default=CAM) is not CAM      # fx set: the config's camera
    Config.clear()
    assert camera_from_config(default=CAM) is CAM


def test_apply_to_matches_jax(tmp_path, clear_config):
    p = tmp_path / "cfg.yaml"
    p.write_text(YAML)
    Config.set_parameter_file(str(p))
    jcfg.Config.set_parameter_file(str(p))
    assert VO_CONFIG_KEYS == jcfg.VO_CONFIG_KEYS
    got = jax_vo_options(apply_to(tvo.VOOptions(), VO_CONFIG_KEYS))
    want = jcfg.apply_to(jvo.VOOptions(), jcfg.VO_CONFIG_KEYS)
    diff = {k: (v, getattr(want, k)) for k, v in got.items() if v != getattr(want, k)}
    print(f"apply_to: {len(got)} shared fields, differing: {diff}")
    assert not diff
    cam, jcam = camera_from_config(), jcfg.camera_from_config()
    assert all(getattr(cam, k) == float(np.asarray(getattr(jcam, k)))
               for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"))


def test_system_from_config_file(tmp_path, clear_config):
    """system.sensor / system.vo / system.map and the camera from the file;
    the step-6 modes raise (no fallback)."""
    def cfg(extra: str) -> str:
        p = tmp_path / "cfg.yaml"
        p.write_text(YAML + extra)
        return str(p)

    s = System(config_file=cfg("system:\n  sensor: rgbd\n  vo: sparse_direct\n  map: dense\n"),
               device="cpu")
    assert s.sensor is Sensor.RGBD and s.vo.o.map_type is tvo.MapType.DENSE
    assert s.vo.cam.fx == 321.0 and s.vo.o.kf_min_frames == 6 and s.vo.o.map_K == 8
    s = System(config_file=cfg("system:\n  sensor: stereo\n"), device="cpu")
    assert s.sensor is Sensor.STEREO and s.vo.o.map_type is tvo.MapType.SPARSE
    for bad in ("  vo: sparse_orb\n", "  vo: semi_dense_direct\n", "  map: semi_dense\n"):
        with pytest.raises(ValueError, match="step 6"):
            System(config_file=cfg("system:\n" + bad), device="cpu")


def _tum_fixture(root: str, n: int, with_assoc: bool = True):
    """test_tum_path.py's TUM layout, rendered by the port: rgb/*.png,
    depth/*.png (16-bit, 1/5000 m), rgb.txt, depth.txt, associate.txt,
    groundtruth.txt.  Returns the ground-truth poses."""
    from PIL import Image

    scene = PlaneScene(CAM, plane_z=3.0, seed=4, device="cpu")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    H, W = SHAPE
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    px = torch.tensor(np.stack([u, v], axis=-1))
    poses, stamps, lines = [], [], {"rgb": [], "depth": [], "assoc": []}
    for k in range(n):
        t = k / max(n - 1, 1)
        T = tse3.exp(torch.tensor(np.asarray([0.9 * t, 0.15 * np.sin(2 * t), 0.25 * t,
                                              0.02 * np.sin(3 * t), -0.12 * t, 0.02 * t],
                                             np.float32)))
        ts = 1305031102.0 + k / 30.0
        poses.append(T)
        stamps.append(ts)
        rgb, dep = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        Image.fromarray(scene.render(T, SHAPE).numpy().astype(np.uint8), mode="L").save(
            os.path.join(root, rgb))
        z = scene.depth(px, T).numpy()
        Image.fromarray(np.clip(z * 5000.0, 0, 65535).astype(np.uint16)).save(
            os.path.join(root, dep))
        lines["rgb"].append(f"{ts:.6f} {rgb}")
        lines["depth"].append(f"{ts:.6f} {dep}")
        lines["assoc"].append(f"{ts:.6f} {rgb} {ts:.6f} {dep}")
    for name in ("rgb", "depth"):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("# ts data\n" + "\n".join(lines[name]) + "\n")
    if with_assoc:
        with open(os.path.join(root, "associate.txt"), "w") as f:
            f.write("\n".join(lines["assoc"]) + "\n")
    traj.save_tum(os.path.join(root, "groundtruth.txt"), stamps, poses)
    return poses


def _same_frames(port_ds, jax_ds) -> int:
    a, b = list(port_ds), list(jax_ds)
    assert len(port_ds) == len(jax_ds) == len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.timestamp == fb.timestamp
        assert fa.gray.dtype == np.float32 and np.array_equal(fa.gray, fb.gray)
        assert (fa.depth is None) == (fb.depth is None)
        if fa.depth is not None:
            assert np.array_equal(fa.depth, fb.depth)
    return len(a)


def _same_groundtruth(port_gt, jax_gt) -> float:
    """Equal stamps; the largest params7 difference (the JAX poses' through
    the port's float32 quaternion)."""
    (sa, pa), (sb, pb) = port_gt, jax_gt
    assert np.array_equal(np.asarray(sa), np.asarray(sb))
    want = np.stack([np.concatenate([so3.to_quaternion(torch.tensor(np.asarray(T.R))).numpy(),
                                     np.asarray(T.t)]) for T in pb])
    return float(np.abs(_canonical(np.asarray(pa)) - _canonical(want)).max())


def _canonical(p7: np.ndarray) -> np.ndarray:
    """params7 with w >= 0 (q and -q are one rotation)."""
    return np.where(p7[:, :1] < 0, np.concatenate([-p7[:, :4], p7[:, 4:]], 1), p7)


@pytest.mark.parametrize("with_assoc", [True, False], ids=["associate", "nearest"])
def test_tum_dataset_matches_jax(tmp_path, with_assoc):
    root = str(tmp_path / "seq")
    poses = _tum_fixture(root, 5, with_assoc)
    n = _same_frames(ds_mod.TumDataset(root), jds.TumDataset(root))
    port = ds_mod.TumDataset(root)
    d = _same_groundtruth(port.groundtruth, jds.TumDataset(root).groundtruth)
    f0 = next(iter(port))
    centre = f0.depth[SHAPE[0] // 2, SHAPE[1] // 2]
    d_gt = float(np.abs(_canonical(port.groundtruth[1]) - _canonical(
        np.stack([T.params7().numpy() for T in poses]))).max())
    print(f"TUM ({'associate.txt' if with_assoc else 'nearest stamps'}): {n} frames equal, ground "
          f"truth within {d:.3e} of the JAX loader's and {d_gt:.3e} of the written poses; depth at "
          f"the centre {centre:.4f} m")
    assert d <= TOL_POSE and d_gt < 1e-4 and 2.0 < centre < 4.0


def test_euroc_dataset_matches_jax(tmp_path):
    from PIL import Image

    root = tmp_path / "MH_01"
    cam_dir, gt_dir = root / "mav0" / "cam0" / "data", root / "mav0" / "state_groundtruth_estimate0"
    cam_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    scene = PlaneScene(CAM, plane_z=3.0, seed=6, device="cpu")
    cam_rows, gt_rows, poses = [], [], []
    for k in range(6):
        t = k / 5
        T = tse3.exp(torch.tensor(np.asarray([0.6 * t, 0.1 * np.sin(2 * t), 0.2 * t, 0.0,
                                              -0.08 * t, 0.0], np.float32)))
        poses.append(T)
        ts = 1403636579763555584 + k * 50_000_000
        Image.fromarray(scene.render(T, SHAPE).numpy().astype(np.uint8), mode="L").save(
            cam_dir / f"{ts}.png")
        cam_rows.append(f"{ts},{ts}.png")
        T_wc = T.inverse()
        q, p = so3.to_quaternion(T_wc.R).numpy(), T_wc.t.numpy()
        gt_rows.append(f"{ts},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}")
    (root / "mav0" / "cam0" / "data.csv").write_text("#timestamp [ns],filename\n"
                                                     + "\n".join(cam_rows) + "\n")
    (gt_dir / "data.csv").write_text("#timestamp, p_RS_R_x ...\n" + "\n".join(gt_rows) + "\n")
    n = _same_frames(ds_mod.EurocDataset(str(root)), jds.EurocDataset(str(root)))
    port = ds_mod.EurocDataset(str(root / "mav0"))
    d = _same_groundtruth(port.groundtruth, jds.EurocDataset(str(root)).groundtruth)
    d_gt = float(np.abs(_canonical(port.groundtruth[1]) - _canonical(
        np.stack([T.params7().numpy() for T in poses]))).max())
    step = port.groundtruth[0][1] - port.groundtruth[0][0]
    print(f"EuRoC: {n} frames equal, ground truth within {d:.3e} of the JAX loader's and "
          f"{d_gt:.3e} of the written poses; stamps step {step:.6f} s")
    assert d <= TOL_POSE and d_gt < 1e-4 and abs(step - 0.05) < 1e-6


def test_synthetic_dataset_matches_jax():
    port = list(ds_mod.SyntheticDataset(CAM, n_frames=3, shape=SHAPE, with_depth=True,
                                        device="cpu"))
    want = list(jds.SyntheticDataset(jax_camera(CAM), n_frames=3, shape=SHAPE, with_depth=True))
    worst = {"img": 0.0, "img_mean": 0.0, "depth": 0.0, "pose": 0.0}
    for fa, fb in zip(port, want):
        assert fa.timestamp == fb.timestamp
        d = np.abs(fa.gray.numpy() - fb.gray)
        worst["img"] = max(worst["img"], float(d.max()))
        worst["img_mean"] = max(worst["img_mean"], float(d.mean()))
        worst["depth"] = max(worst["depth"], float(np.abs(fa.depth.numpy() / fb.depth - 1).max()))
        for a, b in ((fa.T_cw_gt.R, fb.T_cw_gt.R), (fa.T_cw_gt.t, fb.T_cw_gt.t)):
            worst["pose"] = max(worst["pose"], float(np.abs(a.numpy() - np.asarray(b)).max()))
    print(f"SyntheticDataset against the JAX one: {worst}")
    assert worst["img"] <= TOL_RENDER and worst["img_mean"] <= TOL_RENDER_MEAN
    assert worst["depth"] <= TOL_DEPTH and worst["pose"] <= TOL_POSE


def test_viewer_writes_files(tmp_path):
    pts = np.array([[0, 0, 3], [1, 2, 3], [np.nan, 0, 0]], np.float32)
    viewer.save_ply(str(tmp_path / "c.ply"), torch.tensor(pts))
    lines = (tmp_path / "c.ply").read_text().splitlines()
    assert "element vertex 2" in lines and lines[-1] == "1.00000 2.00000 3.00000"
    poses = [tse3.exp(torch.tensor([0.1 * k, 0, 0, 0, 0.02 * k, 0.0])) for k in range(5)]
    viewer.plot_trajectory(str(tmp_path / "t.png"), poses, [p.params7() for p in poses])
    s = System(camera=CAM, sensor=Sensor.RGBD, options=tvo.VOOptions(use_vocabulary=False),
               device="cpu")
    fd = next(iter(ds_mod.SyntheticDataset(CAM, n_frames=2, shape=SHAPE, with_depth=True,
                                           device="cpu")))
    s.track_rgbd(fd.gray, fd.depth, 0.0)
    viewer.plot_map(str(tmp_path / "m.png"), s.vo.server.state, poses)
    xy = torch.rand(20, 2) * 100
    viewer.plot_tracked_points(str(tmp_path / "p.png"), fd.gray, xy, xy + 1, torch.ones(20) > 0)
    for name in ("t.png", "m.png", "p.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_run_tum_main_end_to_end(tmp_path):
    """test_tum_path.py's end-to-end test through the port's script: the
    fixture's camera from a config file, RGBD, 20 frames on the CPU."""
    root = str(tmp_path / "seq")
    _tum_fixture(root, 20)
    out = str(tmp_path / "out")
    cfg = tmp_path / "cam.yaml"
    cfg.write_text("camera:\n  fx: 320.0\n  fy: 320.0\n  cx: 160.0\n  cy: 120.0\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "ygz_slam_tpu_torch.run_tum", root, "--sensor",
                           "rgbd", "--config", str(cfg), "--out", out, "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    print(proc.stdout[-2000:], proc.stderr[-2000:])
    assert proc.returncode == 0
    ate_cm = float(proc.stdout.split("ATE RMSE:")[1].split("cm")[0])
    assert ate_cm < 5.0
    for name in ("trajectory_tum.txt", "map.npz", "cloud.ply", "trajectory.png", "map.png"):
        assert os.path.exists(os.path.join(out, name)), name
    stamps, _ = traj.load_tum(os.path.join(out, "trajectory_tum.txt"))
    assert len(stamps) == 20
    bad = subprocess.run([sys.executable, "-m", "ygz_slam_tpu_torch.run_tum", root, "--vo",
                          "sparse_orb", "--out", out, "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "step 6" in bad.stderr


def test_run_tum_tracks_a_frame_without_depth(tmp_path):
    """A TUM folder whose depth.txt lacks one frame: the JAX script would
    call `track_monocular` on its RGBD System there, which asserts the
    MONOCULAR sensor (ROADMAP section 3); the port's script tracks the
    frame without depth and covers every frame."""
    from ygz_slam_tpu.system import system as jsys

    root = str(tmp_path / "seq")
    _tum_fixture(root, 6, with_assoc=False)
    dpath = os.path.join(root, "depth.txt")
    lines = open(dpath).read().splitlines()
    with open(dpath, "w") as f:
        f.write("\n".join(lines[:3] + lines[4:]) + "\n")      # frame 2 loses its depth
    frames = list(ds_mod.TumDataset(root))
    assert [fd.depth is None for fd in frames] == [False, False, True, False, False, False]
    js = jsys.System(camera=jax_camera(CAM), sensor=jsys.Sensor.RGBD,
                     options=jvo.VOOptions(use_vocabulary=False))
    with pytest.raises(AssertionError):
        js.track_monocular(frames[2].gray, frames[2].timestamp)
    out, cfg = str(tmp_path / "out"), tmp_path / "cam.yaml"
    cfg.write_text("camera:\n  fx: 320.0\n  fy: 320.0\n  cx: 160.0\n  cy: 120.0\n")
    proc = subprocess.run([sys.executable, "-m", "ygz_slam_tpu_torch.run_tum", root, "--config",
                           str(cfg), "--out", out, "--device", "cpu"], cwd=REPO,
                          env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True,
                          timeout=300)
    print(proc.stdout[-1000:], proc.stderr[-1000:])
    assert proc.returncode == 0 and "[0] GOOD" in proc.stdout
    stamps, _ = traj.load_tum(os.path.join(out, "trajectory_tum.txt"))
    assert len(stamps) == 6
