"""Rectified stereo matching (`ops/zmssd.py`, `ops/stereo.py`) on the CPU:
`zmssd`, `epipolar_search` and `match_stereo` against the JAX package on
tests/test_stereo.py's PlaneScene pair (seed 11, baseline 0.1 m, 240x320)
rendered by the JAX package and fed to both, and ports of
test_stereo.py's `test_depth_accuracy` and `test_out_of_range_rejected`
on the port's own renders and detections.

The scan's samples along each segment round as the JAX package's
`jnp.linspace` on the CPU (`zmssd.segment_samples`), but the ZMSSD sums
of 64 products reduce in another order, so a near-tie may pick another
sample: decisions are held to agree on >= 98% of the rows, and positions
and depths where both packages accept.

The STEREO sensor in the VO: both `VisualOdometry` classes on
tests/test_stereo.py's stereo sequence (seed 12, its first 7 frames: the
stereo start and one sensor keyframe at frame 5), held as
tests/test_torch_sensors.py holds the RGBD run (`_torch_port.sensor_runs`); then
test_stereo.py::test_tracks_metric's gates on the port's System over its 14
frames (>= 11 GOOD, rigid ATE < 0.03 m)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.geometry import PinholeCamera as JCam
from ygz_slam_tpu.ops import fast as jfast
from ygz_slam_tpu.ops import stereo as jst
from ygz_slam_tpu.ops import zmssd as jz
from ygz_slam_tpu.ops.interp import sample_patches as jsample
from ygz_slam_tpu.utils.synthetic import PlaneScene as JPlane

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.system.system import Sensor, System
from ygz_slam_tpu_torch.ops import fast, stereo, zmssd
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import (SENSOR_GATE_OPTS, SENSOR_PARITY_OPTS, compare_sensor_run,
                         compare_sensor_start, np32, sensor_gate, sensor_runs)

torch.set_num_threads(1)

CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
SHAPE = (240, 320)
BASELINE = 0.1
TOL_ZMSSD = 1e-5        # zmssd scores, relative to the largest
TOL_XY = 1e-4           # px: positions where both packages accept
TOL_DEPTH = 1e-4        # match_stereo depth, relative, where both accept
MIN_AGREE = 0.98        # ok flags
N_PARITY = 7            # stereo frames run through both packages


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_pair():
    """test_stereo.py's pair rendered by the JAX package at the identity,
    and its FAST corners (120)."""
    jcam = JCam.create(320.0, 320.0, 160.0, 120.0)
    scene = JPlane(jcam, plane_z=3.0, seed=11)
    shift = JSE3(jnp.eye(3), jnp.asarray([-BASELINE, 0.0, 0.0]))
    left = scene.render(JSE3.identity(), SHAPE)
    right = scene.render(shift.compose(JSE3.identity()), SHAPE)
    c = jfast.detect(left, 20.0, cell=16, max_corners=120)
    return dict(left=left, right=right, xy=c.xy, mask=c.mask, fx=jcam.fx)


def _agree(a, b) -> float:
    return float(np.mean(np32(a) == np32(b)))


def test_zmssd_matches_jax():
    rng = np.random.default_rng(0)
    ref = rng.uniform(40, 215, (24, 8, 8)).astype(np.float32)
    cur = rng.uniform(40, 215, (24, 7, 8, 8)).astype(np.float32)
    want = np.asarray(jz.zmssd(jnp.asarray(ref), jnp.asarray(cur)))
    got = zmssd.zmssd(_t(ref), _t(cur)).numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"zmssd: max error {err:.3e} of the largest score (tolerance {TOL_ZMSSD})")
    assert got.shape == want.shape and err <= TOL_ZMSSD


def test_segment_samples_round_as_jax():
    for n in (3, 32, 48, 64):
        assert np.array_equal(zmssd.segment_samples(n, "cpu").numpy(),
                              np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_epipolar_search_matches_jax(jax_pair):
    p = jax_pair
    fxb = float(np.float32(p["fx"]) * np.float32(BASELINE))
    pa = p["xy"] - jnp.asarray([fxb / 20.0, 0.0], jnp.float32)
    pb = p["xy"] - jnp.asarray([fxb / 0.3, 0.0], jnp.float32)
    patches = jsample(p["left"], p["xy"], 8)
    want = jz.epipolar_search(p["right"], patches, pa, pb, p["mask"], n_samples=48)
    got = zmssd.epipolar_search(_t(p["right"]), _t(patches), _t(pa), _t(pb), _t(p["mask"]),
                                n_samples=48)
    both = np32(want.ok) & np32(got.ok)
    d_xy = np.abs(np32(got.xy) - np32(want.xy))[both].max()
    agree = _agree(got.ok, want.ok)
    same_xy = float(np.mean(np.all(np.abs(np32(got.xy) - np32(want.xy)) <= TOL_XY, axis=1)[both]))
    print(f"epipolar_search: ok flags agree on {agree:.4f} of {both.size} rows, {both.sum()} "
          f"accepted by both, the same sample on {same_xy:.4f} of them (max |dxy| {d_xy:.3e})")
    assert agree >= MIN_AGREE and same_xy >= MIN_AGREE


def test_match_stereo_matches_jax(jax_pair):
    p = jax_pair
    want = jst.match_stereo(p["left"], p["right"], p["xy"], p["mask"], p["fx"], BASELINE,
                            min_depth=0.5, max_depth=10.0)
    got = stereo.match_stereo(_t(p["left"]), _t(p["right"]), _t(p["xy"]), _t(p["mask"]),
                              CAM.fx, BASELINE, min_depth=0.5, max_depth=10.0)
    both = np32(want.ok) & np32(got.ok)
    rel = (np.abs(np32(got.depth) - np32(want.depth)) / np32(want.depth))[both]
    agree = _agree(got.ok, want.ok)
    print(f"match_stereo: ok flags agree on {agree:.4f} ({int(np32(got.ok).sum())} port, "
          f"{int(np32(want.ok).sum())} JAX); depth where both accept: max relative error "
          f"{rel.max():.3e}, {np.mean(rel <= TOL_DEPTH):.4f} within {TOL_DEPTH}")
    assert agree >= MIN_AGREE and both.sum() > 60
    assert np.mean(rel <= TOL_DEPTH) >= MIN_AGREE
    assert np.all(np32(got.depth)[~np32(got.ok)] == -1.0)


def _port_pair(seed: int, max_corners: int):
    """The pair and its corners, rendered and detected by the port."""
    scene = PlaneScene(CAM, plane_z=3.0, seed=seed, device="cpu")
    T_left = SE3.identity(device="cpu")
    T_right = SE3(torch.eye(3), torch.tensor([-BASELINE, 0.0, 0.0])).compose(T_left)
    left, right = scene.render(T_left, SHAPE), scene.render(T_right, SHAPE)
    return scene, left, right, fast.detect(left, 20.0, cell=16, max_corners=max_corners)


def test_depth_accuracy():
    """test_stereo.py's gates: > 60 matches, median relative depth error <
    2% against the rendering's depth."""
    scene, left, right, c = _port_pair(11, 120)
    sd = stereo.match_stereo(left, right, c.xy, c.mask, CAM.fx, BASELINE, min_depth=0.5,
                             max_depth=10.0)
    gt = scene.depth(c.xy, SE3.identity(device="cpu"))
    ok = np32(sd.ok & c.mask)
    rel = np.abs(np32(sd.depth) - np32(gt)) / np32(gt)
    print(f"depth accuracy: {ok.sum()} matches, median relative error {np.median(rel[ok]):.3e}")
    assert ok.sum() > 60 and np.median(rel[ok]) < 0.02


def test_out_of_range_rejected():
    """Depth 3 m outside [5, 20] m: fewer than 30% of the corners accepted
    (test_stereo.py's gate; a few quasi-periodic texture aliases survive)."""
    _, left, right, c = _port_pair(11, 64)
    sd = stereo.match_stereo(left, right, c.xy, c.mask, CAM.fx, BASELINE, min_depth=5.0,
                             max_depth=20.0)
    n_ok, n_valid = int((sd.ok & c.mask).sum()), int(c.mask.sum())
    print(f"out of range: {n_ok} of {n_valid} corners accepted")
    assert n_ok < 0.3 * n_valid


@pytest.fixture(scope="module")
def stereo_frames():
    """tests/test_stereo.py's 14 rectified pairs (right camera at +0.1 m on
    the left one's x) and their poses."""
    scene = PlaneScene(CAM, plane_z=3.0, seed=12, device="cpu")
    shift = SE3(torch.eye(3), torch.tensor([-BASELINE, 0.0, 0.0]))
    out = []
    for k in range(14):
        t = k / 13.0
        T = tse3.exp(torch.tensor(np.asarray(
            [0.5 * t, 0.08 * np.sin(2 * t), 0.12 * t, 0.01 * np.sin(3 * t), -0.06 * t, 0.01 * t],
            np.float32)))
        out.append((scene.render(T, SHAPE), scene.render(shift.compose(T), SHAPE), T))
    return out


@pytest.fixture(scope="module")
def stereo_runs(stereo_frames):
    return sensor_runs(CAM, stereo_frames[:N_PARITY], lambda f: dict(img=f[0], right=f[1]),
                       SENSOR_PARITY_OPTS)


def test_init_stereo_map_matches_jax(stereo_runs):
    compare_sensor_start(stereo_runs["port"][3], stereo_runs["jax"][3], "STEREO")


def test_stereo_run_matches_jax(stereo_runs):
    compare_sensor_run(stereo_runs, "STEREO")


def test_stereo_tracks_metric(stereo_frames):
    """tests/test_stereo.py::test_tracks_metric on the port."""
    s = System(camera=CAM, sensor=Sensor.STEREO, options=SENSOR_GATE_OPTS, device="cpu")
    res = [s.track_stereo(l_, r_, float(k)) for k, (l_, r_, _) in enumerate(stereo_frames)]
    s.shutdown()
    sensor_gate(res, [T for *_, T in stereo_frames], 11, "STEREO System")
