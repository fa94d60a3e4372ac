"""The port's synthetic scenes against the JAX package's, on the CPU:
TwoPlaneScene, BoxScene (2048-texel faces as bench_accuracy.py renders
them, and 256-texel faces; vignette 0.25 with the benchmark's gain and bias
drift) and loop_trajectory, from the same seeds.

Textures, mip stacks and poses are numpy arithmetic in both packages, so
they must be equal.  Renders are held to the tolerance of the rendered
workloads against the JAX package's (test_torch_track_step.py's
test_workload_matches_bench_common): within 1e-3 on >= 99.9% of pixels,
within 1e-2 everywhere; ray geometry within 1e-5 relative."""
import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.utils import synthetic as ts

from _torch_port import jax_camera, np32

torch.set_num_threads(1)

TOL_IMG = 1e-3
TOL_IMG_FLIP = 1e-2
MIN_IMG_AGREE = 0.999
TOL_POSE = 1e-6
SHAPE = (240, 320)
CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)   # bench_accuracy.py's camera
HORIZON = 2000                                           # tests/test_accuracy_gate.py
FRAMES = (0, 37, 90, 149)


def _jax_pose(T: SE3):
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import SE3 as JSE3

    return JSE3(jnp.asarray(np32(T.R)), jnp.asarray(np32(T.t)))


def _photometry(k: int):
    """bench_accuracy.py's exposure drift at frame k."""
    return 1.0 + 0.08 * np.sin(2 * np.pi * k / 400.0), 4.0 * np.sin(2 * np.pi * k / 270.0)


def _assert_images_close(a, b):
    d = np.abs(np32(a) - np32(b))
    assert (d <= TOL_IMG).mean() >= MIN_IMG_AGREE and d.max() <= TOL_IMG_FLIP, \
        ((d > TOL_IMG).mean(), d.max())


@pytest.fixture(scope="module", params=[2048, 256], ids=["tex2048", "tex256"])
def boxes(request):
    from ygz_slam_tpu.utils import synthetic as js

    size = request.param
    return (ts.BoxScene(CAM, tex_size=size, vignette=0.25, device="cpu"),
            js.BoxScene(jax_camera(CAM), tex_size=size, vignette=0.25))


def test_box_textures_and_mips_equal(boxes):
    port, jax_scene = boxes
    assert port.texs.shape == (6, ts.BoxScene.N_MIPS, port.tex_size, port.tex_size)
    np.testing.assert_array_equal(np32(port.texs), np32(jax_scene.texs))


@pytest.mark.parametrize("face", ["out", "tangent"])
def test_loop_trajectory_matches(face):
    from ygz_slam_tpu.utils import synthetic as js

    port = ts.loop_trajectory(HORIZON, radius=1.8, laps=2.2, face=face, device="cpu")
    ref = js.loop_trajectory(HORIZON, radius=1.8, laps=2.2, face=face)
    assert len(port) == len(ref) == HORIZON
    for k in range(0, HORIZON, 97):
        assert np.abs(np32(port[k].R) - np32(ref[k].R)).max() <= TOL_POSE
        assert np.abs(np32(port[k].t) - np32(ref[k].t)).max() <= TOL_POSE


@pytest.mark.parametrize("k", FRAMES)
def test_box_render_matches(boxes, k):
    """The benchmark's frame k (face="out", horizon 2000), with and without
    the photometric perturbation."""
    port, jax_scene = boxes
    T = ts.loop_trajectory(HORIZON, radius=1.8, laps=2.2, face="out", device="cpu")[k]
    gain, bias = _photometry(k)
    _assert_images_close(port.render(T, SHAPE, gain=gain, bias=bias),
                         jax_scene.render(_jax_pose(T), SHAPE, gain=gain, bias=bias))
    _assert_images_close(port.render(T, SHAPE), jax_scene.render(_jax_pose(T), SHAPE))


def _two_plane_pose(k: int, n: int = 40) -> SE3:
    """tests/test_nonplanar.py's trajectory at frame k of n."""
    t = k / (n - 1)
    return tse3.exp(torch.tensor([0.9 * t, 0.15 * np.sin(2 * t), 0.2 * t, 0.02 * np.sin(3 * t),
                                  -0.12 * t, 0.02 * t], dtype=torch.float32))


@pytest.mark.parametrize("k", [0, 13, 39])
def test_two_plane_render_matches(k):
    from ygz_slam_tpu.utils import synthetic as js

    port = ts.TwoPlaneScene(CAM, device="cpu")
    jax_scene = js.TwoPlaneScene(jax_camera(CAM))
    np.testing.assert_array_equal(np32(port.tex), np32(jax_scene.tex))
    np.testing.assert_array_equal(np32(port.tex_far), np32(jax_scene.tex_far))
    T = _two_plane_pose(k)
    _assert_images_close(port.render(T, SHAPE), jax_scene.render(_jax_pose(T), SHAPE))


def _scenes():
    from ygz_slam_tpu.utils import synthetic as js

    jcam = jax_camera(CAM)
    return {"plane": (ts.PlaneScene(CAM, device="cpu"), js.PlaneScene(jcam)),
            "two_plane": (ts.TwoPlaneScene(CAM, device="cpu"), js.TwoPlaneScene(jcam)),
            "box": (ts.BoxScene(CAM, tex_size=64, device="cpu"),
                    js.BoxScene(jcam, tex_size=64))}


@pytest.mark.parametrize("name", ["plane", "two_plane", "box"])
def test_scene_geometry_matches(name):
    """world_from_pixel, depth and project_to of each scene on a pixel grid
    (corners and the occlusion boundary included), at a box pose and a
    two-plane pose."""
    import jax.numpy as jnp

    port, jax_scene = _scenes()[name]
    T_a = (ts.loop_trajectory(HORIZON, radius=1.8, laps=2.2, face="out", device="cpu")[400]
           if name == "box" else _two_plane_pose(5))
    T_b = (ts.loop_trajectory(HORIZON, radius=1.8, laps=2.2, face="out", device="cpu")[404]
           if name == "box" else _two_plane_pose(9))
    u, v = np.meshgrid(np.linspace(0, 319, 33, dtype=np.float32),
                       np.linspace(0, 239, 25, dtype=np.float32))
    px = np.stack([u, v], -1)
    pairs = ((port.world_from_pixel(torch.tensor(px), T_a),
              jax_scene.world_from_pixel(jnp.asarray(px), _jax_pose(T_a))),
             (port.depth(torch.tensor(px), T_a), jax_scene.depth(jnp.asarray(px), _jax_pose(T_a))),
             (port.project_to(torch.tensor(px), T_a, T_b),
              jax_scene.project_to(jnp.asarray(px), _jax_pose(T_a), _jax_pose(T_b))))
    for a, b in pairs:
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("make", [
    lambda: ts.BoxScene(CAM, tex_size=64),
    lambda: ts.TwoPlaneScene(CAM, tex_size=64),
    lambda: ts.loop_trajectory(4),
], ids=["BoxScene", "TwoPlaneScene", "loop_trajectory"])
def test_scenes_default_to_the_card(make, monkeypatch):
    """With no device named, the scenes and trajectories go to the card, and
    raise where there is none (they never pick the CPU on their own)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        make()


def test_box_scene_takes_six_textures():
    """textures= replaces the procedural faces (their mip stacks built from
    them); anything but six raises."""
    tex = [np.full((32, 32), 10.0 * (f + 1), np.float32) for f in range(6)]
    box = ts.BoxScene(CAM, textures=tex, device="cpu")
    assert box.tex_size == 32
    np.testing.assert_array_equal(np32(box.texs[:, 2]), np.stack(tex))   # flat: every mip equal
    with pytest.raises(ValueError, match="6 face textures"):
        ts.BoxScene(CAM, textures=tex[:5], device="cpu")
