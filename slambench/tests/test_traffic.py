"""The traffic generator and the renderers repeat from their seed, and
stay the frozen copies of what they copy."""
import numpy as np
import pytest
import torch

from slambench import scene, traffic


@pytest.mark.parametrize("name", ["explore", "wall_scan", "xyz", "track"])
def test_poses_repeat_from_the_seed(name):
    mix = traffic.load(name)
    R1, t1 = traffic.poses(mix, 2 ** 31 + 17, 50)
    R2, t2 = traffic.poses(mix, 2 ** 31 + 17, 50)
    assert np.array_equal(R1, R2) and np.array_equal(t1, t2)
    assert np.allclose(np.einsum("nij,nkj->nik", R1, R1), np.eye(3), atol=1e-12)


def test_loop_moves_with_the_seed():
    mix = traffic.load("explore")
    _, t1 = traffic.poses(mix, 1, 20)
    _, t2 = traffic.poses(mix, 2, 20)
    assert not np.allclose(t1, t2)


def test_clip_is_bench_batch_clip():
    from ygz_slam_tpu_torch.models.tracking import _pose

    mix = traffic.load("track")
    R, t = traffic.poses(mix, 5, 65)
    for i in (0, 7, 33, 59, 60, 64):
        T = _pose(i % 60, "cpu")
        assert np.allclose(R[i], T.R.numpy(), atol=2e-6)
        assert np.allclose(t[i], T.t.numpy(), atol=2e-6)


def test_loop_is_the_port_loop():
    """The `explore` mix is bench_accuracy.py's loop: 2.2 laps in 2000 frames,
    radius 1.8, facing out."""
    from ygz_slam_tpu_torch.utils.synthetic import loop_trajectory

    Ts = loop_trajectory(2000, radius=1.8, laps=2.2, seed=0, face="out", device="cpu")
    R, t = traffic.poses(traffic.load("explore"), 0, 1000)
    for k in (0, 123, 999):
        assert np.allclose(R[k], Ts[k].R.numpy(), atol=1e-6)
        assert np.allclose(t[k], Ts[k].t.numpy(), atol=1e-6)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_textures_repeat_from_the_seed():
    a = scene.textures(2, 64, _gen(3), "cpu")
    b = scene.textures(2, 64, _gen(3), "cpu")
    c = scene.textures(2, 64, _gen(4), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) == pytest.approx(40.0) and float(a.max()) == pytest.approx(215.0)


def test_box_render_is_the_port_box_scene():
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.utils.synthetic import BoxScene

    cam = PinholeCamera.create(64.0, 64.0, 32.5, 24.5)
    port = BoxScene(cam, tex_size=128, tex_per_meter=16.0, seed=0, vignette=0.25, device="cpu")
    mine = scene.BoxWorld(scene.Camera(cam.fx, cam.fy, cam.cx, cam.cy), [4.0, 2.0, 4.0], 128,
                          16.0, 0.25, 0.7, _gen(0), "cpu")
    mine.mips = port.texs.reshape(30, 128, 128).clone()
    R, t = scene.loop_pose(0.7, 1.8, 0.08, np.array([0.1, 0.2, 0.3]))
    T = SE3(torch.tensor(R, dtype=torch.float32), torch.tensor(t, dtype=torch.float32))
    want = port.render(T, (48, 64), gain=1.05, bias=-2.0)
    got = mine.render(T.R[None], T.t[None], (48, 64), torch.tensor([1.05]),
                      torch.tensor([-2.0]))[0]
    assert float((want - got).abs().max()) < 0.05


def test_plane_depth_is_the_port_plane_scene():
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

    cam = PinholeCamera.create(535.4, 539.2, 320.1, 247.6)
    port = PlaneScene(cam, plane_z=3.0, tex_per_meter=220.0, device="cpu")
    mine = scene.PlaneWorld(scene.Camera(cam.fx, cam.fy, cam.cx, cam.cy), 1, 3.0, 64, 220.0,
                            _gen(0), "cpu")
    px = torch.tensor([[[30.0, 40.0], [600.0, 450.0], [325.0, 250.0]]])
    eye, zero = torch.eye(3)[None], torch.zeros((1, 3))
    want = port.depth(px[0], SE3.identity(device="cpu"))
    assert torch.allclose(mine.depth_at(px, eye, zero)[0], want, atol=1e-5)
