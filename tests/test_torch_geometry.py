"""Parity of the PyTorch port's geometry, image ops and K1 window gather
with the JAX package, on the CPU.  Inputs are made with numpy from seeds
and handed to both packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import PinholeCamera as JCam
from ygz_slam_tpu.geometry import jacobians as jjac, se3 as jse3, so3 as jso3
from ygz_slam_tpu.ops import interp as jinterp, pyramid as jpyr
from ygz_slam_tpu.ops.pallas import align2d_kernel as jak
from ygz_slam_tpu.solvers import robust as jrobust
from ygz_slam_tpu.utils import synthetic as jsyn

import ygz_slam_tpu_torch as port
from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import jacobians as tjac, se3 as tse3, so3 as tso3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera as TCam
from ygz_slam_tpu_torch.models import tracking as tr
from ygz_slam_tpu_torch.ops import interp as tinterp, pyramid as tpyr
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tak, on_card
from ygz_slam_tpu_torch.solvers import robust as trobust
from ygz_slam_tpu_torch.utils import synthetic as tsyn

from _torch_port import jax_kernels_interpreted

torch.set_num_threads(1)

# float32 elementwise math in both packages; the two differ only where
# XLA and PyTorch order a reduction or fuse differently: a few ulp.
TOL_GEOM = 2e-5
# Bilinear mixes of 0-255 intensities: |value| <= 255 at ~1e-7 relative.
TOL_PATCH = 1e-4
# Pyramid: two banded f32 products on a 0-255 image, summed in another
# order by XLA and PyTorch.
TOL_PYR = 1e-3

CAMS = {
    "pinhole": (517.3, 516.5, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0),
    "distorted": (517.3, 516.5, 318.6, 255.3, -0.28, 0.074, 1.9e-4, 1.8e-5),
}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _tangents(n=64, scale=0.8, seed=0):
    return (_rng(seed).normal(0, scale, (n, 6)) * [0.5, 0.5, 0.5, 1, 1, 1]).astype(np.float32)


class TestDevice:
    def test_explicit_cpu(self):
        assert port.resolve_device("cpu") == torch.device("cpu")

    def test_default_without_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.resolve_device()

    @pytest.mark.parametrize("make", [
        lambda: tsyn.make_texture(16),
        lambda: tsyn.PlaneScene(TCam.create(100.0, 100.0, 50.0, 40.0), tex_size=16),
        lambda: tse3.SE3.identity(),
        lambda: tr.make_workload(1),
        lambda: convert.reference_prep_from_numpy(np.zeros((2, 3)), [], None),
    ], ids=["make_texture", "PlaneScene", "SE3.identity", "make_workload", "convert"])
    def test_constructors_without_gpu_raise(self, monkeypatch, make):
        """Constructors that make tensors follow resolve_device: with no
        device named and no GPU they raise, never building on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()

    def test_tf32_off(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False

    def test_kernel_wrappers_refuse_other_devices(self):
        with pytest.raises(ValueError, match="meta"):
            on_card(torch.empty(3, device="meta"))


class TestLie:
    @pytest.mark.parametrize("scale", [1e-5, 0.3, 2.5])
    def test_so3_exp_log(self, scale):
        w = _tangents(scale=scale)[:, 3:]
        Rj = np.asarray(jso3.exp(jnp.asarray(w)))
        Rt = tso3.exp(torch.tensor(w)).numpy()
        np.testing.assert_allclose(Rt, Rj, atol=TOL_GEOM)
        np.testing.assert_allclose(tso3.log(torch.tensor(Rj)).numpy(),
                                   np.asarray(jso3.log(jnp.asarray(Rj))), atol=1e-4)

    def test_quaternion_roundtrip(self):
        R = np.asarray(jso3.exp(jnp.asarray(_tangents(scale=1.5)[:, 3:])))
        qj = np.asarray(jso3.to_quaternion(jnp.asarray(R)))
        qt = tso3.to_quaternion(torch.tensor(R)).numpy()
        np.testing.assert_allclose(qt, qj, atol=TOL_GEOM)
        np.testing.assert_allclose(tso3.from_quaternion(torch.tensor(qj)).numpy(),
                                   np.asarray(jso3.from_quaternion(jnp.asarray(qj))),
                                   atol=TOL_GEOM)

    def test_se3_ops(self):
        xa, xb = _tangents(seed=1), _tangents(seed=2)
        Ja, Jb = jse3.exp(jnp.asarray(xa)), jse3.exp(jnp.asarray(xb))
        Ta, Tb = tse3.exp(torch.tensor(xa)), tse3.exp(torch.tensor(xb))
        np.testing.assert_allclose(Ta.R.numpy(), np.asarray(Ja.R), atol=TOL_GEOM)
        np.testing.assert_allclose(Ta.t.numpy(), np.asarray(Ja.t), atol=TOL_GEOM)
        C, JC = Ta.compose(Tb.inverse()), Ja.compose(Jb.inverse())
        np.testing.assert_allclose(C.t.numpy(), np.asarray(JC.t), atol=1e-4)
        np.testing.assert_allclose(tse3.log(Ta).numpy(), np.asarray(jse3.log(Ja)), atol=1e-4)
        np.testing.assert_allclose(Ta.params7().numpy(), np.asarray(Ja.params7()),
                                   atol=TOL_GEOM)
        np.testing.assert_allclose(tse3.distance(Ta, Tb).numpy(),
                                   np.asarray(jse3.distance(Ja, Jb)), atol=1e-4)
        p = _rng(3).normal(0, 2, (64, 3)).astype(np.float32)
        np.testing.assert_allclose(Ta.apply(torch.tensor(p)).numpy(),
                                   np.asarray(Ja.apply(jnp.asarray(p))), atol=1e-4)


class TestCamera:
    @pytest.mark.parametrize("kind", sorted(CAMS))
    def test_projections(self, kind):
        tc, jc = TCam.create(*CAMS[kind]), JCam.create(*CAMS[kind])
        rng = _rng(4)
        px = np.c_[rng.uniform(0, 640, 100), rng.uniform(0, 480, 100)].astype(np.float32)
        d = rng.uniform(1, 5, 100).astype(np.float32)
        pc_t = tc.pixel_to_camera(torch.tensor(px), torch.tensor(d))
        pc_j = np.asarray(jc.pixel_to_camera(jnp.asarray(px), jnp.asarray(d)))
        np.testing.assert_allclose(pc_t.numpy(), pc_j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.camera_to_pixel(torch.tensor(pc_j)).numpy(),
                                   np.asarray(jc.camera_to_pixel(jnp.asarray(pc_j))),
                                   atol=1e-3)
        np.testing.assert_allclose(tc.undistort_px(torch.tensor(px)).numpy(),
                                   np.asarray(jc.undistort_px(jnp.asarray(px))), atol=1e-3)
        xi = _tangents(n=1, scale=0.05, seed=5)[0]
        Tt, Tj = tse3.exp(torch.tensor(xi)), jse3.exp(jnp.asarray(xi))
        pw = np.asarray(jc.pixel_to_world(jnp.asarray(px), Tj, depth=jnp.asarray(d)))
        np.testing.assert_allclose(
            tc.pixel_to_world(torch.tensor(px), Tt, depth=torch.tensor(d)).numpy(),
            pw, atol=1e-4)
        np.testing.assert_allclose(tc.world_to_pixel(torch.tensor(pw), Tt).numpy(),
                                   np.asarray(jc.world_to_pixel(jnp.asarray(pw), Tj)),
                                   atol=2e-3)

    def test_zero_distortion_is_identity(self):
        tc = TCam.create(*CAMS["pinhole"])
        x = torch.tensor(_rng(6).normal(0, 0.3, (50, 2)).astype(np.float32))
        assert not tc.has_distortion
        assert tc.distort(x) is x and tc.undistort(x) is x and tc.undistort_px(x) is x

    def test_duv_dxi(self):
        pc = (_rng(7).normal(0, 1, (80, 3)) + [0, 0, 4]).astype(np.float32)
        np.testing.assert_allclose(tjac.duv_dxi(torch.tensor(pc), 517.3, 516.5).numpy(),
                                   np.asarray(jjac.duv_dxi(jnp.asarray(pc), 517.3, 516.5)),
                                   rtol=1e-5, atol=1e-3)


class TestImageOps:
    def _img(self, H=120, W=160, seed=8):
        return _rng(seed).uniform(0, 255, (H, W)).astype(np.float32)

    def test_bilinear_in_bounds_sample_patches(self):
        img = self._img()
        rng = _rng(9)
        c = np.c_[rng.uniform(-3, 163, 60), rng.uniform(-3, 123, 60)].astype(np.float32)
        np.testing.assert_allclose(
            tinterp.bilinear(torch.tensor(img), torch.tensor(c)).numpy(),
            np.asarray(jinterp.bilinear(jnp.asarray(img), jnp.asarray(c))), atol=TOL_PATCH)
        np.testing.assert_array_equal(
            tinterp.in_bounds(torch.tensor(c), 120, 160, margin=4).numpy(),
            np.asarray(jinterp.in_bounds(jnp.asarray(c), 120, 160, margin=4)))
        np.testing.assert_allclose(
            tinterp.sample_patches(torch.tensor(img), torch.tensor(c), 10).numpy(),
            np.asarray(jinterp.sample_patches(jnp.asarray(img), jnp.asarray(c), 10)),
            atol=TOL_PATCH)

    @pytest.mark.parametrize("shape", [(480, 640), (479, 641)])
    def test_pyramid(self, shape):
        img = self._img(*shape)
        pt = tpyr.build_pyramid(torch.tensor(img), 3)
        pj = jpyr.build_pyramid(jnp.asarray(img), 3)
        for a, b in zip(pt, pj):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_PYR)

    def test_mad_scale(self):
        r = _rng(10).standard_cauchy(101).astype(np.float32)
        m = _rng(11).uniform(size=101) > 0.3
        assert float(trobust.mad_scale(torch.tensor(r), torch.tensor(m))) == \
            pytest.approx(float(jrobust.mad_scale(jnp.asarray(r), jnp.asarray(m))), rel=1e-6)

    def test_texture_bitwise(self):
        np.testing.assert_array_equal(tsyn.make_texture(256, seed=3, device="cpu").numpy(),
                                      np.asarray(jsyn.make_texture(256, seed=3)))


WINDOW_CASES = [((480, 640), 16), ((240, 320), 16), ((120, 160), 16), ((480, 640), 32),
                ((480, 640), 7)]


class TestWindows:
    """K1 against the JAX gather_windows kernel run in interpret mode."""

    @pytest.mark.parametrize("shape,win", WINDOW_CASES)
    def test_gather_windows_exact(self, shape, win):
        H, W = shape
        rng = _rng(12)
        img = rng.uniform(0, 255, shape).astype(np.float32)
        xi = rng.integers(0, W - win + 1, 40).astype(np.int32)
        yi = rng.integers(0, H - win + 1, 40).astype(np.int32)
        xi[:3], yi[:3] = [0, W - win, 5], [H - win, 0, 3]
        with jax_kernels_interpreted():
            ref = np.asarray(jak.gather_windows(jnp.asarray(img), jnp.asarray(xi),
                                                jnp.asarray(yi), win))
        out = tak.gather_windows(torch.tensor(img), torch.tensor(xi),
                                 torch.tensor(yi), win)
        np.testing.assert_array_equal(out.numpy(), ref)

    @pytest.mark.parametrize("shape,win", WINDOW_CASES + [((60, 80), 32)])
    def test_gather_windows_off_image_exact(self, shape, win):
        """Origins off the image, negative and beyond W - win / H - win: the
        JAX kernel returns the window of the zero-padded image, and so does
        K1."""
        H, W = shape
        rng = _rng(15)
        img = rng.uniform(0, 255, shape).astype(np.float32)
        xi = rng.integers(-40, W + 11, 40).astype(np.int32)
        yi = rng.integers(-40, H + 11, 40).astype(np.int32)
        xi[:4], yi[:4] = [-3, W - win + 3, -win - 2, 5], [H - win + 2, -2, 5, H + 4]
        with jax_kernels_interpreted():
            ref = np.asarray(jak.gather_windows(jnp.asarray(img), jnp.asarray(xi),
                                                jnp.asarray(yi), win))
        out = tak.gather_windows(torch.tensor(img), torch.tensor(xi), torch.tensor(yi), win)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert (ref[:4] == 0).any() and (ref[:4] != 0).any()

    def test_bilinear_patches(self):
        rng = _rng(13)
        img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
        c = np.r_[np.c_[rng.uniform(0, 319, 40), rng.uniform(0, 239, 40)],
                  [[0, 0], [319, 239], [316, 238], [2, 237]]].astype(np.float32)
        with jax_kernels_interpreted():
            ref = np.asarray(jak.bilinear_patches(jnp.asarray(img), jnp.asarray(c), 6))
        out = tak.bilinear_patches(torch.tensor(img), torch.tensor(c), 6)
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL_PATCH)

    def test_wild_coordinates_stay_finite(self):
        """Masked callers pass behind-camera projections (~1e12) and NaN."""
        img = torch.tensor(_rng(0).uniform(0, 255, (120, 160)).astype(np.float32))
        c = torch.tensor([[1e12, -1e12], [np.nan, 50.0], [-5.0, 1e9], [80.0, 60.0]])
        assert torch.isfinite(tak.bilinear_patches(img, c, 4)).all()
