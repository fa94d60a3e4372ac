"""Parity of the port's host-side pose tools (utils/np_se3.py, a copy of
the JAX package's, and system/trajectory.py) with the JAX package's, on
random poses made with numpy.  Both are float64 numpy on the host, except
where the JAX package goes through its float32 SE3 (TUM files, camera
centres), which bounds those comparisons at ~1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.system import trajectory as jtraj
from ygz_slam_tpu.utils import np_se3 as jnp_se3

from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.system import trajectory as ttraj
from ygz_slam_tpu_torch.utils import np_se3 as tnp_se3

from _torch_port import np32

torch.set_num_threads(1)

TOL_F32 = 2e-6       # through the JAX package's float32 SE3


def _poses(n, seed=0):
    """[n, 7] params7 (unit wxyz quaternion with w > 0, translation)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.sign(q[:, :1])
    return np.c_[q, rng.uniform(-2, 2, (n, 3))]


@pytest.mark.parametrize("fn", ["compose7", "relative7"])
def test_binary_ops_match(fn):
    a, b = _poses(32, 1), _poses(32, 2)
    np.testing.assert_allclose(getattr(tnp_se3, fn)(a, b), getattr(jnp_se3, fn)(a, b),
                               rtol=0, atol=1e-12)


def test_inverse_matches():
    a = _poses(32, 3)
    np.testing.assert_allclose(tnp_se3.inverse7(a), jnp_se3.inverse7(a), rtol=0, atol=1e-12)


def test_log_matches():
    """log6 takes one pose: small, large and near-pi rotations."""
    P = _poses(16, 9)
    P[0, :4] = [1.0, 1e-9, 0.0, 0.0]
    P[1, :4] = [1e-4, 1.0, 0.0, 0.0]
    for p in P:
        np.testing.assert_allclose(tnp_se3.log6(p), jnp_se3.log6(p), rtol=0, atol=1e-9)


def test_rt_round_trip_matches():
    for p in _poses(8, 4):
        R, t = tnp_se3.params7_to_Rt(p)
        Rj, tj = jnp_se3.params7_to_Rt(p)
        np.testing.assert_allclose(R, Rj, atol=1e-12)
        np.testing.assert_allclose(t, tj, atol=1e-12)
        np.testing.assert_allclose(tnp_se3.Rt_to_params7(R, t), jnp_se3.Rt_to_params7(Rj, tj),
                                   atol=1e-12)


def test_camera_centers_match():
    P = _poses(16, 5).astype(np.float32)
    np.testing.assert_allclose(ttraj.camera_centers(P), jtraj.camera_centers(P), atol=TOL_F32)
    ports = [TSE3.from_params7(torch.tensor(p)) for p in P]
    np.testing.assert_allclose(ttraj.camera_centers(ports), jtraj.camera_centers(P),
                               atol=TOL_F32)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_and_ate_match(with_scale):
    rng = np.random.default_rng(6)
    est = rng.normal(size=(50, 3))
    R = tnp_se3.params7_to_Rt(_poses(1, 7)[0])[0]
    gt = (2.5 if with_scale else 1.0) * est @ R.T + np.array([0.3, -1.0, 2.0])
    noisy = gt + rng.normal(0, 0.01, gt.shape)
    for a, b in zip(ttraj.umeyama_align(est, noisy, with_scale),
                    jtraj.umeyama_align(est, noisy, with_scale)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    assert ttraj.ate_rmse(est, noisy, with_scale) == pytest.approx(
        jtraj.ate_rmse(est, noisy, with_scale), abs=1e-12)
    assert ttraj.ate_rmse(est, gt, with_scale) < 1e-9      # an exact similarity


def test_tum_files_cross_load(tmp_path):
    """Each package reads the other's TUM file back to the same poses."""
    P = _poses(10, 8).astype(np.float32)
    stamps = np.arange(10) * 0.1
    ttraj.save_tum(str(tmp_path / "port.txt"), stamps, [TSE3.from_params7(torch.tensor(p))
                                                        for p in P])
    jtraj.save_tum(str(tmp_path / "jax.txt"), stamps, [jnp.asarray(p) for p in P])
    ts, Pt = ttraj.load_tum(str(tmp_path / "jax.txt"))
    tj, Pj = jtraj.load_tum(str(tmp_path / "port.txt"))
    np.testing.assert_allclose(ts, stamps, atol=1e-6)
    np.testing.assert_allclose(tj, stamps, atol=1e-6)
    for p, pt, Tj in zip(P, Pt, Pj):
        R, t = tnp_se3.params7_to_Rt(p)
        Rt_, tt_ = tnp_se3.params7_to_Rt(pt)
        assert isinstance(Tj, JSE3)
        np.testing.assert_allclose(Rt_, R, atol=1e-5)
        np.testing.assert_allclose(tt_, t, atol=1e-5)
        np.testing.assert_allclose(np32(Tj.R), R, atol=1e-5)
        np.testing.assert_allclose(np32(Tj.t), t, atol=1e-5)
