"""Parity of the port's LM-Schur bundle adjustment (solvers/ba.py:
two_view_ba, local_ba; models/local_mapping.local_ba_on_map) with the JAX
package's on the CPU.

Synthetic maps made with numpy: K=4 keyframes on a sideways sweep
observing 120 landmarks at 2-5 m, f = 320, 0.5 px noise, 5% outlier
observations, the first two keyframes fixed (gauge and scale), the free
poses (by ~3 mm, ~2 mrad) and all points (by ~1 cm) perturbed.  Both
packages run the same LM schedule; they differ in the order of the
scatter-add sums only.

Two-view BA fixes one camera only, so the map's scale is a null direction
of its reduced system.  In float32 the step along it is rounding noise
(|dl| up to 7.5 m on this scene at the first iteration, with dc differing
by 40% between the packages) and whether LM accepts it is decided by that
noise: the JAX package rejects its first five steps, the port accepts its
first and drifts to a state where the points are behind the camera and
chi2 falls because their observations drop out (ROADMAP.md, queue 3).  So
two-view BA is compared in float64 (JAX under `jax.enable_x64`), where the
null-direction noise is ~1e-9 and both packages reach the same optimum."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.geometry import PinholeCamera as JCam, SE3 as JSE3
from ygz_slam_tpu.map import state as jms
from ygz_slam_tpu.models import local_mapping as jlm
from ygz_slam_tpu.solvers import ba as jba

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera as TCam
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.map import state as tms
from ygz_slam_tpu_torch.models import local_mapping as tlm
from ygz_slam_tpu_torch.solvers import ba as tba

from _torch_port import np32

torch.set_num_threads(1)

TOL_REL = 1e-4
CAM = (320.0, 320.0, 160.0, 120.0)
K, NPT, F = 4, 120, 128


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _poses(rng):
    xis = [[0.12 * k, 0.01 * k, 0.02 * k, 0.005 * k, -0.02 * k, 0.003 * k] for k in range(K)]
    return [tse3.exp(torch.tensor(x, dtype=torch.float32)) for x in xis]


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    cam = TCam.create(*CAM)
    pts = np.c_[rng.uniform(-1.5, 1.5, (NPT, 2)), rng.uniform(2.0, 5.0, NPT)].astype(np.float32)
    Ts = _poses(rng)
    px = np.stack([np32(cam.world_to_pixel(torch.tensor(pts), T)) for T in Ts])     # [K, N, 2]
    px = px + rng.normal(0, 0.5, px.shape).astype(np.float32)
    out = rng.random(px.shape[:2]) < 0.05
    px[out] += rng.uniform(-30, 30, (int(out.sum()), 2)).astype(np.float32)
    pose_noise = [np.r_[rng.normal(0, 0.003, 3), rng.normal(0, 0.002, 3)] if k >= 2 else
                  np.zeros(6) for k in range(K)]
    Ts0 = [tse3.exp(torch.tensor(n, dtype=torch.float32)).compose(T) for n, T in
           zip(pose_noise, Ts)]
    pts0 = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    return cam, Ts, Ts0, pts, pts0, px.astype(np.float32)


def test_inv3x3_matches():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    t = np32(tba.inv3x3(torch.tensor(A)))
    assert _rel(t, np32(jba.inv3x3(jnp.asarray(A)))) < 1e-6
    assert np.abs(t @ A - np.eye(3)).max() < 1e-3


@pytest.mark.parametrize("n_iter", [3, 10])
def test_two_view_ba_matches(n_iter):
    cam, Ts, Ts0, pts, pts0, px = _scene()
    mask = np.ones(NPT, bool)
    mask[-5:] = False

    def f64(x):
        return np.asarray(x, np.float64)

    T_ref, T_cur = (TSE3(torch.tensor(f64(T.R)), torch.tensor(f64(T.t))) for T in (Ts0[0], Ts0[2]))
    t = tba.two_view_ba(T_ref, T_cur, torch.tensor(f64(pts0)), torch.tensor(f64(px[0])),
                        torch.tensor(f64(px[2])), torch.tensor(mask), cam, n_iter=n_iter)
    with jax.enable_x64(True):
        J = [JSE3(jnp.asarray(f64(T.R)), jnp.asarray(f64(T.t))) for T in (Ts0[0], Ts0[2])]
        j = jba.two_view_ba(J[0], J[1], jnp.asarray(f64(pts0)), jnp.asarray(f64(px[0])),
                            jnp.asarray(f64(px[2])), jnp.asarray(mask), JCam.create(*CAM),
                            n_iter=n_iter)
        assert j.points.dtype == jnp.float64
        jR, jt, jpts, jinl, jchi2 = (np.asarray(a) for a in (j.poses.R, j.poses.t, j.points,
                                                             j.inlier, j.chi2))
    gaps = [_rel(t.poses.R.numpy(), jR), _rel(t.poses.t.numpy(), jt),
            _rel(t.points.numpy(), jpts), _rel(t.chi2.numpy(), jchi2)]
    print(f"two_view_ba n_iter={n_iter} (float64): R {gaps[0]:.2e}, t {gaps[1]:.2e}, points "
          f"{gaps[2]:.2e}, chi2 {gaps[3]:.2e} (relative)")
    assert max(gaps) < TOL_REL
    assert np.array_equal(t.inlier.numpy(), jinl)
    if n_iter == 10:        # LM accepted steps: the run moved
        assert float(t.chi2) < 0.5 * float(tba.two_view_ba(
            T_ref, T_cur, torch.tensor(f64(pts0)), torch.tensor(f64(px[0])),
            torch.tensor(f64(px[2])), torch.tensor(mask), cam, n_iter=0).chi2)


def _map(cam, Ts0, pts0, px):
    """A MapState of K keyframes whose first NPT features observe the
    landmarks (the rest invalid), built by the port and mirrored to JAX."""
    m = tms.empty_map(K, F, 3 * NPT, device="cpu")
    rows = torch.arange(NPT, dtype=torch.int32)
    for k, T in enumerate(Ts0):
        fpx = torch.zeros((F, 2))
        fpx[:NPT] = torch.tensor(px[k])
        valid = torch.zeros(F, dtype=torch.bool)
        valid[:NPT] = True
        fp = torch.full((F,), -1, dtype=torch.int32)
        fp[:NPT] = rows
        m = tms.insert_keyframe(m, k, k, T, fpx, torch.zeros(F, dtype=torch.int32),
                                torch.zeros(F), torch.zeros((F, 8), dtype=torch.int32),
                                torch.ones(F), fp, valid)
    m = tms.add_landmarks(m, rows, torch.ones(NPT, dtype=torch.bool), torch.tensor(pts0),
                          torch.zeros((NPT, 8), dtype=torch.int32), 0)
    return m


def test_local_ba_on_map_matches():
    cam, Ts, Ts0, pts, pts0, px = _scene(2)
    m = tms.update_covisibility(_map(cam, Ts0, pts0, px))
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(m).items()})
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    tm, tchi2 = tlm.local_ba_on_map(m, cam, torch.tensor(fixed), n_iter=8)
    jm2, jchi2 = jlm.local_ba_on_map(jm, JCam.create(*CAM), jnp.asarray(fixed), n_iter=8)
    gaps = [_rel(np32(tm.kf_pose7), np32(jm2.kf_pose7)), _rel(np32(tm.pt_pos), np32(jm2.pt_pos)),
            _rel(np32(tchi2), np32(jchi2))]
    print(f"local_ba_on_map (float32): poses {gaps[0]:.2e}, points {gaps[1]:.2e}, chi2 "
          f"{gaps[2]:.2e} (relative)")
    assert max(gaps) < TOL_REL
    assert np.array_equal(np32(tm.kf_pose7)[:2], np32(m.kf_pose7)[:2])     # fixed stay
    err0 = float(tse3.distance(TSE3.from_params7(m.kf_pose7[3]), Ts[3]))
    err1 = float(tse3.distance(TSE3.from_params7(tm.kf_pose7[3]), Ts[3]))
    assert err1 < err0


def test_local_ba_all_fixed_is_a_zero_step():
    """Every camera fixed: the reduced system is the identity, the camera
    step exactly zero, and nothing raises; the points still move."""
    cam, Ts, Ts0, pts, pts0, px = _scene(3)
    m = tms.update_covisibility(_map(cam, Ts0, pts0, px))
    tm, chi2 = tlm.local_ba_on_map(m, cam, torch.ones(K, dtype=torch.bool), n_iter=3)
    # Written back through SE3 (params7 -> R -> params7): equal to that
    # round trip of the input, bit for bit.
    assert torch.equal(tm.kf_pose7, TSE3.from_params7(m.kf_pose7).params7())
    assert bool(torch.isfinite(tm.pt_pos).all()) and bool(torch.isfinite(chi2))
    assert not torch.equal(tm.pt_pos, m.pt_pos)
