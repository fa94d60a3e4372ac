"""The port's remaining solver code against the JAX package's on the CPU:
the robust weights and scale estimators (solvers/robust.py), the
Gauss-Newton / Levenberg-Marquardt engine (solvers/nlls.py), point-only BA
and optimize_current (solvers/ba.py), on tests/test_solvers.py's problems;
and local BA's default path unchanged by `fixed_point`.

Tolerances: the weights and scales are elementwise float32 formulas, held
to TOL_ELEM; the scales and the solvers sum in other orders (and solve by
other factorizations: torch's cholesky_solve against JAX's two triangular
solves), so they are held to TOL_SOLVE, relative to the result's size."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.solvers import ba as jba
from ygz_slam_tpu.solvers import nlls as jnlls
from ygz_slam_tpu.solvers import robust as jrobust

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.solvers import ba as tba
from ygz_slam_tpu_torch.solvers import nlls as tnlls
from ygz_slam_tpu_torch.solvers import robust as trobust

import test_solvers
from _torch_port import np32

torch.set_num_threads(1)

TOL_ELEM = 1e-6          # relative, elementwise float32 formulas
TOL_SOLVE = 1e-4         # relative: float32 sums and solves in other orders
TOL_BA_POINT = 1e-4      # m, point-only BA and optimize_current's landmarks
TOL_BA_POSE = 1e-5       # optimize_current's free pose (se3 distance)
# Below this chi2 a solve has fitted its model exactly, and when it stops is
# decided by rounding noise (a step of ~1e-8 against eps 1e-10, chi2 0
# against 1e-14): the line fit stops after 4 Gauss-Newton iterations in the
# port and 5 in the JAX package.  Iterations and the converged flag are
# compared above it.
EXACT_FIT = 1e-10


def _close(a, b, tol):
    a, b = np.asarray(np32(a), np.float64), np.asarray(np32(b), np.float64)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)
    assert err <= tol, err


@pytest.fixture(scope="module")
def residuals():
    rng = np.random.default_rng(0)
    r = np.concatenate([rng.normal(0, 2.0, 500), rng.uniform(-40, 40, 100), [0.0, 4.6851, -4.6851,
                                                                               1.345, 1e-13]])
    return r.astype(np.float32), rng.uniform(size=r.shape[0]) > 0.3


@pytest.mark.parametrize("name", ["huber_weight", "tukey_weight", "tdist_weight", "unit_weight"])
def test_weights(residuals, name):
    r, _ = residuals
    _close(getattr(trobust, name)(torch.tensor(r)), getattr(jrobust, name)(jnp.asarray(r)),
           TOL_ELEM)


def test_huber_loss(residuals):
    r, _ = residuals
    r2 = r * r
    _close(trobust.huber_loss(torch.tensor(r2), 2.447), jrobust.huber_loss(jnp.asarray(r2), 2.447),
           TOL_ELEM)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["tdist_scale", "normal_scale", "mad_scale"])
def test_scales(residuals, name, masked):
    r, m = residuals
    tm, jm = (torch.tensor(m), jnp.asarray(m)) if masked else (None, None)
    _close(getattr(trobust, name)(torch.tensor(r), tm), getattr(jrobust, name)(jnp.asarray(r), jm),
           TOL_SOLVE)


def test_robust_constants():
    for name in ("TUKEY_B", "HUBER_K", "TDIST_DOF", "MAD_SCALE"):
        assert getattr(trobust, name) == getattr(jrobust, name)


def _line_fit(xp):
    xs = xp.linspace(0, 1, 50)
    ys = 3.0 * xs + 0.5

    def compute(p):
        r = p[0] * xs + p[1] - ys
        J = xp.stack([xs, xp.ones_like(xs)], axis=-1)
        return J.T @ J, -J.T @ r, xp.sum(r * r)
    return compute


def _rosenbrock(xp):
    def compute(p):
        x, y = p[0], p[1]
        r = xp.stack([1.0 - x, 10.0 * (y - x * x)])
        J = xp.stack([xp.stack([-xp.ones_like(x), xp.zeros_like(x)]),
                      xp.stack([-20.0 * x, 10.0 * xp.ones_like(x)])])
        return J.T @ J, -J.T @ r, xp.sum(r * r)
    return compute


def _tanh(xp):
    def compute(p):
        r = xp.stack([xp.tanh(p[0]) - 0.9])
        J = (1.0 / xp.cosh(p[0]) ** 2).reshape(1, 1)
        return J.T @ J, -J.T @ r, xp.sum(r * r)
    return compute


CASES = {   # test_solvers.py's TestNLLS problems: (model, solver, x0, n_iter)
    "gn_line": (_line_fit, "gauss_newton", [0.0, 0.0], 5),
    "gn_rollback": (_tanh, "gauss_newton", [3.0], 10),
    "gn_rosenbrock": (_rosenbrock, "gauss_newton", [-1.2, 1.0], 10),
    "lm_rosenbrock": (_rosenbrock, "levenberg_marquardt", [-1.2, 1.0], 60),
    "lm_line": (_line_fit, "levenberg_marquardt", [0.0, 0.0], 15),
}


@pytest.mark.parametrize("case", CASES)
def test_nlls_matches_jax(case):
    model, solver, x0, n_iter = CASES[case]
    xj, sj = getattr(jnlls, solver)(model(jnp), lambda x, dx: x + dx,
                                    jnp.asarray(x0, jnp.float32), n_iter=n_iter)
    xt, st = getattr(tnlls, solver)(model(torch), lambda x, dx: x + dx,
                                    torch.tensor(x0, dtype=torch.float32), n_iter=n_iter)
    print(f"measured: {case}: x {np32(xt)} vs {np32(xj)}, chi2 {float(st.chi2):.3e} vs "
          f"{float(sj.chi2):.3e}, iterations {int(st.iters)} vs {int(sj.iters)}")
    _close(xt, xj, TOL_SOLVE)
    assert abs(float(st.chi2) - float(sj.chi2)) <= TOL_SOLVE * max(float(sj.chi2), 1e-3)
    if float(sj.chi2) > EXACT_FIT:
        assert int(st.iters) == int(sj.iters) and bool(st.converged) == bool(sj.converged)
    if solver == "gauss_newton":
        _close(st.H, sj.H, TOL_SOLVE)


def test_gn_rollback_keeps_best():
    """A step that raises chi2 is rolled back: the result is never worse
    than the start, and the solve stops there."""
    compute = _tanh(torch)
    p0 = torch.tensor([3.0])
    x, st = tnlls.gauss_newton(compute, lambda x, dx: x + dx, p0, n_iter=10)
    assert float(st.chi2) <= float(compute(p0)[2]) + 1e-9
    assert int(st.iters) < 10


def test_nlls_on_a_manifold():
    """An SE3 state (a NamedTuple) through both solvers: a pose fitted to
    points it maps, the update applied by boxplus."""
    rng = np.random.default_rng(1)
    p = torch.tensor(rng.uniform(-1, 1, (20, 3)), dtype=torch.float32)
    T_gt = tse3.exp(torch.tensor([0.1, -0.2, 0.05, 0.02, 0.03, -0.01]))
    q = T_gt.apply(p)

    def compute(T):
        y = T.apply(p)
        r = (y - q).reshape(-1)
        J = torch.cat([torch.eye(3).expand(20, 3, 3),
                       -torch.stack([torch.zeros_like(y[:, 0]), -y[:, 2], y[:, 1], y[:, 2],
                                     torch.zeros_like(y[:, 0]), -y[:, 0], -y[:, 1], y[:, 0],
                                     torch.zeros_like(y[:, 0])], -1).reshape(20, 3, 3)],
                      dim=-1).reshape(-1, 6)
        return J.T @ J, -J.T @ r, torch.sum(r * r)

    retract = lambda T, dx: tse3.exp(dx).compose(T)
    for solver in (tnlls.gauss_newton, tnlls.levenberg_marquardt):
        T, st = solver(compute, retract, TSE3.identity(device="cpu"), n_iter=20)
        assert isinstance(T, TSE3) and float(tse3.distance(T, T_gt)) < 1e-4


@pytest.fixture(scope="module")
def scene4():
    poses, pts, px = test_solvers.make_scene(n_kf=4, n_pts=32)
    return np32(poses.params7()), np32(pts), np32(px)


def test_point_only_ba_matches_jax(scene4):
    """test_solvers.py's TestPointOnlyBA problem: 4 fixed poses, 32
    landmarks 5 cm off."""
    p7, pts, px = scene4
    K, N = 4, 32
    kf = np.repeat(np.arange(K, dtype=np.int32), N)
    pt = np.tile(np.arange(N, dtype=np.int32), K)
    noisy = pts + np.random.default_rng(2).normal(0, 0.05, pts.shape).astype(np.float32)
    jcam = test_solvers.CAM
    jout = jba.point_only_ba(jax.vmap(lambda q: q)(jba.SE3.from_params7(jnp.asarray(p7))),
                             jnp.asarray(noisy),
                             jba.Observations(jnp.asarray(kf), jnp.asarray(pt),
                                              jnp.asarray(px.reshape(-1, 2)), jnp.ones(K * N, bool)),
                             jcam)
    tout = tba.point_only_ba(TSE3.from_params7(torch.tensor(p7)), torch.tensor(noisy),
                             tba.Observations(torch.tensor(kf), torch.tensor(pt),
                                              torch.tensor(px.reshape(-1, 2)),
                                              torch.ones(K * N, dtype=torch.bool)),
                             convert.camera_from_numpy(*jcam))
    err = float(np.abs(np32(tout) - np32(jout)).max())
    e0 = float(np.linalg.norm(noisy - pts, axis=-1).mean())
    e1 = float(np.linalg.norm(np32(tout) - pts, axis=-1).mean())
    print(f"measured: point-only BA port against JAX {err:.2e} m; error {e0:.4f} -> {e1:.6f}")
    assert err <= TOL_BA_POINT
    assert e1 < 0.05 * e0


@pytest.fixture(scope="module")
def current():
    """test_solvers.py's TestOptimizeCurrent fixture and its perturbed
    current pose and landmarks, as numpy."""
    cam, poses, gt_poses, gt_pts, obs = test_solvers.TestOptimizeCurrent()._fixture()
    cur = 3
    T_bad = jba.se3m.boxplus(gt_poses[cur], jnp.asarray([0.05, -0.04, 0.03, 0.01, -0.01, 0.02]))
    noisy = jax.tree.map(lambda full, bad: full.at[cur].set(bad), poses, T_bad)
    pts_noisy = gt_pts + 0.02 * jax.random.normal(jax.random.PRNGKey(0), gt_pts.shape)
    return dict(jcam=cam, cam=convert.camera_from_numpy(*cam), cur=cur, jobs=obs,
                obs=tba.Observations(*(torch.tensor(np32(a)) for a in obs)),
                gt7=np32(jax.vmap(lambda T: T.params7())(poses)), p7=np32(noisy.params7()),
                jposes=noisy, pts=np32(pts_noisy), gt_pts=np32(gt_pts))


def test_optimize_current_matches_jax(current):
    c = current
    jres = jba.optimize_current(c["jposes"], jnp.asarray(c["pts"]), c["jobs"], c["jcam"], c["cur"],
                                n_iter=15)
    tres = tba.optimize_current(TSE3.from_params7(torch.tensor(c["p7"])), torch.tensor(c["pts"]),
                                c["obs"], c["cam"], c["cur"], n_iter=15)
    jT = TSE3.from_params7(torch.tensor(np32(jres.poses.params7())))
    d = float(tse3.distance(TSE3(tres.poses.R[3], tres.poses.t[3]), TSE3(jT.R[3], jT.t[3])))
    dx = float(np.abs(np32(tres.points) - np32(jres.points)).max())
    gt = TSE3.from_params7(torch.tensor(c["gt7"]))
    err = float(tse3.distance(TSE3(tres.poses.R[3], tres.poses.t[3]), TSE3(gt.R[3], gt.t[3])))
    print(f"measured: optimize_current port against JAX: pose {d:.2e}, points {dx:.2e}; pose "
          f"error {err:.5f}; inliers {int(tres.inlier.sum())} vs {int(jres.inlier.sum())}")
    assert d <= TOL_BA_POSE and dx <= TOL_BA_POINT
    assert np.array_equal(np32(tres.inlier), np32(jres.inlier))
    T0 = TSE3.from_params7(torch.tensor(c["p7"]))
    for k in range(3):
        assert torch.equal(tres.poses.R[k], T0.R[k]) and torch.equal(tres.poses.t[k], T0.t[k])


def test_optimize_current_freezes_unseen_points(current):
    """test_solvers.py's rule: landmarks the current frame does not observe
    stay where they are, though other keyframes observe them."""
    c = current
    obs = c["obs"]
    keep = ~((obs.kf_idx == c["cur"]) & (obs.pt_idx >= 30))
    obs = obs._replace(mask=obs.mask & keep)
    pts = torch.tensor(c["gt_pts"]) + 0.05
    res = tba.optimize_current(TSE3.from_params7(torch.tensor(c["gt7"])), pts, obs, c["cam"],
                               c["cur"], n_iter=8)
    moved = (res.points - pts).abs()
    assert float(moved[30:].max()) == 0.0
    assert float(moved[:30].max()) > 1e-3


def test_local_ba_default_path_unchanged(current):
    """`fixed_point` absent and all False give the same bits (the default
    path multiplies nothing)."""
    c = current
    fixed = torch.arange(4) < 2
    args = (TSE3.from_params7(torch.tensor(c["p7"])), torch.tensor(c["pts"]), c["obs"], c["cam"],
            fixed)
    a = tba.local_ba(*args, n_iter=6)
    b = tba.local_ba(*args, n_iter=6, fixed_point=torch.zeros(60, dtype=torch.bool))
    for x, y in ((a.poses.R, b.poses.R), (a.poses.t, b.poses.t), (a.points, b.points),
                 (a.chi2, b.chi2), (a.inlier, b.inlier)):
        assert torch.equal(x, y)
