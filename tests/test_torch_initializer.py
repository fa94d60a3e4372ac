"""Parity of the port's monocular initializer (solvers/initializer.py) and
DLT triangulation with the JAX package's, on the CPU.

Synthetic correspondences made with numpy: 200 points seen by two cameras
(K of a 640x480 camera, f = 640), either on a plane (the homography is
chosen) or spread in depth (the fundamental is), with 0.3 px noise and 20%
of the matches replaced by outliers.  The RANSAC draw is the JAX
package's: the port's `ransac_hf_from_samples` gets the indices
`jax.random.choice` drew."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.geometry import triangulation as jtri
from ygz_slam_tpu.solvers import initializer as jin

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry import triangulation as ttri
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.solvers import initializer as tin

from _torch_port import jax_ransac_indices, np32

torch.set_num_threads(1)

N = 200
K_NP = np.array([[640.0, 0.0, 320.0], [0.0, 640.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
MOTION = [0.25, -0.04, 0.05, 0.02, -0.06, 0.01]      # frame 2 w.r.t. frame 1
MIN_AGREE = 0.99      # inlier sets: a point on the chi2 threshold may flip on rounding
TOL_POSE = 1e-4
TOL_PTS = 1e-3        # relative
TOL_MODEL = 1e-4      # H, F up to scale and sign, relative


def _correspondences(planar: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([-1.6, -1.2], [1.6, 1.2], (N, 2))
    z = np.full(N, 3.0) if planar else rng.uniform(2.0, 5.0, N)
    X1 = np.c_[xy * z[:, None] / 3.0, z]
    T = tse3.exp(torch.tensor(MOTION, dtype=torch.float64))
    R, t = T.R.numpy(), T.t.numpy()
    X2 = X1 @ R.T + t

    def proj(X):
        return (X[:, :2] / X[:, 2:]) * 640.0 + np.array([320.0, 240.0])

    p1 = proj(X1) + rng.normal(0, 0.3, (N, 2))
    p2 = proj(X2) + rng.normal(0, 0.3, (N, 2))
    out = rng.random(N) < 0.2
    p2[out] = rng.uniform([0, 0], [640, 480], (int(out.sum()), 2))
    mask = np.ones(N, bool)
    mask[-7:] = False                                  # padded rows
    return p1.astype(np.float32), p2.astype(np.float32), mask, R.astype(np.float32), \
        t.astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _same_up_to_scale(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.fixture(scope="module", params=[True, False], ids=["planar", "general"])
def case(request):
    p1, p2, mask, R, t = _correspondences(request.param)
    idx = jax_ransac_indices(mask, 7)
    jres = jin.ransac_hf(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), jax.random.key(7))
    tres = tin.ransac_hf_from_samples(_t(idx, torch.long), _t(p1), _t(p2), _t(mask, torch.bool))
    return dict(planar=request.param, p1=p1, p2=p2, mask=mask, R=R, t=t, idx=idx, jres=jres,
                tres=tres)


def test_jax_indices_are_the_ones_ransac_draws(case):
    """The JAX draw handed to the port: 200 hypotheses of 8 distinct valid
    matches (test_ransac_matches then shows both score the same models)."""
    mask = case["mask"]
    idx = case["idx"]
    assert idx.shape == (200, 8)
    assert all(len(set(r)) == 8 and mask[r].all() for r in idx)


def test_ransac_matches(case):
    jres, tres = case["jres"], case["tres"]
    assert (float(tres.rh) > 0.4) == (float(jres.rh) > 0.4) == case["planar"]
    gaps = dict(rh=abs(float(tres.rh) - float(jres.rh)),
                H=_same_up_to_scale(np32(tres.H), np32(jres.H)),
                F=_same_up_to_scale(np32(tres.F), np32(jres.F)),
                inl_h=np.mean(np32(tres.inliers_h) == np32(jres.inliers_h)),
                inl_f=np.mean(np32(tres.inliers_f) == np32(jres.inliers_f)))
    print(f"ransac_hf ({'planar' if case['planar'] else 'general'}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert gaps["rh"] < 1e-3 and gaps["H"] < TOL_MODEL and gaps["F"] < TOL_MODEL
    assert gaps["inl_h"] >= MIN_AGREE and gaps["inl_f"] >= MIN_AGREE


def test_reconstruct_matches(case):
    p1, p2, mask = case["p1"], case["p2"], case["mask"]
    jout = jin.reconstruct(case["jres"], jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                           jnp.asarray(K_NP))
    tout = tin.reconstruct(case["tres"], _t(p1), _t(p2), _t(mask, torch.bool), _t(K_NP))
    assert bool(tout.success) and bool(jout.success)
    assert bool(tout.used_h) == bool(jout.used_h) == case["planar"]
    T_t = tout.T21
    T_j = TSE3(_t(np32(jout.T21.R)), _t(np32(jout.T21.t)))
    good_t, good_j = np32(tout.good), np32(jout.good)
    both = good_t & good_j
    X_t, X_j = np32(tout.points3d)[both], np32(jout.points3d)[both]
    gaps = (float(tse3.distance(T_t, T_j)), np.mean(good_t == good_j),
            np.abs(X_t - X_j).max() / np.abs(X_j).max())
    print(f"reconstruct ({'planar' if case['planar'] else 'general'}): T21 distance "
          f"{gaps[0]:.2e}, good sets agree {gaps[1]:.4f}, points {gaps[2]:.2e} (relative)")
    assert gaps[0] < TOL_POSE and gaps[1] >= MIN_AGREE and gaps[2] < TOL_PTS
    # The motion is recovered up to the scale of t.
    assert np.abs(np32(T_t.R) - case["R"]).max() < 1e-2
    t_dir = case["t"] / np.linalg.norm(case["t"])
    assert float(np32(T_t.t) @ t_dir) > 0.99


def test_init_result_converts_both_ways(case):
    """The JAX init result carried into the port and back is bit-equal,
    and the port's own result, carried out, agrees with it."""
    p1, p2, mask = case["p1"], case["p2"], case["mask"]
    jout = jin.reconstruct(case["jres"], jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                           jnp.asarray(K_NP))
    jfields = dict(success=jout.success, R=jout.T21.R, t=jout.T21.t, points3d=jout.points3d,
                   good=jout.good, used_h=jout.used_h)
    port = convert.init_result_from_numpy(**{k: np32(v) for k, v in jfields.items()},
                                          device="cpu")
    assert port.points3d.dtype == torch.float32 and port.good.dtype == torch.bool
    back = convert.init_result_to_numpy(port)
    for k, v in jfields.items():
        assert np.array_equal(back[k], np32(v)), k
    own = convert.init_result_to_numpy(tin.reconstruct(case["tres"], _t(p1), _t(p2),
                                                       _t(mask, torch.bool), _t(K_NP)))
    assert bool(own["used_h"]) == bool(back["used_h"])
    assert np.abs(own["t"] - back["t"]).max() < TOL_POSE


def test_initialize_two_view_with_jax_draw(case, monkeypatch):
    """The whole entry point, the sampler replaced by the JAX draw."""
    p1, p2, mask = case["p1"], case["p2"], case["mask"]
    monkeypatch.setattr(tin, "sample_hypotheses",
                        lambda m, n, gen: _t(jax_ransac_indices(m, gen.initial_seed(), n),
                                             torch.long))
    tout = tin.initialize_two_view(_t(p1), _t(p2), _t(mask, torch.bool), _t(K_NP),
                                   torch.Generator().manual_seed(7))
    jout = jin.initialize_two_view(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                                   jnp.asarray(K_NP), jax.random.key(7))
    assert bool(tout.success) == bool(jout.success)
    assert float(tse3.distance(tout.T21, TSE3(_t(np32(jout.T21.R)), _t(np32(jout.T21.t))))) \
        < TOL_POSE


def test_normalize_and_minimal_models(case):
    p1, p2, mask = case["p1"], case["p2"], case["mask"]
    n_t, T_t = tin.normalize_points(_t(p1), _t(mask, torch.bool))
    n_j, T_j = jin.normalize_points(jnp.asarray(p1), jnp.asarray(mask))
    assert np.abs(np32(n_t) - np32(n_j)).max() < 1e-5
    assert np.abs(np32(T_t) - np32(T_j)).max() < 1e-6
    ix = case["idx"][0]
    a, b = np32(n_j)[ix], jin.normalize_points(jnp.asarray(p2), jnp.asarray(mask))[0][ix]
    assert _same_up_to_scale(np32(tin._h_from_points(_t(a), _t(np32(b)))),
                             np32(jin._h_from_points(jnp.asarray(a), b))) < TOL_MODEL
    assert _same_up_to_scale(np32(tin._f_from_points(_t(a), _t(np32(b)))),
                             np32(jin._f_from_points(jnp.asarray(a), b))) < TOL_MODEL


def test_checks_match(case):
    p1, p2, mask = case["p1"], case["p2"], case["mask"]
    jres = case["jres"]
    for tfn, jfn, M in ((tin.check_homography, jin.check_homography, jres.H),
                        (tin.check_fundamental, jin.check_fundamental, jres.F)):
        s_t, ok_t = tfn(_t(np32(M)), _t(p1), _t(p2), _t(mask, torch.bool))
        s_j, ok_j = jfn(M, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask))
        assert abs(float(s_t) - float(s_j)) <= 1e-4 * abs(float(s_j))
        assert np.mean(np32(ok_t) == np32(ok_j)) >= MIN_AGREE


def _same_candidates(Ra, ta, Rb, tb, tol=1e-4):
    """Every (R, t) of one set has a partner in the other."""
    for R, t in zip(Ra, ta):
        d = [max(np.abs(R - R2).max(), np.abs(t - t2).max()) for R2, t2 in zip(Rb, tb)]
        if min(d) > tol:
            return False
    return True


def test_decompositions(case):
    jres = case["jres"]
    H, F = np32(jres.H), np32(jres.F)
    Rs_t, ts_t = (np32(x) for x in tin.decompose_h(_t(H), _t(K_NP)))
    Rs_n, ts_n = (np32(x) for x in tin.decompose_h(_t(-H), _t(K_NP)))
    Rs_j, ts_j = (np32(x) for x in jin.decompose_h(jnp.asarray(H), jnp.asarray(K_NP)))
    assert _same_candidates(Rs_t, ts_t, Rs_n, ts_n) and _same_candidates(Rs_n, ts_n, Rs_t, ts_t)
    assert _same_candidates(Rs_t, ts_t, Rs_j, ts_j) and _same_candidates(Rs_j, ts_j, Rs_t, ts_t)
    E = K_NP.T @ F @ K_NP
    Re_t, te_t = (np32(x) for x in tin.decompose_e(_t(E)))
    Re_j, te_j = (np32(x) for x in jin.decompose_e(jnp.asarray(E)))
    assert _same_candidates(Re_t, te_t, Re_j, te_j) and _same_candidates(Re_j, te_j, Re_t, te_t)


def test_check_rt_matches(case):
    p1, p2, mask = case["p1"], case["p2"], case["mask"]
    R, t = case["R"], case["t"] / np.linalg.norm(case["t"])
    out_t = tin.check_rt(_t(R), _t(t), _t(p1), _t(p2), _t(mask, torch.bool), _t(K_NP))
    out_j = jin.check_rt(jnp.asarray(R), jnp.asarray(t), jnp.asarray(p1), jnp.asarray(p2),
                         jnp.asarray(mask), jnp.asarray(K_NP))
    assert abs(int(out_t.n_good) - int(out_j.n_good)) <= 1
    assert abs(float(out_t.parallax_deg) - float(out_j.parallax_deg)) < 1e-3
    both = np32(out_t.good) & np32(out_j.good)
    X_t, X_j = np32(out_t.points3d)[both], np32(out_j.points3d)[both]
    assert np.abs(X_t - X_j).max() / np.abs(X_j).max() < TOL_PTS


def test_triangulate_dlt_matches():
    rng = np.random.default_rng(3)
    X = np.c_[rng.uniform(-1, 1, (50, 2)), rng.uniform(2, 5, 50)].astype(np.float32)
    T = tse3.exp(torch.tensor(MOTION))
    R, t = np32(T.R), np32(T.t)
    P1 = np.c_[np.eye(3), np.zeros(3)].astype(np.float32)
    P2 = np.c_[R, t].astype(np.float32)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    Xt = np32(ttri.triangulate_dlt(_t(P1), _t(P2), _t(x1), _t(x2)))
    Xj = np32(jtri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(x1),
                                   jnp.asarray(x2)))
    assert np.abs(Xt - Xj).max() / np.abs(Xj).max() < TOL_PTS
    assert np.abs(Xt - X).max() < 1e-3
