"""The Sim(3) group and the Sim(3) half of the pose graph, the port against
the JAX package, both on the CPU: tests/test_sim3.py's seven tests, each
run on the port with the JAX test's own assertions, and beside them the
port's values held to the JAX functions' on the same seeded inputs.

Tolerances: the group operations (exp, log, compose, inverse, apply,
adjoint) within TOL_GROUP relative to max(1, |value|) (float32, the same
formulas in another library's kernels), on both sides of each Taylor
threshold of `_W` (theta^2 < 1e-8, |sigma| < 1e-5) and of so3's; the
pose-graph solves (`optimize_sim3`, `close_loop_global`,
`close_loop_global_sim3`: 25-30 dense float32 Gauss-Newton solves, two
LAPACKs) within TOL_PG on poses and scales, chi2 within TOL_CHI2 relative;
`correct_landmarks_sim3` within TOL_GROUP."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.geometry import Sim3 as JSim3
from ygz_slam_tpu.geometry import sim3 as jsim3
from ygz_slam_tpu.models import relocalization as jrl
from ygz_slam_tpu.solvers import pose_graph as jpg

from ygz_slam_tpu_torch.geometry import Sim3, se3, sim3
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.solvers import pose_graph as tpg
from ygz_slam_tpu_torch.utils import np_se3

from _torch_port import np32

torch.set_num_threads(1)

TOL_GROUP = 1e-5        # group operations, relative to max(1, |value|)
TOL_PG = 1e-4           # pose-graph poses (params7 / params8 entries) and scales
TOL_CHI2 = 1e-3         # pose-graph chi2, relative (a sum over the residual floor)


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def close(a, b, tol=TOL_GROUP) -> float:
    a, b = np32(a).astype(np.float64), np32(b).astype(np.float64)
    d = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
    assert d <= tol, d
    return d


# -- the group ------------------------------------------------------------------
def tangents(kind: str, n: int = 40, seed: int = 0) -> np.ndarray:
    """Tangents on one side of the Taylor thresholds: both angle and scale
    large, both tiny, a tiny scale only, a tiny angle only, and each just
    either side of its threshold."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.8, (n, 7))
    if kind == "tiny_both":
        xi = rng.normal(0, 1e-6, (n, 7))
    elif kind == "tiny_scale":
        xi[:, 6] = rng.normal(0, 1e-8, n)
    elif kind == "tiny_angle":
        xi[:, 3:6] = rng.normal(0, 1e-8, (n, 3))
    elif kind == "scale_at_threshold":
        xi[:, 6] = rng.choice([-1, 1], n) * rng.uniform(0.5e-5, 2e-5, n)
    elif kind == "angle_at_threshold":
        d = rng.normal(size=(n, 3))
        xi[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.5e-4, 2e-4, n)[:, None]
    return xi.astype(np.float32)


KINDS = ["general", "tiny_both", "tiny_scale", "tiny_angle", "scale_at_threshold",
         "angle_at_threshold"]


@pytest.mark.parametrize("kind", KINDS)
def test_exp_log_adjoint_as_jax(kind):
    xi = tangents(kind)
    S_t, S_j = sim3.exp(t(xi)), jsim3.exp(jnp.asarray(xi))
    close(S_t.R, S_j.R)
    close(S_t.t, S_j.t)
    close(S_t.s, S_j.s)
    close(sim3._W(t(xi[:, 3:6]), t(xi[:, 6])), jsim3._W(jnp.asarray(xi[:, 3:6]),
                                                        jnp.asarray(xi[:, 6])))
    close(sim3.log(S_t), jsim3.log(S_j), tol=2e-4)     # the JAX roundtrip's own bound
    close(sim3.adjoint(S_t), jsim3.adjoint(S_j))
    Sb_t, Sb_j = sim3.exp(t(xi[::-1].copy())), jsim3.exp(jnp.asarray(xi[::-1].copy()))
    C_t, C_j = S_t.compose(Sb_t.inverse()), S_j.compose(Sb_j.inverse())
    close(C_t.params8(), C_j.params8())
    x = np.random.default_rng(5).normal(0, 1, (xi.shape[0], 3)).astype(np.float32)
    close(S_t.apply(t(x)), S_j.apply(jnp.asarray(x)))
    close(sim3.distance(S_t, Sb_t), jsim3.distance(S_j, Sb_j), tol=2e-4)


def test_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    xi = np.concatenate([
        rng.normal(0, 1.0, (100, 7)),
        rng.normal(0, 1e-6, (20, 7)),
        np.concatenate([rng.normal(0, 1, (20, 6)), rng.normal(0, 1e-8, (20, 1))], 1),
        np.concatenate([rng.normal(0, 1e-8, (20, 3)), rng.normal(0, 1, (20, 4))], 1),
    ]).astype(np.float32)
    err = float((sim3.log(sim3.exp(t(xi))) - t(xi)).abs().max())
    assert err < 2e-4, err


def test_compose_inverse_apply():
    rng = np.random.default_rng(1)
    xi = t(rng.normal(0, 0.6, (40, 7)))
    Sa, Sb = sim3.exp(xi[:20]), sim3.exp(xi[20:])
    x = t(rng.normal(0, 1, (20, 3)))
    assert float((Sa.compose(Sb).apply(x) - Sa.apply(Sb.apply(x))).abs().max()) < 1e-4
    ident = Sa.compose(Sa.inverse())
    assert float((ident.s - 1).abs().max()) < 1e-5
    assert float(ident.t.abs().max()) < 1e-5


def test_adjoint_identity():
    """Ad(S) xi == log(S exp(xi) S^-1) to first order."""
    rng = np.random.default_rng(2)
    S1 = sim3.exp(t([0.3, -0.2, 0.1, 0.2, -0.1, 0.15, 0.1]))
    small = t(rng.normal(0, 1e-3, (30, 7)))
    lhs = torch.einsum("ab,nb->na", sim3.adjoint(S1), small)
    Sv = Sim3(S1.R.expand(30, 3, 3), S1.t.expand(30, 3), S1.s.expand(30))
    rhs = sim3.log(Sv.compose(sim3.exp(small)).compose(Sv.inverse()))
    rel = float((lhs - rhs).abs().max() / rhs.abs().max())
    assert rel < 1e-2, rel


def test_se3_consistency():
    """sigma = 0 reduces exactly to SE(3); to_se3 absorbs the scale."""
    rng = np.random.default_rng(3)
    xi6 = t(rng.normal(0, 0.5, (20, 6)))
    S0 = sim3.exp(torch.cat([xi6, torch.zeros(20, 1)], -1))
    T = se3.exp(xi6)
    assert float((S0.R - T.R).abs().max()) < 1e-5
    assert float((S0.t - T.t).abs().max()) < 1e-5
    S = Sim3(T.R, T.t, torch.full((20,), 2.5))
    c_sim = -torch.einsum("nij,ni->nj", S.R, S.t / S.s[:, None])
    T2 = S.to_se3()
    c_se3 = -torch.einsum("nij,ni->nj", T2.R, T2.t)
    assert float((c_sim - c_se3).abs().max()) < 1e-5


# -- the Sim(3) pose graph ----------------------------------------------------------
def drifted_loop(K=24, drift=1.02):
    """tests/test_sim3.py's `_drifted_loop`: a circle whose odometry
    translations drift in scale by `drift` per step; (gt centres, gt
    params7, drifted params7)."""
    gt_centers = np.asarray([[2 * np.cos(2 * np.pi * k / K), 2 * np.sin(2 * np.pi * k / K), 0.0]
                             for k in range(K)], np.float32)
    gt7 = np.stack([np.concatenate([[1, 0, 0, 0], -c]) for c in gt_centers]).astype(np.float32)
    est7 = [gt7[0]]
    for k in range(1, K):
        T_rel = np_se3.relative7(gt7[k], gt7[k - 1]).copy()
        T_rel[4:7] *= drift ** k
        est7.append(np_se3.compose7(T_rel, est7[-1]))
    return gt_centers, gt7, np.asarray(est7, np.float32)


def ate(p7, gt_centers) -> float:
    c = np.stack([-(np_se3.params7_to_Rt(p)[0].T @ np_se3.params7_to_Rt(p)[1])
                  for p in np.asarray(p7)])
    return float(np.sqrt(((c - gt_centers) ** 2).sum(1).mean()))


def loop_edges(K, est7, gt7, drift):
    ii = list(range(K - 1)) + [K - 1]
    jj = list(range(1, K)) + [0]
    T7 = [np_se3.relative7(est7[k + 1], est7[k]) for k in range(K - 1)]
    T7.append(np_se3.relative7(gt7[0], gt7[K - 1]))
    lam = drift ** (K - 1)
    e8 = np.asarray([np.concatenate([T7[k], [1.0]]) for k in range(K - 1)]
                    + [np.concatenate([T7[K - 1], [1.0 / lam]])], np.float32)
    return (np.asarray(ii, np.int32), np.asarray(jj, np.int32), np.asarray(T7, np.float32), e8,
            lam)


def test_scale_drifted_loop():
    """SE(3) closure cannot absorb per-node scale drift; Sim(3) brings ATE
    to the noise floor and recovers the drift profile, as in the JAX
    package (poses, scales and chi2 held to its solve)."""
    K, drift = 24, 1.02
    gt_centers, gt7, est7 = drifted_loop(K, drift)
    ii, jj, T7, e8, lam = loop_edges(K, est7, gt7, drift)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ones = np.ones(K, np.float32)
    edges = tpg.PoseGraphEdges(t(ii).int(), t(jj).int(), t(T7), t(ones),
                               torch.ones(K, dtype=torch.bool))
    p_se3, _ = tpg.optimize(SE3.from_params7(t(est7)), edges, torch.tensor(fixed), n_iter=30)
    ate0, ate_se3 = ate(est7, gt_centers), ate(np32(p_se3.params7()), gt_centers)
    sedges = tpg.Sim3Edges(edges.i, edges.j, t(e8), edges.weight, edges.mask)
    psim, chi2 = tpg.optimize_sim3(Sim3.from_se3(SE3.from_params7(t(est7))), sedges,
                                   torch.tensor(fixed), n_iter=30)
    ate_sim3 = ate(np32(psim.to_se3().params7()), gt_centers)
    jedges = jpg.Sim3Edges(jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(e8), jnp.asarray(ones),
                           jnp.ones(K, bool))
    jsim, jchi2 = jpg.optimize_sim3(JSim3.from_se3(JSE3.from_params7(jnp.asarray(est7))), jedges,
                                    jnp.asarray(fixed), n_iter=30)
    d = close(psim.params8(), jsim.params8(), tol=TOL_PG)
    dchi2 = abs(float(chi2) - float(jchi2)) / max(float(jchi2), 1e-12)
    s = np32(psim.s)
    print(f"ATE {ate0:.4f} -> SE(3) {ate_se3:.4f}, Sim(3) {ate_sim3:.5f}; scale at the far end "
          f"{s[-1]:.4f} (lambda {lam:.4f}); against JAX: params8 {d:.2e}, chi2 {float(chi2):.3e} / "
          f"{float(jchi2):.3e}")
    assert dchi2 < TOL_CHI2 or abs(float(chi2) - float(jchi2)) < 1e-9
    assert ate_se3 > 0.5 * ate0, (ate_se3, ate0)
    assert ate_sim3 < 0.15 * ate0, (ate_sim3, ate0)
    assert ate_sim3 < 0.15 * ate_se3
    assert abs(s[-1] - lam) / lam < 0.05, (s[-1], lam)


def global_inputs():
    K, drift, A = 24, 1.02, 16
    gt_centers, gt7, est7 = drifted_loop(K, drift)
    return dict(arc_pose7=est7[:A], arc_frame_id=np.arange(A, dtype=np.int32),
                act_pose7=est7[A:], act_frame_id=np.arange(A, K, dtype=np.int32),
                act_cov=np.zeros((K - A, K - A), np.int32), loop_arc_idx=0,
                new_act_idx=K - A - 1,
                T_loop7=np_se3.relative7(gt7[K - 1], gt7[0]).astype(np.float32)), \
        gt_centers, est7, drift ** (K - 1)


def test_close_loop_global_sim3():
    """The archive + active global closure: corrected SE(3) poses and
    per-node scales out, ATE repaired; equal to the JAX closure within
    TOL_PG."""
    args, gt_centers, est7, lam = global_inputs()
    stats = {}
    arc_new, act_new, arc_s, act_s, chi2 = trl.close_loop_global_sim3(
        **args, loop_scale=lam, n_iter=30, device="cpu", stats=stats)
    j = jrl.close_loop_global_sim3(**args, loop_scale=lam, n_iter=30)
    for a, b in zip((arc_new, act_new, arc_s, act_s), j[:4]):
        close(a, b, tol=TOL_PG)
    assert abs(chi2 - j[4]) / max(j[4], 1e-12) < TOL_CHI2 or abs(chi2 - j[4]) < 1e-9
    out7 = np.concatenate([arc_new, act_new])
    ate0, ate1 = ate(est7, gt_centers), ate(out7, gt_centers)
    print(f"ATE {ate0:.4f} -> {ate1:.5f}, padded to P={stats['P']}, EP={stats['EP']}")
    assert stats == {"P": 32, "EP": 32}
    assert ate1 < 0.15 * ate0, (ate1, ate0)
    s = np.concatenate([arc_s, act_s])
    assert abs(s[-1] - lam) / lam < 0.05


def test_close_loop_global_se3_as_jax():
    """The SE(3) global closure (`sim3_loops` off) on the same graph, with
    covisibility edges among the active keyframes: equal to the JAX one."""
    args, _, _, _ = global_inputs()
    cov = np.zeros_like(args["act_cov"])
    cov[0, 1] = cov[1, 0] = 40
    cov[2, 5] = cov[5, 2] = 12
    cov[3, 4] = cov[4, 3] = 9          # below the edge threshold
    args["act_cov"] = cov
    arc_new, act_new, chi2 = trl.close_loop_global(**args, n_iter=25, device="cpu")
    j = jrl.close_loop_global(**args, n_iter=25)
    close(arc_new, j[0], tol=TOL_PG)
    close(act_new, j[1], tol=TOL_PG)
    assert abs(chi2 - j[2]) / max(j[2], 1e-12) < TOL_CHI2 or abs(chi2 - j[2]) < 1e-9


def test_landmark_reanchor_consistency():
    """correct_landmarks_sim3: p' = S_new^-1(T_old(p)), so the new
    similarity camera sees the point at the old camera coordinates and the
    extracted SE(3) camera along the same ray at depth / s; equal to the
    JAX function."""
    rng = np.random.default_rng(4)
    K, L = 4, 30
    old7 = np.stack([np.concatenate([[1, 0, 0, 0], rng.normal(0, 0.5, 3)]).astype(np.float32)
                     for _ in range(K)])
    pts = rng.normal(0, 1, (L, 3)).astype(np.float32) + np.float32([0, 0, 4])
    anchor = rng.integers(0, K, L).astype(np.int32)
    xi = rng.normal(0, 0.1, (K, 7)).astype(np.float32)
    S_new = sim3.exp(t(xi)).compose(Sim3.from_se3(SE3.from_params7(t(old7))))
    p_new = tpg.correct_landmarks_sim3(t(pts), torch.tensor(anchor), t(old7), S_new.params8())
    jS_new = jax.vmap(lambda c, s: c.compose(s))(
        jsim3.exp(jnp.asarray(xi)), JSim3.from_se3(JSE3.from_params7(jnp.asarray(old7))))
    close(p_new, jpg.correct_landmarks_sim3(jnp.asarray(pts), jnp.asarray(anchor),
                                            jnp.asarray(old7), jS_new.params8()), tol=1e-5)
    a = torch.tensor(anchor).long()
    pc_old = SE3.from_params7(t(old7)[a]).apply(t(pts))
    S_a = Sim3(S_new.R[a], S_new.t[a], S_new.s[a])
    assert torch.allclose(S_a.apply(p_new), pc_old, atol=1e-4)
    assert torch.allclose(S_a.to_se3().apply(p_new) * S_a.s[:, None], pc_old, atol=1e-4)


def test_sim3_edges_from_covisibility_as_jax():
    K = 5
    rng = np.random.default_rng(3)
    pose7 = np.stack([np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)])
                      for q in rng.normal(size=(K, 4))]).astype(np.float32)
    cov = np.zeros((K, K), np.int32)
    cov[0, 1] = cov[1, 0] = 50
    cov[2, 3] = cov[3, 2] = 10
    valid = np.ones(K, bool)
    e = tpg.sim3_edges_from_covisibility(t(pose7), torch.tensor(cov), torch.tensor(valid))
    je = jpg.sim3_edges_from_covisibility(jnp.asarray(pose7), jnp.asarray(cov),
                                          jnp.asarray(valid))
    assert np.array_equal(np32(e.mask), np.asarray(je.mask))
    assert np.array_equal(np32(e.i), np.asarray(je.i)) and np.array_equal(np32(e.j),
                                                                          np.asarray(je.j))
    m = np32(e.mask)
    close(np32(e.S_ji8)[m], np.asarray(je.S_ji8)[m])
    assert np.all(np32(e.S_ji8)[:, 7] == 1.0)
