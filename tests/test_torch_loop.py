"""Loop closing within the active window, the port against the JAX package,
both on the CPU: the SE(3) pose graph (`solvers/pose_graph.py`) on
tests/test_vocab_posegraph.py's drifted ring, `close_loop` on
tests/test_relocalization.py's planted 6-keyframe loop, `detect_loop` and
one mapping pass with the loop block on a JAX map carried across (with a
planted loop: one keyframe's landmarks duplicated into rows of their own,
so it shares no landmark with the newest keyframe but sees the same
place), and a VisualOdometry run with `loop_closing` on (test_relocalization's
PlaneScene seed 7, its 20 tracked frames, the vocabulary on, no archive).

Tolerances: pose-graph poses within 1e-4 (float32 Gauss-Newton, 20-30
dense solves, the two packages' LAPACK), chi2 within 1e-4 relative;
covisibility edges equal (measured poses within 1e-5); detect_loop's
candidate, found flag and inlier count equal and its relative pose within
1e-4 (K5 interpreted on the JAX side); the mapping pass's keyframe poses
within 5e-3 (its local BA after the loop block: the packages' BA sums in
other orders and the port inverts landmark blocks in float64; the test
prints the same pass without the loop block beside it, and ROADMAP section
3 the card against the CPU after one pass, 2.7e-3) and its loop flag equal; the VO run's statuses, keyframes and
closed loops equal and its poses within 1e-2 map units, as
test_torch_mono_vo.py's."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import se3 as jse3
from ygz_slam_tpu.geometry import so3 as jso3
from ygz_slam_tpu.geometry.se3 import SE3 as JSE3
from ygz_slam_tpu.map import vocabulary as jvoc
from ygz_slam_tpu.models import relocalization as jrl
from ygz_slam_tpu.solvers import pose_graph as jpg

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import pose_graph as tpg

from _torch_port import jax_camera, jax_kernels_interpreted, jax_mono_run, jax_vo_options, np32
from test_torch_relocalization import CAM, OPTS, blackout_frames

torch.set_num_threads(1)

TOL_PG = 1e-4            # pose-graph poses, port against JAX
TOL_CHI2 = 1e-4          # relative
TOL_EDGE = 1e-5          # covisibility edges' measured poses (two float32 compositions)
TOL_LOOP = 1e-4          # detect_loop's relative pose
TOL_PASS = 5e-3          # keyframe poses after a mapping pass (local BA's parity)
TOL_TRAJ = 1e-2          # the VO run's poses, map units
N_RUN = 20
LOOP_OPTS = dataclasses.replace(OPTS, loop_closing=True)


def t_se3(p7) -> SE3:
    return SE3.from_params7(torch.tensor(np32(p7)))


def max_dist(p7_a, p7_b) -> float:
    return float(tse3.distance(t_se3(p7_a), t_se3(p7_b)).max())


def ring(K=8, drift=0.05, seed=0):
    """test_vocab_posegraph.py's ring: ground truth, the drifted estimate
    and odometry plus one loop edge, as JAX params7 and JAX edges."""
    rng = np.random.default_rng(seed)
    gt = [JSE3(jso3.exp(jnp.asarray([0, 0, 2 * np.pi * k / K], jnp.float32)),
               jnp.asarray([np.cos(2 * np.pi * k / K), np.sin(2 * np.pi * k / K), 0.0],
                           jnp.float32)) for k in range(K)]
    est = [gt[0]]
    for k in range(1, K):
        d = gt[k].compose(gt[k - 1].inverse())
        noise = jse3.exp(jnp.asarray(rng.normal(0, drift, 6), jnp.float32))
        est.append(noise.compose(d).compose(est[-1]))
    ii = list(range(K - 1)) + [K - 1]
    jj = list(range(1, K)) + [0]
    T_ji = jnp.stack([gt[b].compose(gt[a].inverse()).params7() for a, b in zip(ii, jj)])
    edges = jpg.PoseGraphEdges(i=jnp.asarray(ii, jnp.int32), j=jnp.asarray(jj, jnp.int32),
                               T_ji7=T_ji, weight=jnp.ones(K, jnp.float32), mask=jnp.ones(K, bool))
    return (jnp.stack([g.params7() for g in gt]), jnp.stack([e.params7() for e in est]), edges)


def t_edges(e) -> tpg.PoseGraphEdges:
    return tpg.PoseGraphEdges(*(convert._like(np32(x), "cpu") for x in e))


@pytest.mark.parametrize("n_iter", [10, 30])
def test_pose_graph_corrects_drift_as_jax(n_iter):
    gt7, est7, edges = ring()
    fixed = np.zeros(8, bool)
    fixed[0] = True
    jopt, jchi2 = jpg.optimize(JSE3.from_params7(est7), edges, jnp.asarray(fixed), n_iter=n_iter)
    topt, tchi2 = tpg.optimize(t_se3(est7), t_edges(edges), torch.tensor(fixed), n_iter=n_iter)
    d = max_dist(topt.params7(), jopt.params7())
    dchi2 = abs(float(tchi2) - float(jchi2)) / max(float(jchi2), 1e-12)
    err_before = float(tse3.distance(t_se3(est7), t_se3(gt7)).mean())
    err_after = float(tse3.distance(topt, t_se3(gt7)).mean())
    print(f"{n_iter} iterations: poses within {d:.2e} of JAX (tol {TOL_PG}); chi2 {float(tchi2):.3e} "
          f"/ {float(jchi2):.3e}; error {err_before:.4f} -> {err_after:.4f}; the fixed pose moved "
          f"{float(tse3.distance(SE3(topt.R[0], topt.t[0]), t_se3(est7[0]))):.1e}")
    assert d < TOL_PG and (dchi2 < TOL_CHI2 or abs(float(tchi2) - float(jchi2)) < 1e-9)
    assert float(tse3.distance(SE3(topt.R[0], topt.t[0]), t_se3(est7[0]))) < 1e-5
    if n_iter == 30:                        # test_vocab_posegraph's test_corrects_drift
        assert err_after < 0.2 * err_before and float(tchi2) < 1e-4


def test_edges_from_covisibility_as_jax():
    K = 5
    rng = np.random.default_rng(3)
    pose7 = np.stack([np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)])
                      for q in rng.normal(size=(K, 4))]).astype(np.float32)
    cov = np.zeros((K, K), np.int32)
    cov[0, 1] = cov[1, 0] = 50
    cov[1, 2] = cov[2, 1] = 5
    cov[2, 3] = cov[3, 2] = 10
    valid = np.ones(K, bool)
    valid[4] = False
    je = jpg.edges_from_covisibility(jnp.asarray(pose7), jnp.asarray(cov), jnp.asarray(valid),
                                     min_weight=10)
    te = tpg.edges_from_covisibility(torch.tensor(pose7), torch.tensor(cov), torch.tensor(valid),
                                     min_weight=10)
    for name in ("i", "j", "mask"):
        assert np.array_equal(np32(getattr(te, name)), np.asarray(getattr(je, name))), name
    assert np.allclose(np32(te.weight), np.asarray(je.weight), rtol=0, atol=1e-6)
    d = max_dist(te.T_ji7, je.T_ji7)
    m = np32(te.mask).reshape(K, K)
    print(f"edges {np.argwhere(m).tolist()}, measured poses within {d:.1e} (tol {TOL_EDGE})")
    assert m[0, 1] and m[2, 3] and not m[1, 2] and not m[1, 0] and d < TOL_EDGE


def planted_loop():
    """test_relocalization.py's test_close_loop_corrects_poses inputs."""
    K = 6
    rng = np.random.default_rng(1)
    gt = [jse3.exp(jnp.asarray([0.2 * k, 0, 0, 0, 0.05 * k, 0], jnp.float32)) for k in range(K)]
    est = [jse3.exp(jnp.asarray(rng.normal(0, 0.02 * min(k, 1) * k, 6), jnp.float32)).compose(
        gt[k]) for k in range(K)]
    cov = np.zeros((K, K), np.int32)
    for k in range(K - 1):
        cov[k, k + 1] = cov[k + 1, k] = 30
    T_loop = gt[5].compose(gt[0].inverse())
    return dict(K=K, gt7=np.stack([np.asarray(g.params7()) for g in gt]),
                est7=np.stack([np.asarray(e.params7()) for e in est]), cov=cov,
                T_loop7=np.asarray(T_loop.params7()),
                pt_pos=rng.uniform(-1, 1, (20, 3)).astype(np.float32),
                pt_first=rng.integers(0, K, 20).astype(np.int32))


def test_close_loop_on_the_planted_loop_as_jax():
    p = planted_loop()
    K = p["K"]
    jloop = jrl.LoopResult(found=jnp.asarray(True), loop_kf=jnp.asarray(0),
                           T_loop7=jnp.asarray(p["T_loop7"]), scale=jnp.asarray(1.0))
    jpose, jpts, jchi2 = jrl.close_loop(
        jnp.asarray(p["est7"]), jnp.ones(K, bool), jnp.asarray(p["cov"]), jnp.asarray(p["pt_pos"]),
        jnp.ones(20, bool), jnp.asarray(p["pt_first"]), jnp.asarray(5), jloop)
    tloop = trl.LoopResult(found=torch.tensor(True), loop_kf=torch.tensor(0),
                           T_loop7=torch.tensor(p["T_loop7"]), scale=torch.tensor(1.0))
    tpose, tpts, tchi2 = trl.close_loop(
        torch.tensor(p["est7"]), torch.ones(K, dtype=torch.bool), torch.tensor(p["cov"]),
        torch.tensor(p["pt_pos"]), torch.ones(20, dtype=torch.bool), torch.tensor(p["pt_first"]),
        5, tloop)
    d = max_dist(tpose, jpose)
    d_pts = float(np.abs(np32(tpts) - np.asarray(jpts)).max())
    opt = t_se3(tpose)
    T0, T5 = SE3(opt.R[0], opt.t[0]), SE3(opt.R[5], opt.t[5])
    resid = float(torch.linalg.norm(tse3.log(t_se3(p["T_loop7"]).compose(T0).compose(
        T5.inverse()))))
    err_before = float(tse3.distance(t_se3(p["est7"]), t_se3(p["gt7"])).mean())
    err_after = float(tse3.distance(opt, t_se3(p["gt7"])).mean())
    print(f"poses within {d:.2e} of JAX (tol {TOL_PG}), points within {d_pts:.2e}; loop "
          f"residual {resid:.4f} (< 0.05); error {err_before:.4f} -> {err_after:.4f}")
    assert d < TOL_PG and d_pts < TOL_PG
    assert resid < 0.05 and err_after < 1.5 * err_before
    # found = False leaves the map as it was.
    pose_n, pts_n, _ = trl.close_loop(
        torch.tensor(p["est7"]), torch.ones(K, dtype=torch.bool), torch.tensor(p["cov"]),
        torch.tensor(p["pt_pos"]), torch.ones(20, dtype=torch.bool), torch.tensor(p["pt_first"]),
        5, tloop._replace(found=torch.tensor(False)))
    assert torch.equal(pose_n, torch.tensor(p["est7"])) and torch.equal(pts_n,
                                                                         torch.tensor(p["pt_pos"]))


# -- the VO run and the map it leaves ------------------------------------------------
@pytest.fixture(scope="module")
def runs():
    frames = blackout_frames()[:N_RUN]
    vo = tvo.VisualOdometry(CAM, LOOP_OPTS, device="cpu")
    names = [vo.add_frame(frames[k], float(k)).status.name for k in range(N_RUN)]
    T7 = np.stack([p for _, p in vo.trajectory])
    jnames, jT7, jkf, jv = jax_mono_run(CAM, frames, jax_vo_options(LOOP_OPTS))
    return dict(names=names, T7=T7, vo=vo, jnames=jnames, jT7=jT7, jv=jv)


def test_vo_run_with_loop_closing_as_jax(runs):
    vo, jv = runs["vo"], runs["jv"]
    d = max(max_dist(a[None], b[None]) for a, b in zip(runs["T7"], runs["jT7"]))
    print(f"statuses {runs['names']}; keyframes {vo.stats['keyframes']} / {jv.stats['keyframes']}, "
          f"loops closed {vo.stats['loops_closed_active']} / {jv.stats['loops_closed_active']}; "
          f"poses within {d:.2e} (tol {TOL_TRAJ})")
    assert runs["names"] == runs["jnames"]
    assert vo.stats["keyframes"] == jv.stats["keyframes"] and len(vo.server.kf_used) >= 4
    assert vo.stats["loops_closed_active"] == jv.stats["loops_closed_active"]
    assert d < TOL_TRAJ


def test_loop_closing_changes_nothing_without_a_loop(runs):
    """loop_closing off: the same run bit for bit when no loop is found."""
    frames = blackout_frames()[:N_RUN]
    vo = tvo.VisualOdometry(CAM, OPTS, device="cpu")
    for k in range(N_RUN):
        vo.add_frame(frames[k], float(k))
    assert runs["vo"].stats["loops_closed_active"] == 0
    assert np.array_equal(np.stack([p for _, p in vo.trajectory]), runs["T7"])
    assert all(torch.equal(a, b) for a, b in zip(vo.server.state, runs["vo"].server.state))


def planted_map(jv):
    """The JAX map at the end of the run with a loop planted: the landmarks
    of the window keyframe whose BoW row scores best against the newest
    keyframe's copied into free rows and that keyframe's features linked to
    the copies, so it shares no landmark with the newest keyframe but sees
    the same place.  Returns (numpy MapState fields, kf_bow, kf_nodes, newest
    slot, planted slot)."""
    m = {k: np.asarray(v).copy() for k, v in jv.server.state._asdict().items()}
    new = jv.server.kf_used[-1]
    kf_bow = np.asarray(jv.kf_bow)
    scores = np.asarray(jvoc.score_l1(jnp.asarray(kf_bow[new])[None], jnp.asarray(kf_bow)))
    slot = max((s for s in jv.server.kf_used if s != new), key=lambda s: scores[s])
    fp = m["feat_point"][slot]
    linked = np.where(fp >= 0)[0]
    free = np.where(~m["pt_valid"])[0][:len(linked)]
    for f, r in zip(linked, free):
        src = fp[f]
        for name in ("pt_pos", "pt_desc", "pt_valid", "pt_obs", "pt_visible", "pt_found",
                     "pt_first_kf", "pt_ref_feat"):
            m[name][r] = m[name][src]
        m["pt_ref_feat"][r] = slot * m["feat_point"].shape[1] + f
        m["feat_point"][slot, f] = r
    return m, np.asarray(jv.kf_bow), np.asarray(jv.kf_nodes), new, slot


def test_detect_loop_on_the_jax_map_as_jax(runs):
    jv = runs["jv"]
    m, kf_bow, kf_nodes, new, planted = planted_map(jv)
    jm = jv.server.state._replace(**{k: jnp.asarray(v) for k, v in m.items()})
    from ygz_slam_tpu.map import state as jms

    jm = jms.update_covisibility(jm)
    tm = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()},
                                      device="cpu")
    assert int(tm.cov_weight[new, planted]) == 0
    vocab = convert.vocabulary_from_numpy(jvoc.state_dict(jv.vocab), device="cpu")
    with jax_kernels_interpreted():
        jl = jax.jit(lambda *a: jrl.detect_loop(jv.vocab, jax_camera(CAM), new, *a,
                                                feat_angle_flat=jm.feat_angle.reshape(-1)))(
            jnp.asarray(kf_bow), jm.kf_valid, jm.kf_pose7, jm.cov_weight,
            jm.feat_desc.reshape(-1, 8), jnp.asarray(kf_nodes).reshape(-1),
            jm.feat_px.reshape(-1, 2), jm.feat_point.reshape(-1), jm.feat_valid.reshape(-1),
            jm.pt_pos, jm.pt_valid)
    tl = trl.detect_loop(vocab, CAM, new, torch.tensor(kf_bow), tm.kf_valid, tm.kf_pose7,
                         tm.cov_weight, tm.feat_desc.reshape(-1, 8),
                         torch.tensor(kf_nodes).reshape(-1), tm.feat_px.reshape(-1, 2),
                         tm.feat_point.reshape(-1), tm.feat_valid.reshape(-1), tm.pt_pos,
                         tm.pt_valid, feat_angle_flat=tm.feat_angle.reshape(-1))
    d = max_dist(tl.T_loop7[None], np.asarray(jl.T_loop7)[None])
    print(f"new slot {new}, planted slot {planted}: port found {bool(tl.found)} candidate "
          f"{int(tl.loop_kf)} inliers {int(tl.n_inl)}; JAX {bool(jl.found)} {int(jl.loop_kf)} "
          f"{int(jl.n_inl)}; relative pose within {d:.2e} (tol {TOL_LOOP})")
    assert bool(tl.found) and bool(jl.found) and int(tl.loop_kf) == planted
    assert int(tl.loop_kf) == int(jl.loop_kf) and int(tl.n_inl) == int(jl.n_inl)
    assert d < TOL_LOOP


def test_mapping_pass_with_the_loop_block_as_jax(runs):
    jv, vo = runs["jv"], runs["vo"]
    m, kf_bow, kf_nodes, new, planted = planted_map(jv)
    K = m["kf_valid"].shape[0]
    fixed = np.zeros(K, bool)
    fixed[jv.server.kf_used[:2]] = True
    jm = jv.server.state._replace(**{k: jnp.asarray(v) for k, v in m.items()})
    with jax_kernels_interpreted():
        jst, jfound, jscores, jpose7, _ = jv._jit_map_pass(
            jm, jnp.asarray(new), jnp.asarray(kf_bow), jnp.asarray(kf_nodes), jnp.asarray(fixed),
            True)
    tm = convert.map_state_from_numpy(m, device="cpu")
    tst, tscores, tfound = tvo.mapping_pass(CAM, vo.o, tm, torch.tensor(fixed),
                                            loop=(vo.vocab, new, torch.tensor(kf_bow),
                                                  torch.tensor(kf_nodes)))
    # The control: the same pass without the loop block in both packages.
    jst0, _, _, jpose0, _ = jv._jit_map_pass(jm, jnp.asarray(new), jnp.asarray(kf_bow),
                                              jnp.asarray(kf_nodes), jnp.asarray(fixed), False)
    tst0, _, tfound0 = tvo.mapping_pass(CAM, vo.o, tm, torch.tensor(fixed))
    used = jv.server.kf_used
    d = max_dist(np32(tst.kf_pose7)[used], np.asarray(jpose7)[used])
    d0 = max_dist(np32(tst0.kf_pose7)[used], np.asarray(jpose0)[used])
    moved = max_dist(np32(tst.kf_pose7)[used], np32(tst0.kf_pose7)[used])
    print(f"loop found: port {bool(tfound)} JAX {bool(jfound)}; keyframe poses within {d:.2e} "
          f"(tol {TOL_PASS}; without the loop block {d0:.2e}); the loop moved them by up to "
          f"{moved:.2e}")
    assert bool(tfound) and bool(jfound) and not bool(tfound0)
    assert d < TOL_PASS and d0 < TOL_PASS
