"""Relocalization, the port against the JAX package, both on the CPU:
tests/test_relocalization.py's blackout-and-revisit run (PlaneScene seed 7,
240x320, 20 tracked frames, 4 noise frames, then the view of frame 10
again) through both packages' `VisualOdometry` with the vocabulary on, in
the port's configuration (no archive, loop closing, async mapping or depth
filter), and one `relocalize` call on the JAX package's map carried across
(`convert`).

Both packages get the port's rendered frames; the port's init RANSAC and
its P3P triples are the JAX package's draws (`jax.random.key(frame_id)`
for the init, `fold_in(PRNGKey(17), kf)` per candidate), so both score the
same hypotheses.  After initialisation the two track with different
algorithms (the JAX package's CPU route runs its jnp per-level
`gauss_newton`, the port the plain versions of its kernels), so the run is
held at outcome level: statuses frame by frame, the relocalization on the
same frame, recovered poses within 1e-2 map units.  The one `relocalize`
call on identical inputs is held stage by stage: BoW scores within 1e-6,
candidates, matches and inlier counts equal, the pose within 1e-4 of the
JAX package's with its pose-BA kernel (K5, interpreted; the port's K8
runs K5's body per candidate)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.map import vocabulary as jvoc
from ygz_slam_tpu.models import relocalization as jrl
from ygz_slam_tpu.ops import hamming as jhm

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.ops import hamming as thm
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import (jax_camera, jax_kernels_interpreted, jax_mono_run, jax_pnp_draws,
                         jax_ransac_indices, jax_vo_options, np32)

torch.set_num_threads(1)

SHAPE = (240, 320)
CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
N_TRACK, N_NOISE, N_REVISIT = 20, 4, 6     # tests/test_relocalization.py's phases
REVISIT = 10                               # the frame whose view comes back
TOL_TRAJ = 1e-2          # recovered camera poses, port against JAX, map units
TOL_REVISIT = 5e-2       # recovered pose against the pose tracked at the revisited frame
TOL_SCORE = 1e-6         # BoW scores (float32 sums over 10^4 words)
TOL_POSE = 1e-4          # relocalize's pose on identical inputs (test_torch_pose_ba.py)
OPTS = mw.mono_options(use_vocabulary=True, loop_closing=False, init_min_disparity=15.0,
                       kf_min_frames=4, kf_max_trans=0.03, kf_max_rot=0.04,
                       lost_reset_frames=50)


def trajectory(n):
    """tests/test_relocalization.py's `trajectory`: T_cw of frame k."""
    out = []
    for k in range(n):
        t = k / max(n - 1, 1)
        out.append(tse3.exp(torch.tensor(
            [1.0 * t, 0.15 * np.sin(2 * t), 0.25 * t, 0.02 * np.sin(3 * t), -0.14 * t, 0.02 * t],
            dtype=torch.float32)))
    return out


def blackout_frames():
    """[30, 240, 320]: 20 frames along the trajectory, 4 of uniform noise,
    6 renders of frame REVISIT's pose."""
    scene = PlaneScene(CAM, plane_z=3.0, seed=7, device="cpu")
    poses = trajectory(26)
    rng = np.random.default_rng(0)
    noise = [torch.tensor(rng.uniform(0, 255, SHAPE), dtype=torch.float32)
             for _ in range(N_NOISE)]
    return torch.stack([scene.render(poses[k], SHAPE) for k in range(N_TRACK)] + noise
                       + [scene.render(poses[REVISIT], SHAPE)] * N_REVISIT)


def port_run(frames, monkeypatch):
    """The port's VisualOdometry over `frames`, handed the JAX draws."""
    monkeypatch.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
        jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
    monkeypatch.setattr(trl, "relocalize", functools.partial(trl.relocalize, draws=jax_pnp_draws))
    vo = tvo.VisualOdometry(CAM, OPTS, device="cpu")
    names = [vo.add_frame(frames[k], float(k)).status.name for k in range(len(frames))]
    return names, np.stack([p for _, p in vo.trajectory]), vo


@pytest.fixture(scope="module")
def runs():
    frames = blackout_frames()
    with pytest.MonkeyPatch.context() as mp:
        names, T7, vo = port_run(frames, mp)
    snap = {}

    def on_frame(k, jv):
        if k == N_TRACK - 1:
            snap.update({name: np.asarray(a).copy()
                         for name, a in jv.server.state._asdict().items()},
                        kf_bow=np.asarray(jv.kf_bow).copy(), kf_nodes=np.asarray(jv.kf_nodes))

    jnames, jT7, _, jv = jax_mono_run(CAM, frames, jax_vo_options(OPTS), on_frame=on_frame)
    return dict(frames=frames, names=names, T7=T7, vo=vo, jnames=jnames, jT7=jT7, jv=jv,
                jmap=snap)


def first_reloc(names):
    """The first GOOD frame after the blackout."""
    return next(k for k in range(N_TRACK + 1, len(names)) if names[k] == "GOOD")


def test_blackout_statuses_and_relocalization_frame_equal(runs):
    names, jnames = runs["names"], runs["jnames"]
    print(f"port {names}\nJAX  {jnames}\nport stats {dict(runs['vo'].stats)}")
    assert names == jnames
    assert all(n == "LOST" for n in names[N_TRACK + 1:N_TRACK + N_NOISE])
    k = first_reloc(names)
    # The lost_reloc_after-th failed retry is the first frame that tries it.
    assert k == N_TRACK + 1 + OPTS.lost_reloc_after
    assert runs["vo"].stats["relocalizations"] == 1
    assert runs["vo"].stats["reloc_attempts"] == 1


def test_recovered_poses_agree_and_land_on_the_revisited_pose(runs):
    T7, jT7 = runs["T7"], runs["jT7"]
    k = first_reloc(runs["names"])
    d_pkg = max(float(tse3.distance(SE3.from_params7(torch.tensor(T7[j])),
                                    SE3.from_params7(torch.tensor(jT7[j]))))
                for j in range(k, len(T7)))
    d_rev = float(tse3.distance(SE3.from_params7(torch.tensor(T7[k])),
                                SE3.from_params7(torch.tensor(T7[REVISIT]))))
    print(f"relocalized at frame {k}: port against JAX {d_pkg:.3e} (tol {TOL_TRAJ}); "
          f"against the pose tracked at frame {REVISIT} {d_rev:.3e} (tol {TOL_REVISIT})")
    assert d_pkg < TOL_TRAJ
    assert d_rev < TOL_REVISIT


@pytest.fixture(scope="module")
def carried(runs):
    """The JAX map after frame N_TRACK - 1, carried across, and the port's
    features of the first revisit frame."""
    jm = runs["jmap"]
    m = convert.map_state_from_numpy(jm, device="cpu")
    vocab = convert.vocabulary_from_numpy(jvoc.state_dict(runs["jv"].vocab), device="cpu")
    pyr = tfe.preprocess(runs["frames"][N_TRACK + N_NOISE], OPTS.n_levels)
    q = tfe.detect_multilevel(pyr, OPTS.detect_threshold, OPTS.grid_cell, OPTS.feat_budgets)
    return dict(m=m, vocab=vocab, q=q, kf_bow=torch.tensor(jm["kf_bow"]),
                kf_nodes=torch.tensor(jm["kf_nodes"]))


def _port_relocalize(c, stages=None, **kw):
    m, q = c["m"], c["q"]
    return trl.relocalize(
        c["vocab"], CAM, q.desc, q.px, q.valid, c["kf_bow"], m.kf_valid, m.kf_pose7,
        m.feat_desc.reshape(-1, 8), c["kf_nodes"].reshape(-1), m.feat_point.reshape(-1),
        m.feat_valid.reshape(-1), m.pt_pos, m.pt_valid, min_inliers=OPTS.reloc_min_inliers,
        feat_angle_flat=m.feat_angle.reshape(-1), q_angle=q.angle, top_c=OPTS.reloc_top_c,
        use_pnp=True, stages=stages, **kw)


def test_relocalize_on_the_jax_map_matches_jax(runs, carried):
    jm, q = runs["jmap"], carried["q"]
    jvocab = runs["jv"].vocab
    qd = jnp.asarray(np32(q.desc).view(np.uint32))
    qv, qpx, qang = jnp.asarray(np32(q.valid)), jnp.asarray(np32(q.px)), jnp.asarray(
        np32(q.angle))
    K, F = jm["feat_valid"].shape
    args = (jvocab, jax_camera(CAM), qd, qpx, qv, jnp.asarray(jm["kf_bow"]),
            jnp.asarray(jm["kf_valid"]), jnp.asarray(jm["kf_pose7"]),
            jnp.asarray(jm["feat_desc"].reshape(-1, 8)), jnp.asarray(jm["kf_nodes"].reshape(-1)),
            jnp.asarray(jm["feat_point"].reshape(-1)), jnp.asarray(jm["feat_valid"].reshape(-1)),
            jnp.asarray(jm["pt_pos"]), jnp.asarray(jm["pt_valid"]))
    with jax_kernels_interpreted():
        jr = jax.jit(functools.partial(
            jrl.relocalize, jvocab, jax_camera(CAM), min_inliers=OPTS.reloc_min_inliers,
            top_c=OPTS.reloc_top_c, use_pnp=True))(
                *args[2:], feat_angle_flat=jnp.asarray(jm["feat_angle"].reshape(-1)),
                q_angle=qang)
    # The JAX package's stages, by its own functions (relocalization.py:76-105).
    words, _ = jvoc.transform(jvocab, qd, qv)
    jscores = np.where(jm["kf_valid"], np.asarray(jvoc.score_l1(
        jvoc.bow_vector(jvocab, words, qv)[None, :], jnp.asarray(jm["kf_bow"]))), -1.0)
    jcand = np.asarray(jax.lax.top_k(jnp.asarray(jscores), min(OPTS.reloc_top_c, K))[1])
    jmatch = []
    for kf in jcand:
        rows = kf * F + np.arange(F)
        cp = jm["feat_point"].reshape(-1)[rows]
        cv = jm["feat_valid"].reshape(-1)[rows] & (cp >= 0) & jm["pt_valid"][np.clip(cp, 0, None)]
        idx, ok = jhm.match_nn(qd, jnp.asarray(jm["feat_desc"].reshape(-1, 8)[rows]), qv,
                               jnp.asarray(cv), max_dist=64, ratio=1.0, cross_check=True)
        ok = jhm.rotation_consistency(qang, jnp.asarray(jm["feat_angle"].reshape(-1)[rows])[
            jnp.clip(idx, 0, F - 1)], ok)
        jmatch.append(np.where(np.asarray(ok), np.asarray(idx), -1))

    stages = {}
    r = _port_relocalize(carried, stages, draws=jax_pnp_draws)
    a = stages["attempt"]
    d_score = float(np.abs(np32(a.scores) - jscores).max())
    d_pose = float(tse3.distance(r.T_cw, SE3(torch.tensor(np32(jr.T_cw.R)),
                                             torch.tensor(np32(jr.T_cw.t)))))
    print(f"BoW scores within {d_score:.2e} (tol {TOL_SCORE}); candidates {np32(a.cand)}; "
          f"inliers port {int(r.n_inliers)} JAX {int(jr.n_inliers)} at slot {int(r.kf_slot)} / "
          f"{int(jr.kf_slot)}; per candidate {np32(a.n_inl)}; pose distance {d_pose:.2e} "
          f"(tol {TOL_POSE})")
    assert d_score < TOL_SCORE
    assert np.array_equal(np32(a.cand), jcand)
    assert np.array_equal(np32(a.match_idx), np.stack(jmatch))
    assert bool(r.success) and bool(jr.success)
    assert int(r.n_inliers) == int(jr.n_inliers) and int(r.kf_slot) == int(jr.kf_slot)
    assert d_pose < TOL_POSE


def test_one_matrix_for_all_candidates_equals_separate_matchings(carried):
    """candidate_matches' one [Nq, C*F] matrix, each matcher on its column
    block, against C separate `match_nn` calls on each candidate's rows."""
    m, q = carried["m"], carried["q"]
    K, F = m.feat_valid.shape
    cand = torch.arange(K)
    rows = cand[:, None] * F + torch.arange(F)[None, :]
    c_desc = m.feat_desc.reshape(-1, 8)[rows]
    c_valid = m.feat_valid.reshape(-1)[rows]
    c_angle = m.feat_angle.reshape(-1)[rows]
    idx, ok = trl.candidate_matches(q.desc, q.valid, c_desc, c_valid, q.angle, c_angle)
    for c in range(K):
        i, k = thm.match_nn(q.desc, c_desc[c].contiguous(), q.valid, c_valid[c], max_dist=64,
                            ratio=1.0, cross_check=True)
        k = thm.rotation_consistency(q.angle, c_angle[c][torch.clamp(i, 0, F - 1).long()], k)
        assert torch.equal(idx[c], i) and torch.equal(ok[c], k)
    assert int(ok.sum()) > 0


def test_loop_closing_with_the_vocabulary_raises():
    """Loop closing with the vocabulary once raised together with the
    archive (the archive loops were not ported); it now constructs with the
    archive as without it."""
    vo = tvo.VisualOdometry(CAM, mw.mono_options(use_vocabulary=True, archive_map=True),
                            device="cpu")
    assert vo.o.loop_closing and vo.archive is not None and vo.vocab is not None
    vo = tvo.VisualOdometry(CAM, mw.mono_options(use_vocabulary=True), device="cpu")
    assert vo.o.loop_closing and vo.archive is None
    assert vo.vocab.n_words == 10 ** 4 and tuple(vo.kf_bow.shape) == (OPTS.map_K, 10 ** 4)
    vo = tvo.VisualOdometry(CAM, mw.mono_options(use_vocabulary=True, loop_closing=False,
                                                 archive_map=True), device="cpu")
    assert vo.archive is not None and vo.archive.W == 10 ** 4
    # Without the vocabulary, loop closing has nothing to run on: no error.
    assert tvo.VisualOdometry(CAM, mw.mono_options(archive_map=True), device="cpu").vocab is None
