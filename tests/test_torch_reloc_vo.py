"""Relocalization in the port's VisualOdometry, on the CPU (no JAX):
tests/test_relocalization.py's kidnapped camera (`TestKidnappedPnP`: an
upside-down revisit that only the P3P-RANSAC seed recovers), the NOT_READY
resume against a surviving map, the vocabulary changing nothing on a run
with no LOST frame, chunked tracking equal to per-frame across a
relocalization, and the bootstrap vocabulary."""
import dataclasses

import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.map import vocabulary as tvoc
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from test_torch_relocalization import CAM, OPTS, SHAPE, blackout_frames, trajectory

torch.set_num_threads(1)

TOL_KIDNAP = 0.05        # tests/test_relocalization.py: P3P-seeded pose error, map units
TOL_RESUME = 5e-2        # resumed pose against the keyframe's, map units
KIDNAP_OPTS = mw.mono_options(use_vocabulary=True, loop_closing=False, init_min_disparity=15.0,
                              kf_min_frames=4, kf_max_trans=0.03)


@pytest.fixture(scope="module")
def kidnap_map():
    """TestKidnappedPnP's map: PlaneScene seed 8, 20 frames of the
    trajectory, test_relocalization's keyframe gates."""
    scene = PlaneScene(CAM, plane_z=3.0, seed=8, device="cpu")
    poses = trajectory(20)
    vo = tvo.VisualOdometry(CAM, KIDNAP_OPTS, device="cpu")
    for k in range(20):
        vo.add_frame(scene.render(poses[k], SHAPE), float(k))
    assert vo.status is tvo.Status.GOOD
    return scene, poses, vo


def _relocalize(vo, q, **kw):
    m = vo.server.state
    return trl.relocalize(
        vo.vocab, CAM, q.desc, q.px, q.valid, vo.kf_bow, m.kf_valid, m.kf_pose7,
        m.feat_desc.reshape(-1, 8), vo.kf_nodes.reshape(-1), m.feat_point.reshape(-1),
        m.feat_valid.reshape(-1), m.pt_pos, m.pt_valid, feat_angle_flat=m.feat_angle.reshape(-1),
        q_angle=q.angle, **kw)


def test_kidnapped_upside_down_revisit(kidnap_map):
    """A camera back upside down (roll 180 deg) with a lateral offset:
    >170 deg from every stored keyframe pose.  The P3P-RANSAC seed recovers
    the pose; seeded at the stored pose, the solve fails or lands in an
    aliased basin far away."""
    scene, poses, vo = kidnap_map
    m = vo.server.state
    slot = vo.server.kf_used[-1]
    fid = int(m.kf_id[slot])
    s_map = float(torch.linalg.norm(m.kf_pose7[slot, 4:7])) / max(
        float(torch.linalg.norm(poses[fid].t)), 1e-9)
    c = np.asarray([0.5, -0.1, 0.1], np.float32)
    fwd = np.asarray([0.15, 0.0, 3.0], np.float32) - c
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0, 1, 0], fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], 1).astype(np.float32)
    R_cw = np.asarray([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32) @ R_wc.T
    T_world = SE3(torch.tensor(R_cw), torch.tensor(-R_cw @ c))
    T_map = SE3(T_world.R, T_world.t * s_map)
    pyr = tfe.preprocess(scene.render(T_world, SHAPE), 3)
    q = tfe.detect_multilevel(pyr, KIDNAP_OPTS.detect_threshold, KIDNAP_OPTS.grid_cell,
                              KIDNAP_OPTS.feat_budgets)
    r_pnp = _relocalize(vo, q, min_inliers=15, use_pnp=True)
    err_pnp = float(tse3.distance(r_pnp.T_cw, T_map))
    r_pri = _relocalize(vo, q, min_inliers=15, use_pnp=False)
    err_pri = float(tse3.distance(r_pri.T_cw, T_map))
    print(f"P3P seed: success {bool(r_pnp.success)}, {int(r_pnp.n_inliers)} inliers, error "
          f"{err_pnp:.3e} (tol {TOL_KIDNAP}); stored-pose seed: success {bool(r_pri.success)}, "
          f"{int(r_pri.n_inliers)} inliers, error {err_pri:.3e}")
    assert bool(r_pnp.success), int(r_pnp.n_inliers)
    assert err_pnp < TOL_KIDNAP
    assert (not bool(r_pri.success)) or err_pri > 10 * err_pnp


def test_not_ready_resumes_on_a_surviving_map(kidnap_map):
    """A VisualOdometry in NOT_READY holding the map (as after a map load)
    relocalizes against it on its first frame instead of re-initializing,
    anchored at the newest keyframe, and tracks on."""
    scene, poses, vo = kidnap_map
    fresh = tvo.VisualOdometry(CAM, KIDNAP_OPTS, device="cpu")
    fresh.server.state = type(vo.server.state)(*(t.clone() for t in vo.server.state))
    fresh.server.kf_used = list(vo.server.kf_used)
    fresh.kf_images = vo.kf_images.clone()
    fresh.kf_bow, fresh.kf_nodes = vo.kf_bow.clone(), vo.kf_nodes.clone()
    m = vo.server.state
    slot = vo.server.kf_used[-1]
    fid = int(m.kf_id[slot])
    statuses = []
    for k in range(fid, min(fid + 4, len(poses))):
        r = fresh.add_frame(scene.render(poses[k], SHAPE), float(k))
        statuses.append(r.status)
        if k == fid:
            err = float(tse3.distance(r.T_cw, SE3.from_params7(m.kf_pose7[slot])))
    print(f"resumed on frame {fid} (keyframe slot {slot}): {statuses}, error {err:.3e} "
          f"(tol {TOL_RESUME}); stats {dict(fresh.stats)}")
    assert statuses == [tvo.Status.GOOD] * len(statuses)
    assert err < TOL_RESUME
    assert fresh.stats["relocalizations"] == 1 and fresh.last_kf_slot == slot
    assert fresh.stats.get("init_model_h", 0) + fresh.stats.get("init_model_f", 0) == 0
    # A reset keeps the vocabulary and clears the map's BoW rows; with no
    # map left, NOT_READY starts an init.
    fresh.reset()
    assert fresh.vocab is vo.vocab and not bool(fresh.kf_bow.any())
    assert bool((fresh.kf_nodes == -1).all())
    assert fresh.add_frame(scene.render(poses[0], SHAPE), 0.0).status is tvo.Status.INITING


def test_keyframe_bow_rows_are_the_stored_features(kidnap_map):
    _, _, vo = kidnap_map
    m = vo.server.state
    for slot in vo.server.kf_used:
        words, nodes = tvoc.transform(vo.vocab, m.feat_desc[slot], m.feat_valid[slot])
        assert torch.equal(vo.kf_nodes[slot], nodes)
        assert torch.equal(vo.kf_bow[slot], tvoc.bow_vector(vo.vocab, words, m.feat_valid[slot]))
        assert abs(float(vo.kf_bow[slot].sum()) - 1.0) < 1e-5


@pytest.fixture(scope="module")
def blackout():
    return blackout_frames()


def _run(frames, opts, chunk=None):
    vo = tvo.VisualOdometry(CAM, opts, device="cpu")
    if chunk is None:
        res = [vo.add_frame(frames[k], float(k)) for k in range(len(frames))]
    else:
        res = vo.add_frames(frames, [float(k) for k in range(len(frames))], chunk=chunk)
    return [r.status for r in res], vo


def _same_run(a, b):
    (sa, va), (sb, vb) = a, b
    return (sa == sb and np.array_equal(np.stack([p for _, p in va.trajectory]),
                                        np.stack([p for _, p in vb.trajectory]))
            and all(torch.equal(x, y) for x, y in zip(va.server.state, vb.server.state))
            and va.server.kf_used == vb.server.kf_used)


def test_vocabulary_changes_nothing_without_a_lost_frame(blackout):
    frames = blackout[:20]
    on = _run(frames, OPTS)
    off = _run(frames, dataclasses.replace(OPTS, use_vocabulary=False))
    assert tvo.Status.LOST not in on[0] and on[0][-1] is tvo.Status.GOOD
    assert _same_run(on, off)
    assert on[1].stats == off[1].stats
    assert bool(on[1].kf_bow[on[1].server.kf_used].any(dim=1).all())


def test_chunked_equals_per_frame_across_a_relocalization(blackout):
    per_frame = _run(blackout, OPTS)
    chunked = _run(blackout, OPTS, chunk=4)
    print(f"per frame {[s.name for s in per_frame[0]]}; chunk stats "
          f"{dict(chunked[1].chunk_stats)}")
    assert per_frame[1].stats["relocalizations"] == 1
    assert _same_run(per_frame, chunked)
    assert per_frame[1].stats == chunked[1].stats
    assert torch.equal(per_frame[1].kf_bow, chunked[1].kf_bow)
    assert chunked[1].chunk_stats["chunks"] > 1


def test_bootstrap_vocabulary():
    """vocab_asset=False trains the JAX package's 512-word bootstrap (k=8,
    depth 3) on four PlaneScene renders, once per process and device."""
    opts = mw.mono_options(use_vocabulary=True, loop_closing=False, vocab_asset=False)
    v1 = tvo.VisualOdometry(CAM, opts, device="cpu").vocab
    v2 = tvo.VisualOdometry(CAM, opts, device="cpu").vocab
    assert v1 is v2 and (v1.k, v1.depth, v1.n_words) == (8, 3, 512)
    assert [tuple(n.shape) for n in v1.nodes] == [(8, 8), (64, 8), (512, 8)]
    assert bool((v1.weights >= 0).all()) and float(v1.weights.max()) > 0


def test_blackout_revisit_workload():
    """models/reloc_workload.py (chip_smoke.py's path 9a and 9b) at 240x320:
    the revisit frame relocalizes onto the window's oldest keyframe, the
    frames after it track, and the kidnapped view is recovered by the P3P
    seed only."""
    from ygz_slam_tpu_torch.models import reloc_workload as rw
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, T_gt7 = mw.make_mono_workload(40, device="cpu", shape=SHAPE, du=1 / 39)
    s = System(camera=cam, options=rw.reloc_options(), device="cpu")
    out = rw.blackout_revisit(s, frames, n_pre=30, n_after=8)
    print({k: v for k, v in out.items() if k not in ("T7", "statuses", "fed")})
    assert out["ok"] and out["reloc_frame"] == 30 + rw.N_NOISE
    assert s.vo.stats["relocalizations"] == 1
    T_world, T_map = rw.kidnapped_pose(s.vo, T_gt7, out["fed"])
    q = s.vo._detect(tfe.preprocess(rw.kidnapped_frame(cam, T_world, SHAPE), 3))
    gen = torch.Generator().manual_seed(1)
    r = _relocalize(s.vo, q, min_inliers=15, top_c=10, use_pnp=True, generator=gen)
    r_pri = _relocalize(s.vo, q, min_inliers=15, top_c=10, use_pnp=False)
    err, err_pri = (float(tse3.distance(x.T_cw, T_map)) for x in (r, r_pri))
    print(f"kidnapped: P3P seed {bool(r.success)} {int(r.n_inliers)} {err:.3e}; stored-pose "
          f"seed {bool(r_pri.success)} {int(r_pri.n_inliers)} {err_pri:.3e}")
    assert bool(r.success) and err < rw.TOL_KIDNAP
    assert (not bool(r_pri.success)) or err_pri > 10 * err
