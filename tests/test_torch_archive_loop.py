"""The archive loops, the port against the JAX package, both on the CPU:
`detect_loop_archive`, `apply_global_correction` and the epoch merge's pose
and point maps (`VisualOdometry._merge_epochs`) on states recorded from a
short JAX run of tests/test_archive.py's out-and-back sweep
(`archive_workload.out_and_back_frames`, 240x320, PlaneScene seed 3, the
JAX defaults with ARC_OPTS, mapping synchronous), up to the keyframe whose
archive detection first finds a loop (frame 38: archive row 3, 70 inliers).

Each of the run's archive detections (the keyframes past the cooldown with
a non-empty archive) is replayed through the port on the recorded map,
archive view and BoW rows, the port handed the JAX package's P3P draws
(`_torch_port.jax_pnp_draws`, key 29): retrieval scores, candidates,
`found`, `loop_kf` and `n_inl` equal; `T_loop7` within TOL_LOOP (pose
distance; pose-only BA is K8's plain version against the JAX CPU route)
and `scale` within TOL_SCALE relative (the spread ratio's float32 sums).
`apply_global_correction` on the recorded map with seeded corrections,
without and with per-keyframe scales: poses equal, landmarks within
TOL_POINTS.  The merge on the found loop with the matched row taken as
another epoch's: window poses, landmarks, feature depths, logged poses and
archive rows within TOL_MERGE (the same float64 host arithmetic, float32
results)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.map import vocabulary as jvoc
from ygz_slam_tpu.map.archive import ArchiveView as JArchiveView
from ygz_slam_tpu.map.state import MapState as JMapState
from ygz_slam_tpu.models import relocalization as jrl
from ygz_slam_tpu.models import visual_odometry as jvo

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.map.archive import ArchiveView
from ygz_slam_tpu_torch.models import archive_workload as aw
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.models import visual_odometry as tvo

from _torch_port import jax_camera, jax_pnp_draws, jax_vo_options, np32

torch.set_num_threads(1)

SHAPE = (240, 320)
OPTS = aw.loop_options(async_mapping=False)
TOL_LOOP = 1e-4          # T_loop7, pose distance
TOL_SCALE = 1e-5         # the loop's scale, relative
TOL_POINTS = 1e-5        # corrected landmarks, relative to max(1, |p|)
TOL_MERGE = 1e-6         # merged poses, landmarks, depths, relative to max(1, |x|)


def snapshot_vo(jv) -> dict:
    """The JAX VisualOdometry's host and map state that `_merge_epochs`
    reads and writes, as numpy."""
    st = jv.server.state
    return dict(state={k: np.asarray(v) for k, v in st._asdict().items()},
                kf_used=list(jv.server.kf_used), arc=jv.archive.state_dict(),
                arc_poses=jv.archive.poses7(), arc_epochs=jv.archive.epochs(),
                log={k: np.asarray(v).copy() for k, v in jv.kf_pose_log.items()},
                fid_epoch=dict(jv._fid_epoch), epoch=jv.epoch,
                prev7=np.asarray(jv.prev_T_cw.params7()), cur7=np.asarray(jv.T_cw.params7()),
                last_fid=jv._last_kf_fid, last7=np.asarray(jv._last_kf_pose7).copy())


@pytest.fixture(scope="module")
def recorded():
    jvocab = jvo._shared_vocabulary()
    cam, frames, _ = aw.out_and_back_frames(SHAPE, device="cpu")
    jv = jvo.VisualOdometry(jax_camera(cam), jvo.VOOptions(**jax_vo_options(OPTS)))
    calls, merge = [], {}
    real = jv._jit_loop_arc

    def hook(slot, fid, kf_bow, kf_nodes, mstate, arc):
        out = real(slot, fid, kf_bow, kf_nodes, mstate, arc)
        rec = dict(slot=int(slot), fid=int(fid), kf_bow=np.asarray(kf_bow),
                   kf_nodes=np.asarray(kf_nodes),
                   state={k: np.asarray(v) for k, v in mstate._asdict().items()},
                   arc={k: np.asarray(v) for k, v in arc._asdict().items()},
                   found=bool(out.found), loop_kf=int(out.loop_kf), n_inl=int(out.n_inl),
                   scale=float(out.scale), T_loop7=np.asarray(out.T_loop7))
        calls.append(rec)
        if rec["found"] and not merge:
            # The merge's maps, the matched row taken as another epoch's.
            merge["before"] = snapshot_vo(jv)
            jv._merge_epochs(rec["slot"], out, jv.epoch + 1)
            merge["after"] = snapshot_vo(jv)
        return out

    jv._jit_loop_arc = hook
    for k in range(frames.shape[0]):
        jv.add_frame(np32(frames[k]), float(k))
        if merge:
            break
    tvocab = convert.vocabulary_from_numpy(jvoc.state_dict(jvocab), device="cpu")
    return dict(cam=cam, tvocab=tvocab, calls=calls, merge=merge, frame=k)


def port_detect(rec, tvocab, cam, stages=None):
    st = convert.map_state_from_numpy(rec["state"], device="cpu")
    arc = ArchiveView(**{k: convert._like(v, "cpu") for k, v in rec["arc"].items()})
    o = OPTS
    return trl.detect_loop_archive(
        tvocab, cam, rec["slot"], rec["fid"], torch.tensor(rec["kf_bow"]), st.kf_valid,
        st.cov_weight, st.feat_desc.reshape(-1, 8), torch.tensor(rec["kf_nodes"]).reshape(-1),
        st.feat_px.reshape(-1, 2), st.feat_valid.reshape(-1), st.kf_pose7, arc,
        min_frame_gap=o.loop_min_frame_gap, min_inliers=o.loop_min_inliers,
        feat_angle_flat=st.feat_angle.reshape(-1), feat_point_flat=st.feat_point.reshape(-1),
        pt_pos=st.pt_pos, pt_valid=st.pt_valid, top_c=o.loop_top_c,
        draws=functools.partial(jax_pnp_draws, key=29), stages=stages)


def test_the_run_finds_an_archive_loop(recorded):
    calls = recorded["calls"]
    print(f"archive detections at keyframe frames {[c['fid'] for c in calls]}; found "
          f"{[c['found'] for c in calls]}; the first found at frame {recorded['frame']}: row "
          f"{calls[-1]['loop_kf']}, {calls[-1]['n_inl']} inliers, scale {calls[-1]['scale']:.6f}")
    assert len(calls) >= 2 and calls[-1]["found"] and not any(c["found"] for c in calls[:-1])


def test_detect_loop_archive_as_jax(recorded):
    """Every recorded detection: the retrieval and candidates equal, the
    outcome equal, T_loop7 and scale within tolerance."""
    tvocab, cam = recorded["tvocab"], recorded["cam"]
    for rec in recorded["calls"]:
        stages = {}
        lp = port_detect(rec, tvocab, cam, stages)
        jst = JMapState(**{k: jnp.asarray(v) for k, v in rec["state"].items()})
        jarc = JArchiveView(**{k: jnp.asarray(v) for k, v in rec["arc"].items()})
        gap_ok = jarc.frame_id < (rec["fid"] - OPTS.loop_min_frame_gap)
        F = rec["kf_nodes"].shape[1]
        q_rows = rec["slot"] * F + jnp.arange(F)
        jscores = np.asarray(jrl._archive_retrieval_scores(
            jvo._shared_vocabulary(), jst.feat_desc.reshape(-1, 8)[q_rows],
            jst.feat_valid.reshape(-1)[q_rows], jarc, jarc.valid & gap_ok))
        a = stages["attempt"]
        d_pose = float(tse3.distance(SE3.from_params7(lp.T_loop7),
                                     SE3.from_params7(torch.tensor(rec["T_loop7"]))))
        d_scale = abs(float(lp.scale) - rec["scale"]) / rec["scale"]
        print(f"frame {rec['fid']}: candidates {np32(a.cand).tolist()}, inliers "
              f"{np32(a.n_inl).tolist()}; found {bool(lp.found)} / {rec['found']}, row "
              f"{int(lp.loop_kf)} / {rec['loop_kf']}, inliers {int(lp.n_inl)} / {rec['n_inl']}; "
              f"T_loop7 {d_pose:.2e} (tol {TOL_LOOP}), scale {float(lp.scale):.6f} / "
              f"{rec['scale']:.6f} ({d_scale:.1e}); scales {np32(stages['scale']).round(4).tolist()}")
        assert np.array_equal(np32(a.scores), jscores)
        assert np.array_equal(np32(a.cand),
                              np.asarray(jax.lax.top_k(jnp.asarray(jscores), OPTS.loop_top_c)[1]))
        assert bool(lp.found) == rec["found"] and int(lp.n_inl) == rec["n_inl"]
        assert int(lp.loop_kf) == rec["loop_kf"]
        assert d_pose < TOL_LOOP and d_scale < TOL_SCALE


def perturbed_poses(pose7: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xi = torch.tensor(rng.normal(0, 0.02, (pose7.shape[0], 6)), dtype=torch.float32)
    return np32(tse3.exp(xi).compose(SE3.from_params7(torch.tensor(pose7))).params7())


@pytest.mark.parametrize("with_scale", [False, True], ids=["se3", "sim3"])
def test_apply_global_correction_as_jax(recorded, with_scale):
    rec = recorded["calls"][-1]
    st_np = rec["state"]
    new7 = perturbed_poses(st_np["kf_pose7"], 11)
    scale = (np.random.default_rng(12).uniform(0.9, 1.1, new7.shape[0]).astype(np.float32)
             if with_scale else None)
    tst = trl.apply_global_correction(convert.map_state_from_numpy(st_np, device="cpu"),
                                      torch.tensor(new7),
                                      None if scale is None else torch.tensor(scale))
    jst = jrl.apply_global_correction(JMapState(**{k: jnp.asarray(v) for k, v in st_np.items()}),
                                      jnp.asarray(new7),
                                      None if scale is None else jnp.asarray(scale))
    valid = st_np["pt_valid"]
    d = float(np.max(np.abs(np32(tst.pt_pos) - np.asarray(jst.pt_pos))
                     / np.maximum(1.0, np.abs(np.asarray(jst.pt_pos)))))
    moved = float(np.abs(np32(tst.pt_pos) - st_np["pt_pos"])[valid].max())
    print(f"{int(valid.sum())} landmarks moved by up to {moved:.3e}; port against JAX {d:.2e} "
          f"(tol {TOL_POINTS})")
    assert np.array_equal(np32(tst.kf_pose7), new7)
    assert d < TOL_POINTS and moved > 1e-3
    assert np.array_equal(np32(tst.pt_pos)[~valid], st_np["pt_pos"][~valid])


def test_merge_epochs_as_jax(recorded):
    """`_merge_epochs` on the port holding the JAX run's state at its found
    archive loop (the row taken as another epoch's): the same maps of the
    window, the logged poses and the archive rows, the epochs relabelled,
    the seeds dropped and the velocity reset."""
    before, after = recorded["merge"]["before"], recorded["merge"]["after"]
    rec = recorded["calls"][-1]
    vo = tvo.VisualOdometry(recorded["cam"], OPTS, device="cpu")
    vo.server.state = convert.map_state_from_numpy(before["state"], device="cpu")
    vo.server.kf_used = list(before["kf_used"])
    vo.archive = convert.archive_from_numpy(before["arc"], OPTS.map_F, vo.archive.W, device="cpu")
    vo.kf_pose_log = {k: v.copy() for k, v in before["log"].items()}
    vo._fid_epoch = dict(before["fid_epoch"])
    vo.epoch = before["epoch"]
    vo.prev_T_cw = SE3.from_params7(torch.tensor(before["prev7"]))
    vo.T_cw = SE3.from_params7(torch.tensor(before["cur7"]))
    vo._last_kf_fid, vo._last_kf_pose7 = before["last_fid"], before["last7"].copy()
    vo.velocity = SE3.from_params7(torch.tensor([1.0, 0, 0, 0, 0.1, 0, 0]))
    vo.seeds = "seeds"
    lp = trl.LoopResult(found=True, loop_kf=rec["loop_kf"], T_loop7=rec["T_loop7"],
                        scale=rec["scale"], n_inl=rec["n_inl"])
    vo._merge_epochs(rec["slot"], lp, before["epoch"] + 1)

    def rel(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))) if a.size else 0.0

    st = convert.map_state_to_numpy(vo.server.state)
    d = dict(kf_pose7=rel(st["kf_pose7"], after["state"]["kf_pose7"]),
             pt_pos=rel(st["pt_pos"], after["state"]["pt_pos"]),
             feat_depth=rel(st["feat_depth"], after["state"]["feat_depth"]),
             log=max(rel(vo.kf_pose_log[k], v) for k, v in after["log"].items()),
             arc_poses=rel(vo.archive.poses7(), after["arc_poses"]),
             arc_pts=rel(vo.archive.state_dict()["__arc_pt_pos"], after["arc"]["__arc_pt_pos"]),
             prev=rel(np32(vo.prev_T_cw.params7()), after["prev7"]),
             last=rel(vo._last_kf_pose7, after["last7"]))
    moved = rel(after["state"]["pt_pos"], before["state"]["pt_pos"])
    print(f"merge of epoch {before['epoch']} by scale {rec['scale']:.4f}: landmarks moved by "
          f"{moved:.3e}; port against JAX {d} (tol {TOL_MERGE})")
    assert moved > 1e-4
    assert all(v <= TOL_MERGE for v in d.values()), d
    assert set(vo.kf_pose_log) == set(after["log"]) and vo._fid_epoch == after["fid_epoch"]
    assert vo.epoch == after["epoch"] == before["epoch"] + 1
    assert np.array_equal(vo.archive.epochs(), after["arc_epochs"])
    assert vo.seeds is None
    assert torch.equal(vo.velocity.params7(), SE3.identity(device="cpu").params7())
