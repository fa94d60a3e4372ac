"""The keyframe archive in VisualOdometry, the port against the JAX package,
both on the CPU: tests/test_archive.py's tests on the archive tier, through
both packages' VisualOdometry on the kidnapped sweep of
models/archive_workload.py at 240x320 (52 frames of a 3.4 m one-way sweep
over PlaneScene seed 3 on a 6-slot window, 4 noise frames, then the oldest
archived keyframe's view and the 8 frames after it), in the port's
configuration (the archive on, loop closing, the depth filter and async
mapping off), and chunked tracking against per-frame across the archive
relocalization (the port alone).

Both packages get the port's rendered frames.  The JAX package runs its CPU
route (jnp per-level Gauss-Newton and pose BA), the port the plain versions
of its kernels: the two track with different algorithms, so the run is held
at outcome level: statuses frame by frame, the archive's frame ids and
epochs, the relocalization on the same frame, equal.  Poses agree within
1e-2 map units (test_torch_mono_vo.py's bound) over the first SPAN_EXACT
frames; over the whole run within 0.1: the window evicts a keyframe every
~4 frames and the trajectories drift apart, as the JAX package's own two
routes do on these frames (its CPU route against its kernels interpreted:
up to 7.8e-2 map units; the port against the CPU route: up to 8.5e-2).

test_archive.py's kidnapped test forces the status to LOST with a lost
count of 0 and asserts the first kidnapped frame GOOD; with
lost_reloc_after = 3 the JAX package itself gives LOST there (the
relocalization is tried from the third failed retry on).  The port's test
loses track from the images (noise frames) and asserts the frames after the
archive relocalization GOOD.  test_archive_survives_save_load waits for the
port of System.save_map / load_map."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.models import frontend as jfe

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import archive_workload as aw
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.utils import np_se3

from _torch_port import jax_mono_run, jax_vo_options, np32

torch.set_num_threads(1)

SHAPE = (240, 320)
OPTS = aw.archive_options()
SPAN_EXACT = 12          # frames held to TOL_TRAJ
TOL_TRAJ = 1e-2          # map units, test_torch_mono_vo.py's bound
TOL_SWEEP = 0.1          # map units, over the whole run (see the module docstring)
TOL_CENTRE = 0.15        # test_archive.py: archive relocalization's camera centre, map units


def centre(p7) -> np.ndarray:
    R, t = np_se3.params7_to_Rt(np.asarray(p7))
    return -R.T @ t


@pytest.fixture(scope="module")
def runs():
    cam, frames, _ = aw.sweep_frames(SHAPE, device="cpu")
    n = frames.shape[0]
    snap = {}

    def query(arc_ids):
        """test_relocalize_against_evicted_keyframe's query frame."""
        early = int(arc_ids.min())
        return early, frames[max(early, 2)]

    vo = tvo.VisualOdometry(cam, OPTS, device="cpu")

    def feed(img, ts):
        r = vo.add_frame(img, ts)
        if len(vo.trajectory) == n:             # the sweep's end
            early, q_img = query(vo.archive.frame_ids())
            o = vo.o
            q = tfe.detect_multilevel(tfe.preprocess(q_img, o.n_levels), o.detect_threshold,
                                      o.grid_cell, o.feat_budgets)
            ra = trl.relocalize_archive(vo.vocab, cam, q.desc, q.px, q.valid,
                                        vo.archive.device_view(), min_inliers=o.reloc_min_inliers,
                                        q_angle=q.angle, top_c=o.reloc_top_c)
            snap.update(ids=vo.archive.frame_ids(), epochs=vo.archive.epochs(),
                        poses=vo.archive.poses7(), count=vo.archive.count,
                        pt_ok=int(vo.archive.device_view().pt_ok[:vo.archive.count].sum()),
                        logged=all(int(f) in vo.kf_pose_log for f in vo.archive.frame_ids()),
                        window=len(vo.server.kf_used), early=early,
                        reloc=(bool(ra.success), int(ra.n_inliers),
                               float(np.linalg.norm(centre(ra.T_cw.params7().numpy())
                                                    - centre(vo.kf_pose_log[early])))))
        return r

    out = aw.kidnapped_sweep(vo, frames, feed=feed)
    imgs = aw.fed_frames(frames, out["fed"])
    jsnap = {}

    def on_frame(k, jv):
        if k == n - 1:
            early, q_img = query(jv.archive.frame_ids())
            feats = jv._jit_detect_free(jfe.preprocess(jnp.asarray(np32(q_img)), jv.o.n_levels))
            ra = jv._jit_reloc_arc(feats.desc, feats.px, feats.valid, feats.angle,
                                   jv.archive.device_view())
            c = centre(np.asarray(ra.T_cw.params7()))
            jsnap.update(ids=jv.archive.frame_ids(), epochs=jv.archive.epochs(),
                         poses=jv.archive.poses7(), count=jv.archive.count,
                         reloc=(bool(ra.success), int(ra.n_inliers),
                                float(np.linalg.norm(c - centre(jv.kf_pose_log[early])))))

    jnames, jT7, _, jv = jax_mono_run(cam, imgs, jax_vo_options(OPTS), on_frame=on_frame)
    return dict(cam=cam, frames=frames, imgs=imgs, out=out, vo=vo, snap=snap, jnames=jnames,
                jT7=jT7, jv=jv, jsnap=jsnap)


def test_evicted_keyframes_are_archived(runs):
    s, js = runs["snap"], runs["jsnap"]
    d = max(float(tse3.distance(SE3.from_params7(torch.tensor(a)),
                                SE3.from_params7(torch.tensor(b)))) for a, b in
            zip(s["poses"], js["poses"]))
    print(f"archived at the sweep's end: port {s['ids'].tolist()} epochs {s['epochs'].tolist()}, "
          f"JAX {js['ids'].tolist()}; {s['pt_ok']} landmark snapshots; archived poses within "
          f"{d:.2e} (tol {TOL_SWEEP})")
    assert s["window"] <= OPTS.map_K and s["count"] >= 1
    assert len(set(s["ids"].tolist())) == s["count"]
    assert s["pt_ok"] > 20 and s["logged"]
    assert np.array_equal(s["ids"], js["ids"]) and np.array_equal(s["epochs"], js["epochs"])
    assert d < TOL_SWEEP


def test_relocalize_against_evicted_keyframe(runs):
    s, js = runs["snap"], runs["jsnap"]
    print(f"query frame {max(s['early'], 2)} against the archive (success, inliers, camera centre "
          f"error in map units): port {s['reloc']}, JAX {js['reloc']} (tol {TOL_CENTRE})")
    # test_archive.py's options keep the default reloc_min_inliers, 20.
    assert s["reloc"][1] >= 20 and js["reloc"][1] >= 20
    assert s["reloc"][1] == js["reloc"][1]
    assert s["reloc"][2] < TOL_CENTRE and js["reloc"][2] < TOL_CENTRE


def test_kidnapped_camera_resumes_in_old_region(runs):
    out, vo, jv = runs["out"], runs["vo"], runs["jv"]
    names = [x.name for x in out["statuses"]]
    k = out["reloc_frame"]
    print(f"port {''.join(x[0] for x in names)}\nJAX  {''.join(x[0] for x in runs['jnames'])}\n"
          f"relocalized at fed frame {k} onto archived keyframe {out['revisit_fid']}, pose error "
          f"{out['reloc_error']:.2e} (< {aw.TOL_REVISIT}); port stats {dict(vo.stats)}")
    assert names == runs["jnames"]
    assert out["ok"], {x: out[x] for x in ("relocalized", "near", "after_good")}
    for st in (vo.stats, jv.stats):
        assert st["relocs_archive"] >= 1 and st["keyframes_reactivated"] >= 1
    assert vo.stats["relocs_archive"] == jv.stats["relocs_archive"]
    assert vo.stats["keyframes_archived"] == jv.stats["keyframes_archived"]
    assert vo.archive.count == (vo.stats["evictions"] + vo.stats["keyframes_culled"]
                                - vo.stats["keyframes_reactivated"])
    assert np.array_equal(vo.archive.frame_ids(), jv.archive.frame_ids())
    assert vo.stats["inliers_total"] > 0 and int(vo.trajectory[-1][1].shape[0]) == 7


def test_trajectories_agree(runs):
    T7, jT7 = runs["out"]["T7"], runs["jT7"]
    d = [float(tse3.distance(SE3.from_params7(torch.tensor(a)), SE3.from_params7(torch.tensor(b))))
         for a, b in zip(T7, jT7)]
    print(f"poses port against JAX: max {max(d[:SPAN_EXACT]):.2e} over the first {SPAN_EXACT} "
          f"frames (tol {TOL_TRAJ}), {max(d):.2e} over all {len(d)} (tol {TOL_SWEEP})")
    assert max(d[:SPAN_EXACT]) < TOL_TRAJ and max(d) < TOL_SWEEP


def test_chunked_equals_per_frame_across_an_archive_relocalization(runs):
    vo = runs["vo"]
    ch = tvo.VisualOdometry(runs["cam"], OPTS, device="cpu")
    res = ch.add_frames(runs["imgs"], [float(k) for k in range(len(runs["imgs"]))], chunk=4)
    print(f"chunk stats {dict(ch.chunk_stats)}")
    assert [r.status for r in res] == runs["out"]["statuses"]
    assert np.array_equal(np.stack([p for _, p in ch.trajectory]),
                          np.stack([p for _, p in vo.trajectory]))
    assert all(torch.equal(a, b) for a, b in zip(ch.server.state, vo.server.state))
    assert ch.server.kf_used == vo.server.kf_used and ch.stats == vo.stats
    assert np.array_equal(ch.archive.frame_ids(), vo.archive.frame_ids())
    assert all(torch.equal(a, b) for a, b in zip(ch.archive.device_view(),
                                                 vo.archive.device_view()))
    assert ch.chunk_stats["chunks"] > 1 and ch.stats["relocs_archive"] == 1


@pytest.fixture(scope="module")
def reset_runs():
    """test_post_reset_eviction_still_archives' run in both packages: the
    first 30 frames of test_archive.py's 60-frame out-and-back sweep, a
    reset, the same frames again until two keyframes exist, then the oldest
    evicted by hand."""
    from ygz_slam_tpu.models import visual_odometry as jvo
    from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

    cam = aw.camera(SHAPE)
    scene = PlaneScene(cam, plane_z=3.0, seed=3, device="cpu")
    frames = []
    for k in range(30):
        t = k / 59
        x = 1.3 * np.sin(np.pi * t)
        frames.append(scene.render(tse3.exp(torch.tensor(
            [x, 0.1 * np.sin(2 * np.pi * t), 0.0, 0.0, -0.08 * np.sin(np.pi * t), 0.0],
            dtype=torch.float32)), SHAPE))

    from _torch_port import jax_camera

    out = {}
    for name, vo in (("port", tvo.VisualOdometry(cam, OPTS, device="cpu")),
                     ("jax", jvo.VisualOdometry(jax_camera(cam),
                                                jvo.VOOptions(**jax_vo_options(OPTS))))):
        img = (lambda k: frames[k]) if name == "port" else (lambda k: np32(frames[k]))
        for k in range(30):
            vo.add_frame(img(k), float(k))
        good = vo.status.name == "GOOD"
        vo.reset()
        rec = dict(good=good, epoch=vo.epoch, hook=vo.server.on_evict is not None,
                   after_reset=vo.archive.count, epochs_reset=vo.archive.epochs().tolist())
        for j in range(30):
            vo.add_frame(img(j), float(100 + j))
            if len(vo.server.kf_used) >= 2:
                break
        rec["kfs"] = len(vo.server.kf_used)
        before = vo.archive.count
        vo.server.evict_kf(vo.server.kf_used[0])
        rec.update(added=vo.archive.count - before, last_epoch=int(vo.archive.epochs()[-1]))
        out[name] = rec
    return out


def test_post_reset_eviction_still_archives(reset_runs):
    p, j = reset_runs["port"], reset_runs["jax"]
    print(f"port {p}\nJAX  {j}")
    assert p["good"] and p["epoch"] == 1 and p["hook"] and p["kfs"] >= 2
    assert p["added"] == 1 and p["last_epoch"] == 1
    # The reset archived the whole window into epoch 0.
    assert p["after_reset"] >= 2 and set(p["epochs_reset"]) == {0}
    assert p == j
