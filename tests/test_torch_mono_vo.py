"""The monocular system from raw frames, the port against the JAX package,
both on the CPU: `VisualOdometry` (through `System.track_monocular` in the
port) on tests/test_vo.py's 240x320, 40-frame sequence, with the slice's
options (no vocabulary, depth filter, archive or async mapping, and
test_vo's keyframe gates).  Both get the port's rendered frames, and the
port's RANSAC sampler is replaced by the JAX package's draw
(`jax.random.key(frame_id)` on the same mask), so both score the same
hypotheses.

After initialisation the two track with different algorithms: the JAX
VisualOdometry on a CPU runs its jnp per-level `gauss_newton` (K3 and K9
need a TPU there), the port the plain versions of its kernels.  So the run
is held at outcome level (statuses, keyframe frames, trajectories within
1e-2 of the map's unit, both ATEs under test_vo's 0.05 m); the init, which
both compute with the same algorithm, is held to 1e-3."""
import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.system.system import Sensor, System
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_mono_run, jax_ransac_indices, jax_vo_options, np32

torch.set_num_threads(1)

N_FRAMES = 40
SHAPE = (240, 320)
DU = 1.0 / (N_FRAMES - 1)          # tests/test_vo.py: t = k / (n - 1)
MIN_AGREE = 0.98                   # tracked and inlier sets
TOL_INIT = 1e-3                    # T2 and the mean-depth-1 points after the first local BA
TOL_TRAJ = 1e-2                    # camera centres, map units
ATE_MAX = 0.05                     # tests/test_vo.py:99


def _port_run(cam, frames, monkeypatch, jax_draw: bool = True):
    """The port's System over `frames`; returns (statuses, params7 [n, 7],
    keyframe frames, the init snapshot, the System)."""
    if jax_draw:
        monkeypatch.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
    seen = {}
    real_init = tin.initialize_two_view

    def record_init(pts1, pts2, mask, *a, **kw):
        seen["tracked"] = mask.clone()
        return real_init(pts1, pts2, mask, *a, **kw)

    monkeypatch.setattr(tin, "initialize_two_view", record_init)
    s = System(camera=cam, options=mw.mono_options(), device="cpu")
    kf_frames = []

    def on_frame(k, r):
        if s.vo.stats["keyframes"] > len(kf_frames):
            kf_frames.append(k)
        if r.status is tvo.Status.GOOD and "state" not in seen:
            st = s.vo.server.state
            seen.update(state=type(st)(*(t.clone() for t in st)),
                        slots=list(s.vo.server.kf_used))

    statuses, T7, _ = mw.run_mono(s, frames, on_frame)
    return statuses, T7, kf_frames, seen, s


@pytest.fixture(scope="module")
def runs():
    cam, frames, T_gt7 = mw.make_mono_workload(N_FRAMES, device="cpu", shape=SHAPE, du=DU)
    with pytest.MonkeyPatch.context() as mp:
        port = _port_run(cam, frames, mp)
    jseen = {}

    def record_jax_init(jv):
        real = jv._jit_init

        def init(p1, p2, mask, key):
            jseen["tracked"] = np32(mask).copy()
            return real(p1, p2, mask, key)

        jv._jit_init = init

    from ygz_slam_tpu.models import visual_odometry as jvo
    from _torch_port import jax_camera

    jv = jvo.VisualOdometry(jax_camera(cam), jvo.VOOptions(**jax_vo_options(mw.mono_options())))
    record_jax_init(jv)

    def on_frame(k, jv):
        if jv.status is jvo.Status.GOOD and "state" not in jseen:
            jseen.update(state={f: np32(v) for f, v in jv.server.state._asdict().items()},
                         slots=list(jv.server.kf_used))

    jnames, jT7, jkf, jv = jax_mono_run(cam, frames, {}, on_frame=on_frame, jv=jv)
    return dict(cam=cam, frames=frames, T_gt7=np32(T_gt7), port=port,
                jax=(jnames, jT7, jkf, jseen, jv))


def test_init_matches(runs):
    """Same init frame and model; the tracked and inlier sets agree; the
    second keyframe's pose and the mean-depth-1 points after the first
    local BA agree to 1e-3."""
    statuses, _, _, seen, s = runs["port"]
    jnames, _, _, jseen, jv = runs["jax"]
    k0 = mw.init_frame(statuses)
    assert k0 == jnames.index("GOOD") and 0 < k0 < mw.INIT_WITHIN
    assert s.vo.init_used_h == jv.init_used_h
    tracked, jtracked = np32(seen["tracked"]), jseen["tracked"]
    assert np.mean(tracked == jtracked) >= MIN_AGREE
    m, jm = seen["state"], jseen["state"]
    assert seen["slots"] == jseen["slots"] == [0, 1]
    n = tracked.shape[0]
    inl, jinl = np32(m.feat_valid[0, :n]), jm["feat_valid"][0, :n]
    assert inl.sum() >= 40 and np.mean(inl == jinl) >= MIN_AGREE
    assert np.abs(np32(m.kf_pose7[:2]) - jm["kf_pose7"][:2]).max() <= TOL_INIT
    # Landmarks keyed by their first keyframe's pixel: two detections that
    # tie may come in the other order (ROADMAP queue 3), so rows may swap.
    pts = _landmarks_by_pixel({f: np32(v) for f, v in m._asdict().items()})
    jpts = _landmarks_by_pixel(jm)
    common = sorted(set(pts) & set(jpts))
    assert len(common) >= MIN_AGREE * max(len(pts), len(jpts))
    d = np.linalg.norm(np.stack([pts[k] for k in common]) - np.stack([jpts[k] for k in common]),
                       axis=1)
    print(f"init: frame {k0}, H={s.vo.init_used_h}, tracked sets agree "
          f"{np.mean(tracked == jtracked):.4f}, inliers agree {np.mean(inl == jinl):.4f}, "
          f"pose7 {np.abs(np32(m.kf_pose7[:2]) - jm['kf_pose7'][:2]).max():.2e}, points "
          f"{d.max():.2e} on {len(common)} landmarks")
    assert d.max() <= TOL_INIT
    depth = np.stack([pts[k] for k in common])[:, 2]
    assert abs(float(depth.mean()) - 1.0) < 0.05     # the map's unit: mean depth 1


def _landmarks_by_pixel(m: dict) -> dict:
    """{keyframe-0 pixel: position} of the valid landmarks slot 0 observes."""
    rows = m["feat_point"][0]
    ok = m["feat_valid"][0] & (rows >= 0)
    ok &= m["pt_valid"][np.clip(rows, 0, None)]
    return {tuple(np.round(m["feat_px"][0][f], 3)): m["pt_pos"][rows[f]] for f in np.where(ok)[0]}


def test_run_matches(runs):
    """Statuses frame by frame, keyframes on the same frames (+-1), both
    ATEs under 0.05 m, trajectories within 1e-2 map units."""
    statuses, T7, kf, _, s = runs["port"]
    jnames, jT7, jkf, _, jv = runs["jax"]
    assert [x.name for x in statuses] == jnames
    assert len(kf) == len(jkf) >= 3
    assert all(abs(a - b) <= 1 for a, b in zip(kf, jkf))
    T_gt7 = runs["T_gt7"]
    jstatuses = [tvo.Status[n] for n in jnames]
    ate = mw.good_ate(statuses, T7, T_gt7)
    jate = mw.good_ate(jstatuses, jT7, T_gt7)
    print(f"port ATE {ate:.5f} m, JAX ATE {jate:.5f} m, keyframes {kf} / {jkf}")
    assert ate < ATE_MAX and jate < ATE_MAX
    good = [k for k, x in enumerate(statuses) if x is tvo.Status.GOOD]
    d = np.linalg.norm(traj.camera_centers(T7[good]) - traj.camera_centers(jT7[good]), axis=1)
    print(f"trajectories: max camera-centre gap {d.max():.2e} map units over {len(good)} "
          f"GOOD frames")
    assert d.max() <= TOL_TRAJ
    assert mw.mono_gate(statuses, T7, T_gt7)[2]
    assert s.vo.stats["keyframes"] == jv.stats["keyframes"]
    # Keyframe culling keeps the same window of slots.
    assert s.vo.server.kf_used == jv.server.kf_used


def test_saved_trajectory(runs, tmp_path):
    """System.save_trajectory writes the tracked poses (corrected=False) or
    each GOOD frame re-anchored on its keyframe's refined pose (True), in
    the TUM format that `trajectory.load_tum` reads back."""
    statuses, T7, _, _, s = runs["port"]
    for corrected in (False, True):
        path = str(tmp_path / f"traj_{corrected}.txt")
        s.save_trajectory(path, corrected=corrected)
        stamps, P = traj.load_tum(path)
        assert np.array_equal(stamps, np.arange(N_FRAMES, dtype=float))
        d = np.linalg.norm(traj.camera_centers(P) - traj.camera_centers(T7), axis=1)
        # TUM files hold 6 decimals; re-anchoring moves a frame by what BA
        # moved its keyframe.
        assert d.max() <= (1e-2 if corrected else 1e-5), (corrected, d.max())


def test_static_camera_stays_initing():
    """A camera that never moves never initialises (tests/test_vo.py:111)."""
    cam, frames, _ = mw.make_mono_workload(1, device="cpu", shape=SHAPE, du=DU)
    s = System(camera=cam, options=mw.mono_options(), device="cpu")
    for _ in range(5):
        r = s.track_monocular(frames[0])
    assert r.status in (tvo.Status.NOT_READY, tvo.Status.INITING)


def test_reset_and_reinit(runs):
    """reset() empties the map and the system initialises again
    (tests/test_vo.py:124)."""
    frames = runs["frames"]
    s = System(camera=runs["cam"], options=mw.mono_options(), device="cpu")
    for k in range(20):
        s.track_monocular(frames[k], float(k))
    assert s.status is tvo.Status.GOOD
    s.reset()
    assert s.status is tvo.Status.NOT_READY and s.vo.server.kf_used == []
    assert not bool(s.vo.server.state.pt_valid.any())
    for k in range(12):
        r = s.track_monocular(frames[k], float(k))
    assert r.status in (tvo.Status.INITING, tvo.Status.GOOD)


def test_depth_filter_runs_and_reset_clears_seeds(runs):
    """The depth filter is ported: a System with `use_depth_filter=True`
    tracks test_reset_and_reinit's frames with seeds on the last keyframe;
    reset() clears them (and the seed keyframe), and the system initialises
    again."""
    frames = runs["frames"]
    s = System(camera=runs["cam"], options=mw.mono_options(use_depth_filter=True), device="cpu")
    for k in range(20):
        s.track_monocular(frames[k], float(k))
    vo = s.vo
    assert s.status is tvo.Status.GOOD and vo.stats["keyframes"] >= 1
    assert vo.seeds is not None and vo.seed_kf_slot == vo.last_kf_slot
    assert bool(vo.seeds.valid.any())
    s.reset()
    assert vo.seeds is None and vo.seed_kf_slot == -1 and vo.seed_feat_idx is None
    assert s.status is tvo.Status.NOT_READY and vo.server.kf_used == []
    for k in range(12):
        r = s.track_monocular(frames[k], float(k))
    assert r.status in (tvo.Status.INITING, tvo.Status.GOOD)


def _tracker_taken(vo, frame, monkeypatch) -> list:
    """The trackers `vo._run_tracker` calls on `frame` (each stubbed: only
    the dispatch is read), with a gradient-pixel set on slot 0 for
    SEMI_DENSE_DIRECT."""
    calls = []
    for name in ("track", "track_orb", "track_sd"):
        monkeypatch.setattr(tvo, name, lambda *a, _n=name, **kw: calls.append(_n))
    pyr = tvo.fe.preprocess(frame, vo.o.n_levels)
    vo.kf_images = torch.zeros((vo.o.map_K,) + tuple(frame.shape))
    if vo.o.vo_type is tvo.VOType.SEMI_DENSE_DIRECT:
        vo.sd = tvo.sd_init(vo.o, pyr[0], 0, 1.0)
    try:
        vo._run_tracker(pyr, vo.T_cw)
    except TypeError:                     # the stub's None does not unpack
        pass
    return calls


@pytest.mark.parametrize("opt", [dict(use_vocabulary=True, archive_map=True),
                                 dict(vo_type=tvo.VOType.SEMI_DENSE_DIRECT),
                                 dict(async_mapping=True), dict(vo_type=tvo.VOType.SPARSE_ORB)],
                         ids=["use_vocabulary", "vo_type_semi_dense", "async_mapping", "vo_type"])
def test_options_construct(opt, monkeypatch):
    """Options once unsupported construct: the archive loops (the vocabulary
    with the archive and loop closing), async mapping, and the SPARSE_ORB
    and SEMI_DENSE_DIRECT frontends, each of which takes its own tracker
    (`track_orb`, `track_sd`)."""
    cam, frames, _ = mw.make_mono_workload(1, device="cpu", shape=SHAPE, du=DU)
    vo = System(camera=cam, options=mw.mono_options(**opt), device="cpu").vo
    assert not hasattr(tvo, "_unsupported")
    if opt.get("archive_map"):
        assert vo.archive is not None and vo.vocab is not None and vo.o.loop_closing
    if "vo_type" in opt:
        want = "track_orb" if opt["vo_type"] is tvo.VOType.SPARSE_ORB else "track_sd"
        assert vo.o.vo_type is opt["vo_type"]
        assert _tracker_taken(vo, frames[0], monkeypatch) == [want]


@pytest.mark.parametrize("sensor", [Sensor.STEREO, Sensor.RGBD])
def test_other_sensors_construct(sensor):
    """The depth sensors construct with every map type; with the SEMI_DENSE
    map (the last step-6 part to raise) the sensor start seeds the first
    keyframe's gradient-pixel set."""
    cam, frames, _ = mw.make_mono_workload(1, device="cpu", shape=SHAPE, du=DU)
    for map_type in (tvo.MapType.SPARSE, tvo.MapType.DENSE):
        s = System(camera=cam, sensor=sensor, options=mw.mono_options(map_type=map_type),
                   device="cpu")
        assert s.sensor is sensor and s.vo.o.map_type is map_type
    s = System(camera=cam, sensor=sensor,
               options=mw.mono_options(map_type=tvo.MapType.SEMI_DENSE), device="cpu")
    assert s.sensor is sensor and s.vo.o.map_type is tvo.MapType.SEMI_DENSE and s.vo.sd is None
    # Frame 0 is at the identity, in front of the plane at z = 3: its depth
    # image, or its rectified right view 0.1 m (the default baseline) aside.
    right = depth = None
    if sensor is Sensor.STEREO:
        T_right = SE3(torch.eye(3), torch.tensor([-s.vo.o.stereo_baseline, 0.0, 0.0]))
        right = PlaneScene(cam, plane_z=3.0, seed=0, device="cpu").render(T_right, SHAPE)
    else:
        depth = torch.full_like(frames[0], 3.0)
    r = s.vo.add_frame(frames[0], 0.0, depth=depth, right=right)
    assert r.status is tvo.Status.GOOD
    assert s.vo.sd is not None and s.vo.sd.kf_slot == s.vo.last_kf_slot
