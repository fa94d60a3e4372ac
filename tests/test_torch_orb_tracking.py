"""The SPARSE_ORB frontend (`models/orb_tracking.py`, `VisualOdometry` with
`vo_type=SPARSE_ORB`), the port against the JAX package, both on the CPU,
at tests/test_vo.py's size (240x320, its camera and keyframe gates).

Matching is held exactly: both packages get the same landmarks,
descriptors and detections (the packages' ORB descriptors differ by up to
2 bits, ROADMAP section 3), and match decisions and observation pixels
must be equal.  `track_map_orb` is held on a rendered frame with the map of
an initialised JAX VisualOdometry, the JAX side on the route its own
VisualOdometry tests take on the CPU (the jnp `pose_only_ba`; the port's K5
follows the fused Pallas kernel, held to it interpreted in
tests/test_torch_pose_ba.py; the two part by ~3e-5 here).  The
VisualOdometry guard runs both classes over 18 frames (init at frame 10, a
keyframe at 15, the depth filter's seeds updated after it) with the JAX
defaults; the port gets the JAX package's RANSAC draw.  Its camera centres
agreed to 1.0e-4 map units on one CPU thread, so they are held to 1e-3."""
import copy
import functools

import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import orb_tracking as torb
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.ops import fast, orb
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_camera, jax_mono_run, jax_ransac_indices, jax_vo_options, np32

torch.set_num_threads(1)

SHAPE = (240, 320)
N_FRAMES = 18              # init at 10, a keyframe at 15, two frames after it
DU = 1.0 / 39              # tests/test_vo.py's 40-frame sequence
TOL_PX = 1e-6              # observation pixels where both packages match, px
TOL_POSE = 1e-4            # track_map_orb's pose, rotation and translation entries
MIN_AGREE = 0.99           # track_map_orb's inlier sets
TOL_TRAJ = 1e-3            # VO camera centres, map units (measured spread 1.0e-4)
CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)    # tests/test_vo.py's
ORB_OPTS = dict(vo_type=tvo.VOType.SPARSE_ORB, **mw.VO_OPTS)


def _jax_features(f: tfe.Features):
    import jax.numpy as jnp
    from ygz_slam_tpu.models.frontend import Features

    return Features(px=jnp.asarray(np32(f.px)), level=jnp.asarray(np32(f.level)),
                    score=jnp.asarray(np32(f.score)), angle=jnp.asarray(np32(f.angle)),
                    desc=jnp.asarray(np32(f.desc).view(np.uint32)),
                    depth=jnp.asarray(np32(f.depth)), valid=jnp.asarray(np32(f.valid)))


def _jse3(T: SE3):
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import SE3 as JSE3

    return JSE3(jnp.asarray(np32(T.R)), jnp.asarray(np32(T.t)))


@pytest.mark.parametrize("dim", [0, 1])
def test_first_argmin_takes_the_first_of_ties(dim):
    """`first_argmin` equals jnp.argmin (first index among equal minima) on
    Hamming-like matrices full of ties."""
    import jax.numpy as jnp

    d = np.random.default_rng(7 + dim).integers(0, 6, size=(97, 53)).astype(np.int32)
    d[:, 5] = 0                                   # a column of ties
    d[11] = 3                                     # a row of ties
    got = torb.first_argmin(torch.from_numpy(d), dim).numpy()
    assert np.array_equal(got, np.asarray(jnp.argmin(jnp.asarray(d), axis=dim)))


def _scene_features(seed: int, n: int):
    """tests/test_vo_types.py's exact-descriptor case: FAST corners of a
    PlaneScene view at the identity, their ORB descriptors, and the points
    on the plane behind them."""
    cam = CAM
    scene = PlaneScene(cam, plane_z=3.0, seed=seed, device="cpu")
    T0 = SE3.identity(device="cpu")
    img = scene.render(T0, SHAPE)
    c = fast.detect(img, 20.0, cell=12, max_corners=n)
    ang, desc = orb.compute(img, c.xy)
    depth = scene.depth(c.xy, T0)
    pts = cam.pixel_to_world(c.xy, T0, depth=depth)
    feats = tfe.Features(px=c.xy, level=torch.zeros(n, dtype=torch.int32), score=c.score,
                         angle=ang, desc=desc, depth=depth, valid=c.mask)
    return cam, pts, c.mask, desc, feats


def _case(name: str):
    """(camera, pose, landmarks, valid, descriptors [L, 8], features,
    keyword arguments) of a matching case, seeded."""
    rng = np.random.default_rng(11)
    cam, pts, valid, desc, feats = _scene_features(3, 128)
    T = SE3.identity(device="cpu")
    kw = dict(radius=10.0)
    if name == "exact":
        return cam, T, pts, valid, desc, feats, kw
    n = feats.px.shape[0]
    # Descriptors with a few bits flipped, features on levels 0-2 (the
    # window scales with 2^level), the pose off by a small motion.
    flips = rng.integers(0, 2, size=(n, 8, 32)) * (rng.random((n, 8, 32)) < 0.04)
    words = (flips << np.arange(32)).sum(-1).astype(np.uint64).astype(np.uint32).view(np.int32)
    desc_n = desc ^ torch.from_numpy(words)
    level = torch.from_numpy(rng.integers(0, 3, size=n).astype(np.int32))
    feats = feats._replace(level=level)
    T = tse3.exp(torch.tensor([0.01, -0.005, 0.0, 0.0, 0.002, 0.0]))
    kw = dict(radius=15.0, max_dist=80)
    if name == "noisy":
        return cam, T, pts, valid, desc_n, feats, kw
    if name == "ties":
        # Every other landmark copies its neighbour's descriptor, and half
        # the features repeat another's: equal distances everywhere.
        desc_t = desc_n.clone()
        desc_t[1::2] = desc_t[0:-1:2]
        fd = feats.desc.clone()
        fd[1::2] = fd[0:-1:2]
        return cam, T, pts, valid, desc_t, feats._replace(desc=fd), dict(kw, ratio=1.01)
    if name == "rotation_gate":
        angle = torch.from_numpy(rng.uniform(-np.pi, np.pi, size=n).astype(np.float32))
        return cam, T, pts, valid, desc_n, feats, dict(kw, pt_angle=angle)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["exact", "noisy", "ties", "rotation_gate"])
def test_match_by_projection(name):
    """The same landmarks, descriptors and features through both packages'
    `match_by_projection`: matched flags, in-view flags and observation
    pixels (the best feature of every landmark, matched or not) equal; the
    exact case also holds tests/test_vo_types.py's gates (>= 80% matched,
    at the true pixel)."""
    import jax.numpy as jnp
    from ygz_slam_tpu.models import orb_tracking as jorb

    cam, T, pts, valid, desc, feats, kw = _case(name)
    m, obs, inv = torb.match_by_projection(cam, T, pts, valid, desc, feats, **kw)
    jkw = dict(kw)
    if "pt_angle" in jkw:
        jkw["pt_angle"] = jnp.asarray(np32(kw["pt_angle"]))
    jm, jobs, jinv = jorb.match_by_projection(
        jax_camera(cam), _jse3(T), jnp.asarray(np32(pts)), jnp.asarray(np32(valid)),
        jnp.asarray(np32(desc).view(np.uint32)), _jax_features(feats), **jkw)
    m, jm = np32(m), np32(jm)
    print(f"{name}: {int(m.sum())} of {int(np32(valid).sum())} landmarks matched, "
          f"JAX {int(jm.sum())}")
    assert np.array_equal(m, jm) and np.array_equal(np32(inv), np32(jinv))
    assert np.abs(np32(obs) - np32(jobs)).max() <= TOL_PX
    assert m.sum() > 0
    if name == "exact":
        assert m.sum() >= 0.8 * int(np32(valid).sum())
        assert np.linalg.norm(np32(obs) - np32(feats.px), axis=1)[m].max() < 1e-3


def _port_vo(cam, frames, opts, n):
    vo = tvo.VisualOdometry(cam, opts, device="cpu")
    names = [vo.add_frame(frames[k], float(k)).status.name for k in range(n)]
    return names, np.stack([p for _, p in vo.trajectory_poses(corrected=False)]), vo


@pytest.fixture(scope="module")
def runs():
    """Both VisualOdometry classes with `vo_type=SPARSE_ORB` over the first
    N_FRAMES frames, and the JAX one's map and motion model at the end."""
    cam, frames, T_gt7 = mw.make_mono_workload(40, device="cpu", shape=SHAPE, du=DU)
    opts = tvo.VOOptions(**ORB_OPTS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        names, T7, vo = _port_vo(cam, frames, opts, N_FRAMES)
    jnames, jT7, _, jv = jax_mono_run(cam, frames[:N_FRAMES], jax_vo_options(opts))
    jv._join_mapping()
    st = convert.map_state_from_numpy({k: np.asarray(v) for k, v in
                                       jv.server.state._asdict().items()}, device="cpu")
    T_prev = SE3(torch.tensor(np32(jv.prev_T_cw.R)), torch.tensor(np32(jv.prev_T_cw.t)))
    vel = SE3(torch.tensor(np32(jv.velocity.R)), torch.tensor(np32(jv.velocity.t)))
    return dict(cam=cam, frames=frames, names=names, T7=T7, vo=vo, jnames=jnames, jT7=jT7,
                jv=jv, jstate=st, T_pred=vel.compose(T_prev))


def test_track_map_orb(runs):
    """`track_map_orb` on frame N_FRAMES with the initialised JAX VO's map
    (3072 landmark rows) and motion-model pose, the port's detections given
    to both: pose within TOL_POSE, inlier sets equal on >= 99% of the rows,
    candidates equal, observations equal where both found the landmark."""
    import jax
    import jax.numpy as jnp
    from ygz_slam_tpu.models import orb_tracking as jorb

    cam, st, T_pred = runs["cam"], runs["jstate"], runs["T_pred"]
    o = tvo.VOOptions(**ORB_OPTS)
    pyr = tfe.preprocess(runs["frames"][N_FRAMES], o.n_levels)
    feats = tfe.detect_multilevel(pyr, o.detect_threshold, o.grid_cell, o.feat_budgets)
    tm = torb.track_map_orb(SHAPE, cam, T_pred, st.pt_pos, st.pt_valid, st.pt_desc, feats,
                            radius_coarse=o.orb_match_radius, max_dist=o.orb_max_hamming,
                            max_step_motion=o.max_step_motion)
    jargs = (SHAPE, jax_camera(cam), _jse3(T_pred), jnp.asarray(np32(st.pt_pos)),
             jnp.asarray(np32(st.pt_valid)), jnp.asarray(np32(st.pt_desc).view(np.uint32)),
             _jax_features(feats))
    jkw = dict(radius_coarse=o.orb_match_radius, max_dist=o.orb_max_hamming,
               max_step_motion=o.max_step_motion)
    # jit: ~3x faster than eager dispatch here.
    jtm = jax.jit(functools.partial(jorb.track_map_orb, SHAPE, **jkw))(*jargs[1:])
    dR = np.abs(np32(tm.T_cw.R) - np32(jtm.T_cw.R)).max()
    dt = np.abs(np32(tm.T_cw.t) - np32(jtm.T_cw.t)).max()
    f, jf = np32(tm.found), np32(jtm.found)
    agree = float((f == jf).mean())
    both = f & jf
    print(f"inliers {int(f.sum())} / JAX {int(jf.sum())}, agree {agree:.4f}, "
          f"pose |dR| {dR:.2e} |dt| {dt:.2e}")
    assert f.sum() >= o.min_track_inliers
    assert dR <= TOL_POSE and dt <= TOL_POSE
    assert agree >= MIN_AGREE
    assert np.array_equal(np32(tm.candidate), np32(jtm.candidate))
    assert np.abs(np32(tm.obs_px)[both] - np32(jtm.obs_px)[both]).max() <= TOL_PX


def test_vo_matches_jax(runs):
    """Both VisualOdometry classes over the first N_FRAMES frames: the same
    status on every frame, the same keyframes, camera centres within
    TOL_TRAJ, the same exported cloud size."""
    names, jnames, vo, jv = runs["names"], runs["jnames"], runs["vo"], runs["jv"]
    c = traj.camera_centers(runs["T7"])
    jc = traj.camera_centers(runs["jT7"])
    err = float(np.abs(c - jc).max())
    print(f"statuses {names}; centres {err:.2e} apart; stats {dict(vo.stats)}")
    assert names == jnames
    assert names[-1] == "GOOD" and vo.stats["keyframes"] >= 1
    assert vo.stats["keyframes"] == jv.stats["keyframes"]
    assert vo.stats["frames_good"] == jv.stats["frames_good"]
    assert err <= TOL_TRAJ
    assert vo.seeds is not None          # the depth filter ran after the keyframe
    assert vo.export_point_cloud().shape == jv.export_point_cloud().shape
    assert vo.chunk_stats["chunks"] == 0


def test_add_frames_takes_the_per_frame_path(runs):
    """An ORB VisualOdometry's chunked entry point tracks every frame
    through `add_frame` (the chunk step is SPARSE_DIRECT's), with the same
    results as the per-frame run."""
    cam, frames = runs["cam"], runs["frames"]
    vo = tvo.VisualOdometry(cam, tvo.VOOptions(**ORB_OPTS, chunk_frames=4), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        res = vo.add_frames(frames[:13], [float(k) for k in range(13)])
    assert vo.chunk_stats["chunks"] == 0
    assert [r.status.name for r in res] == runs["names"][:13]
    T7 = np.stack([p for _, p in vo.trajectory_poses(corrected=False)])
    assert np.array_equal(T7, runs["T7"][:13])


def spiked_frames(n: int = 13, spike_at: int = 10, spike: float = 0.25, horizon: int = 24):
    """tests/test_vo_types.py's second-chance sequence: test_vo's trajectory
    at horizon 24, every pose from `spike_at` on shifted `spike` m sideways
    (a ~27 px jump: outside the 15 px window, inside the widened one)."""
    cam = CAM
    scene = PlaneScene(cam, plane_z=3.0, seed=0, device="cpu")
    dT = tse3.exp(torch.tensor([spike, 0.0, 0.0, 0.0, 0.0, 0.0]))
    poses = [p if k < spike_at else dT.compose(p)
             for k, p in enumerate(mw.trajectory(n, 1.0 / (horizon - 1), "cpu"))]
    return cam, torch.stack([scene.render(T, SHAPE) for T in poses])


def test_second_chance_recovers_the_spike():
    """tests/test_vo_types.py::TestOrbSecondChance on the port: the spike
    frame is GOOD through the widened pass (>= 1 hit) and LOST without
    it."""
    cam, frames = spiked_frames()
    spike_at = 10
    vo_on = tvo.VisualOdometry(cam, tvo.VOOptions(**ORB_OPTS), device="cpu")
    st_on = [vo_on.add_frame(frames[k], float(k)).status for k in range(spike_at)]
    # The frames before the spike are the same either way: the run without
    # the pass starts from a copy of the VO there.
    vo_off = copy.deepcopy(vo_on)
    vo_off.o = tvo.VOOptions(orb_second_chance=False, **ORB_OPTS)
    st_off = list(st_on)
    for k in range(spike_at, frames.shape[0]):
        st_on.append(vo_on.add_frame(frames[k], float(k)).status)
        st_off.append(vo_off.add_frame(frames[k], float(k)).status)
    print(f"on {[s.name for s in st_on]}, hits {vo_on.stats['orb_second_chance_hits']}; "
          f"off {[s.name for s in st_off]}")
    assert st_on[spike_at] is tvo.Status.GOOD
    assert vo_on.stats["orb_second_chance_hits"] >= 1
    assert st_off[spike_at] is tvo.Status.LOST
    assert vo_off.stats["orb_second_chance_hits"] == 0


def _run_40(opts):
    cam, frames, T_gt7 = mw.make_mono_workload(40, device="cpu", shape=SHAPE, du=DU)
    vo = tvo.VisualOdometry(cam, opts, device="cpu")
    st = [vo.add_frame(frames[k], float(k)).status for k in range(40)]
    return vo, st, np.stack([p for _, p in vo.trajectory_poses(corrected=False)]), np32(T_gt7)


@pytest.mark.slow
def test_tracks_sequence():
    """tests/test_vo_types.py::TestSparseORB::test_tracks_sequence on the
    port: more than half of the 40 frames GOOD, Sim(3)-aligned ATE < 0.10
    (integer-pixel matching: looser than the direct tracker's 0.05)."""
    vo, st, T7, gt = _run_40(tvo.VOOptions(**ORB_OPTS))
    good = [k for k, s in enumerate(st) if s is tvo.Status.GOOD]
    ate = traj.ate_rmse(traj.camera_centers(T7[good]), traj.camera_centers(gt[good]))
    print(f"{len(good)} GOOD, ATE {ate:.4f}")
    assert len(good) > 20 and ate < 0.10
