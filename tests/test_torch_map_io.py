"""The map file (`System.save_map` / `load_map`) and the vocabulary swap
(`VisualOdometry.set_vocabulary`, `refresh_vocabulary`) on the CPU.

- A port-written map (RGBD with the DENSE cloud, the vocabulary and archive
  rows: every key of the layout) loads into the JAX package's `System`,
  which writes it again, and that file into the port, which writes it a
  third time: the three files hold the same keys and arrays, bit for bit,
  with the JAX package's dtypes (uint32 descriptors and vocabulary nodes).
- Ports of tests/test_system.py's `test_resume_from_saved_map` and
  `test_save_trajectory_and_map`, tests/test_archive.py's
  `test_archive_survives_save_load` (every archive array equal, not only
  the poses) and tests/test_vocab_persistence.py's
  `test_load_map_relocalizes_under_foreign_bootstrap_vocab` and
  `test_refresh_keeps_relocalization_working` (on a loaded map with archive
  rows), with the JAX tests' gates.
- `set_vocabulary(recompute=True)` on one map and one vocabulary in both
  packages: the window's BoW rows and nodes and the archive's, within
  TOL_BOW and equal."""
import numpy as np
import pytest
import torch

from ygz_slam_tpu.models import visual_odometry as jvo
from ygz_slam_tpu.map import vocabulary as jvoc
from ygz_slam_tpu.system import system as jsys

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.map import vocabulary as voc
from ygz_slam_tpu_torch.models import archive_workload as aw
from ygz_slam_tpu_torch.models import frontend as fe
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.system.system import Sensor, System
from ygz_slam_tpu_torch.utils.datasets import SyntheticDataset
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_camera, jax_vo_options

torch.set_num_threads(1)

CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
SHAPE = (240, 320)
TOL_BOW = 1e-6          # BoW rows (L1-normalised tf-idf) against the JAX package's
# tests/test_system.py::test_resume_from_saved_map's options.
RESUME_OPTS = tvo.VOOptions(init_min_disparity=15.0, kf_min_frames=4, kf_max_trans=0.03,
                            kf_max_rot=0.04)
# The round-trip map: RGBD with the DENSE cloud, a 4-slot window (archive
# rows) and a fast keyframe cadence.
FULL_OPTS = tvo.VOOptions(kf_min_frames=3, kf_max_trans=0.05, map_K=4,
                          map_type=tvo.MapType.DENSE)


def _mono_frames(seed: int, n: int, motion):
    """PlaneScene `seed` renders along motion(t) -> twist, t = k / (n - 1)."""
    scene = PlaneScene(CAM, plane_z=3.0, seed=seed, device="cpu")
    return [scene.render(tse3.exp(torch.tensor(np.asarray(motion(k / (n - 1)), np.float32))),
                         SHAPE) for k in range(n)]


@pytest.fixture(scope="module")
def mono_map(tmp_path_factory):
    """test_resume_from_saved_map's System A over its 22 frames, its map
    saved: (System, frames, path)."""
    imgs = _mono_frames(31, 22, lambda t: [1.0 * t, 0.15 * np.sin(2 * t), 0.25 * t,
                                           0.02 * np.sin(3 * t), -0.14 * t, 0.02 * t])
    s = System(camera=CAM, sensor=Sensor.MONOCULAR, options=RESUME_OPTS, device="cpu")
    for k, img in enumerate(imgs):
        s.track_monocular(img, float(k))
    path = str(tmp_path_factory.mktemp("mono") / "resume.npz")
    s.save_map(path)
    return s, imgs, path


@pytest.fixture(scope="module")
def archive_map(tmp_path_factory):
    """test_archive_survives_save_load's System: the first 30 frames of the
    60-frame out-and-back sweep with ARC_OPTS, its map saved."""
    cam, frames, _ = aw.out_and_back_frames(SHAPE, n=60, device="cpu")
    s = System(camera=cam, options=aw.loop_options(), device="cpu")
    for k in range(30):
        s.track_monocular(frames[k], float(k))
    path = str(tmp_path_factory.mktemp("arc") / "map.npz")
    s.save_map(path)
    return s, frames, path


def _arrays(path: str) -> dict:
    with np.load(path) as f:
        return dict(f)


def test_map_file_round_trips_through_jax(tmp_path):
    ds = SyntheticDataset(CAM, n_frames=16, shape=SHAPE, with_depth=True, motion_scale=0.5,
                          device="cpu")
    s = System(camera=CAM, sensor=Sensor.RGBD, options=FULL_OPTS, device="cpu")
    for fd in ds:
        s.track_rgbd(fd.gray, fd.depth, fd.timestamp)
    p1, p2, p3 = (str(tmp_path / f"map{i}.npz") for i in (1, 2, 3))
    s.save_map(p1)
    sj = jsys.System(camera=jax_camera(CAM), sensor=jsys.Sensor.RGBD,
                     options=jvo.VOOptions(**jax_vo_options(FULL_OPTS)))
    sj.load_map(p1)
    assert np.asarray(sj.vo.server.state.feat_desc).dtype == np.uint32
    sj.save_map(p2)
    s3 = System(camera=CAM, sensor=Sensor.RGBD, options=FULL_OPTS, device="cpu")
    s3.load_map(p2)
    s3.save_map(p3)
    a1, a2, a3 = _arrays(p1), _arrays(p2), _arrays(p3)
    print(f"round trip port -> JAX -> port: {len(a1)} arrays ({sum(v.nbytes for v in a1.values())} "
          f"bytes), archive rows {s.vo.archive.count}, aux cloud {a1['__aux_cloud'].shape}; "
          f"descriptors {a1['feat_desc'].dtype}, vocabulary nodes {a1['__vocab_nodes_0'].dtype}")
    assert s.vo.archive.count > 0 and "__aux_cloud" in a1 and "__vocab_meta" in a1
    assert set(a1) == set(a2) == set(a3)
    for k in a1:
        assert a1[k].dtype == a2[k].dtype == a3[k].dtype, k
        assert np.array_equal(a1[k], a2[k]) and np.array_equal(a1[k], a3[k]), k
    assert a1["feat_desc"].dtype == a1["pt_desc"].dtype == a1["__arc_desc"].dtype == np.uint32
    assert a1["__vocab_nodes_0"].dtype == np.uint32 and a1["kf_valid"].dtype == np.bool_


def test_resume_from_saved_map(mono_map):
    """System B loads A's map and resumes by relocalizing: the frame of its
    third keyframe GOOD, the next GOOD with > 50 inliers."""
    sa, imgs, path = mono_map
    assert sa.status is tvo.Status.GOOD
    sb = System(camera=CAM, sensor=Sensor.MONOCULAR, options=RESUME_OPTS, device="cpu")
    sb.load_map(path)
    kf_fid = int(sb.vo.server.state.kf_id[sb.vo.server.kf_used[2]])
    r1 = sb.track_monocular(imgs[kf_fid], 100.0)
    r2 = sb.track_monocular(imgs[kf_fid + 1], 101.0)
    print(f"resume at frame {kf_fid}: {r1.status.name} ({r1.n_inliers} inliers), then "
          f"{r2.status.name} ({r2.n_inliers}); relocalizations {sb.vo.stats['relocalizations']}")
    assert r1.status is tvo.Status.GOOD
    assert r2.status is tvo.Status.GOOD and r2.n_inliers > 50
    assert sb.vo.stats["relocalizations"] == 1


def test_save_trajectory_and_map(tmp_path):
    ds = SyntheticDataset(CAM, n_frames=14, shape=SHAPE, with_depth=True, motion_scale=0.5,
                          device="cpu")
    s = System(camera=CAM, sensor=Sensor.RGBD,
               options=tvo.VOOptions(kf_min_frames=5, kf_max_trans=0.05), device="cpu")
    for fd in ds:
        s.track_rgbd(fd.gray, fd.depth, fd.timestamp)
    tpath, mpath = str(tmp_path / "traj.txt"), str(tmp_path / "map.npz")
    s.save_trajectory(tpath)
    s.save_map(mpath)
    stamps, _ = traj.load_tum(tpath)
    s2 = System(camera=CAM, sensor=Sensor.RGBD, options=tvo.VOOptions(kf_min_frames=5),
                device="cpu")
    s2.load_map(mpath)
    m1, m2 = s.vo.server.state, s2.vo.server.state
    assert len(stamps) >= 12
    assert int(m2.pt_valid.sum()) == int(m1.pt_valid.sum())
    assert torch.equal(m2.kf_pose7, m1.kf_pose7)
    assert s2.vo.server.kf_used == s.vo.server.kf_used
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))


def test_archive_survives_save_load(archive_map):
    s1, _, path = archive_map
    s2 = System(camera=s1.vo.cam, options=aw.loop_options(), device="cpu")
    s2.load_map(path)
    print(f"archive: {s1.vo.archive.count} rows saved, {s2.vo.archive.count} loaded")
    assert s1.vo.archive.count > 0 and s2.vo.archive.count == s1.vo.archive.count
    np.testing.assert_array_equal(s2.vo.archive.poses7(), s1.vo.archive.poses7())
    d1, d2 = s1.vo.archive.state_dict(), s2.vo.archive.state_dict()
    assert set(d1) == set(d2) and all(np.array_equal(d1[k], d2[k]) for k in d1)
    assert s2.vo.kf_pose_log.keys() >= set(int(f) for f in s1.vo.archive.frame_ids())


def _random_vocab(seed: int):
    """tests/test_vocab_persistence.py's `train_random_vocab`."""
    rng = np.random.default_rng(seed)
    return voc.train(rng.integers(0, 2 ** 32, size=(600, 8), dtype=np.uint32), k=8, depth=3,
                     iters=2, seed=seed, device="cpu")


def test_load_map_relocalizes_under_foreign_bootstrap_vocab(mono_map, monkeypatch):
    """A process whose own vocabulary is unrelated loads the map: the map's
    vocabulary replaces it, and a query at the newest keyframe's frame
    relocalizes."""
    sa, imgs, path = mono_map
    q_fid = int(sa.vo.server.state.kf_id[sa.vo.server.kf_used[-1]])
    foreign = _random_vocab(99)
    monkeypatch.setattr(tvo, "_shared_vocabulary", lambda *a, **kw: foreign)
    sb = System(camera=CAM, sensor=Sensor.MONOCULAR, options=RESUME_OPTS, device="cpu")
    assert sb.vo.vocab is foreign
    sb.load_map(path)
    assert all(torch.equal(a, b) for a, b in zip(sb.vo.vocab.nodes, sa.vo.vocab.nodes))
    r = sb.track_monocular(imgs[q_fid], 99.0)
    print(f"relocalization under the map's vocabulary at frame {q_fid}: {r.status.name}, "
          f"{r.n_inliers} inliers")
    assert r.status is tvo.Status.GOOD and r.n_inliers >= sb.vo.o.reloc_min_inliers


def test_refresh_keeps_relocalization_working(archive_map):
    """The vocabulary retrained on a loaded map's window and archive: it
    changes, the BoW rows follow it, and a query at the newest keyframe's
    frame still relocalizes."""
    s1, frames, path = archive_map
    s = System(camera=s1.vo.cam, options=aw.loop_options(), device="cpu")
    s.load_map(path)
    vo = s.vo
    old = [n.clone() for n in vo.vocab.nodes]
    assert vo.refresh_vocabulary(min_descriptors=100)
    assert vo.stats["vocab_refreshes"] == 1
    assert any(not torch.equal(a, b) for a, b in zip(vo.vocab.nodes, old))
    assert vo.archive.W == vo.vocab.n_words == vo.kf_bow.shape[1]
    q_fid = int(vo.server.state.kf_id[vo.server.kf_used[-1]])
    vo.frame_id = q_fid
    r = vo._try_relocalize(fe.preprocess(frames[q_fid], vo.o.n_levels))
    print(f"after the refresh ({vo.vocab.n_words} words): relocalization at frame {q_fid} "
          f"{'succeeded' if r is not None else 'failed'}")
    assert r is not None


def test_set_vocabulary_matches_jax(archive_map):
    """One map (the archive run's file) and one vocabulary in both
    packages: set_vocabulary(recompute=True) gives the same BoW rows and
    nodes, in the window and in the archive."""
    s1, _, path = archive_map
    vocab = _random_vocab(7)
    s = System(camera=s1.vo.cam, options=aw.loop_options(), device="cpu")
    s.load_map(path)
    s.vo.set_vocabulary(vocab, recompute=True)
    sj = jsys.System(camera=jax_camera(s1.vo.cam),
                     options=jvo.VOOptions(**jax_vo_options(aw.loop_options())))
    sj.load_map(path)
    sj.vo.set_vocabulary(jvoc.from_state_dict(voc.state_dict(vocab)), recompute=True)
    d_bow = float(np.abs(s.vo.kf_bow.numpy() - np.asarray(sj.vo.kf_bow)).max())
    arc, arc_j = s.vo.archive.state_dict(), sj.vo.archive.state_dict()
    d_arc = float(np.abs(arc["__arc_bow"] - arc_j["__arc_bow"]).max())
    print(f"set_vocabulary: window BoW rows within {d_bow:.3e}, archive rows "
          f"({len(arc_j['__arc_bow'])}) within {d_arc:.3e} (tolerance {TOL_BOW}); nodes equal")
    assert d_bow <= TOL_BOW and d_arc <= TOL_BOW
    assert np.array_equal(s.vo.kf_nodes.numpy(), np.asarray(sj.vo.kf_nodes))
    assert np.array_equal(arc["__arc_nodes"], arc_j["__arc_nodes"])
