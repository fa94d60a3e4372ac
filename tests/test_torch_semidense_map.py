"""Every frontend with every map type, and the SPARSE_DIRECT + SEMI_DENSE
map case, on the CPU at tests/test_vo.py's size (240x320).

- Each of the 3 x 3 `vo_type` x `map_type` combinations constructs a
  `System` (RGBD, the JAX defaults otherwise) and tracks two frames of
  tests/test_vo.py's sequence with depth through the frontend it names: the sensor start, then
  one frame through `track` (SPARSE_DIRECT), `track_orb` or `track_sd`.
- With `vo_type=SPARSE_DIRECT` and `map_type=SEMI_DENSE` the JAX
  VisualOdometry seeds a gradient-pixel set at every keyframe but never
  updates it (`semidense.update` runs only inside its `_track_sd`, which
  only SEMI_DENSE_DIRECT takes), so `export_points` (sigma < z_range /
  100) exports none of it and the exported cloud is the landmarks alone.
  The port keeps that behaviour (ROADMAP section 3, "Open, on the
  reference side"); both packages run the same 18 frames here and both
  show it."""
import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system.system import Sensor, System
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_mono_run, jax_ransac_indices, jax_vo_options, np32

torch.set_num_threads(1)

SHAPE = (240, 320)
N_FRAMES = 18              # init at 10, a keyframe at 15, two frames after it
DU = 1.0 / 39              # tests/test_vo.py's 40-frame sequence
TRACKER = {tvo.VOType.SPARSE_DIRECT: "track", tvo.VOType.SPARSE_ORB: "track_orb",
           tvo.VOType.SEMI_DENSE_DIRECT: "track_sd"}


def _rgbd_frames(n: int):
    """tests/test_vo.py's first n frames with their depth images (the
    plane's depth at every pixel).  (SyntheticDataset's texture does not
    hold SPARSE_ORB's matches from frame 0 to 1 in either package: 13
    inliers.)"""
    cam, frames, T7 = mw.make_mono_workload(n, device="cpu", shape=SHAPE, du=DU)
    scene = PlaneScene(cam, plane_z=3.0, seed=0, device="cpu")
    ys, xs = torch.meshgrid(torch.arange(SHAPE[0]), torch.arange(SHAPE[1]), indexing="ij")
    px = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(torch.float32)
    return [(frames[k], scene.depth(px, SE3.from_params7(T7[k])).reshape(SHAPE))
            for k in range(n)]


@pytest.mark.parametrize("map_type", list(tvo.MapType), ids=lambda m: m.name)
@pytest.mark.parametrize("vo_type", list(tvo.VOType), ids=lambda v: v.name)
def test_every_frontend_and_map_type_tracks(vo_type, map_type, monkeypatch):
    """System(sensor=RGBD) with the combination: frame 0 starts the map
    (GOOD), frame 1 goes through the frontend's tracker and is GOOD; a
    gradient-pixel set exists exactly where the JAX package keeps one
    (SEMI_DENSE_DIRECT or the SEMI_DENSE map), a DENSE cloud where the map
    is DENSE, and the exported cloud holds the landmarks."""
    cam, _, _ = mw.make_mono_workload(1, device="cpu", shape=SHAPE, du=DU)
    calls = []
    for name in set(TRACKER.values()):
        real = getattr(tvo, name)
        monkeypatch.setattr(tvo, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    s = System(camera=cam, sensor=Sensor.RGBD,
               options=tvo.VOOptions(vo_type=vo_type, map_type=map_type, **mw.VO_OPTS),
               device="cpu")
    res = [s.track_rgbd(img, depth, float(k)) for k, (img, depth) in enumerate(_rgbd_frames(2))]
    s.shutdown()
    vo = s.vo
    print(f"{vo_type.name} x {map_type.name}: {[r.status.name for r in res]}, inliers "
          f"{res[1].n_inliers}, trackers {calls}")
    assert [r.status for r in res] == [tvo.Status.GOOD, tvo.Status.GOOD]
    assert calls == [TRACKER[vo_type]]
    wants_sd = vo_type is tvo.VOType.SEMI_DENSE_DIRECT or map_type is tvo.MapType.SEMI_DENSE
    assert (vo.sd is not None) == wants_sd
    assert len(vo.dense_cloud) == (1 if map_type is tvo.MapType.DENSE else 0)
    assert vo.export_point_cloud().shape[0] >= int(vo.server.state.pt_valid.sum()) > 0


@pytest.fixture(scope="module")
def quirk_runs():
    """Both VisualOdometry classes with SPARSE_DIRECT and the SEMI_DENSE map
    over N_FRAMES frames, the port with the JAX package's RANSAC draw."""
    cam, frames, _ = mw.make_mono_workload(40, device="cpu", shape=SHAPE, du=DU)
    opts = tvo.VOOptions(map_type=tvo.MapType.SEMI_DENSE, **mw.VO_OPTS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        vo = tvo.VisualOdometry(cam, opts, device="cpu")
        names = [vo.add_frame(frames[k], float(k)).status.name for k in range(N_FRAMES)]
    jnames, _, _, jv = jax_mono_run(cam, frames[:N_FRAMES], jax_vo_options(opts))
    return names, vo, jnames, jv


def test_sparse_direct_with_semidense_map_exports_landmarks_only(quirk_runs):
    """Both VisualOdometry classes with SPARSE_DIRECT and the SEMI_DENSE map
    over N_FRAMES frames: the same statuses; in both a gradient-pixel set on
    the last keyframe whose seeds still hold their prior (never updated),
    and an exported cloud equal to the landmarks alone, of the same size."""
    names, vo, jnames, jv = quirk_runs
    cloud, jcloud = vo.export_point_cloud(), jv.export_point_cloud()
    m = vo.server.state
    landmarks = np32(m.pt_pos)[np32(m.pt_valid)]
    jm = jv.server.state
    jlandmarks = np.asarray(jm.pt_pos)[np.asarray(jm.pt_valid)]
    print(f"statuses {names}; cloud {cloud.shape[0]} (JAX {jcloud.shape[0]}), landmarks "
          f"{landmarks.shape[0]} (JAX {jlandmarks.shape[0]}), keyframes {vo.stats['keyframes']}")
    assert names == jnames and names[-1] == "GOOD" and vo.stats["keyframes"] >= 1
    for v, c, lm in ((vo, cloud, landmarks), (jv, jcloud, jlandmarks)):
        assert v.sd is not None and int(v.sd.kf_slot) == v.last_kf_slot
        s = v.sd.seeds               # the Beta prior (10, 10) untouched by any update
        assert (np.asarray(s.a) == 10.0).all() and (np.asarray(s.b) == 10.0).all()
        assert np.asarray(s.valid).sum() > 0
        assert v.semidense_cloud == []
        assert np.array_equal(c, lm)
    assert cloud.shape == jcloud.shape
