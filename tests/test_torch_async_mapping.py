"""Async mapping in the port (`VOOptions.async_mapping`, the JAX default):
the keyframe's mapping pass (loop closing, local BA, culling) runs on a
worker thread, and every consumer of the state joins it first.  The port
alone on the CPU, on tests/test_async_mapping.py's run (test_vo.py's
trajectory over PlaneScene seed 0, 40 frames 240x320, `VO_OPTS` with the
JAX defaults: the depth filter, the vocabulary, the archive, loop closing):

- sync and async give the same trajectory (corrected and as tracked),
  keyframe poses and landmarks, bit for bit, per frame and chunked (a
  chunk starts only after the join);
- the keyframe's `add_frame` returns while its pass is in flight, made
  deterministic by holding the pass on a `threading.Event`;
- an exception in the worker is re-raised at the next `add_frame`;
- `System.shutdown` and `System.export_point_cloud` join."""
import threading

import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.system.system import System

torch.set_num_threads(1)

N = 40
SHAPE = (240, 320)


def options(async_mapping: bool):
    return tvo.VOOptions(**mw.VO_OPTS, async_mapping=async_mapping)


@pytest.fixture(scope="module")
def workload():
    return mw.make_mono_workload(N, device="cpu", shape=SHAPE, du=1.0 / (N - 1))


def run(workload, async_mapping: bool, chunk: int | None = None):
    cam, frames, _ = workload
    vo = tvo.VisualOdometry(cam, options(async_mapping), device="cpu")
    if chunk:
        vo.add_frames(frames, [float(k) for k in range(N)], chunk=chunk)
    else:
        for k in range(N):
            vo.add_frame(frames[k], float(k))
    return vo


def fingerprint(vo) -> tuple:
    corrected = vo.trajectory_poses()
    tracked = vo.trajectory_poses(corrected=False)
    m = vo.server.state
    return ([ts for ts, _ in corrected], np.stack([p for _, p in corrected]),
            np.stack([p for _, p in tracked]), m.kf_pose7.numpy().copy(), m.pt_pos.numpy().copy(),
            dict(vo.stats))


@pytest.fixture(scope="module")
def sync_run(workload):
    return fingerprint(run(workload, False))


def assert_equal_runs(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:5], b[1:5]):
        np.testing.assert_array_equal(x, y)
    assert a[5] == b[5]


@pytest.mark.parametrize("chunk", [None, 6], ids=["per_frame", "chunked"])
def test_async_mapping_parity(workload, sync_run, chunk):
    vo = run(workload, True, chunk)
    fp = fingerprint(vo)
    print(f"{'chunked' if chunk else 'per frame'}: {vo.stats['keyframes']} keyframes, "
          f"stats {dict(vo.stats)}, chunks {dict(vo.chunk_stats)}")
    assert vo.stats["keyframes"] >= 3
    assert_equal_runs(fp, sync_run)
    assert vo._map_thread is None


def test_async_mapping_returns_before_pass_completes(workload):
    """The keyframe's add_frame hands control back with the pass still in
    flight: the first keyframe's pass is held on an event, the worker is
    alive when add_frame returns, and the next add_frame joins it."""
    cam, frames, _ = workload
    vo = tvo.VisualOdometry(cam, options(True), device="cpu")
    entered, release = threading.Event(), threading.Event()
    real = vo._keyframe_mapping_pass

    def held(slot, kf_fid):
        entered.set()
        release.wait(timeout=120)
        return real(slot, kf_fid)

    vo._keyframe_mapping_pass = held
    seen = None
    for k in range(N):
        n_kf = vo.stats["keyframes"]
        vo.add_frame(frames[k], float(k))
        if vo.stats["keyframes"] > n_kf and seen is None:
            th = vo._map_thread
            assert entered.wait(timeout=60)
            seen = (k, th is not None and th.is_alive())
            del vo._keyframe_mapping_pass         # later keyframes run unheld
            release.set()
    release.set()
    vo.trajectory_poses()
    print(f"keyframe at frame {seen[0]}: pass in flight after add_frame returned: {seen[1]}")
    assert seen is not None and seen[1]
    assert vo._map_thread is None and vo.stats["keyframes"] >= 2


def test_worker_exception_reraised_at_next_add_frame(workload):
    cam, frames, _ = workload
    vo = tvo.VisualOdometry(cam, options(True), device="cpu")

    def fails(slot, kf_fid):
        raise RuntimeError("mapping pass failed")

    vo._keyframe_mapping_pass = fails
    k = 0
    while vo.stats["keyframes"] == 0:
        vo.add_frame(frames[k], float(k))      # the keyframe's frame returns
        k += 1
    with pytest.raises(RuntimeError, match="mapping pass failed"):
        vo.add_frame(frames[k], float(k))
    assert vo._map_thread is None and vo._map_exc is None


def test_system_shutdown_and_export_point_cloud_join(workload):
    cam, frames, _ = workload
    s = System(camera=cam, options=options(True), device="cpu")
    kf_frame = None
    for k in range(N):
        n_kf = s.vo.stats["keyframes"]
        s.track_monocular(frames[k], float(k))
        if s.vo.stats["keyframes"] > n_kf:
            kf_frame = k
            break
    assert kf_frame is not None
    cloud = s.export_point_cloud()
    assert s.vo._map_thread is None
    m = s.vo.server.state
    np.testing.assert_array_equal(cloud, m.pt_pos[m.pt_valid].numpy())
    assert cloud.shape == (int(m.pt_valid.sum()), 3) and np.isfinite(cloud).all()
    s.track_monocular(frames[kf_frame + 1], float(kf_frame + 1))
    s.shutdown()
    assert s.vo._map_thread is None


def test_default_options_construct_and_track(workload):
    """`VisualOdometry(cam, VOOptions())` and `System(camera=cam)`, the JAX
    package's defaults unchanged (the archive loops and async mapping on),
    construct and track: GOOD from initialisation to the last frame, with
    keyframes whose passes ran on the worker."""
    cam, frames, _ = workload
    assert tvo.VisualOdometry(cam, tvo.VOOptions(), device="cpu").o == tvo.VOOptions()
    s = System(camera=cam, device="cpu")
    st = [s.track_monocular(frames[k], float(k)).status for k in range(N)]
    s.shutdown()
    k0 = st.index(tvo.Status.GOOD)
    print(f"init at frame {k0}, stats {dict(s.vo.stats)}")
    assert s.vo.o == tvo.VOOptions() and s.vo.archive is not None and s.vo.vocab is not None
    assert all(x is tvo.Status.GOOD for x in st[k0:]) and s.vo.stats["keyframes"] >= 1
    assert s.export_point_cloud().shape[0] > 0
