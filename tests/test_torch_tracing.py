"""The port's span recorder (`utils/profiling.span`, `tracing`,
`current_span`) and the spans at its layer boundaries, on the CPU:

- with no `tracing()` open, `span` hands back one shared object that reads
  no clock and records nothing;
- inside it, nested spans carry their parent's id and frame, the thread's
  name, and a span on a worker thread links to the span given as its cause;
- a VisualOdometry run with async mapping (tests/test_async_mapping.py's
  40-frame run, cut to 24: keyframes at frames 15 and 20) records the frame
  path's stages, each keyframe's mapping pass on the `ygz-mapping` thread
  under its insertion, and the next frame's join, and returns the same
  poses, bit for bit, as the run with nothing recorded;
- one `track_batch_step` records the batch step's four stages."""
import contextlib
import threading
import time

import pytest
import torch

from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import batch as bm
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 24
SHAPE = (240, 320)
FRAME_CHILDREN = {"join_mapping", "preprocess", "track", "update_seeds", "keyframe_due",
                  "insert_keyframe", "pose_fetch"}
PASS_CHILDREN = {"loop_block", "local_ba", "archive_loop", "mapping_fetch", "cull_keyframes"}


def test_off_records_nothing_and_returns_one_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with nothing recording")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    a, b = profiling.span("a", frame=1), profiling.span("b", parent=7)
    assert a is b
    with a as entered:
        with b:
            assert profiling.current_span() is None
    assert entered is a and a.id is None


def test_nested_spans_and_a_worker_span_with_its_cause(monkeypatch):
    def no_sync(*args, **kwargs):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with profiling.tracing() as rec:
        with profiling.span("outer", frame=3) as outer:
            with profiling.span("inner") as inner:
                assert profiling.current_span() is inner
            cause = profiling.current_span()

            def work():
                with profiling.span("caused", parent=cause):
                    with profiling.span("under"):
                        pass
                with profiling.span("root"):
                    pass

            th = threading.Thread(target=work, name="worker")
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        with profiling.tracing() as inside:
            with profiling.span("nested_tracing"):
                pass
        with profiling.span("after"):
            pass
    assert profiling.span("x") is profiling.span("y") and profiling.current_span() is None
    assert [r.name for r in inside] == ["nested_tracing"]
    by = {r.name: r for r in rec}
    assert [r.name for r in rec] == ["inner", "under", "caused", "root", "outer", "after"]
    assert cause is outer and by["outer"].id == outer.id and by["outer"].parent is None
    assert by["inner"].parent == outer.id and by["inner"].frame == 3
    assert by["caused"].parent == outer.id and by["caused"].frame == 3
    assert by["under"].parent == by["caused"].id and by["under"].frame == 3
    assert by["root"].parent is None and by["root"].frame is None
    assert by["after"].parent is None
    assert {r.thread for r in rec if r.name in ("caused", "under", "root")} == {"worker"}
    assert {r.thread for r in rec if r.name in ("outer", "inner", "after")} == {"MainThread"}
    assert by["caused"].tid != by["outer"].tid
    for r in rec:
        assert r.t0 <= r.t1
    assert by["outer"].t0 <= by["inner"].t0 and by["inner"].t1 <= by["outer"].t1


def _run_vo(workload, traced: bool):
    cam, frames, _ = workload
    vo = tvo.VisualOdometry(cam, tvo.VOOptions(**mw.VO_OPTS), device="cpu")
    with profiling.tracing() if traced else contextlib.nullcontext() as rec:
        poses = [vo.add_frame(frames[k], float(k)).T_cw.params7() for k in range(N)]
        vo._join_mapping()
    return vo, torch.stack(poses), rec


@pytest.fixture(scope="module")
def vo_runs():
    workload = mw.make_mono_workload(N, device="cpu", shape=SHAPE, du=1.0 / 39)
    return _run_vo(workload, traced=True), _run_vo(workload, traced=False)


def test_vo_poses_bit_equal_with_tracing_on_and_off(vo_runs):
    (vo_on, poses_on, _), (vo_off, poses_off, _) = vo_runs
    assert vo_on.stats["keyframes"] >= 2
    assert torch.equal(poses_on, poses_off)
    assert dict(vo_on.stats) == dict(vo_off.stats)


def test_vo_spans_name_and_nest_the_stages(vo_runs):
    (vo, _, rec), _ = vo_runs
    by_id = {r.id: r for r in rec}

    def children(r):
        return [c for c in rec if c.parent == r.id]

    frames = [r for r in rec if r.name == "frame"]
    assert [r.frame for r in frames] == list(range(N))
    assert all(r.parent is None and r.thread == "MainThread" for r in frames)
    for f in frames:
        names = [c.name for c in children(f)]
        assert set(names) <= FRAME_CHILDREN and {"preprocess", "pose_fetch"} <= set(names)
        assert all(c.frame == f.frame and c.thread == "MainThread" for c in children(f))
    tracks = [r for r in rec if r.name == "track"]
    assert tracks and all(by_id[t.parent].name == "frame" for t in tracks)
    for t in tracks:
        assert [c.name for c in children(t)] == ["sparse_align", "visible_patches", "local_map"]
    seeds = [r for r in rec if r.name == "update_seeds"]
    assert seeds and all(by_id[s.parent].name == "frame" for s in seeds)

    inserts = [r for r in rec if r.name == "insert_keyframe"]
    passes = [r for r in rec if r.name == "mapping_pass"]
    assert len(inserts) == len(passes) == vo.stats["keyframes"] >= 2
    for ins in inserts:
        assert by_id[ins.parent].name == "frame"
        assert [c.name for c in children(ins)] == ["kf_cycle", "kf_fetch", "mapping_pass"]
        mp = [p for p in passes if p.parent == ins.id]
        assert len(mp) == 1 and mp[0].thread == "ygz-mapping" and mp[0].frame == ins.frame
        names = {c.name for c in children(mp[0])}
        assert {"local_ba", "mapping_fetch", "cull_keyframes"} <= names <= PASS_CHILDREN
        assert all(c.thread == "ygz-mapping" and c.frame == ins.frame for c in children(mp[0]))
        # The next frame joins the pass first.
        nxt = [f for f in frames if f.frame == ins.frame + 1]
        if nxt:
            kids = children(nxt[0])
            joins = [c for c in kids if c.name == "join_mapping"]
            assert len(joins) == 1 and min(c.t0 for c in kids) == joins[0].t0
            assert joins[0].t1 >= mp[0].t1
    assert any(r.name == "loop_block" for r in rec)


def test_batch_step_spans():
    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, _ = bm.make_batch_workload(
        2, 2, device="cpu")
    st = bm.make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches)
    with profiling.tracing() as rec:
        T7, n_inl = bm.track_batch_step(st, SE3.identity((2,), device="cpu").params7(), frames[1])
    assert T7.shape == (2, 7) and n_inl.shape == (2,)
    by = {r.name: r for r in rec}
    assert [r.name for r in rec] == ["batch_pyramid", "batch_sparse_align", "batch_align2d",
                                     "batch_pose_ba", "batch_step"]
    assert by["batch_step"].parent is None
    assert all(by[n].parent == by["batch_step"].id for n in by if n != "batch_step")
