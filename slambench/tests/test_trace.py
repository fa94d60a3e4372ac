"""The trace reduction and the metric readers on synthetic runs."""
import importlib.util
from pathlib import Path

import pytest

from slambench import trace
from slambench.run import Run

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name.replace('.', '_')}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# Device intervals (ns on the profiler's clock, 1000 ns ahead of the host's).
OFFSET = 1000
INTERVALS = [("k_a", 1100, 1300), ("k_b", 1250, 1400), ("Memcpy HtoD", 1600, 1700),
             ("k_a", 1900, 2050), ("k_c", 2500, 3200)]
SPANS = [("ordinary", 0, 500, 1), ("keyframe", 500, 1200, 1), ("after_keyframe", 1200, 1900, 1)]


def test_merge():
    assert trace.merge(INTERVALS, 1000, 3000) == [(1100, 1400), (1600, 1700), (1900, 2050),
                                                  (2500, 3000)]


def test_reduce_busy_idle_and_names():
    t = trace.reduce(INTERVALS, 0, 2000, OFFSET, SPANS)
    assert t.window_ns == 2000
    assert t.busy_ns == 300 + 100 + 150 + 500
    assert t.kernels == 4
    assert t.ops[0] == ["k_c", 500 / 1e9]
    idle = dict(t.idle_by_span)
    # Gaps (host ns): [0, 100) ordinary, [400, 600) keyframe, [700, 900)
    # keyframe, [1050, 1500) after_keyframe.
    assert idle == {"ordinary": 100 / 1e9, "keyframe": 400 / 1e9,
                    "after_keyframe": 450 / 1e9}
    assert t.longest_gaps[0] == ["after_keyframe", 450 / 1e9]


def test_gap_outside_spans_is_the_harness():
    t = trace.reduce([("k", 1000, 1100)], 0, 1000, OFFSET, [])
    assert t.idle_by_span == [["harness", 900 / 1e9]]


def _run(**kw):
    base = dict(cfg={}, setup_s=12.5, window_s=2.0, spans=[], frames=0,
                counters={})
    base.update(kw)
    return Run(**base)


def test_frame_readers():
    spans = [("ordinary", 0, 10_000_000, 1), ("keyframe", 0, 50_000_000, 1),
             ("after_keyframe", 0, 150_000_000, 1), ("ordinary", 0, 20_000_000, 1)]
    run = _run(spans=spans, frames=4, counters={"frames": 4, "keyframes": 1})
    assert reader("frames_per_s")(run) == 2.0
    assert reader("setup_s")(run) == 12.5
    assert reader("ordinary_frame_ms")(run) == pytest.approx(15.0)
    assert reader("keyframe_frame_ms")(run) == pytest.approx(100.0)
    assert reader("keyframes_per_100_frames")(run) == 25.0
    assert reader("frame_latency_p95_ms.wall_scan")(run) == pytest.approx(135.0)
    assert reader("keyframes_per_100_frames")(_run(frames=4, counters={"frames": 4})) == 0.0
    assert reader("keyframes_per_100_frames")(_run(frames=4, counters={"steps": 1})) is None
    for name in ("device_kernels_per_frame", "device_idle_share", "fleet_step_roofline",
                 "step_enqueue_ms"):
        assert reader(name)(run) is None


def test_trace_readers():
    t = trace.reduce(INTERVALS, 0, 2000, OFFSET, SPANS)
    run = _run(spans=SPANS, frames=3, trace=t)
    assert reader("device_idle_share")(run) == pytest.approx(1 - 1050 / 2000)
    assert reader("device_kernels_per_frame")(run) == pytest.approx(4 / 3)


def test_fleet_readers():
    cfg = {"streams": 16, "landmarks": 200, "shape": [480, 640], "levels": 3}
    t = trace.Trace(window_ns=10 ** 9, busy_ns=10 ** 8, kernels=1000)
    run = _run(cfg=cfg, spans=[("step", 0, 1, 16)] * 100, frames=1600,
               counters={"steps": 100}, enqueue_ns=[2_000_000, 4_000_000], trace=t)
    assert reader("step_enqueue_ms")(run) == pytest.approx(3.0)
    share = reader("fleet_step_roofline")(run)
    assert 0.0 < share < 100.0
    assert reader("device_kernels_per_frame")(run) == pytest.approx(1000 / 1600)
