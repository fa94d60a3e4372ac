"""The reduction of a traced window by the program's spans
(`slambench.spans`) and the metric readers that read `program_span`, on
synthetic runs."""
import importlib.util
from pathlib import Path

import pytest

from slambench import spans, trace
from slambench.run import Run
from ygz_slam_tpu_torch.utils.profiling import SpanRecord

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MAIN, MAPPING = (1, "MainThread"), (2, "ygz-mapping")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name.replace('.', '_')}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rec(i, parent, name, thread, t0, t1, frame=None):
    tid, th = thread
    return SpanRecord(i, parent, name, th, tid, frame, t0, t1)


# test_trace.py's window: device intervals on the profiler's clock, 1000 ns
# ahead of the host's; gaps (host ns) [0, 100), [400, 600), [700, 900),
# [1050, 1500).
OFFSET = 1000
INTERVALS = [("k_a", 1100, 1300), ("k_b", 1250, 1400), ("Memcpy HtoD", 1600, 1700),
             ("k_a", 1900, 2050), ("k_c", 2500, 3200)]
SPANS = [("ordinary", 0, 500, 1), ("keyframe", 500, 1200, 1), ("after_keyframe", 1200, 1900, 1)]
PROGRAM = [
    rec(1, None, "frame", MAIN, 10, 490, 0), rec(2, 1, "track", MAIN, 20, 300),
    rec(3, 1, "update_seeds", MAIN, 300, 480),
    rec(4, None, "frame", MAIN, 510, 1190, 1), rec(5, 4, "insert_keyframe", MAIN, 700, 1000),
    rec(6, 5, "kf_cycle", MAIN, 700, 950),
    rec(7, 5, "mapping_pass", MAPPING, 1000, 1590, 1), rec(8, 7, "loop_block", MAPPING, 1000, 1400),
    rec(9, None, "frame", MAIN, 1210, 1890, 2), rec(10, 9, "join_mapping", MAIN, 1210, 1600),
]


def test_without_program_spans_it_is_trace_reduce():
    assert spans.reduce(INTERVALS, 0, 2000, OFFSET, SPANS) == trace.reduce(
        INTERVALS, 0, 2000, OFFSET, SPANS)
    assert spans.reduce(INTERVALS, 0, 2000, OFFSET, SPANS, program=[]) == trace.reduce(
        INTERVALS, 0, 2000, OFFSET, SPANS)


def test_gaps_are_named_by_the_callers_innermost_span():
    t = spans.reduce(INTERVALS, 0, 2000, OFFSET, SPANS, program=PROGRAM)
    base = trace.reduce(INTERVALS, 0, 2000, OFFSET, SPANS)
    assert (t.window_ns, t.busy_ns, t.kernels, t.ops) == (base.window_ns, base.busy_ns,
                                                          base.kernels, base.ops)
    # The gap at 500 falls between two frames: its benchmark label alone.
    # The one at 1275 is the caller's join, not the mapping thread's loop.
    assert dict(t.idle_by_span) == {"ordinary/track": 100 / 1e9, "keyframe": 200 / 1e9,
                                    "keyframe/kf_cycle": 200 / 1e9,
                                    "after_keyframe/join_mapping": 450 / 1e9}
    assert t.longest_gaps[0] == ["after_keyframe/join_mapping", 450 / 1e9]


def test_outside_the_benchmarks_spans_is_the_harness():
    t = spans.reduce([("k", 1000, 1100)], 0, 1000, OFFSET, [],
                     program=[rec(1, None, "frame", MAIN, 0, 1000)])
    assert t.idle_by_span == [["harness", 900 / 1e9]]


def test_operations_go_to_the_span_open_on_their_launching_thread():
    # (name, start, end, launch on the profiler's clock, the launching thread's ids)
    launches = [("k_a", 1100, 1300, 1050, {1, 0}), ("k_b", 1250, 1400, 1350, {1}),
                ("Memcpy HtoD", 1600, 1700, 1560, {1}), ("k_a", 1900, 2050, 1800, {7}),
                ("k_c", 2500, 3200, 2100, {2 - 2 ** 32})]
    t = spans.reduce(INTERVALS, 0, 2000, OFFSET, SPANS, program=PROGRAM, launches=launches)
    assert (t.by_launch, t.by_thread, t.by_start) == (5, 4, 0)
    # The second k_a's thread is unknown: no worker span is open at its
    # launch, so the caller's.  k_c runs during the caller's join, launched
    # by the mapping thread (its id in 32 signed bits) in its loop block.
    assert t.by_program_span == {"loop_block": [1, 500], "track": [1, 200],
                                 "update_seeds": [1, 150], "kf_cycle": [1, 150],
                                 "frame": [0, 100]}


def test_without_launch_events_an_operations_start_stands_for_its_launch():
    t = spans.reduce(INTERVALS, 0, 2000, OFFSET, SPANS, program=PROGRAM)
    assert (t.by_launch, t.by_thread, t.by_start) == (0, 0, 5)
    # At k_c's start (host 1500) the caller joins and the worker is inside
    # its pass, after the loop block: the worker's span takes it.
    assert t.by_program_span == {"mapping_pass": [1, 500], "track": [2, 350],
                                 "kf_cycle": [1, 150], "frame": [0, 100]}


def test_summary_and_self_time():
    t = spans.reduce(INTERVALS, 0, 2000, OFFSET, SPANS, program=PROGRAM)
    s = spans.summary(PROGRAM, t)
    assert s["frame"] == {"count": 3, "total_ms": 0.002, "mean_ms": 0.0006,
                          "kernels": 0, "device_ms": 0.0}
    assert s["track"]["kernels"] == 2 and "kernels" not in s["join_mapping"]
    assert spans.summary(PROGRAM)["loop_block"] == {"count": 1, "total_ms": 0.0,
                                                    "mean_ms": 0.0004}
    # Frame 1's children cover [700, 1000] of [510, 1190]; frame 2's [1210, 1600].
    assert spans.self_ms(PROGRAM, "frame") == [
        (480 - 280 - 180) / 1e6, (680 - 300) / 1e6, (680 - 390) / 1e6]


MS = 1_000_000


def _run(**kw):
    base = dict(cfg={}, setup_s=12.5, window_s=2.0, spans=[], frames=0, counters={})
    base.update(kw)
    program = base.pop("program", None)
    run = Run(**base)
    if program is not None:
        run.program_spans = program
    return run


MONO_SPANS = [("ordinary", 0, 30 * MS, 1), ("keyframe", 30 * MS, 100 * MS, 1),
              ("after_keyframe", 100 * MS, 400 * MS, 1)]
MONO_PROGRAM = [
    rec(1, None, "frame", MAIN, 1 * MS, 29 * MS, 0), rec(2, 1, "track", MAIN, 2 * MS, 12 * MS),
    rec(3, 1, "update_seeds", MAIN, 12 * MS, 20 * MS),
    rec(4, 1, "pose_fetch", MAIN, 25 * MS, 26 * MS),
    rec(5, None, "frame", MAIN, 31 * MS, 99 * MS, 1), rec(6, 5, "track", MAIN, 32 * MS, 42 * MS),
    rec(7, 5, "update_seeds", MAIN, 42 * MS, 50 * MS),
    rec(8, 5, "insert_keyframe", MAIN, 55 * MS, 95 * MS),
    rec(9, 8, "mapping_pass", MAPPING, 60 * MS, 380 * MS, 1),
    rec(10, 9, "loop_block", MAPPING, 61 * MS, 300 * MS),
    rec(11, None, "frame", MAIN, 101 * MS, 399 * MS, 2),
    rec(12, 11, "join_mapping", MAIN, 101 * MS, 381 * MS),
    rec(13, 11, "track", MAIN, 382 * MS, 392 * MS),
    # After the window: the session's last join, and a pass it joined.
    rec(14, None, "join_mapping", MAIN, 500 * MS, 510 * MS),
    rec(15, 8, "mapping_pass", MAPPING, 395 * MS, 505 * MS, 3),
]


def test_vo_readers():
    run = _run(spans=MONO_SPANS, frames=3, program=MONO_PROGRAM)
    assert reader("tracking_ms")(run) == pytest.approx(10.0)
    assert reader("seed_update_ms")(run) == pytest.approx(8.0)
    # Untraced ms: 28 - 19, 68 - 58, 298 - 290.
    assert reader("frame_self_ms")(run) == pytest.approx(9.0)
    assert reader("keyframe_insert_ms")(run) == pytest.approx(40.0)
    assert reader("mapping_pass_ms")(run) == pytest.approx(320.0)
    assert reader("loop_block_ms")(run) == pytest.approx(239.0)
    assert reader("mapping_join_wait_ms")(run) == pytest.approx(280.0)
    assert reader("batch_sparse_align_ms")(run) is None


def test_fleet_reader():
    program = [rec(2 * k + 1, None, "batch_step", MAIN, k * 10 * MS, k * 10 * MS + 9 * MS)
               for k in range(3)]
    program += [rec(2 * k + 2, 2 * k + 1, "batch_sparse_align", MAIN, k * 10 * MS + MS,
                    k * 10 * MS + MS + (4 + k) * MS) for k in range(3)]
    run = _run(spans=[("step", k * 10 * MS, k * 10 * MS + 9 * MS, 16) for k in range(3)],
               frames=48, program=program)
    assert reader("batch_sparse_align_ms")(run) == pytest.approx(5.0)
    for name in ("tracking_ms", "seed_update_ms", "keyframe_insert_ms", "mapping_pass_ms",
                 "loop_block_ms", "mapping_join_wait_ms"):
        assert reader(name)(run) is None


NEW = ["tracking_ms", "seed_update_ms", "frame_self_ms", "keyframe_insert_ms", "mapping_pass_ms",
       "loop_block_ms", "mapping_join_wait_ms", "batch_sparse_align_ms"]


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_in_a_run_without_program_spans(name):
    assert reader(name)(_run(spans=MONO_SPANS, frames=3)) is None
    assert reader(name)(_run(spans=MONO_SPANS, frames=3, program=[])) is None
