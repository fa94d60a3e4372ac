"""One cell's window read through the program's own spans:

    python3 -m slambench.span_report --workload <cell> --seed <n> --seconds <s>

The cell runs as `slambench/run.py --trace 1` runs it (`run.measure`: the
same set-up, window and profiler, then the same comparison), with
`profiling.tracing()` open from the window's opening until the session has
finished (the last mapping pass joined).  The records become the run's
`program_spans`, and the window's reduction is redone by
`slambench.spans.reduce`, which names each idle gap and places each device
operation by the program span the host was in.

Standard output, one JSON line: `correct`, `attempted`, `failed`, the
cell's traced metrics and every metric reader BENCHMARK.json does not list
yet, and the breakdown with every idle gap's name.  Standard error: a
`spans` line (per span name: count, total and mean ms, and the device
operations and device ms placed in it) and a `coverage` line (the mean
`frame` span of ordinary frames against `ordinary_frame_ms`, their
untraced share, and per benchmark label the share of idle time a program
span names).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402


@contextlib.contextmanager
def captured(seen: dict):
    """Keep the profile and the arguments of the window's reduction that
    `run.measure` hands `slambench.trace`, for the reduction by spans."""
    from slambench import trace

    device_intervals, reduce = trace.device_intervals, trace.reduce

    def keep_profile(prof):
        seen["prof"] = prof
        return device_intervals(prof)

    def keep_window(*args):
        seen["window"] = args
        return reduce(*args)

    trace.device_intervals, trace.reduce = keep_profile, keep_window
    try:
        yield
    finally:
        trace.device_intervals, trace.reduce = device_intervals, reduce


def tracing_hook(held: dict):
    """A session hook that opens the recorder as the window opens."""
    from ygz_slam_tpu_torch.utils import profiling

    def hook(sess):
        start = sess.start_window

        def start_window():
            held["tracing"] = profiling.tracing()
            held["records"] = held["tracing"].__enter__()
            start()
        sess.start_window = start_window
    return hook


def coverage(run) -> dict:
    """The acceptance readings: the mean `frame` span of ordinary frames,
    their mean untraced ms, and per benchmark label the share of its idle
    time that carries a program span's name."""
    from slambench import spans

    recs = spans.in_window(run)
    frames = sorted((r for r in recs if r.name == "frame"), key=lambda r: r.t0)
    starts = [r.t0 for r in frames]
    ordinary = []
    for label, t0, t1, _ in run.spans:
        i = int(np.searchsorted(starts, t0))
        if label == "ordinary" and i < len(frames) and frames[i].t1 <= t1:
            ordinary.append(frames[i])
    self_ms = dict(zip((r.id for r in recs if r.name == "frame"),
                       spans.self_ms(recs, "frame")))
    out = {}
    if ordinary:
        out["ordinary_frame_span_ms"] = float(np.mean([(r.t1 - r.t0) / 1e6 for r in ordinary]))
        out["ordinary_frame_self_ms"] = float(np.mean([self_ms[r.id] for r in ordinary]))
    total, named = defaultdict(float), defaultdict(float)
    for name, s in run.trace.idle_by_span:
        label, _, inner = name.partition("/")
        total[label] += s
        named[label] += s if inner else 0.0
    out["idle_named_share"] = {k: named[k] / total[k] for k in total if total[k]}
    out["idle_s"] = dict(total)
    return out


def report(bench: dict, cell: dict, cfg: dict, mix: dict, limits: dict, seed: int,
           seconds: float, device, t_start: float):
    """Run the cell traced, with the recorder open over its window, and
    read it.  Returns (the JSON line's dict, the Run), or (None, None) where
    a module that must not load in the measured process has loaded."""
    from slambench import run as R
    from slambench import spans

    held, seen = {}, {}
    try:
        with captured(seen):
            run, sess, peak = R.measure(cfg, mix, seed, seconds, True, device, t_start,
                                        session_hook=tracing_hook(held))
    finally:
        if "tracing" in held:
            held["tracing"].__exit__(None, None, None)
    loaded = R.forbidden_modules()
    if loaded:
        print(f"modules that must not load in the measured process: {loaded}", file=sys.stderr)
        return None, None
    run.program_spans = list(held.get("records", []))
    if run.program_spans:
        try:
            launches = spans.device_launches(seen["prof"])
        except AttributeError as e:          # a profiler without correlation ids
            print(f"no launch events: {e}", file=sys.stderr)
            launches = None
        run.trace = spans.reduce(*seen["window"], program=run.program_spans, launches=launches)
    correct, _ = R.judge(cfg, sess, limits)

    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    new = sorted(p.stem for p in (R.BENCH / "metrics").glob("*.py") if p.stem not in listed)
    metrics = {}
    for name in [m["name"] for m in R.metrics_of(bench, cell["name"], True)] + new:
        v = R.read_metric(name, run)
        if v is not None and math.isfinite(v):
            metrics[name] = v
    result = {"workload": cell["name"], "seed": seed, "correct": correct, "attempted": run.frames,
              "failed": run.failed, "frames_per_s": run.frames / run.window_s,
              "setup_s": run.setup_s, "metrics": metrics, "memory_peak_bytes": peak,
              "busy_s": run.trace.busy_ns / 1e9, "window_s": run.trace.window_ns / 1e9,
              "idle_by_span": run.trace.idle_by_span, "device_ops": run.trace.ops}
    if isinstance(run.trace, spans.SpanTrace):
        result["placed"] = {"by_launch": run.trace.by_launch,
                            "by_thread": run.trace.by_thread,
                            "by_start": run.trace.by_start}
    return result, run


def main(argv=None) -> int:
    from slambench import run as R
    from slambench import spans

    ap = argparse.ArgumentParser(description="Read one cell's window by the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    bench, cell, cfg, mix, limits = R.load_cell(args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result, run = report(bench, cell, cfg, mix, limits, args.seed, args.seconds, device, T_START)
    if result is None:
        return 4
    result["device"] = torch.cuda.get_device_name(device)
    print(f"spans {json.dumps(spans.summary(spans.in_window(run), run.trace))}", file=sys.stderr)
    print(f"coverage {json.dumps(coverage(run))}", file=sys.stderr)
    print(f"host {json.dumps(R.host_summary(run))}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
