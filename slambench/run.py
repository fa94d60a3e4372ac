"""Benchmark of ygz_slam_tpu_torch on one card: runs one cell of
BENCHMARK.json and prints its result as the last line of standard output.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m slambench.run ...` from the repository's root).  A cell
names a configuration (`slambench/configs/<name>.json`, whose `driver` is
`slambench/drivers/<driver>.py`), a traffic mix (`slambench/traffic/<name>.json`)
and its limits (`slambench/limits/<cell>.json`, against the numbers
`slambench/judges/<driver>.py` compares); each metric is read by
`slambench/metrics/<metric>.py`.  Set-up (imports, rendering, the system's
construction, its warm-up and the mix's set-up frames) is timed as
`setup_s`; then the cell's entry is driven closed loop for `--seconds`;
then the reference judges what the window returned.  With `--trace 1` the
window runs under torch.profiler and the per-layer metrics are reported
instead of the end-to-end ones.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# Run as a script, the folder itself leads sys.path, where its module names
# (trace, run) would shadow the standard library's: the root replaces it.
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that must not be loaded in the measured process
# (compared whole: the system's package name begins with the last one).
FORBIDDEN = ("jax", "jaxlib", "flax", "ygz_slam_tpu")


@dataclass
class Run:
    """What a run leaves for the metric readers."""
    cfg: dict
    setup_s: float
    window_s: float
    spans: list                      # (label, t0 ns, t1 ns, frames) of the window's calls
    frames: int                      # camera frames returned in the window
    counters: dict                   # the system's counters over the window
    enqueue_ns: list = field(default_factory=list)
    trace: object = None             # trace.Trace of a traced window
    failed: int = 0
    host: dict = field(default_factory=dict)   # the host's state over the window (stderr only)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(workload: str, listed: bool = True):
    """(BENCHMARK.json, the cell, its configuration, traffic mix and limits),
    each found by name.  With `listed` False a cell that BENCHMARK.json does
    not list is read as `<config>.<traffic>` with no limits (the control's
    readings of a mix that is not a cell)."""
    from slambench import traffic

    bench = load_json(ROOT / "BENCHMARK.json")
    if listed or any(w["name"] == workload for w in bench["workloads"]):
        cell = find(bench["workloads"], workload, "workload")
    else:
        config, _, mix = workload.partition(".")
        cell = {"name": workload, "config": config, "traffic": mix, "chips": 1}
    cfg = load_json(ROOT / find(bench["configs"], cell["config"], "config")["file"])
    limits = BENCH / "limits" / f"{cell['name']}.json"
    return (bench, cell, cfg, traffic.load(cell["traffic"]),
            load_json(limits) if listed or limits.exists() else {})


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with a trace its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, session_hook=None):
    """Set up, drive the window and close it.  Returns (Run, the session,
    memory peak bytes).  `session_hook`, if given, receives the session
    after set-up (the tests plant faults there)."""
    import torch

    from slambench import trace as tr

    driver = importlib.import_module(f"slambench.drivers.{cfg['driver']}")
    sess = driver.setup(cfg, mix, seed, seconds, device)
    if session_hook is not None:
        session_hook(sess)
    synchronize(device)
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        synchronize(device)
        marker_host = time.perf_counter_ns()
        torch.zeros(1, device=device)
        synchronize(device)
    gc0 = sum(g["collections"] for g in gc.get_stats())
    cpu0 = time.process_time()
    sess.start_window()
    w0 = time.perf_counter_ns()
    limit = int(seconds * 1e9)
    while time.perf_counter_ns() - w0 < limit and sess.more():
        sess.step()
    synchronize(device)
    w1 = time.perf_counter_ns()
    host = {"gc_collections": sum(g["collections"] for g in gc.get_stats()) - gc0,
            "cpu_share": (time.process_time() - cpu0) / ((w1 - w0) / 1e9)}
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        intervals = tr.device_intervals(prof)
        # The marker is the first device operation of the window's trace.
        offset = min(s for _, s, _ in intervals) - marker_host if intervals else 0
        summary = tr.reduce(intervals, w0, w1, offset, sess.spans)
    sess.finish()
    frames = sum(sp[3] for sp in sess.spans)
    run = Run(cfg=cfg, setup_s=setup_s, window_s=(w1 - w0) / 1e9,
              spans=list(sess.spans), frames=frames, counters=sess.counters(),
              enqueue_ns=list(getattr(sess, "enqueue_ns", [])), trace=summary,
              failed=sess.failed(), host=host)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return run, sess, peak


def judge(cfg: dict, sess, limits: dict):
    """Free the system's state, then compare what it returned with the
    reference: (correct, rows)."""
    from slambench import reference

    out = sess.outputs()
    sess.free()
    numbers = reference.judge(cfg["driver"], out)
    return reference.verdict(numbers, limits)


def host_summary(run: Run) -> dict:
    """Where a run's host time went, for comparing a slow run with a fast
    one: quantiles of the window's call ms (and their median in each
    quarter of the window), of the host ms before each step returned (the
    fleet), the garbage collector's passes and the process's CPU seconds
    per window second."""
    def q(ms):
        return [round(float(v), 3) for v in np.percentile(ms, [10, 50, 90, 99])] if ms else []

    ms = [(t1 - t0) / 1e6 for _, t0, t1, _ in run.spans]
    out = {"call_ms_p10_50_90_99": q(ms),
           "call_ms_p50_by_quarter": [round(float(np.median(c)), 3)
                                      for c in np.array_split(ms, 4) if len(c)]}
    if run.enqueue_ns:
        out["enqueue_ms_p10_50_90_99"] = q([n / 1e6 for n in run.enqueue_ns])
    return {**out, **run.host}


def _num(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, cfg, mix, limits = load_cell(args.workload)

    import torch
    # One host thread for PyTorch's CPU operations: the system's host work is
    # one Python thread launching small kernels, and idle OpenMP workers
    # spinning beside it on a shared host only add noise.
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run, sess, peak = measure(cfg, mix, args.seed, args.seconds, bool(args.trace), device,
                              T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that must not load in the measured process: {loaded}", file=sys.stderr)
        return 4
    correct, rows = judge(cfg, sess, limits)

    metrics = {}
    for m in metrics_of(bench, cell["name"], bool(args.trace)):
        v = read_metric(m["name"], run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.frames, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_ns / 1e9
        device_info["window_s"] = run.trace.window_ns / 1e9
        gaps = run.trace.idle_by_span[:10]
        gaps += run.trace.longest_gaps[:10 - len(gaps)]
        result["breakdown"] = {"device_ops": run.trace.ops[:10], "idle_gaps": gaps}
    result["checks"] = {name: {"value": _num(v), "limit": lim} for name, v, lim, _ in rows}
    print(f"setup_s {run.setup_s:.3f}  window_s {run.window_s:.3f}  frames {run.frames}  "
          f"counters {json.dumps(run.counters, sort_keys=True)}", file=sys.stderr)
    print(f"host {json.dumps(host_summary(run))}", file=sys.stderr)
    for name, v, lim, op in rows:
        print(f"check {name} = {v!r} (limit {op} {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
