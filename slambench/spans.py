"""The program's own spans against a traced window: what the per-layer
metrics that read `program_span` take, and the idle gaps and device
operations named by the stage the host was in.

Program spans are the records of `ygz_slam_tpu_torch.utils.profiling`
(`id`, `parent`, `name`, `thread`, `tid`, `frame`, `t0`, `t1`, host
`time.perf_counter_ns`); a run carries them as `program_spans`.  Nothing
here imports the system: the records are read by their fields.

`reduce` extends `trace.reduce`:
- an idle gap is named `<benchmark label>/<innermost program span open on
  the caller's thread at the gap's midpoint>`; the bare label stays where
  no program span was open there;
- each device operation goes to the program span open on its launching
  thread when it was launched: the launch is the profiler's runtime or
  driver event with the operation's correlation id, its thread the one
  whose identifier's low 32 bits are the event's resource id; where a
  profile has no such event, the operation's start on the mapped clock
  stands for its launch, and where the thread is not known the span is
  taken from a thread other than the caller's that has one open then (a
  caller with a worker running is mostly waiting for it), else from the
  caller's.
With no program spans it returns exactly what `trace.reduce` returns.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from slambench import trace

CALLER = "MainThread"       # the thread that drives the window's calls
LOW32 = 0xFFFFFFFF


@dataclass
class SpanTrace(trace.Trace):
    # program span name -> [device operations (copies and fills left out),
    # device ns of every operation], for what was launched while the span
    # was the innermost open on the launching thread
    by_program_span: dict = field(default_factory=dict)
    by_launch: int = 0              # operations placed by their launch event,
    by_thread: int = 0              # of which on their launching thread,
    by_start: int = 0               # and operations placed by their start


def device_launches(prof) -> list:
    """(name, start ns, end ns, launch ns or None, launching thread ids) of
    every device operation a finished torch.profiler.profile recorded, the
    launch found through the operation's correlation id among the
    profile's host events (all on the profiler's clock; the thread ids are
    the event's resource id, the launching thread's identifier in 32 bits
    on the H100's PyTorch 2.11, and its thread id)."""
    events = list(prof.profiler.kineto_results.events())
    host = {}
    for e in events:
        if e.device_type().name != "CUDA":
            corr = e.correlation_id()
            if corr:            # the launch call comes first; module loading may share its id
                host.setdefault(corr, (e.start_ns(), {e.device_resource_id(),
                                                      e.start_thread_id()}))
    out = []
    for e in events:
        if e.device_type().name == "CUDA":
            s = e.start_ns()
            launch, tids = host.get(e.correlation_id(), (None, frozenset()))
            out.append((e.name(), s, s + e.duration_ns(), launch, tids))
    return out


class _Innermost:
    """The innermost span open at a time on one thread, whose spans nest:
    breakpoints of the elementary intervals and each one's innermost span."""

    def __init__(self, records):
        marks = sorted([(r.t0, 1, -r.t1, r) for r in records]
                       + [(r.t1, 0, 0, r) for r in records], key=lambda m: m[:3])
        self.at, self.top = [], []
        stack = []
        for t, opening, _, r in marks:
            if opening:
                stack.append(r)
            elif r in stack:
                stack.remove(r)
            self.at.append(t)
            self.top.append(stack[-1] if stack else None)

    def __call__(self, t: int):
        i = bisect.bisect_right(self.at, t) - 1
        return self.top[i] if i >= 0 else None


def reduce(intervals, lo_host: int, hi_host: int, offset_ns: int, spans, program=(),
           launches=None, top: int = 10) -> trace.Trace:
    """`trace.reduce` of the window, with the idle gaps named and the
    device operations placed by the program's spans (module docstring).
    `launches` are `device_launches` of the same profile (None: each
    operation's start stands for its launch)."""
    base = trace.reduce(intervals, lo_host, hi_host, offset_ns, spans, top)
    if not program:
        return base
    lo, hi = lo_host + offset_ns, hi_host + offset_ns
    by_thread = defaultdict(list)
    for r in program:
        by_thread[r.thread].append(r)
    open_on = {th: _Innermost(rs) for th, rs in by_thread.items()}
    caller = open_on.get(CALLER, lambda t: None)
    thread_of_tid = {r.tid & LOW32: r.thread for r in program}

    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]

    def label(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > spans[i][2]:
            return "harness"
        inner = caller(t)
        return spans[i][0] if inner is None else f"{spans[i][0]}/{inner.name}"

    inside = [(n, s, e) for n, s, e in intervals if e > lo and s < hi]
    gaps, prev = [], lo
    for s, e in trace.merge(inside, lo, hi):
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    idle, named = defaultdict(int), []
    for s, e in gaps:
        lab = label((s + e) // 2 - offset_ns)
        idle[lab] += e - s
        named.append((lab, e - s))
    named.sort(key=lambda x: -x[1])

    def thread_of(tids):
        return next((thread_of_tid[t & LOW32] for t in tids if t & LOW32 in thread_of_tid),
                    None)

    def placed(t: int, thread):
        if thread is not None:
            return open_on[thread](t)
        for th, find in open_on.items():
            if th != CALLER and find(t) is not None:
                return find(t)
        return caller(t)

    ops = launches if launches is not None else [(n, s, e, None, ()) for n, s, e in intervals]
    per = defaultdict(lambda: [0, 0])
    n_launch = n_thread = n_start = 0
    for name, s, e, launch, tids in ops:
        if not (e > lo and s < hi):
            continue
        if launch is not None:
            thread = thread_of(tids)
            n_launch += 1
            n_thread += thread is not None
            r = placed(launch - offset_ns, thread)
        else:
            n_start += 1
            r = placed(s - offset_ns, None)
        acc = per[r.name if r is not None else "(none)"]
        acc[0] += not name.startswith(trace.COPY_PREFIXES)
        acc[1] += min(e, hi) - max(s, lo)
    return SpanTrace(
        window_ns=base.window_ns, busy_ns=base.busy_ns, kernels=base.kernels, ops=base.ops,
        idle_by_span=[[n, v / 1e9] for n, v in sorted(idle.items(), key=lambda x: -x[1])],
        longest_gaps=[[n, v / 1e9] for n, v in named[:top]],
        by_program_span={k: v for k, v in sorted(per.items(), key=lambda x: -x[1][1])},
        by_launch=n_launch, by_thread=n_thread, by_start=n_start)


def in_window(run) -> list:
    """The run's program spans that lie inside its window: from the start
    of the benchmark's first call to the end of its last.  A mapping pass
    still running as the window closes is left out: in a traced run it runs
    on while the profiler stops and the trace is reduced, holding the
    interpreter lock for seconds."""
    prog = getattr(run, "program_spans", None)
    if not prog or not run.spans:
        return []
    lo = min(sp[1] for sp in run.spans)
    hi = max(sp[2] for sp in run.spans)
    return [r for r in prog if lo <= r.t0 and r.t1 <= hi]


def durations_ms(run, name: str) -> list:
    return [(r.t1 - r.t0) / 1e6 for r in in_window(run) if r.name == name]


def self_ms(records, name: str) -> list:
    """Per span called `name`: its duration less the union of its direct
    children's intervals (the host time no child span covers), in ms."""
    kids = defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.parent].append((r.t0, r.t1))
    out = []
    for r in records:
        if r.name != name:
            continue
        covered, end = 0, r.t0
        for s, e in sorted(kids[r.id]):
            s, e = max(s, end), min(e, r.t1)
            if e > s:
                covered += e - s
                end = e
        out.append((r.t1 - r.t0 - covered) / 1e6)
    return out


def summary(records, tr=None) -> dict:
    """Per span name: count, total and mean ms, and, of a traced window, the
    device operations (copies and fills left out) and device ms placed in
    it."""
    acc = defaultdict(list)
    for r in records:
        acc[r.name].append((r.t1 - r.t0) / 1e6)
    per = getattr(tr, "by_program_span", {})
    out = {}
    for name, ms in sorted(acc.items(), key=lambda x: -sum(x[1])):
        out[name] = {"count": len(ms), "total_ms": round(sum(ms), 3),
                     "mean_ms": round(sum(ms) / len(ms), 4)}
        if name in per:
            out[name]["kernels"] = per[name][0]
            out[name]["device_ms"] = round(per[name][1] / 1e6, 3)
    return out
