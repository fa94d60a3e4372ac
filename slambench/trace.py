"""Reduction of a traced window to what the per-layer metrics read: the
device's busy time (the union of its operations' intervals), the device
operations by total time, and the idle gaps named by the benchmark's span
that was open on the host at the time.

Device intervals come from torch.profiler (CUDA activity only) as
(name, start ns, end ns) on the profiler's clock; `offset_ns` maps that
clock to the host's `time.perf_counter_ns` (device time = host time +
offset), measured by a marker launch when the window opens.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def device_intervals(prof) -> list:
    """(name, start ns, end ns) of every device operation a finished
    torch.profiler.profile recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def merge(intervals, lo: int, hi: int) -> list:
    """The union of intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


@dataclass
class Trace:
    window_ns: int
    busy_ns: int
    kernels: int                     # device operations that are not copies or fills
    ops: list = field(default_factory=list)          # [name, seconds], most time first
    idle_by_span: list = field(default_factory=list)  # [label, seconds], most first
    longest_gaps: list = field(default_factory=list)  # [label, seconds], longest first


def reduce(intervals, lo_host: int, hi_host: int, offset_ns: int, spans, top: int = 10) -> Trace:
    """The window [lo_host, hi_host] (host ns) of a trace.  `spans` are the
    benchmark's (label, t0, t1, frames) on the host clock; an idle gap is
    named by the span open at its midpoint, "harness" where none was."""
    lo, hi = lo_host + offset_ns, hi_host + offset_ns
    inside = [(n, s, e) for n, s, e in intervals if e > lo and s < hi]
    merged = merge(inside, lo, hi)
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(int)
    for n, s, e in inside:
        by_name[n] += min(e, hi) - max(s, lo)
    kernels = sum(1 for n, _, _ in inside if not n.startswith(COPY_PREFIXES))
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]

    def label(mid_host: int) -> str:
        i = bisect.bisect_right(starts, mid_host) - 1
        if i >= 0 and spans[i][1] <= mid_host <= spans[i][2]:
            return spans[i][0]
        return "harness"

    idle = defaultdict(int)
    named = []
    for s, e in gaps:
        lab = label((s + e) // 2 - offset_ns)
        idle[lab] += e - s
        named.append((lab, e - s))
    named.sort(key=lambda x: -x[1])
    return Trace(
        window_ns=hi - lo, busy_ns=busy, kernels=kernels,
        ops=[[n, v / 1e9] for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        idle_by_span=[[n, v / 1e9] for n, v in sorted(idle.items(), key=lambda x: -x[1])],
        longest_gaps=[[n, v / 1e9] for n, v in named[:top]])
