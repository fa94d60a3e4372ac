"""Timing, tracing and benchmark-log helpers (counterpart of
ygz_slam_tpu/utils/profiling.py): named wall-clock accumulators that can
wait for the card, a torch.profiler trace, and a JSON-lines benchmark log.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _synchronize(value) -> None:
    """Wait for the devices that `value`'s tensors (a tensor, or a tuple,
    list or dict of them) live on; CPU tensors need no wait."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _synchronize(v)


class Timers:
    """Named wall-clock accumulators; `time(name, block_on=x)` waits for the
    card to finish x's work before it stops the clock, so asynchronous
    launches do not hide their kernels' time."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(self.total[k], 4), "count": self.count[k],
                    "mean_ms": round(1e3 * self.total[k] / max(self.count[k], 1), 3)}
                for k in sorted(self.total)}

    def log_line(self) -> str:
        return json.dumps(self.summary())

    def reset(self):
        self.total.clear()
        self.count.clear()


TIMERS = Timers()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace of the block (host operators, and the card's
    kernels where CUDA is available), written to `logdir` as a Chrome trace
    (trace.json); yields the profiler, whose key_averages() the caller may
    read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def append_bench_log(path: str, entry: dict):
    """Append one benchmark record to a JSON-lines log (one object per
    line, with the time "t" it was written unless the entry has one)."""
    entry = dict(entry)
    entry.setdefault("t", time.time())
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
