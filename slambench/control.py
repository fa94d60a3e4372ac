"""The control and the planted faults that the comparison deciding `correct`
has to catch, and a command that reads a cell's compared numbers over many
seeds in one process (sound runs, the control, or a fault):

    python3 -m slambench.control --workload <cell> --seconds <s> --mode <mode> --seeds <n> ...

A `<config>.<traffic>` pair that BENCHMARK.json does not list as a cell runs
too, so that a mix left out of the benchmark can be read.

Modes (each planted by the cell's driver, `plant(session, mode)`, as the
window opens, so that the window's calls run broken underneath):

- `sound`: the system as it is.
- `control`: the configuration's guarantee broken as a shortcut would: the
  tracker runs, but the pose it returns is the motion model's prediction
  (monocular: `VisualOdometry`'s constant-velocity prediction; fleet: the
  batch path's own prediction, the warm start from the last pose, which
  makes it the `unchanged` fault there).
- `unchanged`: the tracking step returns its state unchanged (monocular:
  the previous pose; fleet: the warm-start pose).
- `half_batch`: (fleet) the second half of the streams keep their
  warm-start poses, the first half are tracked.
- `altered`: one answer altered where it is produced: the fifth window
  call's pose moved by 0.5 (map units; fleet: metres) along x (fleet: stream 0).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def window_hook(driver: str, mode: str):
    """A session hook that plants `mode` as the window opens (set-up runs
    sound)."""
    plant = importlib.import_module(f"slambench.drivers.{driver}").plant

    def hook(sess):
        start = sess.start_window

        def start_window():
            start()
            plant(sess, mode)
        sess.start_window = start_window
    return hook


def main(argv=None) -> int:
    from slambench import run as R
    from slambench import reference

    ap = argparse.ArgumentParser(description="Read a cell's compared numbers over seeds.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dump", default=None,
                    help="a directory to keep each run's compared outputs in (npz)")
    args = ap.parse_args(argv)
    _, _, cfg, mix, _ = R.load_cell(args.workload, listed=False)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, sess, _ = R.measure(cfg, mix, seed, args.seconds, False, device, t0,
                                 session_hook=window_hook(cfg["driver"], args.mode))
        out = sess.outputs()
        sess.free()
        torch.cuda.empty_cache()
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            np.savez_compressed(Path(args.dump) / f"{args.workload}.{args.mode}.{seed}.npz",
                                **{k: np.asarray(v) for k, v in out.items()})
        numbers = reference.judge(cfg["driver"], out)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "frames": run.frames, "failed": run.failed,
                          "setup_s": run.setup_s, "frames_per_s": run.frames / run.window_s,
                          "counters": run.counters, "host": R.host_summary(run),
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
