"""Mean host ms of the window's frames that are neither a keyframe nor the
frame after one (a keyframe: the system's keyframe counter moved across the
call): tracking, the seed update and the per-frame host work."""
import numpy as np


def read(run):
    ms = [(t1 - t0) / 1e6 for label, t0, t1, _ in run.spans if label == "ordinary"]
    return float(np.mean(ms)) if ms else None
