"""Mean host ms of the window's `insert_keyframe` program spans: the
keyframe cycle's launches, its one host fetch, and the start of the
mapping pass (on the caller's thread)."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.durations_ms(run, "insert_keyframe")
    return float(np.mean(ms)) if ms else None
