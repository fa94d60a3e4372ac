"""Mean host ms of the window's `loop_block` program spans: the mapping
pass's active-window loop detection and closure (from the window's fourth
keyframe on)."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.durations_ms(run, "loop_block")
    return float(np.mean(ms)) if ms else None
