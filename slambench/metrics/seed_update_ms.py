"""Mean host ms of the window's `update_seeds` program spans: the depth
filter's update of the last keyframe's seeds against a frame."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.durations_ms(run, "update_seeds")
    return float(np.mean(ms)) if ms else None
