"""Mean host ms of the window's `track` program spans: a frame's tracking
(the sparse alignment, the visible map's patches, the local map search and
pose refinement), its launches and any wait inside them."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.durations_ms(run, "track")
    return float(np.mean(ms)) if ms else None
