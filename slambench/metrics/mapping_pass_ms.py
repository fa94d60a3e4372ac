"""Mean host ms of the window's `mapping_pass` program spans (on the
mapping thread, joined inside the window): covisibility, the loop block,
local BA, the archive loop detection, the pass's host fetch and keyframe
culling."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.durations_ms(run, "mapping_pass")
    return float(np.mean(ms)) if ms else None
