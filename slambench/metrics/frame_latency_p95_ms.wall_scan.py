"""95th percentile, over every frame of the traced window, of the host time
from the call with the frame to the return of its pose and status (numpy's
linear interpolation between order statistics).  A per-layer metric: the
tail of a host-paced window spreads from run to run by more than a bound
of the 25% an end-to-end metric may have could hold (PERF.md, section 2)."""
import numpy as np


def read(run):
    lat = [(t1 - t0) / 1e6 for _, t0, t1, n in run.spans for _ in range(n)]
    return float(np.percentile(lat, 95)) if lat else None
