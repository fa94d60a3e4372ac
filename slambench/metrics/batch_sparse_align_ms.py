"""Mean host ms per step of the window's `batch_sparse_align` program
spans: the fleet step's sparse alignment, one K6 launch for every stream's
windows and then each stream's K3 alignment in a Python loop."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.durations_ms(run, "batch_sparse_align")
    return float(np.mean(ms)) if ms else None
