"""Mean host ms until `track_batch_step` returned, before the step's
results were synchronised to the host: the batch layer's launch work."""
import numpy as np


def read(run):
    return float(np.mean(run.enqueue_ns)) / 1e6 if run.enqueue_ns else None
