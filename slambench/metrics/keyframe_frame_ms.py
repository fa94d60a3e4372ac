"""Mean host ms of the window's keyframe frames and of the frame after each
(which joins the keyframe's asynchronous mapping pass): the keyframe cycle
and mapping, as the caller waits for them."""
import numpy as np


def read(run):
    ms = [(t1 - t0) / 1e6 for label, t0, t1, _ in run.spans
          if label in ("keyframe", "after_keyframe")]
    return float(np.mean(ms)) if ms else None
