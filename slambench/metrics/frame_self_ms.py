"""Mean over the window's `frame` program spans of the host ms no child
span covers (a frame span's duration less the union of its direct
children's): the frame's work that no stage span names."""
import numpy as np

from slambench import spans


def read(run):
    ms = spans.self_ms(spans.in_window(run), "frame")
    return float(np.mean(ms)) if ms else None
