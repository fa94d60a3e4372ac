"""The fleet step's least time on the card (`roofline.fleet_step`: every
input byte read once, at the H100's published peaks) over the device's busy
time per step in the traced window, in percent."""
from slambench import roofline


def read(run):
    cfg = run.cfg
    steps = run.counters.get("steps")
    if run.trace is None or not run.trace.busy_ns or not steps or "streams" not in cfg:
        return None
    nbytes, flops = roofline.fleet_step(cfg["streams"], cfg["landmarks"], cfg["shape"],
                                        cfg["levels"])
    least_ms, _ = roofline.bound_ms(nbytes, flops)
    return 100.0 * least_ms / (run.trace.busy_ns / 1e6 / steps)
