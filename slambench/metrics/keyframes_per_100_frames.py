"""Keyframes the system inserted in the window (the change of its
`keyframes` counter, 0 where it never moved) per 100 camera frames."""


def read(run):
    if "frames" not in run.counters or not run.frames:
        return None
    return 100.0 * run.counters.get("keyframes", 0) / run.frames
