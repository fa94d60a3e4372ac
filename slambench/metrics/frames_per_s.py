"""Camera frames whose pose the system returned in the window, over all
streams, per second of the window (host clock, the window's device work
synchronised at its close)."""


def read(run):
    return run.frames / run.window_s if run.frames else None
