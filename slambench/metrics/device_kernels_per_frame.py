"""Device kernels (copies and fills left out) in the traced window per
camera frame returned in it."""


def read(run):
    if run.trace is None or not run.frames or not run.trace.kernels:
        return None
    return run.trace.kernels / run.frames
