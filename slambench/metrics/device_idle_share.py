"""1 - the union of the device's operation intervals over the traced
window's length."""


def read(run):
    if run.trace is None or not run.trace.busy_ns:
        return None
    return 1.0 - run.trace.busy_ns / run.trace.window_ns
