"""Set-up seconds on the host clock: imports, rendering the run's frames,
building and warming the system, and the mix's set-up frames, to the end
of the last set-up call's device work."""


def read(run):
    return run.setup_s
