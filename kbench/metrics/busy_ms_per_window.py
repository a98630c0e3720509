"""Device busy time a scheduling window: the union of the device's
activity intervals in the trace."""

from kbench.metrics._window import windows


def read(run):
    if run.trace is None:
        return None
    return run.trace["busy_s"] * 1e3 / windows(run)
