"""Device activities (kernels, copies, fills) in the trace a scheduling
window."""

from kbench.metrics._window import windows


def read(run):
    if run.trace is None:
        return None
    return run.trace["device_events"] / windows(run)
