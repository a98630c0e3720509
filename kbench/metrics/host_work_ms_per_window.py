"""Host time a scheduling window not spent waiting on the device: the
traced wall time less the CUDA runtime's synchronize and blocking-copy
calls (the profiler's own cost is in it)."""

from kbench.metrics._window import windows


def read(run):
    if run.trace is None:
        return None
    return (run.trace["window_s"] - run.trace["host_wait_s"]) * 1e3 / windows(run)
