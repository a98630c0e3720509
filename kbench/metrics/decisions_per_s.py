"""Pod-scheduling decisions made in the window, summed over lanes (the
delta of the engine's `metrics.scheduling_decisions`, read outside the
window), over the window's whole wall time, which ends in a synchronize."""

from kbench.metrics._window import delta


def read(run):
    if run.trace is not None:
        return None
    return delta(run, "decisions") / run.window_s
