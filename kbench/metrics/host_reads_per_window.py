"""The engine's own host reads a scheduling window (host_syncs; the
harness's readouts are not among them)."""

from kbench.metrics._window import delta, windows


def read(run):
    return delta(run, "host_syncs") / windows(run)
