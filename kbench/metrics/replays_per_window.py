"""CUDA graph replays a scheduling window (dispatch_stats["replays"])."""

from kbench.metrics._window import dispatch_delta, windows


def read(run):
    return dispatch_delta(run, "replays") / windows(run)
