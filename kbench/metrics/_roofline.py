"""What the kernel rooflines share: a kernel's launches and mean device
time in the trace (matched by its CUDA function's name), and the share
of its least time in it."""

from kbench.roofline import least_seconds


def launches(run, names):
    """(launches, device seconds) of the trace's events whose name holds
    one of `names`; None where there is no trace or no launch."""
    if run.trace is None:
        return None
    n, secs = 0, 0.0
    for event, (count, seconds) in run.trace["kernels"].items():
        if any(name in event for name in names):
            n += count
            secs += seconds
    return (n, secs) if n else None


def share(need, n: int, seconds: float) -> float:
    """The least time of one launch over its mean time, in %."""
    return 100.0 * least_seconds(*need) / (seconds / n)


def decisions_per_launch(run, n: int) -> float:
    return (run.after["decisions"] - run.before["decisions"]) / n
