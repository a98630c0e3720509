"""Milliseconds the engine waited on its streaming feeder in the window
(the stalls of a producer behind and of uploads; the cold start is
set-up's), from the feeder's own report."""


def _stalled(report) -> float:
    stalls = report["stalls"]
    return stalls["feeder_not_ready"]["ms"] + stalls["upload_wait"]["ms"]


def read(run):
    a, b = run.before.get("feeder"), run.after.get("feeder")
    if not a or not b:
        return None
    return _stalled(b) - _stalled(a)
