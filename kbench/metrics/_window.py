"""What the readers share: the window's counter deltas."""


def windows(run) -> int:
    return max(run.after["windows"] - run.before["windows"], 1)


def delta(run, key: str) -> int:
    return run.after[key] - run.before[key]


def dispatch_delta(run, key: str) -> int:
    return run.after["dispatch"][key] - run.before["dispatch"][key]
