"""The 95th percentile over every span of the window of its wall time: a
span of `span_windows` scheduling windows ended by one host read of every
lane's decisions counter."""

import numpy as np


def read(run):
    if run.trace is not None or len(run.spans_s) < 20:
        return None
    return float(np.percentile(np.asarray(run.spans_s) * 1e3, 95))
