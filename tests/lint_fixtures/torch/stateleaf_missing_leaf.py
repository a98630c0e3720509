# ktpu: state-module
"""Seeded stateleaf violations for the port's lint: a leaf missing from
the manifest, and a by-name constructor (init_state) that forgets it."""

from typing import NamedTuple, Optional

import torch


class LaneClocks(NamedTuple):
    lane_clock: torch.Tensor
    lane_horizon: torch.Tensor


class ClusterBatchState(NamedTuple):
    time: torch.Tensor
    event_cursor: torch.Tensor
    scratch_probe: torch.Tensor
    auto: Optional[torch.Tensor] = None


CLUSTER_STATE_LEAVES = ("time", "event_cursor", "auto")  # BAD: scratch_probe missing
LANE_CLOCK_LEAVES = ("lane_clock", "lane_horizon")


def init_state(C):
    # BAD: the constructor never names scratch_probe
    return ClusterBatchState(time=torch.zeros(C), event_cursor=torch.zeros(C))


def compare_states(a, b):
    return [k for k in sorted(a) if (a[k] != b[k]).any()]  # fine: every key of a flat state
