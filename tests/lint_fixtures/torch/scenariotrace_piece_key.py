# ktpu: sim-path
"""Seeded scenariotrace violations for the port's lint: per-lane scenario
leaves flowing into Python control flow, a host read, a shape, a piece
key and a capture's arguments."""

import torch


def plan(statics, lanes, executor):
    if (statics.hpa_tolerance > 0.1).any():  # BAD: control flow
        pass
    seed = lanes.lane_clock.tolist()  # BAD: a host read
    buf = torch.zeros((int(statics.ca_max_nodes.max()), 4))  # BAD: a host cast into a shape
    key = ("end", "sorted", statics.ca_threshold)  # BAD: a piece key
    executor.capture([statics.ca_snap])  # BAD: a capture's argument
    if statics.hpa_interval is not None:  # fine: a presence check
        pass
    return seed, buf, key
