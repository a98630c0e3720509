# ktpu: sim-path
"""Seeded shapecontract violations for the port's lint: per-lane (C,)
leaves meeting (C, G) / (C, P) planes without an explicit [:, None]."""

import torch

AXIS_SIGNATURES = {
    "hpa_tolerance": "C",
    "ca_threshold": "C",
    "hpa_tail": "C,G",
    "phase": "C,P",
}


def hpa_math(auto, st, pods):
    over = auto.hpa_tail > st.hpa_tolerance  # BAD: (C,G) vs (C,)
    idle = pods.phase < st.ca_threshold  # BAD: (C,P) vs (C,)
    fine = auto.hpa_tail > st.hpa_tolerance[:, None]  # fine: explicit expansion
    both = torch.where(over, auto.hpa_tail, st.ca_threshold)  # BAD
    return over, idle, fine, both
