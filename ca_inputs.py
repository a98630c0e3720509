"""Seeded operands of the two cluster-autoscaler kernels, as numpy arrays.

chip_smoke.py holds and times the kernels at the Alibaba replay's width on
them, and the port's tests (tests/test_torch_*.py) hold the kernels and
their plain versions against each other and against the JAX package on
them. numpy only: importable with or without the card, torch or jax.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ca_down_inputs", "ca_up_inputs"]


def ca_down_inputs(seed, C=5, N=12, S=8, K=4, edge=None):
    """Scale-down kernel operands: lanes with the branch off, candidates
    over and under the threshold, pending ones, dead ones, padding slots,
    candidates with more than K pods, equal-allocatable targets (name rank
    decides) and pods that fit nowhere. The candidates are the last S node
    slots. `edge` reworks the draws:
      "crossing": lane 0's first candidate re-places its pod onto the
        second, which that deduction pushes over the threshold, so the
        second is not attempted (it would be at its starting utilization);
      "target": lane 0's first candidate (empty) is removed, and the
        second's pod fits only on the first's node: it stays a target;
      "branch_off": every lane off the branch;
      "none_eligible": on the branch, but every candidate dead, pending,
        over the threshold or over K pods;
      "all_eligible": every candidate alive, not pending, under the
        threshold, with 0 to K pods;
      "attempting": the replay's kind of walk: about half the candidates
        alive and under the threshold, 1 to K pods each, one pod in 40
        larger than any node (rollbacks);
      "negative": "attempting" with one request in ten negated (no real
        pod asks for less than nothing, but the walk must still match)."""
    rng = np.random.default_rng(seed)
    branch = rng.random((C, 1)) < 0.8
    branch[0, 0] = True
    if C > 1:
        branch[1, 0] = False
    thresh = rng.choice(np.float32([0.3, 0.5, 0.7]), (C, 1)).astype(np.float32)
    alive = rng.random((C, N)) < 0.85
    not_pending = rng.random((C, N)) < 0.85
    cap_cpu = rng.choice([16000, 32000], (C, N)).astype(np.int32)
    cap_ram = rng.choice([32768, 65536], (C, N)).astype(np.int32)
    # Candidates (the last S node slots) mostly lightly used; the rest
    # anywhere from empty to full.
    used = rng.choice([0.0, 0.1, 0.25, 0.6, 0.9], (C, N))
    used[:, N - S :] = rng.choice([0.0, 0.05, 0.2, 0.45, 0.8], (C, S))
    vcpu = (cap_cpu * (1.0 - used)).astype(np.int32)
    vram = (cap_ram * (1.0 - used)).astype(np.int32)
    name_rank = np.stack([rng.permutation(N) for _ in range(C)]).astype(np.int32)
    slot_perm = np.stack([rng.permutation(np.arange(N - S, N)) for _ in range(C)]).astype(np.int32)
    if C > 2:
        slot_perm[2, -2:] = -1  # padding slots
    cnt = rng.integers(0, K + 2, (C, S)).astype(np.int32)
    pr_cpu = rng.choice([1000, 2000, 4000, 8000, 20000], (C, S * K)).astype(np.int32)
    pr_ram = rng.choice([1024, 2048, 4096, 16384], (C, S * K)).astype(np.int32)
    if edge == "branch_off":
        branch[:] = False
    elif edge == "none_eligible":
        branch[:] = True
        why = rng.integers(0, 4, (C, S))
        slotc = np.clip(slot_perm, 0, N - 1)
        rows = np.arange(C)[:, None]
        alive[rows, slotc] &= why != 0
        not_pending[rows, slotc] &= why != 1
        vcpu[rows, slotc] = np.where(why == 2, 0, vcpu[rows, slotc])
        cnt = np.where(why == 3, K + 1 + rng.integers(0, 3, (C, S)), cnt).astype(np.int32)
    elif edge == "all_eligible":
        branch[:] = True
        alive[:, N - S :] = True
        not_pending[:, N - S :] = True
        vcpu[:, N - S :] = cap_cpu[:, N - S :]
        vram[:, N - S :] = cap_ram[:, N - S :]
        slot_perm = np.stack([rng.permutation(np.arange(N - S, N)) for _ in range(C)]).astype(np.int32)
        cnt = rng.integers(0, K + 1, (C, S)).astype(np.int32)
    elif edge in ("attempting", "negative"):
        branch[:] = True
        thresh[:] = 0.5
        alive[:, N - S :] = rng.random((C, S)) < 0.5
        not_pending[:, N - S :] = True
        cand_used = rng.choice([0.0, 0.05, 0.2, 0.45], (C, S))
        vcpu[:, N - S :] = (cap_cpu[:, N - S :] * (1.0 - cand_used)).astype(np.int32)
        vram[:, N - S :] = (cap_ram[:, N - S :] * (1.0 - cand_used)).astype(np.int32)
        cnt = rng.integers(1, K + 1, (C, S)).astype(np.int32)
        pr_cpu = np.where(rng.random((C, S * K)) < 1 / 40, 70000, pr_cpu).astype(np.int32)
        if edge == "negative":
            pr_cpu = np.where(rng.random((C, S * K)) < 0.1, -pr_cpu, pr_cpu).astype(np.int32)
            pr_ram = np.where(rng.random((C, S * K)) < 0.1, -pr_ram, pr_ram).astype(np.int32)
    elif edge in ("crossing", "target"):
        # Lane 0 by hand: the non-candidate slots full, the candidates in
        # slot order, name ranks in slot order, 16 000 mCPU nodes.
        branch[0] = True
        thresh[0] = 0.5
        alive[0] = True
        not_pending[0] = True
        cap_cpu[0] = 16000
        cap_ram[0] = 32768
        vcpu[0] = 0
        vram[0] = 0
        name_rank[0] = np.arange(N)
        slot_perm[0] = np.arange(N - S, N)
        cnt[0] = 0
        a, b = N - S, N - S + 1
        if edge == "crossing":
            # a empty with one 6 000 pod; b at 4 000 used (0.25) with one
            # 1 000 pod; the rest empty. a's pod lands on b (first in name
            # order with room): b at 10 000 used (0.625) is over 0.5.
            vcpu[0, a:] = 16000
            vram[0, a:] = 32768
            vcpu[0, b] = 12000
            cnt[0, :2] = 1
            pr_cpu[0, 0], pr_ram[0, 0] = 6000, 1024
            pr_cpu[0, K], pr_ram[0, K] = 1000, 1024
        else:
            # a empty with no pod (removed); b at 4 000 used with one
            # 4 000 pod; the rest full (over the threshold, no room): b's
            # pod fits only on a's node.
            vcpu[0, a] = 16000
            vram[0, a] = 32768
            vcpu[0, b] = 12000
            vram[0, b] = 32768
            cnt[0, 1] = 1
            pr_cpu[0, K], pr_ram[0, K] = 4000, 1024
    slotc = np.clip(slot_perm, 0, N - 1)
    cand_alive = (slot_perm >= 0) & np.take_along_axis(alive, slotc, axis=1)
    pv0 = (np.arange(K)[None, None, :] < cnt[:, :, None]).reshape(C, S * K)
    return (
        branch, thresh, alive, not_pending, cap_cpu, cap_ram, vcpu, vram, name_rank,
        slot_perm, cand_alive, cnt, pr_cpu, pr_ram, pv0,
    ), K


def ca_up_inputs(seed, C=5, G=2, K=8, S=8, edge=None):
    """Scale-up kernel operands: an unbounded group and a bounded one,
    lanes whose quota stops the opens, a lane with no valid candidate, a
    lane whose reserve is consumed (starvation) and pods no template
    holds. `edge`: "none_valid" (no lane has a valid candidate),
    "all_valid" (every cache row valid), "overlap" (every group's reserve
    starts at slot 0, so an open can land on a planned slot)."""
    rng = np.random.default_rng(seed)
    max_nodes = np.resize(np.array([[8], [2], [8], [0], [8]], np.int32), (C, 1))
    ca_count = rng.integers(0, 2, (C, G)).astype(np.int32)
    ca_cursor = (ca_count + rng.integers(0, 2, (C, G))).astype(np.int32)
    ng_max = np.tile(np.array([-1, 3], np.int32)[:G], (C, 1))
    ng_slots = np.full((C, G), S // G, np.int32)
    ng_start = np.tile(np.arange(G, dtype=np.int32) * (S // G), (C, 1))
    if C > 4:
        ca_cursor[4] = ng_slots[4]  # reserve consumed on lane 4
    tmpl_cpu = np.tile(np.array([16000, 32000], np.int32)[:G], (C, 1))
    tmpl_ram = np.tile(np.array([32768, 65536], np.int32)[:G], (C, 1))
    n_valid = rng.integers(1, K + 1, C)
    if C > 2:
        n_valid[2] = 0
    if edge == "none_valid":
        n_valid[:] = 0
    elif edge == "all_valid":
        n_valid[:] = K
    elif edge == "overlap":
        ng_start[:] = 0
        ng_max[:] = -1
    cvalid = np.arange(K)[None, :] < n_valid[:, None]
    creq_cpu = rng.choice([2000, 6000, 12000, 24000, 40000], (C, K)).astype(np.int32)
    creq_ram = rng.choice([2048, 8192, 24576, 49152], (C, K)).astype(np.int32)
    return (
        max_nodes, ca_count, ca_cursor, ng_max, ng_slots, tmpl_cpu, tmpl_ram, ng_start,
        cvalid, creq_cpu, creq_ram,
    ), S
