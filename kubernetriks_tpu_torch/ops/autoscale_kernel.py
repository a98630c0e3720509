"""The two cluster-autoscaler kernels: wrapper, plain PyTorch version and
launch count of each.

| wrapper               | CUDA source (ops/csrc/) | replaces (kubernetriks_tpu/ops/autoscale_kernel.py) |
| fused_ca_scale_down   | ca_scale_down.cu        | `fused_ca_scale_down` (:177, kernel `_ca_down_kernel` :59) |
| fused_ca_scale_up     | ca_scale_up.cu          | `fused_ca_scale_up` (:402, kernel `_ca_up_kernel` :271)    |

Each wrapper takes the reference wrapper's row-major operands. For CPU
tensors it runs the plain version beside it; for CUDA tensors it checks
device, dtype, shape and contiguity, allocates the outputs, launches the
kernel on the current stream, raises if the launch failed, and adds one to
LAUNCHES[name] (ops/_launch.py). There is no fallback from the card to the
plain version.

The plain versions are the reference's XLA loops (`_ca_scale_down`
autoscale.py:1367-1470, `_ca_scale_up` :1010-1108) over per-cluster
vectors: the same walk bounds, the same first-fit tie-breaks (lowest slot
among the lowest name rank; the lowest plan order; the first accepting
group), the same float32 threshold compare.
"""

from __future__ import annotations

import torch

from kubernetriks_tpu_torch.ops._launch import LAUNCHES, SMEM_LIMIT, check, launch, on_cuda

__all__ = [
    "LAUNCHES",
    "ca_down_layout",
    "ca_scale_down_plain",
    "ca_scale_up_plain",
    "ca_up_smem",
    "fused_ca_scale_down",
    "fused_ca_scale_up",
]

_BIG = torch.iinfo(torch.int32).max

# Node slots a thread of the scale-down block scans per re-placement. On
# an H100, 4 and 8 ran the replay-width walk within 4 % of each other, 2
# and 16 slower, and 4 was the faster where no candidate attempts
# (PERF.md); at N = 96 both give one warp.
_CA_DOWN_NODES_PER_THREAD = 4
# Node slots a thread at most (a template instantiation each, in registers):
# 32 slots of 1 024 threads, 32 768 node slots a cluster.
_CA_DOWN_MAX_NPT = 32
# Static shared memory of the scale-down block (the warps' keys), kept out
# of the dynamic budget.
_CA_DOWN_STATIC_SMEM = 1024


# --- scale-down ---------------------------------------------------------------


def ca_scale_down_plain(  # ktpu: sync-ok(the plain version: loop bounds read from CPU tensors; on the card the kernel runs)
    branch, thresh, alive, not_pending, cap_cpu, cap_ram, vcpu, vram, name_rank,
    slot_perm, cand_alive, cnt, pr_cpu, pr_ram, pv0, k_sd: int,
):
    """Walk the CA candidates in name order (their node slots in
    `slot_perm`) up to the last alive one. A candidate on a `branch` lane
    that is alive, not pending removal, under `thresh` utilization and
    runs at most k_sd pods first-fits its pods (rows s*k_sd + k of the pod
    tables, valid where pv0) onto other alive nodes in name order; success
    removes it and keeps the deductions, failure rolls them back. Returns
    removed (C, S) bool, in name-order positions."""
    C, N = alive.shape
    S = slot_perm.shape[1]
    dev = alive.device
    rows = torch.arange(C, device=dev)
    col_n = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    br = branch[:, 0]
    th = thresh[:, 0]
    removed = torch.zeros((C, S), dtype=torch.bool, device=dev)
    iota_s = torch.arange(S, device=dev)
    s_bound = int(torch.where(cand_alive, iota_s + 1, 0).max()) if C * S else 0
    for s in range(s_bound):
        slot = slot_perm[:, s]
        slotc = slot.clamp(0, N - 1).long()
        cc = cap_cpu[rows, slotc]
        cr = cap_ram[rows, slotc]
        used_c = (cc - vcpu[rows, slotc]).to(torch.float32)
        used_r = (cr - vram[rows, slotc]).to(torch.float32)
        util = torch.maximum(
            used_c / cc.clamp(min=1).to(torch.float32),
            used_r / cr.clamp(min=1).to(torch.float32),
        )
        eligible = cand_alive[:, s] & br & not_pending[rows, slotc] & (util < th)
        attempt = eligible & (cnt[:, s] <= k_sd)
        # A candidate no cluster attempts, and pod rows no attempting
        # cluster holds, change nothing: skip them.
        if not bool(attempt.any()):
            continue
        held = (pv0[:, s * k_sd : (s + 1) * k_sd] & attempt[:, None]).any(dim=0)
        k_n = int(torch.where(held, torch.arange(1, k_sd + 1, device=dev), 0).max()) if k_sd else 0
        vc, vr, ok = vcpu, vram, attempt
        for k in range(k_n):
            j = s * k_sd + k
            pv = pv0[:, j] & attempt
            rc = pr_cpu[:, j : j + 1]
            rr = pr_ram[:, j : j + 1]
            fit = alive & (col_n != slot[:, None]) & (rc <= vc) & (rr <= vr)
            any_fit = fit.any(dim=1)
            low = torch.where(fit, name_rank, _BIG).amin(dim=1, keepdim=True)
            tgt = torch.where(fit & (name_rank == low), col_n, _BIG).amin(dim=1, keepdim=True)
            place = (pv & any_fit)[:, None] & (col_n == tgt)
            vc = vc - torch.where(place, rc, 0)
            vr = vr - torch.where(place, rr, 0)
            ok = ok & (~pv | any_fit)
        vcpu = torch.where(ok[:, None], vc, vcpu)
        vram = torch.where(ok[:, None], vr, vram)
        removed[:, s] = ok
    return removed


def ca_down_layout(N: int, S: int, K: int):
    """(threads a block, node slots a thread, candidate positions a window,
    dynamic shared bytes) of ca_scale_down.cu's launch. About
    _CA_DOWN_NODES_PER_THREAD node slots a thread, in whole warps from one
    to 32 (one warp at the autoscaler's N = 96, 448 threads at the replay's
    N = 1 713), the slots a thread (held in registers) rounded up to a
    power of two; a window holds every candidate where shared memory takes
    their pod tables beside one byte a node slot (35 + 8K B a candidate),
    else as many as fit. The wrapper refuses more than _CA_DOWN_MAX_NPT
    slots a thread (32 768 node slots)."""
    threads = min(1024, max(32, 32 * -(-N // (32 * _CA_DOWN_NODES_PER_THREAD))))
    npt = 1
    while npt * threads < N:
        npt *= 2
    nodes = N + 4 * K
    per = 35 + 8 * K
    window = min(S, (SMEM_LIMIT - _CA_DOWN_STATIC_SMEM - nodes) // per)
    return threads, npt, window, nodes + max(window, 0) * per


def fused_ca_scale_down(
    branch: torch.Tensor,  # (C, 1) bool
    thresh: torch.Tensor,  # (C, 1) float32
    alive: torch.Tensor,  # (C, N) bool
    not_pending: torch.Tensor,  # (C, N) bool: no pending removal effect
    cap_cpu: torch.Tensor,  # (C, N) int32
    cap_ram: torch.Tensor,  # (C, N) int32
    vcpu: torch.Tensor,  # (C, N) int32 storage-visible virtual allocatable
    vram: torch.Tensor,  # (C, N) int32
    name_rank: torch.Tensor,  # (C, N) int32 node-name rank
    slot_perm: torch.Tensor,  # (C, S) int32 node slot per name-ordered candidate; -1 pad
    cand_alive: torch.Tensor,  # (C, S) bool
    cnt: torch.Tensor,  # (C, S) int32 pods on the candidate
    pr_cpu: torch.Tensor,  # (C, S*K) int32 pod requests, row s*K + k
    pr_ram: torch.Tensor,  # (C, S*K) int32
    pv0: torch.Tensor,  # (C, S*K) bool: k < cnt
    k_sd: int,
) -> torch.Tensor:
    """removed (C, S) bool in name-order positions."""
    if not on_cuda(alive):
        return ca_scale_down_plain(
            branch, thresh, alive, not_pending, cap_cpu, cap_ram, vcpu, vram,
            name_rank, slot_perm, cand_alive, cnt, pr_cpu, pr_ram, pv0, k_sd,
        )
    C, N = alive.shape
    S = slot_perm.shape[1]
    K = int(k_sd)
    i32, f32, b = torch.int32, torch.float32, torch.bool
    check("fused_ca_scale_down", {
        "branch": (branch, b, (C, 1)), "thresh": (thresh, f32, (C, 1)),
        "alive": (alive, b, (C, N)), "not_pending": (not_pending, b, (C, N)),
        "cap_cpu": (cap_cpu, i32, (C, N)), "cap_ram": (cap_ram, i32, (C, N)),
        "vcpu": (vcpu, i32, (C, N)), "vram": (vram, i32, (C, N)),
        "name_rank": (name_rank, i32, (C, N)), "slot_perm": (slot_perm, i32, (C, S)),
        "cand_alive": (cand_alive, b, (C, S)), "cnt": (cnt, i32, (C, S)),
        "pr_cpu": (pr_cpu, i32, (C, S * K)), "pr_ram": (pr_ram, i32, (C, S * K)),
        "pv0": (pv0, b, (C, S * K)),
    }, alive.device)
    threads, npt, window, smem = ca_down_layout(N, S, K)
    if (S and window < 1) or npt > _CA_DOWN_MAX_NPT:
        raise ValueError(f"fused_ca_scale_down: N={N}, K={K} exceed the kernel's 32 768 node slots "
                         f"or {SMEM_LIMIT} B of shared memory")
    removed = torch.empty((C, S), dtype=b, device=alive.device)
    if C:
        launch("fused_ca_scale_down", "ca_scale_down", [
            branch, thresh, alive, not_pending, cap_cpu, cap_ram, vcpu, vram,
            name_rank, slot_perm, cand_alive, cnt, pr_cpu, pr_ram, pv0, removed,
            C, N, S, K, threads, npt, window,
        ])
    return removed


# --- scale-up -------------------------------------------------------------------


def ca_scale_up_plain(
    max_nodes, ca_count, ca_cursor, ng_max, ng_slots, tmpl_cpu, tmpl_ram, ng_start,
    cvalid, creq_cpu, creq_ram, n_slots: int,
):
    """First-fit bin-pack of the valid cache candidates, in order: into
    the first planned slot (plan order) that holds the pod, else open the
    group's next reserved slot in the first group that accepts it, at full
    template allocatable, while the CA node total is under `max_nodes`.
    Returns (planned (C, S) bool, planned per group (C, Gn) int32,
    reserve-starved open attempts (C,) int32)."""
    C, G = ca_count.shape
    S = n_slots
    K = cvalid.shape[1]
    dev = ca_count.device
    iota_s = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    iota_g = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    planned = torch.zeros((C, S), dtype=torch.bool, device=dev)
    plan_seq = torch.full((C, S), _BIG, dtype=torch.int32, device=dev)
    pcpu = torch.zeros((C, S), dtype=torch.int32, device=dev)
    pram = torch.zeros((C, S), dtype=torch.int32, device=dev)
    g_planned = torch.zeros((C, G), dtype=torch.int32, device=dev)
    total = ca_count.sum(dim=1, dtype=torch.int32)
    counter = torch.zeros((C,), dtype=torch.int32, device=dev)
    starved = torch.zeros((C,), dtype=torch.int32, device=dev)
    k_bound = min(int(cvalid.sum(dim=1).max()), K) if C * K else 0
    for k in range(k_bound):
        valid = cvalid[:, k]
        rc = creq_cpu[:, k : k + 1]
        rr = creq_ram[:, k : k + 1]
        fit = planned & (rc <= pcpu) & (rr <= pram)
        any_fit = fit.any(dim=1)
        first = torch.where(fit, plan_seq, _BIG).amin(dim=1, keepdim=True)
        place = (valid & any_fit)[:, None] & fit & (plan_seq == first)
        pcpu = pcpu - torch.where(place, rc, 0)
        pram = pram - torch.where(place, rr, 0)

        can_open = valid & ~any_fit & (total < max_nodes[:, 0])
        gcount = ca_count + g_planned
        accepts = ((ng_max < 0) | (gcount < ng_max)) & (rc <= tmpl_cpu) & (rr <= tmpl_ram)
        g_ok = accepts & (ca_cursor + g_planned < ng_slots)
        g_found = g_ok.any(dim=1)
        g = torch.where(g_ok, iota_g, _BIG).amin(dim=1, keepdim=True).clamp(max=G - 1).long()
        open_ = can_open & g_found
        starved = starved + (can_open & ~g_found & (accepts & (ng_slots > 0)).any(dim=1)).to(torch.int32)
        s_new = (torch.gather(ng_start, 1, g) + torch.gather(ca_cursor, 1, g) + torch.gather(g_planned, 1, g))
        hit = open_[:, None] & (iota_s == s_new)
        planned = planned | hit
        plan_seq = torch.where(hit, counter[:, None], plan_seq)
        pcpu = torch.where(hit, torch.gather(tmpl_cpu, 1, g), pcpu)
        pram = torch.where(hit, torch.gather(tmpl_ram, 1, g), pram)
        g_planned = g_planned + (open_[:, None] & (iota_g == g)).to(torch.int32)
        total = total + open_.to(torch.int32)
        counter = counter + open_.to(torch.int32)
    return planned, g_planned, starved


def ca_up_smem(S: int, G: int, K: int) -> int:
    """Dynamic shared bytes of ca_scale_up.cu's warp: the valid candidates'
    requests and the planned-node list (5 x 4 B a cache row, for K + 1 rows
    rounded up to whole warps), the group rows (8 x 4 B a group) and the S
    planned flags."""
    return 4 * (5 * ((K + 32) // 32 * 32) + 8 * G) + S


def fused_ca_scale_up(
    max_nodes: torch.Tensor,  # (C, 1) int32 global CA node quota
    ca_count: torch.Tensor,  # (C, Gn) int32
    ca_cursor: torch.Tensor,  # (C, Gn) int32
    ng_max: torch.Tensor,  # (C, Gn) int32 (< 0 unbounded)
    ng_slots: torch.Tensor,  # (C, Gn) int32
    tmpl_cpu: torch.Tensor,  # (C, Gn) int32
    tmpl_ram: torch.Tensor,  # (C, Gn) int32
    ng_start: torch.Tensor,  # (C, Gn) int32
    cvalid: torch.Tensor,  # (C, K) bool
    creq_cpu: torch.Tensor,  # (C, K) int32
    creq_ram: torch.Tensor,  # (C, K) int32
    n_slots: int,
):
    """(planned (C, S) bool, planned per group (C, Gn) int32, starved (C,)
    int32)."""
    if not on_cuda(ca_count):
        return ca_scale_up_plain(
            max_nodes, ca_count, ca_cursor, ng_max, ng_slots, tmpl_cpu, tmpl_ram,
            ng_start, cvalid, creq_cpu, creq_ram, n_slots,
        )
    C, G = ca_count.shape
    K = cvalid.shape[1]
    S = int(n_slots)
    i32, b = torch.int32, torch.bool
    check("fused_ca_scale_up", {
        "max_nodes": (max_nodes, i32, (C, 1)), "ca_count": (ca_count, i32, (C, G)),
        "ca_cursor": (ca_cursor, i32, (C, G)), "ng_max": (ng_max, i32, (C, G)),
        "ng_slots": (ng_slots, i32, (C, G)), "tmpl_cpu": (tmpl_cpu, i32, (C, G)),
        "tmpl_ram": (tmpl_ram, i32, (C, G)), "ng_start": (ng_start, i32, (C, G)),
        "cvalid": (cvalid, b, (C, K)), "creq_cpu": (creq_cpu, i32, (C, K)),
        "creq_ram": (creq_ram, i32, (C, K)),
    }, ca_count.device)
    smem = ca_up_smem(S, G, K)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_ca_scale_up: S={S}, Gn={G} need {smem} B of shared memory (limit {SMEM_LIMIT})")
    dev = ca_count.device
    planned = torch.empty((C, S), dtype=b, device=dev)
    gpl = torch.empty((C, G), dtype=i32, device=dev)
    starved = torch.empty((C,), dtype=i32, device=dev)
    if C:
        launch("fused_ca_scale_up", "ca_scale_up", [
            max_nodes, ca_count, ca_cursor, ng_max, ng_slots, tmpl_cpu, tmpl_ram,
            ng_start, cvalid, creq_cpu, creq_ram, planned, gpl, starved,
            C, S, G, K,
        ])
    return planned, gpl, starved
