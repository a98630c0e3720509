"""The six kernels of the scheduling path: wrapper, plain PyTorch version
and launch count of each.

| wrapper                     | CUDA source (ops/csrc/)    | replaces (kubernetriks_tpu/ops/scheduler_kernel.py) |
| fused_event_scatter         | event_scatter.cu           | `fused_event_scatter` (:671, kernel `_event_kernel` :596)        |
| fused_free_resources        | free_resources.cu          | `fused_free_resources` (:513, kernel `_free_kernel` :435)        |
| fused_select_cycle_commit   | select_cycle_commit.cu     | `fused_select_cycle_commit` (:1139, kernel :1010)                |
| fused_schedule_cycle        | schedule_cycle.cu          | `fused_schedule_cycle` (:903, kernel `_cycle_kernel` :152)       |
| fused_select_schedule_cycle | select_schedule_cycle.cu   | `fused_select_schedule_cycle` (:336, kernel :239)                |
| fused_commit_scatter        | commit_scatter.cu          | `fused_commit_scatter` (:828, kernel `_commit_kernel` :767)      |

The three cycle kernels take the engine's scheduler profile (batched/
pipeline.py) as a build-time profile: `profile_terms` turns it into the
kernels' profile kind and term table (cycle_common.cuh), which the engine
builds once and passes to every launch as `terms`.

The first three carry every window; the cycle itself runs on one of three
routes (engine.BatchedSimulation.cycle_route): the megakernel, the
two-kernel route (selection + cycle, then the commit scatter) or the sorted
route (a queue sort on the device, then the candidate cycle).

Each wrapper takes the reference wrapper's row-major operands. For tensors
on the CPU it runs the plain version beside it (the tests' path); for CUDA
tensors it checks device, dtype, shape and contiguity, allocates the
outputs with torch.empty, launches the kernel on the current stream, raises
if the launch failed, and adds one to LAUNCHES[name] (ops/_launch.py).
There is no fallback from the card to the plain version.

The plain versions are the reference kernels' semantics written with
tensor ops: one-hot min/max/set updates per event, iterated first-set-slot
extraction with one-hot adds, and the iterated lexicographic argmin with
the last-max-wins node argmax. They never call torch.argmax, torch.sort or
torch.cumsum (tie-breaks and summation order are the point).

The cycle kernels' early exit is per cluster: a cluster's loop ends at its
own last valid candidate (or its own queue depth). The Pallas kernels bound
the loop by the deepest cluster of their 128-cluster lane tile, a layout
choice of the TPU; the rows in between are never read (every consumer gates
on `valid`), and a lone cluster's bound is its own there too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from kubernetriks_tpu_torch.batched.pipeline import (
    DEFAULT_PROFILE,
    CompiledProfile,
    is_default_kernel_profile,
    kernel_terms,
    profile_fit_score,
)
from kubernetriks_tpu_torch.ops._launch import (  # noqa: F401  (LAUNCHES, launch_counts, reset_launches: public here)
    LAUNCHES,
    SMEM_LIMIT,
    check as _check,
    launch as _launch,
    launch_counts,
    on_cuda as _on_cuda,
    reset_launches,
)

EV_CREATE_NODE = 1
EV_REMOVE_NODE = 2
EV_CREATE_POD = 3
EV_REMOVE_POD = 4
PHASE_UNSCHEDULABLE = 2
PHASE_RUNNING = 3

_BIG = torch.iinfo(torch.int32).max
_INF = float("inf")

# Slots a block of event_scatter.cu takes (its kTile); pod rows a block of
# free_resources.cu takes: a cluster of at most FREE_TILE_SMALL rows is one
# block, larger ones take tiles of FREE_TILE (its kSmallTile and kTile).
EVENT_TILE = 1024
FREE_TILE_SMALL = 2048
FREE_TILE = 4096
# Blocks a grid may have along y, where both kernels put their tiles.
_MAX_TILES = 65535


# --- 1. event scatter -----------------------------------------------------


def event_scatter_plain(
    ev_kind, ev_slot, ev_rel, ev_seq, ev_valid,
    created, node_removal, pod_create, pod_create_seq, pod_removal,
):
    """One chunk of due trace events applied to the per-slot accumulators:
    node created (set), node removal time (min), pod create time (min),
    pod create seq (max), pod removal time (min). Out-of-range slots match
    no one-hot row and drop."""
    N = created.shape[1]
    P = pod_create.shape[1]
    dev = created.device
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    iota_p = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    for k in range(ev_kind.shape[1]):
        kind = ev_kind[:, k : k + 1]
        slot = ev_slot[:, k : k + 1]
        rel = ev_rel[:, k : k + 1]
        seq = ev_seq[:, k : k + 1]
        v = ev_valid[:, k : k + 1]
        oh_n = iota_n == slot
        oh_p = iota_p == slot
        created = torch.where(oh_n & v & (kind == EV_CREATE_NODE), True, created)
        node_removal = torch.where(
            oh_n & v & (kind == EV_REMOVE_NODE), torch.minimum(node_removal, rel), node_removal
        )
        is_cp = oh_p & v & (kind == EV_CREATE_POD)
        pod_create = torch.where(is_cp, torch.minimum(pod_create, rel), pod_create)
        pod_create_seq = torch.where(is_cp, torch.maximum(pod_create_seq, seq), pod_create_seq)
        pod_removal = torch.where(
            oh_p & v & (kind == EV_REMOVE_POD), torch.minimum(pod_removal, rel), pod_removal
        )
    return created, node_removal, pod_create, pod_create_seq, pod_removal


def fused_event_scatter(
    ev_kind: torch.Tensor,  # (C, E) int32
    ev_slot: torch.Tensor,  # (C, E) int32 device slots (out of range = drop)
    ev_rel: torch.Tensor,  # (C, E) float32 effect time, rel-seconds
    ev_seq: torch.Tensor,  # (C, E) int32 queue sequence for creates
    ev_valid: torch.Tensor,  # (C, E) bool
    created: torch.Tensor,  # (C, N) bool
    node_removal: torch.Tensor,  # (C, N) float32
    pod_create: torch.Tensor,  # (C, P) float32
    pod_create_seq: torch.Tensor,  # (C, P) int32
    pod_removal: torch.Tensor,  # (C, P) float32
):
    """The five accumulators with this chunk's events applied."""
    if not _on_cuda(created):
        return event_scatter_plain(
            ev_kind, ev_slot, ev_rel, ev_seq, ev_valid,
            created, node_removal, pod_create, pod_create_seq, pod_removal,
        )
    C, E = ev_kind.shape
    N = created.shape[1]
    P = pod_create.shape[1]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    _check("fused_event_scatter", {
        "ev_kind": (ev_kind, i32, (C, E)), "ev_slot": (ev_slot, i32, (C, E)),
        "ev_rel": (ev_rel, f32, (C, E)), "ev_seq": (ev_seq, i32, (C, E)),
        "ev_valid": (ev_valid, b, (C, E)), "created": (created, b, (C, N)),
        "node_removal": (node_removal, f32, (C, N)), "pod_create": (pod_create, f32, (C, P)),
        "pod_create_seq": (pod_create_seq, i32, (C, P)), "pod_removal": (pod_removal, f32, (C, P)),
    }, created.device)
    if -(-max(N, P) // EVENT_TILE) > _MAX_TILES:
        raise ValueError(f"fused_event_scatter: N={N}, P={P} need more than {_MAX_TILES} tiles")
    outs = (
        torch.empty_like(created), torch.empty_like(node_removal),
        torch.empty_like(pod_create), torch.empty_like(pod_create_seq),
        torch.empty_like(pod_removal),
    )
    if C:
        _launch("fused_event_scatter", "event_scatter", [
            ev_kind, ev_slot, ev_rel, ev_seq, ev_valid,
            created, node_removal, pod_create, pod_create_seq, pod_removal,
            *outs, C, N, P, E,
        ])
    return outs


# --- 2. freed resources ---------------------------------------------------


def _est_stats_init(C: int, device) -> Tuple[torch.Tensor, ...]:
    z = torch.zeros((C, 1), dtype=torch.float32, device=device)
    return (z, z, z, torch.full_like(z, _INF), torch.full_like(z, -_INF))


def _est_stats_fold(stats, mask, v):
    """One in-order estimator step: count/total/total_sq/min/max of v
    where mask (the reference kernels' per-iteration stats update)."""
    cnt, tot, tsq, mn, mx = stats
    return (
        cnt + torch.where(mask, 1.0, 0.0),
        tot + torch.where(mask, v, 0.0),
        tsq + torch.where(mask, v * v, 0.0),
        torch.minimum(mn, torch.where(mask, v, _INF)),
        torch.maximum(mx, torch.where(mask, v, -_INF)),
    )


def free_resources_plain(freed, node, req_cpu, req_ram, finishes, value, alloc_cpu, alloc_ram):
    """Freed pods' requests added back to their nodes' allocatable, in
    ascending slot order (integer adds, so any order gives the same
    result), and the estimator fold of `value` over the finished subset in
    that order. Returns (alloc_cpu, alloc_ram, stats (C, 5))."""
    C, P = freed.shape
    N = alloc_cpu.shape[1]
    dev = freed.device
    iota_p = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    stats = _est_stats_init(C, dev)
    rem = freed.clone()
    k_bound = int(freed.sum(dim=1).max()) if C and P else 0
    for _ in range(k_bound):
        first = torch.where(rem, iota_p, _BIG).amin(dim=1, keepdim=True)
        sel = rem & (iota_p == first)
        seli = sel.to(torch.int32)
        nd = torch.where(sel, node, -1).amax(dim=1, keepdim=True)
        rc = (seli * req_cpu).amax(dim=1, keepdim=True)
        rr = (seli * req_ram).amax(dim=1, keepdim=True)
        oh = iota_n == nd  # nd == -1 (no freed pod left) matches nothing
        alloc_cpu = alloc_cpu + torch.where(oh, rc, 0)
        alloc_ram = alloc_ram + torch.where(oh, rr, 0)
        rem = rem & ~sel
        fin = (sel & finishes).any(dim=1, keepdim=True)
        v = torch.where(sel, value, -_INF).amax(dim=1, keepdim=True)
        stats = _est_stats_fold(stats, fin, v)
    return alloc_cpu, alloc_ram, torch.cat(stats, dim=1)


def free_layout(N: int, P: int) -> Tuple[int, int, bool, int]:
    """(pod rows a tile, tiles per cluster, whether the allocatable rows
    sit in shared memory, shared bytes a block) of free_resources.cu's
    launch. A cluster of one tile keeps its two allocatable rows in shared
    memory where they fit; otherwise the node sums go through the
    cross-block scratch, whose shared memory (the tiles' value offsets)
    grows with P, not N: so any N runs, and only a P of more than ~2e8
    rows is refused."""
    tile = FREE_TILE_SMALL if P <= FREE_TILE_SMALL else FREE_TILE
    tiles = max(1, -(-P // tile))
    vals = 4 * tile
    smem_nodes = tiles == 1 and vals + 8 * N <= SMEM_LIMIT
    return tile, tiles, smem_nodes, vals + (8 * N if smem_nodes else 4 * (tiles + 1))


# Module-level because the wrapper's signature carries no state.
_FREE_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _free_scratch(device, C: int, N: int, tile: int, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """free_resources.cu's cross-block scratch for the current stream and
    this shape: the counters (a ticket per cluster, then its cpu and ram
    node sums), allocated zeroed once and left zero by every launch; and
    the tiles' finished counts and compacted values, written before they
    are read. One per stream, so calls in flight on two streams never
    share one; one per shape, so a captured CUDA graph keeps its own. The
    window executor warms every piece on its capture stream first, so the
    zero-fill never lands in a graph; a capture that finds no scratch
    raises."""
    key = (device.index, torch.cuda.current_stream().cuda_stream, C, N, T)
    scratch = _FREE_SCRATCH.get(key)
    if scratch is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_free_resources: no scratch for this stream and shape; "
                "launch once on the capture stream before capturing"
            )
        scratch = (
            torch.zeros(C * (1 + 2 * N), dtype=torch.int32, device=device),
            torch.empty(C * T * (1 + tile), dtype=torch.int32, device=device),
        )
        _FREE_SCRATCH[key] = scratch
    return scratch


def fused_free_resources(
    freed: torch.Tensor,  # (C, P) bool
    node: torch.Tensor,  # (C, P) int32 (>= 0 for freed pods)
    req_cpu: torch.Tensor,  # (C, P) int32
    req_ram: torch.Tensor,  # (C, P) int32
    finishes: torch.Tensor,  # (C, P) bool, the estimator subset of freed
    value: torch.Tensor,  # (C, P) float32 estimator sample per pod
    alloc_cpu: torch.Tensor,  # (C, N) int32
    alloc_ram: torch.Tensor,  # (C, N) int32
):
    """(alloc_cpu, alloc_ram, stats (C, 5) count/total/total_sq/min/max)."""
    if not _on_cuda(freed):
        return free_resources_plain(
            freed, node, req_cpu, req_ram, finishes, value, alloc_cpu, alloc_ram
        )
    C, P = freed.shape
    N = alloc_cpu.shape[1]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    _check("fused_free_resources", {
        "freed": (freed, b, (C, P)), "node": (node, i32, (C, P)),
        "req_cpu": (req_cpu, i32, (C, P)), "req_ram": (req_ram, i32, (C, P)),
        "finishes": (finishes, b, (C, P)), "value": (value, f32, (C, P)),
        "alloc_cpu": (alloc_cpu, i32, (C, N)), "alloc_ram": (alloc_ram, i32, (C, N)),
    }, freed.device)
    tile, T, smem_nodes, smem = free_layout(N, P)
    if smem > SMEM_LIMIT or T > _MAX_TILES:
        raise ValueError(f"fused_free_resources: P={P} needs {T} tiles and {smem} B of shared memory "
                         f"(limits {_MAX_TILES} and {SMEM_LIMIT})")
    acpu = torch.empty_like(alloc_cpu)
    aram = torch.empty_like(alloc_ram)
    stats = torch.empty((C, 5), dtype=f32, device=freed.device)
    if C:
        counters, tiles = (None, None) if smem_nodes else _free_scratch(freed.device, C, N, tile, T)
        _launch("fused_free_resources", "free_resources", [
            freed, node, req_cpu, req_ram, finishes, value, alloc_cpu, alloc_ram,
            acpu, aram, stats, counters, tiles, C, N, P,
        ])
    return acpu, aram, stats


# --- 3. selection + cycle + commit megakernel -----------------------------


def _argmin_select(rem, qwin, qbits, qseq, req_cpu, req_ram):
    """One queue pick per cluster: the remaining eligible pod with the
    least (queue win, offset bits, seq), lowest slot if the whole key ties
    (the stable sort's order). Returns (sel one-hot (C, P), slot (C, 1),
    valid (C, 1), its cpu and ram requests (C, 1))."""
    C, P = rem.shape
    iota_p = torch.arange(P, dtype=torch.int32, device=rem.device)[None, :].expand(C, P)
    m = rem
    for key in (qwin, qbits, qseq, iota_p):
        low = torch.where(m, key, _BIG).amin(dim=1, keepdim=True)
        m = m & (key == low)
    valid = m.any(dim=1, keepdim=True)
    seli = m.to(torch.int32)
    slot = torch.where(m, iota_p, -1).amax(dim=1, keepdim=True)
    rc = (seli * req_cpu).amax(dim=1, keepdim=True)
    rr = (seli * req_ram).amax(dim=1, keepdim=True)
    return m, slot, valid, rc, rr


def profile_terms(profile: CompiledProfile, device):
    """(term table or None, profile kind, term count): the cycle kernels'
    launch arguments for `profile` on `device`. Kind 0 runs the default
    profile's own instantiation (no table); 1 and 2 the term list with and
    without the Fit filter. The table (int32 triples: scorer id, float32
    weight bits, multiply) is a copy to the device, so it is built before
    any CUDA graph capture and passed to the wrappers as `terms`."""
    if is_default_kernel_profile(profile):
        return None, 0, 0
    use_fit, terms = kernel_terms(profile)
    flat = [v for t in terms for v in t]
    table = torch.tensor(flat or [0], dtype=torch.int32, device=device)
    return table, 1 if use_fit else 2, len(terms)


def _fit_score_place(alive, cpu, ram, rc, rr, valid, profile=DEFAULT_PROFILE):
    """The decision core of every cycle kernel (reference `_fit_score_place`,
    ops/scheduler_kernel.py:118): the profile's fit mask and score on every
    node for the (C, 1) request, the last node of maximal score (ties go to
    the highest slot; with no fit every node scores -inf, so the last node),
    and the allocatables with the request deducted from that node where
    `valid` and some node fits. Returns (any_fit, best, cpu, ram)."""
    N = cpu.shape[1]
    iota_n = torch.arange(N, dtype=torch.int32, device=cpu.device)[None, :]
    fit, score = profile_fit_score(profile, alive, cpu, ram, rc, rr)
    max_score = score.amax(dim=1, keepdim=True)
    best = torch.where(score == max_score, iota_n, -1).amax(dim=1, keepdim=True)
    any_fit = fit.any(dim=1, keepdim=True)
    upd = valid & any_fit & (iota_n == best)
    return any_fit, best, cpu - torch.where(upd, rc, 0), ram - torch.where(upd, rr, 0)


def select_cycle_commit_plain(
    alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq, req_cpu, req_ram,
    waited, phase, node, qpre_t, start_t, park_t, k_pods: int, profile=DEFAULT_PROFILE,
):
    """Per cluster, up to K times: pick the eligible pod with the least
    (queue win, offset bits, seq) — lowest slot if the whole key ties —
    fit and score it on every node, place it on the last node of maximal
    score, deduct the node's allocatable, and write the pod's phase, node,
    start (assigned) or park (no node fits) offset; fold the queue-time
    estimator over the assignments in pick order."""
    C, P = eligible.shape
    dev = eligible.device
    qbits = qoff.contiguous().view(torch.int32)
    cpu, ram = alloc_cpu, alloc_ram
    start = torch.full((C, P), _INF, dtype=torch.float32, device=dev)
    park_out = torch.full((C, P), _INF, dtype=torch.float32, device=dev)
    stats = _est_stats_init(C, dev)
    rem = eligible.clone()
    depth = int(eligible.sum(dim=1).max()) if C and P else 0
    for k in range(min(depth, k_pods)):
        sel, _, valid, rc, rr = _argmin_select(rem, qwin, qbits, qseq, req_cpu, req_ram)
        any_fit, best, cpu, ram = _fit_score_place(alive, cpu, ram, rc, rr, valid, profile)
        assign = valid & any_fit
        park = valid & ~any_fit
        new_phase = torch.where(assign, PHASE_RUNNING, PHASE_UNSCHEDULABLE).to(torch.int32)
        phase = torch.where(sel & (assign | park), new_phase, phase)
        node = torch.where(sel & assign, best, node)
        start = torch.where(sel & assign, start_t[:, k : k + 1], start)
        park_out = torch.where(sel & park, park_t[:, k : k + 1], park_out)
        w = torch.where(sel, waited, -_INF).amax(dim=1, keepdim=True)
        stats = _est_stats_fold(stats, assign, w + qpre_t[:, k : k + 1])
        rem = rem & ~sel
    return cpu, ram, phase, node, start, park_out, torch.cat(stats, dim=1)


# Node slots the register-resident cycle kernels (all three) hold per
# cluster: 1 024 threads of 32 slots (ops/csrc/cycle_common.cuh).
CYCLE_MAX_NODES = 1024 * 32


def _check_cycle_nodes(name: str, N: int) -> None:
    if N > CYCLE_MAX_NODES:
        raise ValueError(f"{name}: N={N} node slots exceed the kernel's {CYCLE_MAX_NODES}")


def fused_select_cycle_commit(
    alive: torch.Tensor,  # (C, N) bool
    alloc_cpu: torch.Tensor,  # (C, N) int32
    alloc_ram: torch.Tensor,  # (C, N) int32
    eligible: torch.Tensor,  # (C, P) bool
    qwin: torch.Tensor,  # (C, P) int32
    qoff: torch.Tensor,  # (C, P) float32 (non-negative)
    qseq: torch.Tensor,  # (C, P) int32
    pod_req_cpu: torch.Tensor,  # (C, P) int32
    pod_req_ram: torch.Tensor,  # (C, P) int32
    waited: torch.Tensor,  # (C, P) float32
    phase: torch.Tensor,  # (C, P) int32
    node: torch.Tensor,  # (C, P) int32
    qpre_t: torch.Tensor,  # (C, K) float32 positional cd_pre table
    start_t: torch.Tensor,  # (C, K) float32 positional start offsets
    park_t: torch.Tensor,  # (C, K) float32 positional park offsets
    k_pods: int,
    profile: CompiledProfile = DEFAULT_PROFILE,
    terms=None,
):
    """(alloc_cpu, alloc_ram, phase, node, start_tmp, park_tmp, qstats
    (C, 5)); start/park are +inf where untouched."""
    if not _on_cuda(alive):
        return select_cycle_commit_plain(
            alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq,
            pod_req_cpu, pod_req_ram, waited, phase, node, qpre_t, start_t,
            park_t, k_pods, profile,
        )
    C, P = eligible.shape
    N = alloc_cpu.shape[1]
    K = int(k_pods)
    i32, f32, b = torch.int32, torch.float32, torch.bool
    _check("fused_select_cycle_commit", {
        "alive": (alive, b, (C, N)), "alloc_cpu": (alloc_cpu, i32, (C, N)),
        "alloc_ram": (alloc_ram, i32, (C, N)), "eligible": (eligible, b, (C, P)),
        "qwin": (qwin, i32, (C, P)), "qoff": (qoff, f32, (C, P)), "qseq": (qseq, i32, (C, P)),
        "pod_req_cpu": (pod_req_cpu, i32, (C, P)), "pod_req_ram": (pod_req_ram, i32, (C, P)),
        "waited": (waited, f32, (C, P)), "phase": (phase, i32, (C, P)), "node": (node, i32, (C, P)),
        "qpre_t": (qpre_t, f32, (C, K)), "start_t": (start_t, f32, (C, K)),
        "park_t": (park_t, f32, (C, K)),
    }, alive.device)
    _check_cycle_nodes("fused_select_cycle_commit", N)
    outs = (
        torch.empty_like(alloc_cpu), torch.empty_like(alloc_ram),
        torch.empty_like(phase), torch.empty_like(node),
        torch.empty((C, P), dtype=f32, device=alive.device),
        torch.empty((C, P), dtype=f32, device=alive.device),
        torch.empty((C, 5), dtype=f32, device=alive.device),
    )
    if C:
        table, kind, n_terms = terms if terms is not None else profile_terms(profile, alive.device)
        _launch("fused_select_cycle_commit", "select_cycle_commit", [
            alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq,
            pod_req_cpu, pod_req_ram, waited, phase, node, qpre_t, start_t, park_t,
            *outs, table, C, N, P, K, kind, n_terms,
        ])
    return outs


# --- 4. candidate cycle (the sorted route) ----------------------------------


def schedule_cycle_plain(alive, alloc_cpu, alloc_ram, valid, req_cpu, req_ram, profile=DEFAULT_PROFILE):  # ktpu: sync-ok(the plain version: loop bounds read from CPU tensors; on the card the kernel runs)
    """K pre-sorted candidates per cluster, in row order up to the
    cluster's last valid row: fit and score each on every node, take the
    last node of maximal score, deduct it where the row is valid and some
    node fits. Rows at or past the cluster's bound stay zero. Returns
    (assign, fit_any, best (C, K), alloc_cpu, alloc_ram)."""
    C, K = valid.shape
    dev = valid.device
    iota_k = torch.arange(1, K + 1, dtype=torch.int32, device=dev)[None, :]
    k_bound = torch.where(valid, iota_k, 0).amax(dim=1, keepdim=True) if K else None
    steps = int(k_bound.max()) if C and K else 0
    cpu, ram = alloc_cpu, alloc_ram
    cols = {"assign": [], "fit": [], "best": []}
    for k in range(steps):
        live = k < k_bound
        v = valid[:, k : k + 1] & live
        any_fit, best, cpu, ram = _fit_score_place(
            alive, cpu, ram, req_cpu[:, k : k + 1], req_ram[:, k : k + 1], v, profile
        )
        cols["assign"].append(v & any_fit)
        cols["fit"].append(any_fit & live)
        cols["best"].append(torch.where(live, best, 0).to(torch.int32))
    assign = torch.zeros((C, K), dtype=torch.bool, device=dev)
    fit_any = torch.zeros((C, K), dtype=torch.bool, device=dev)
    best = torch.zeros((C, K), dtype=torch.int32, device=dev)
    if steps:
        assign[:, :steps] = torch.cat(cols["assign"], dim=1)
        fit_any[:, :steps] = torch.cat(cols["fit"], dim=1)
        best[:, :steps] = torch.cat(cols["best"], dim=1)
    return assign, fit_any, best, cpu, ram


def fused_schedule_cycle(
    alive: torch.Tensor,  # (C, N) bool
    alloc_cpu: torch.Tensor,  # (C, N) int32
    alloc_ram: torch.Tensor,  # (C, N) int32
    valid: torch.Tensor,  # (C, K) bool
    req_cpu: torch.Tensor,  # (C, K) int32
    req_ram: torch.Tensor,  # (C, K) int32
    profile: CompiledProfile = DEFAULT_PROFILE,
    terms=None,
):
    """(assign (C, K) bool, fit_any (C, K) bool, best (C, K) int32,
    alloc_cpu, alloc_ram)."""
    if not _on_cuda(alive):
        return schedule_cycle_plain(alive, alloc_cpu, alloc_ram, valid, req_cpu, req_ram, profile)
    C, K = valid.shape
    N = alloc_cpu.shape[1]
    i32, b = torch.int32, torch.bool
    _check("fused_schedule_cycle", {
        "alive": (alive, b, (C, N)), "alloc_cpu": (alloc_cpu, i32, (C, N)),
        "alloc_ram": (alloc_ram, i32, (C, N)), "valid": (valid, b, (C, K)),
        "req_cpu": (req_cpu, i32, (C, K)), "req_ram": (req_ram, i32, (C, K)),
    }, alive.device)
    _check_cycle_nodes("fused_schedule_cycle", N)
    outs = (
        torch.empty((C, K), dtype=b, device=alive.device),
        torch.empty((C, K), dtype=b, device=alive.device),
        torch.empty((C, K), dtype=i32, device=alive.device),
        torch.empty_like(alloc_cpu), torch.empty_like(alloc_ram),
    )
    if C:
        table, kind, n_terms = terms if terms is not None else profile_terms(profile, alive.device)
        _launch("fused_schedule_cycle", "schedule_cycle", [
            alive, alloc_cpu, alloc_ram, valid, req_cpu, req_ram, *outs, table, C, N, K, kind, n_terms,
        ])
    return outs


# --- 5. selection + cycle (the two-kernel route, first half) ---------------


def select_schedule_cycle_plain(
    alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq, req_cpu, req_ram, k_pods: int,
    profile=DEFAULT_PROFILE,
):
    """The megakernel's selection and cycle without the commit: up to K
    times per cluster, pick the next pod in queue order and place it as the
    candidate cycle does. Returns (cand, valid, assign, fit_any, best (C, K),
    alloc_cpu, alloc_ram); rows past the cluster's queue depth are zero."""
    C, P = eligible.shape
    K = int(k_pods)
    dev = eligible.device
    qbits = qoff.contiguous().view(torch.int32)
    cpu, ram = alloc_cpu, alloc_ram
    rem = eligible.clone()
    depth = int(eligible.sum(dim=1).max()) if C and P else 0
    steps = min(depth, K)
    cols = {"cand": [], "valid": [], "assign": [], "fit": [], "best": []}
    for _ in range(steps):
        sel, slot, valid, rc, rr = _argmin_select(rem, qwin, qbits, qseq, req_cpu, req_ram)
        any_fit, best, cpu, ram = _fit_score_place(alive, cpu, ram, rc, rr, valid, profile)
        cols["cand"].append(torch.where(valid, slot, 0).to(torch.int32))
        cols["valid"].append(valid)
        cols["assign"].append(valid & any_fit)
        cols["fit"].append(valid & any_fit)
        cols["best"].append(torch.where(valid, best, 0).to(torch.int32))
        rem = rem & ~sel
    outs = [
        torch.zeros((C, K), dtype=torch.int32, device=dev),
        torch.zeros((C, K), dtype=torch.bool, device=dev),
        torch.zeros((C, K), dtype=torch.bool, device=dev),
        torch.zeros((C, K), dtype=torch.bool, device=dev),
        torch.zeros((C, K), dtype=torch.int32, device=dev),
    ]
    if steps:
        for out, key in zip(outs, ("cand", "valid", "assign", "fit", "best")):
            out[:, :steps] = torch.cat(cols[key], dim=1)
    return (*outs, cpu, ram)


def fused_select_schedule_cycle(
    alive: torch.Tensor,  # (C, N) bool
    alloc_cpu: torch.Tensor,  # (C, N) int32
    alloc_ram: torch.Tensor,  # (C, N) int32
    eligible: torch.Tensor,  # (C, P) bool
    qwin: torch.Tensor,  # (C, P) int32
    qoff: torch.Tensor,  # (C, P) float32 (non-negative)
    qseq: torch.Tensor,  # (C, P) int32
    pod_req_cpu: torch.Tensor,  # (C, P) int32
    pod_req_ram: torch.Tensor,  # (C, P) int32
    k_pods: int,
    profile: CompiledProfile = DEFAULT_PROFILE,
    terms=None,
):
    """(cand (C, K) int32, valid (C, K) bool, assign (C, K) bool, fit_any
    (C, K) bool, best (C, K) int32, alloc_cpu, alloc_ram); invalid rows
    are zero."""
    if not _on_cuda(alive):
        return select_schedule_cycle_plain(
            alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq,
            pod_req_cpu, pod_req_ram, k_pods, profile,
        )
    C, P = eligible.shape
    N = alloc_cpu.shape[1]
    K = int(k_pods)
    i32, f32, b = torch.int32, torch.float32, torch.bool
    _check("fused_select_schedule_cycle", {
        "alive": (alive, b, (C, N)), "alloc_cpu": (alloc_cpu, i32, (C, N)),
        "alloc_ram": (alloc_ram, i32, (C, N)), "eligible": (eligible, b, (C, P)),
        "qwin": (qwin, i32, (C, P)), "qoff": (qoff, f32, (C, P)), "qseq": (qseq, i32, (C, P)),
        "pod_req_cpu": (pod_req_cpu, i32, (C, P)), "pod_req_ram": (pod_req_ram, i32, (C, P)),
    }, alive.device)
    _check_cycle_nodes("fused_select_schedule_cycle", N)
    dev = alive.device
    outs = (
        torch.empty((C, K), dtype=i32, device=dev),
        torch.empty((C, K), dtype=b, device=dev),
        torch.empty((C, K), dtype=b, device=dev),
        torch.empty((C, K), dtype=b, device=dev),
        torch.empty((C, K), dtype=i32, device=dev),
        torch.empty_like(alloc_cpu), torch.empty_like(alloc_ram),
    )
    if C:
        table, kind, n_terms = terms if terms is not None else profile_terms(profile, alive.device)
        _launch("fused_select_schedule_cycle", "select_schedule_cycle", [
            alive, alloc_cpu, alloc_ram, eligible, qwin, qoff, qseq,
            pod_req_cpu, pod_req_ram, *outs, table, C, N, P, K, kind, n_terms,
        ])
    return outs


# --- 6. decision commit (the two-kernel route, second half) ----------------


def commit_scatter_plain(cand, assign, park, best, start_s, park_s, phase, node):
    """The cycle's K decisions per cluster written into the (C, P) pod
    rows: RUNNING on `best` with its start offset where assigned,
    UNSCHEDULABLE with its park offset where parked; start/park rows are
    +inf where untouched. Candidate slots are unique within a cycle, so the
    writes are order-free; rows that touch nothing write into a spare
    column P, which is dropped."""
    C, P = phase.shape
    dev = phase.device
    touched = assign | park
    cand = cand.long()

    def scatter(base, mask, values):
        wide = torch.cat([base, base[:, :1]], dim=1)
        return wide.scatter(1, torch.where(mask, cand, P), values.to(base.dtype))[:, :P].contiguous()

    inf = torch.full((C, P), _INF, dtype=torch.float32, device=dev)
    new_phase = torch.where(assign, PHASE_RUNNING, PHASE_UNSCHEDULABLE).to(torch.int32)
    return (
        scatter(phase, touched, new_phase),
        scatter(node, assign, best),
        scatter(inf, assign, start_s),
        scatter(inf, park, park_s),
    )


def fused_commit_scatter(
    cand: torch.Tensor,  # (C, K) int32 pod slots, unique per cluster
    assign: torch.Tensor,  # (C, K) bool
    park: torch.Tensor,  # (C, K) bool
    best: torch.Tensor,  # (C, K) int32 node slots
    start_s: torch.Tensor,  # (C, K) float32 start offsets
    park_s: torch.Tensor,  # (C, K) float32 park offsets
    phase: torch.Tensor,  # (C, P) int32
    node: torch.Tensor,  # (C, P) int32
):
    """(phase, node, start_tmp, park_tmp) with the decisions applied;
    start_tmp/park_tmp are +inf where untouched."""
    if not _on_cuda(phase):
        return commit_scatter_plain(cand, assign, park, best, start_s, park_s, phase, node)
    C, K = cand.shape
    P = phase.shape[1]
    i32, f32, b = torch.int32, torch.float32, torch.bool
    _check("fused_commit_scatter", {
        "cand": (cand, i32, (C, K)), "assign": (assign, b, (C, K)), "park": (park, b, (C, K)),
        "best": (best, i32, (C, K)), "start_s": (start_s, f32, (C, K)),
        "park_s": (park_s, f32, (C, K)), "phase": (phase, i32, (C, P)), "node": (node, i32, (C, P)),
    }, phase.device)
    outs = (
        torch.empty_like(phase), torch.empty_like(node),
        torch.empty((C, P), dtype=f32, device=phase.device),
        torch.empty((C, P), dtype=f32, device=phase.device),
    )
    if C:
        _launch("fused_commit_scatter", "commit_scatter", [
            cand, assign, park, best, start_s, park_s, phase, node, *outs, C, P, K,
        ])
    return outs
