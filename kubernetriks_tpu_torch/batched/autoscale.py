"""The autoscaler passes: the horizontal pod autoscaler (HPA) and the
cluster autoscaler (CA) as masked tensor passes over every cluster at once.

Port of the JAX package's `batched/autoscale.py`: the statics and state
tables, the HPA control law with its 60 s metrics-collection latch
(`hpa_pass`), the CA cycle (`ca_pass`) with its bin-packing scale-up and
simulated re-placement scale-down, which run in the two CUDA kernels of
ops/autoscale_kernel.py, and CA slot reclaim: the compaction that returns
retired reserve slots to their group (`ca_reclaim_pass`) and the name
orders of the live CA nodes derived from their allocation indices
(`ca_name_order`), which the scale-down walk and the same-window
reschedule ranking read in place of the static tables.

What differs from the reference, and why it is exact:
- The reference branches on device data (`lax.cond`): whether an HPA
  cycle or only a metrics collection is due, whether a CA cycle is due,
  and whether any cluster takes the scale-up or the scale-down branch.
  The due times advance by data-independent periods, so the engine
  mirrors them on the host (engine.AutoscaleClock) and calls these passes
  only on due windows, with the mode the reference's conds would pick. The
  scale-up / scale-down choice does depend on data: both bodies run on
  every due CA window under their per-cluster branch masks, and a body
  under an all-false mask returns exactly the reference's skip-branch
  zeros (no candidate is valid, no node is attempted). Under reclaim the
  dynamic name orders are computed on every due CA window, where the
  reference computes them inside its scale-down branch only: they are
  pure functions of the state, so the walk sees the same orders.
- The reference guards the reclaim compaction with a `lax.cond` on "some
  slot is dead"; the port computes it on every window the engine runs it
  in. With nothing retired the permutation is the identity (occupied
  slots are always a prefix of their group), so the pass is then a
  bit-exact no-op.
- Integer sums and counts (per-group and per-node) are scatter-adds and
  integer prefix sums, exact in any order; the node-grouping sort of the
  scale-down is one stable sort on a combined (node, running-first) key.
- The load curve's unit starts use step.xla_cumsum16 (the bits of
  `jnp.cumsum`); the HPA's elapsed-time math is float64 as in the
  reference; every float32 division divides by a tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kubernetriks_tpu_torch.batched.state import (
    PHASE_EMPTY,
    PHASE_FAILED,
    PHASE_QUEUED,
    PHASE_REMOVED,
    PHASE_RUNNING,
    PHASE_SUCCEEDED,
    PHASE_UNSCHEDULABLE,
    AutoscaleState,
    ClusterBatchState,
)
from kubernetriks_tpu_torch.batched.step import stable_lexsort, xla_cumsum16
from kubernetriks_tpu_torch.batched.timerep import (
    INF_WIN,
    TPair,
    t_add,
    t_inf,
    t_le,
    t_lt,
    t_min,
    t_where,
    t_zeros,
)
from kubernetriks_tpu_torch.ops.autoscale_kernel import fused_ca_scale_down, fused_ca_scale_up

BIG_I32 = torch.iinfo(torch.int32).max
INF = float("inf")


class AutoscaleStatics(NamedTuple):
    """Build-time autoscaler tables, all on the engine's device, leading
    axis C (the reference's `AutoscaleStatics`). Pairs are (C,) TPairs;
    control-law parameters are per lane."""

    # HPA pod groups: (C, Gp).
    pg_slot_start: torch.Tensor  # int32 first reserved pod slot
    pg_slot_count: torch.Tensor  # int32 reserved slots
    pg_initial: torch.Tensor  # int32 initial replicas (created by the trace)
    pg_max_pods: torch.Tensor  # int32
    pg_target_cpu: torch.Tensor  # float32; <= 0 = unset
    pg_target_ram: torch.Tensor  # float32
    pg_active_from: TPair  # first HPA tick that sees the group; +inf = never
    pg_creation_s: torch.Tensor  # float64 absolute creation time
    pg_cpu_dur: torch.Tensor  # (C, Gp, U) float32; 0 = padding unit
    pg_cpu_load: torch.Tensor  # (C, Gp, U) float32
    pg_cpu_total: torch.Tensor  # float32 cycle length; 0 = no model
    pg_cpu_const: torch.Tensor  # bool: constant model
    pg_ram_dur: torch.Tensor
    pg_ram_load: torch.Tensor
    pg_ram_total: torch.Tensor
    pg_ram_const: torch.Tensor
    pod_group_id: torch.Tensor  # (C, P) int32 group of each pod slot; -1 = none
    # CA node groups: (C, Gn).
    ng_ca_start: torch.Tensor  # int32 first CA slot of the group
    ng_slot_count: torch.Tensor  # int32 reserved CA slots
    ng_max_count: torch.Tensor  # int32; < 0 = unbounded
    ng_tmpl_cpu: torch.Tensor  # int32 template capacity
    ng_tmpl_ram: torch.Tensor  # int32 (ram units)
    ca_max_nodes: torch.Tensor  # (C,) int32 global CA node quota
    ca_slots: torch.Tensor  # (C, S) int32 node slot of each CA slot; -1 pad
    ca_slot_group: torch.Tensor  # (C, S) int32 owning group; -1 pad
    # Per-lane control law.
    hpa_interval: TPair
    hpa_tolerance: torch.Tensor  # (C,) float64
    ca_threshold: torch.Tensor  # (C,) float64 scale-down utilization threshold
    d_hpa_up: TPair  # HPA tick -> scaled-up pod enters the queue
    d_hpa_down: TPair  # HPA tick -> pod removal effect
    d_ca_up: TPair  # CA fire -> new node schedulable
    d_ca_down: TPair  # CA fire -> node removal effect
    ca_period: TPair  # true CA cycle period (round trip + scan interval)
    ca_snap: TPair  # CA fire -> storage snapshot
    ca_finish_vis: TPair  # pod finish -> storage visibility
    ca_commit_vis: TPair  # scheduler commit -> storage visibility
    col_interval: TPair  # the metrics collector's 60 s cadence
    # Name orders: lexicographic ranks of pod and node names (trace nodes
    # and CA slots "{group}_{k+1}"), and the CA slots in name order.
    pod_name_rank: torch.Tensor  # (C, P) int32
    node_name_rank: torch.Tensor  # (C, N) int32
    ca_sd_order: torch.Tensor  # (C, S) int64
    # Slot reclaim's name classes (None: reclaim unsupported). Each trace
    # node is a class of one name, each CA group the family of names
    # "{group}_{d}"; the build checked that no class interleaves another,
    # so a name's order is its class's static rank, then, within a group,
    # the decimal order of its suffix.
    ca_slot_class: Optional[torch.Tensor] = None  # (C, S) int32 class rank of the slot's group
    ca_class_start: Optional[torch.Tensor] = None  # (C, Gn) int32 first class-sorted slot position
    node_class_key: Optional[torch.Tensor] = None  # (C, N) int32 class rank * (S + 1)


# AutoscaleStatics leaves that are per-lane TRACED scenario data (the
# fleet composes them, batched/fleet.scenario_leaves; reference
# batched/autoscale.py:265): the scenariotrace lint pass forbids them
# from flowing into Python control flow, host casts, shape expressions or
# a piece key, which would make a what-if config shape a captured graph.
SCENARIO_TRACED_LEAVES = (
    "hpa_interval",
    "hpa_tolerance",
    "ca_threshold",
    "ca_max_nodes",
    "pg_active_from",
    "d_hpa_up",
    "d_hpa_down",
    "d_ca_up",
    "d_ca_down",
    "ca_period",
    "ca_snap",
    "ca_finish_vis",
    "ca_commit_vis",
)

# Declared axis signatures (the shapecontract lint pass; reference
# batched/autoscale.py:285): the per-cluster "C" lane vectors are exactly
# the leaves whose broadcasts against per-object (C, G) / (C, P) / (C, S)
# planes must be explicit ([:, None]). "C,G,*" = the (C, G, U) curve
# tables.
AXIS_SIGNATURES = {
    # AutoscaleState (batched/state.py)
    "hpa_head": "C,G",
    "hpa_tail": "C,G",
    "ca_count": "C,G",
    "ca_cursor": "C,G",
    "ca_total": "C,G",
    "ca_alloc": "C,S",
    "ca_reclaimed": "C",
    "hpa_next": "C",
    "ca_next": "C",
    "col_next": "C",
    "col_run": "C,G",
    "col_util_cpu": "C,G",
    "col_util_ram": "C,G",
    # AutoscaleStatics per-lane control-law leaves
    "hpa_interval": "C",
    "hpa_tolerance": "C",
    "ca_threshold": "C",
    "ca_max_nodes": "C",
    "d_hpa_up": "C",
    "d_hpa_down": "C",
    "d_ca_up": "C",
    "d_ca_down": "C",
    "ca_period": "C",
    "ca_snap": "C",
    "ca_finish_vis": "C",
    "ca_commit_vis": "C",
    "col_interval": "C",
    # AutoscaleStatics tables
    "pg_slot_start": "C,G",
    "pg_slot_count": "C,G",
    "pg_initial": "C,G",
    "pg_max_pods": "C,G",
    "pg_target_cpu": "C,G",
    "pg_target_ram": "C,G",
    "pg_active_from": "C,G",
    "pg_creation_s": "C,G",
    "pg_cpu_dur": "C,G,*",
    "pg_cpu_load": "C,G,*",
    "pg_cpu_total": "C,G",
    "pg_cpu_const": "C,G",
    "pg_ram_dur": "C,G,*",
    "pg_ram_load": "C,G,*",
    "pg_ram_total": "C,G",
    "pg_ram_const": "C,G",
    "pod_group_id": "C,P",
    "ng_ca_start": "C,G",
    "ng_slot_count": "C,G",
    "ng_max_count": "C,G",
    "ng_tmpl_cpu": "C,G",
    "ng_tmpl_ram": "C,G",
    "ca_slots": "C,S",
    "ca_slot_group": "C,S",
    "ca_sd_order": "C,S",
    "ca_slot_class": "C,S",
    "ca_class_start": "C,G",
    "pod_name_rank": "C,P",
    "node_name_rank": "C,N",
    "node_class_key": "C,N",
}


def init_autoscale_state(st: AutoscaleStatics, collect: bool, reclaim: bool = False) -> AutoscaleState:
    """Fresh autoscaler state; `collect` arms the HPA collection latch (the
    engine sets it whenever a pod group can be scaled), `reclaim` the CA
    slot-reclaim leaves (it needs the statics' name-class tables)."""
    C, Gp = st.pg_slot_start.shape
    Gn = st.ng_ca_start.shape[1]
    S = st.ca_slots.shape[1]
    dev = st.pg_slot_start.device
    if reclaim and st.ca_slot_class is None:
        raise ValueError(
            "init_autoscale_state(reclaim=True) needs the statics' name-class tables "
            "(ca_slot_class, ca_class_start, node_class_key), which the engine builds "
            "only when the node-name classes do not interleave"
        )

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return AutoscaleState(
        hpa_head=zeros((C, Gp)),
        # The trace's initial replicas count as created.
        hpa_tail=st.pg_initial.clone(),
        ca_count=zeros((C, Gn)),
        ca_cursor=zeros((C, Gn)),
        hpa_next=t_zeros((C,), dev),
        ca_next=t_zeros((C,), dev),
        ca_alloc=torch.full((C, S), -1, dtype=torch.int32, device=dev) if reclaim else None,
        ca_total=zeros((C, Gn)) if reclaim else None,
        ca_reclaimed=zeros((C,)) if reclaim else None,
        col_next=t_zeros((C,), dev) if collect else None,
        col_run=zeros((C, Gp)) if collect else None,
        col_util_cpu=zeros((C, Gp), torch.float32) if collect else None,
        col_util_ram=zeros((C, Gp), torch.float32) if collect else None,
    )


def _col(p: TPair) -> TPair:
    """(C,) pair -> (C, 1), to broadcast against per-object planes."""
    return TPair(win=p.win[:, None], off=p.off[:, None])


def _window_pair(W: torch.Tensor) -> TPair:
    return TPair(win=W, off=torch.zeros(W.shape, dtype=torch.float32, device=W.device))


def _group_sum(values: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(C, n_groups) int32 sums of `values` by `group` (group == n_groups
    drops). Integer adds: exact in any order."""
    C = values.shape[0]
    out = torch.zeros((C, n_groups + 1), dtype=torch.int32, device=values.device)
    return out.scatter_add_(1, group.long(), values.to(torch.int32))[:, :n_groups]


def _py_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`jnp.mod` (the divisor's sign): fmod, then one correction."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _curve_load(dur, load, total, elapsed):
    """Piecewise-constant cyclic load curve at `elapsed` (float64) seconds
    since group creation. dur/load: (C, G, U) float32; total: (C, G)."""
    safe_total = torch.clamp(total.to(torch.float64), min=1e-9)
    pos = torch.where(total > 0, _py_mod(elapsed, safe_total), 0.0)
    C, G, U = dur.shape
    ecs = xla_cumsum16(dur.reshape(C * G, U)).reshape(C, G, U) - dur
    p = pos[..., None]
    in_unit = (ecs.to(torch.float64) <= p) & (p < (ecs + dur).to(torch.float64))
    return torch.where(in_unit, load, 0.0).sum(dim=-1).to(torch.float32)


def decimal_string_key(idx: torch.Tensor, k) -> torch.Tensor:
    """int32 key whose order is the lexicographic order of str(idx) for
    0 <= idx < 10^8 ("g_10" < "g_2"): the value left-aligned to 8 digits,
    shorter first on ties. `k`: step.DeviceConstants (the digit counts'
    bounds and the digit scales)."""
    idx = torch.clamp(idx, min=0)
    digits = torch.bucketize(idx, k.decimal_bounds, right=True) + 1  # int64: the bounds <= idx, plus one
    return (idx * k.pow10[digits] * 16 + digits).to(torch.int32)


def ca_name_order(auto: AutoscaleState, st: AutoscaleStatics, k):
    """The name orders of the live CA nodes under slot reclaim (reference
    `ca_name_order`): (sd_order (C, S) int64, the CA slots in node-name
    order, in place of st.ca_sd_order; node_key (C, N) int32, whose order
    over alive nodes is their name order, in place of st.node_name_rank).
    An occupant is named "{group}_{alloc + 1}": one stable sort of the
    slots by (class, decimal suffix) gives each occupant's rank within its
    group, added to its class's static key. Free slots sort after their
    group's occupants and keep the class key; they are dead, and every
    reader masks them by liveness first. `k`: step.DeviceConstants."""
    C, S = auto.ca_alloc.shape
    Gn = st.ca_class_start.shape[1]
    N = st.node_class_key.shape[1]
    dev = auto.ca_alloc.device
    occupied = auto.ca_alloc >= 0
    suffix = torch.where(occupied, decimal_string_key(auto.ca_alloc + 1, k), BIG_I32)
    # One stable sort by (class, suffix), both non-negative int32.
    sd_order = torch.sort((st.ca_slot_class.long() << 31) + suffix, dim=1, stable=True).indices
    iota = torch.arange(S, dtype=torch.int32, device=dev).expand(C, S)
    pos = torch.empty((C, S), dtype=torch.int32, device=dev).scatter_(1, sd_order, iota)
    gidc = st.ca_slot_group.clamp(0, Gn - 1).long()
    within = torch.where(occupied, pos - torch.gather(st.ca_class_start, 1, gidc), 0)
    tgt = torch.where(occupied & (st.ca_slots >= 0), st.ca_slots, N).long()
    pad = torch.zeros((C, 1), dtype=torch.int32, device=dev)
    node_key = torch.cat([st.node_class_key, pad], dim=1).scatter_add_(1, tgt, within)[:, :N]
    return sd_order, node_key


def reclaim_name_orders(auto: Optional[AutoscaleState], st: AutoscaleStatics, k, needed: bool):
    """ca_name_order's orders for a window's events and CA pass, computed
    once from the autoscaler state its reclaim pass left (neither the
    events nor the HPA pass change the CA leaves): None without slot
    reclaim, or where the window `needed` neither (no removal can apply,
    no CA cycle is due)."""
    if not needed or auto is None or auto.ca_alloc is None:
        return None
    return ca_name_order(auto, st, k)


# --- HPA ----------------------------------------------------------------------


def _hpa_metrics_sample(pods, st: AutoscaleStatics, W, interval64, lo: int):
    """The metrics collector's sample at window W over the pod slice
    [lo, lo + P): (running per group (C, Gp) int32, util_cpu, util_ram
    (C, Gp) float32)."""
    C, P = pods.phase.shape
    Gp = st.pg_slot_start.shape[1]
    gid = st.pod_group_id[:, lo : lo + P]
    gid_c = torch.where(gid >= 0, gid, Gp)
    started = t_le(pods.start_time, _col(_window_pair(W)))
    running = (pods.phase == PHASE_RUNNING) & started
    run_per_group = _group_sum(running, gid_c, Gp)
    runf = torch.clamp(run_per_group, min=1).to(torch.float32)
    elapsed = (W.to(torch.float64) * interval64)[:, None] - st.pg_creation_s
    cpu_load = _curve_load(st.pg_cpu_dur, st.pg_cpu_load, st.pg_cpu_total, elapsed)
    ram_load = _curve_load(st.pg_ram_dur, st.pg_ram_load, st.pg_ram_total, elapsed)
    util_cpu = torch.where(
        st.pg_cpu_total > 0,
        torch.where(st.pg_cpu_const, cpu_load, torch.clamp(cpu_load / runf, max=1.0)),
        0.0,
    )
    util_ram = torch.where(
        st.pg_ram_total > 0,
        torch.where(st.pg_ram_const, ram_load, torch.clamp(ram_load / runf, max=1.0)),
        0.0,
    )
    return run_per_group, util_cpu, util_ram


def _latch_collection(auto: AutoscaleState, st, W, interval, run_per_group, util_cpu, util_ram):
    """The collection latch: where a collection is due, snapshot the
    sample and advance col_next. Returns (col_due (C,), latched leaves)."""
    col_due = t_le(auto.col_next, _window_pair(W))
    due = col_due[:, None]
    return col_due, dict(
        col_next=t_where(col_due, t_add(auto.col_next, st.col_interval, interval), auto.col_next),
        col_run=torch.where(due, run_per_group, auto.col_run),
        col_util_cpu=torch.where(due, util_cpu, auto.col_util_cpu),
        col_util_ram=torch.where(due, util_ram, auto.col_util_ram),
    )


def _hpa_cycle(pods, queue_seq_counter, auto: AutoscaleState, st: AutoscaleStatics, W, k, lo: int):
    """The HPA cycle body over the pod slice [lo, lo + P) (reference
    `_hpa_pass_body`); `k`: step.DeviceConstants. Returns (pods', auto', scaled_up, scaled_down,
    reserve_clamped, n_activated), the last four (C,) int32."""
    C, P = pods.phase.shape
    Gp = st.pg_slot_start.shape[1]
    dev = pods.phase.device
    interval, interval64 = k.interval, k.interval64
    T = _window_pair(W)
    due = t_le(auto.hpa_next, T)
    active = due[:, None] & t_le(st.pg_active_from, _col(T))

    gid = st.pod_group_id[:, lo : lo + P]
    gid_c = torch.where(gid >= 0, gid, Gp)
    gid_g = torch.clamp(gid_c, max=Gp - 1).long()  # gather index; masked where gid < 0
    run_per_group, util_cpu, util_ram = _hpa_metrics_sample(pods, st, W, interval64, lo)

    # The cycle reads the last collection's sample: the new one only when
    # the collection precedes the cycle (at the same instant, the
    # collection first iff scan_interval <= 60 s).
    col_due, latched = _latch_collection(auto, st, W, interval, run_per_group, util_cpu, util_ram)
    same_t = t_le(auto.col_next, auto.hpa_next) & t_le(auto.hpa_next, auto.col_next)
    col_first = t_le(st.hpa_interval, st.col_interval)
    use_new = (col_due & (t_lt(auto.col_next, auto.hpa_next) | (same_t & col_first)))[:, None]
    run_eff = torch.where(use_new, run_per_group, auto.col_run)
    util_cpu = torch.where(use_new, util_cpu, auto.col_util_cpu)
    util_ram = torch.where(use_new, util_ram, auto.col_util_ram)
    present = run_eff > 0

    current = auto.hpa_tail - auto.hpa_head

    def desired_by(util, target):
        ratio = util / torch.clamp(target, min=1e-9)
        in_band = (ratio - 1.0).abs().to(torch.float64) <= st.hpa_tolerance[:, None]
        # -1e-4 guards float32 products landing just above an integer.
        d = torch.ceil(current.to(torch.float32) * ratio - 1e-4).to(torch.int32)
        return torch.where(in_band, current, d)

    has_cpu = st.pg_target_cpu > 0
    has_ram = st.pg_target_ram > 0
    d_cpu = desired_by(util_cpu, st.pg_target_cpu)
    d_ram = desired_by(util_ram, st.pg_target_ram)
    desired = torch.where(
        has_cpu & has_ram,
        torch.maximum(d_cpu, d_ram),
        torch.where(has_cpu, d_cpu, torch.where(has_ram, d_ram, current)),
    )
    desired = torch.minimum(desired, st.pg_max_pods)
    delta = torch.where(active & present, desired - current, 0).to(torch.int32)
    count_g = torch.clamp(st.pg_slot_count, min=1)
    up0 = torch.minimum(torch.clamp(delta, min=0), count_g - current)
    down = torch.minimum(torch.clamp(-delta, min=0), current)

    # Scale-up activates the first `up` reusable slots of the group's
    # reserve in slot order; the occupant's replica index goes to hpa_idx.
    slot_start_p = torch.gather(st.pg_slot_start, 1, gid_g) - lo
    in_group = gid >= 0
    tail_p = torch.gather(auto.hpa_tail, 1, gid_g)
    phase0 = pods.phase
    reusable = (
        (phase0 == PHASE_EMPTY) | (phase0 == PHASE_SUCCEEDED)
        | (phase0 == PHASE_REMOVED) | (phase0 == PHASE_FAILED)
    )
    reuse_in_g = in_group & reusable
    up = torch.minimum(up0, _group_sum(reuse_in_g, gid_c, Gp))
    up_p = torch.gather(up, 1, gid_g)
    down_p = torch.gather(down, 1, gid_g)
    reuse_i = reuse_in_g.to(torch.int32)
    cs_excl = torch.cumsum(reuse_i, dim=1, dtype=torch.int32) - reuse_i
    start_cs = torch.gather(cs_excl, 1, torch.clamp(slot_start_p, 0, P - 1).long())
    reuse_rank = cs_excl - start_cs
    activate = reuse_in_g & (reuse_rank < up_p)
    rank = torch.cumsum(activate, dim=1, dtype=torch.int32) - 1
    n_up = activate.sum(dim=1, dtype=torch.int32)
    enq_p = _col(t_add(T, st.d_hpa_up, interval))
    phase = torch.where(activate, PHASE_QUEUED, phase0).to(torch.int32)
    queue_ts = t_where(activate, enq_p, pods.queue_ts)
    queue_seq = torch.where(activate, queue_seq_counter[:, None] + rank, pods.queue_seq).to(torch.int32)
    initial_attempt_ts = t_where(activate, enq_p, pods.initial_attempt_ts)
    attempts = torch.where(activate, 1, pods.attempts).to(torch.int32)
    hpa_idx = torch.where(activate, tail_p + reuse_rank, pods.hpa_idx).to(torch.int32)
    node = torch.where(activate, -1, pods.node).to(torch.int32)
    start_time = t_where(activate, t_zeros((C, P), dev), pods.start_time)
    finish_time = t_where(activate, t_inf((C, P), dev), pods.finish_time)

    # Scale-down removes the `down` live replicas with the lexicographically
    # smallest names "{group}_{idx}" (not FIFO: "g_10" < "g_2").
    live = (
        in_group
        & ((phase0 == PHASE_QUEUED) | (phase0 == PHASE_UNSCHEDULABLE) | (phase0 == PHASE_RUNNING))
        & (pods.removal_time.win >= INF_WIN)
        & ~activate
    )
    sort_gid = torch.where(live, gid_c, Gp)
    sort_key = torch.where(live, decimal_string_key(pods.hpa_idx, k), 1 << 30)
    s_slot = stable_lexsort((sort_gid, sort_key))
    s_gid = torch.gather(sort_gid, 1, s_slot)
    # Sorted position minus the group's first sorted position.
    counts = _group_sum(torch.ones_like(sort_gid), sort_gid, Gp + 1)
    gseg_start = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    iota = torch.arange(P, dtype=torch.int32, device=dev).expand(C, P)
    rank_sorted = iota - torch.gather(gseg_start, 1, s_gid.long())
    vrank = torch.empty_like(rank_sorted).scatter_(1, s_slot, rank_sorted)
    deactivate = live & (vrank < down_p)
    removal_time = t_where(activate, t_inf((C, P), dev), pods.removal_time)
    rem_p = _col(t_add(T, st.d_hpa_down, interval))
    removal_time = t_where(deactivate, t_min(removal_time, rem_p), removal_time)

    auto = auto._replace(
        hpa_head=auto.hpa_head + down,
        hpa_tail=auto.hpa_tail + up,
        hpa_next=t_where(due, t_add(auto.hpa_next, st.hpa_interval, interval), auto.hpa_next),
        **latched,
    )
    pods = pods._replace(
        phase=phase,
        queue_ts=queue_ts,
        queue_seq=queue_seq,
        initial_attempt_ts=initial_attempt_ts,
        attempts=attempts,
        removal_time=removal_time,
        node=node,
        start_time=start_time,
        finish_time=finish_time,
        hpa_idx=hpa_idx,
    )
    return (
        pods,
        auto,
        up.sum(dim=1, dtype=torch.int32),
        down.sum(dim=1, dtype=torch.int32),
        # Replicas the formula wanted but the reserve could not seat.
        (torch.clamp(delta, min=0) - up).sum(dim=1, dtype=torch.int32),
        n_up,
    )


def hpa_pass(
    state: ClusterBatchState,
    st: AutoscaleStatics,
    W: torch.Tensor,
    k,
    seg: Tuple[int, int],
    cycle: bool,
) -> ClusterBatchState:
    """One HPA window at W over the group slots [seg[0], seg[1]) (reference
    `hpa_pass`). The engine calls it only when a cycle or a collection is
    due on some cluster: `cycle` runs the cycle body (due lanes act, the
    others keep their state), otherwise only the collection latch runs —
    the two branches of the reference's conds. `k`: step.DeviceConstants."""
    pods, auto = state.pods, state.auto
    interval, interval64 = k.interval, k.interval64
    lo, hi = seg
    sub = _map_pods(pods, lambda a: a[:, lo:hi])
    if not cycle:
        run_per_group, util_cpu, util_ram = _hpa_metrics_sample(sub, st, W, interval64, lo)
        _, latched = _latch_collection(auto, st, W, interval, run_per_group, util_cpu, util_ram)
        return state._replace(auto=auto._replace(**latched))
    sub2, auto2, up_s, down_s, clamp_s, n_up = _hpa_cycle(
        sub, state.queue_seq_counter, auto, st, W, k, lo
    )

    def put(full, part):
        full = full.clone()
        full[:, lo:hi] = part
        return full

    pods2 = _map_pods2(pods, sub2, put)
    m = state.metrics
    metrics = m._replace(
        scaled_up_pods=m.scaled_up_pods + up_s,
        scaled_down_pods=m.scaled_down_pods + down_s,
        hpa_reserve_clamped=m.hpa_reserve_clamped + clamp_s,
    )
    return state._replace(
        pods=pods2,
        metrics=metrics,
        queue_seq_counter=state.queue_seq_counter + n_up,
        auto=auto2,
    )


def _map_pods(pods, fn):
    """PodArrays with `fn` applied to every tensor (both halves of pairs)."""
    return type(pods)(*[
        TPair(win=fn(v.win), off=fn(v.off)) if isinstance(v, TPair) else fn(v) for v in pods
    ])


def _map_pods2(pods, sub, fn):
    """PodArrays with `fn(full, part)` applied leaf by leaf."""
    return type(pods)(*[
        TPair(win=fn(a.win, b.win), off=fn(a.off, b.off)) if isinstance(a, TPair) else fn(a, b)
        for a, b in zip(pods, sub)
    ])


# --- CA -----------------------------------------------------------------------


def _per_group(removed: torch.Tensor, st: AutoscaleStatics) -> torch.Tensor:
    Gn = st.ng_ca_start.shape[1]
    return _group_sum(removed, torch.where(removed, st.ca_slot_group, Gn), Gn)


def ca_scale_up(state, auto, st: AutoscaleStatics, branch, K_up: int, phase_v, attempts_v):
    """Bin-packing scale-up over the unscheduled-pod cache in pod-name
    order (reference `_ca_scale_up`): the cache sort here, the bin-pack in
    the scale-up kernel. Returns (planned (C, S) bool, planned per group
    (C, Gn) int32, reserve-starved open attempts (C,) int32)."""
    pods = state.pods
    P = pods.phase.shape[1]
    in_cache = (phase_v == PHASE_UNSCHEDULABLE) | ((phase_v == PHASE_QUEUED) & (attempts_v >= 2))
    order = stable_lexsort((
        torch.where(in_cache, st.pod_name_rank, BIG_I32),
        torch.where(in_cache, pods.queue_ts.win, BIG_I32),
        torch.where(in_cache, pods.queue_ts.off, INF),
        torch.where(in_cache, pods.queue_seq, BIG_I32),
    ))[:, : min(K_up, P)]
    cvalid = torch.gather(in_cache, 1, order) & branch[:, None]
    return fused_ca_scale_up(
        st.ca_max_nodes[:, None].contiguous(), auto.ca_count, auto.ca_cursor,
        st.ng_max_count, st.ng_slot_count, st.ng_tmpl_cpu, st.ng_tmpl_ram, st.ng_ca_start,
        cvalid.contiguous(), torch.gather(pods.req_cpu, 1, order), torch.gather(pods.req_ram, 1, order),
        n_slots=st.ca_slots.shape[1],
    )


def ca_scale_down(
    state, st: AutoscaleStatics, branch, K_sd: int, phase_v, alloc_cpu_v, alloc_ram_v, snap: TPair, interval,
    sd_order: torch.Tensor, node_key: torch.Tensor,
):
    """Threshold + simulated re-placement scale-down (reference
    `_ca_scale_down`, its default descatter path): the storage-visible
    allocatables and each candidate's pod table here, the name-ordered
    candidate walk in the scale-down kernel. `sd_order`, `node_key`: the
    CA slots in name order and the nodes' name key (the static tables, or
    ca_name_order's under reclaim). Returns (removed (C, S) bool, removed
    per group (C, Gn) int32)."""
    pods, nodes = state.pods, state.nodes
    C, P = pods.phase.shape
    N = nodes.alive.shape[1]
    S = st.ca_slots.shape[1]
    dev = pods.phase.device
    snap_p = _col(snap)
    finish_vis = _col(st.ca_finish_vis)
    # What the storage knows at the snapshot: a running pod whose finish
    # (or HPA removal) it has seen is gone; a succeeded pod whose finish
    # it has not seen yet still runs.
    vis_gone = (phase_v == PHASE_RUNNING) & (
        t_le(t_add(pods.finish_time, finish_vis, interval), snap_p)
        | t_le(pods.removal_time, snap_p)
    )
    succ_finish = t_add(t_add(pods.start_time, pods.duration, interval), finish_vis, interval)
    vis_back = (phase_v == PHASE_SUCCEEDED) & ~t_le(succ_finish, snap_p)

    on_any = ((phase_v == PHASE_RUNNING) & ~vis_gone) | vis_back
    in_seg = vis_gone | vis_back | on_any
    key_node = torch.where(in_seg, torch.clamp(pods.node, 0, N - 1), N)
    d_cpu = torch.where(vis_gone, pods.req_cpu, 0) - torch.where(vis_back, pods.req_cpu, 0)
    d_ram = torch.where(vis_gone, pods.req_ram, 0) - torch.where(vis_back, pods.req_ram, 0)
    alloc_cpu_v = alloc_cpu_v + _group_sum(d_cpu, key_node, N)
    alloc_ram_v = alloc_ram_v + _group_sum(d_ram, key_node, N)
    seg_count = _group_sum(on_any, key_node, N)
    hist = _group_sum(in_seg, key_node, N)
    seg_start = torch.cumsum(hist, dim=1, dtype=torch.int32) - hist
    # Each node's segment leads with its storage-running pods in slot order.
    perm = torch.sort(key_node * 2 + (~on_any).to(torch.int32), dim=1, stable=True).indices
    rc_sorted = torch.gather(pods.req_cpu, 1, perm)
    rr_sorted = torch.gather(pods.req_ram, 1, perm)

    slot_perm = torch.gather(st.ca_slots, 1, sd_order)
    slotc = torch.clamp(slot_perm, 0, N - 1).long()
    cand_alive = (slot_perm >= 0) & torch.gather(nodes.alive, 1, slotc)
    cnt_perm = torch.where(slot_perm >= 0, torch.gather(seg_count, 1, slotc), 0).to(torch.int32)
    seg_pos = torch.clamp(torch.gather(seg_start, 1, slotc), 0, P - 1)
    col_k = torch.arange(K_sd, dtype=torch.int32, device=dev)
    take = torch.clamp(seg_pos[:, :, None] + col_k, 0, P - 1).reshape(C, S * K_sd).long()
    pv0 = (col_k < cnt_perm[:, :, None]).reshape(C, S * K_sd)
    removed_perm = fused_ca_scale_down(
        branch[:, None].contiguous(),
        st.ca_threshold.to(torch.float32)[:, None].contiguous(),
        nodes.alive, nodes.remove_time.win >= INF_WIN,
        nodes.cap_cpu, nodes.cap_ram, alloc_cpu_v.contiguous(), alloc_ram_v.contiguous(),
        node_key.contiguous(), slot_perm.contiguous(), cand_alive.contiguous(), cnt_perm.contiguous(),
        torch.gather(rc_sorted, 1, take), torch.gather(rr_sorted, 1, take), pv0.contiguous(),
        k_sd=K_sd,
    )
    removed = torch.zeros((C, S), dtype=torch.bool, device=dev).scatter_(1, sd_order, removed_perm)
    return removed, _per_group(removed, st)


def ca_pass(
    state: ClusterBatchState,
    st: AutoscaleStatics,
    W: torch.Tensor,
    k,
    K_up: int,
    K_sd: int,
    pre,
    orders=None,
) -> ClusterBatchState:
    """One CA cycle on the clusters whose cycle is due at window W
    (reference `ca_pass`). The cycle fired at `auto.ca_next` (c_k) reads
    the storage snapshot at c_k + ca_snap; when that precedes this
    window's commit visibility, `pre` (phase, attempts, alloc_cpu,
    alloc_ram captured before the scheduling cycle) is the storage's view.
    Scale-up runs where the unscheduled cache is non-empty, scale-down
    elsewhere; the engine calls this only on windows where some cluster's
    cycle is due. Under slot reclaim (the state's ca_alloc leaves) the
    scale-down walks the live nodes' dynamic name orders and the scale-up
    stamps each opened slot's allocation index; `orders`: ca_name_order's
    for this state where the caller has them. `k`: step.DeviceConstants."""
    pods, nodes, auto = state.pods, state.nodes, state.auto
    interval = k.interval
    C, N = nodes.alive.shape
    T = _window_pair(W)
    c_k = auto.ca_next
    snap = t_add(c_k, st.ca_snap, interval)
    due = t_lt(snap, _window_pair(W + 1))
    early = (due & t_lt(snap, t_add(T, st.ca_commit_vis, interval)))[:, None]
    pre_phase, pre_attempts, pre_alloc_cpu, pre_alloc_ram = pre
    phase_v = torch.where(early, pre_phase, pods.phase)
    attempts_v = torch.where(early, pre_attempts, pods.attempts)
    alloc_cpu_v = torch.where(early, pre_alloc_cpu, nodes.alloc_cpu)
    alloc_ram_v = torch.where(early, pre_alloc_ram, nodes.alloc_ram)
    in_cache = (phase_v == PHASE_UNSCHEDULABLE) | ((phase_v == PHASE_QUEUED) & (attempts_v >= 2))
    any_unsched = in_cache.any(dim=1)

    planned, planned_per_group, starved = ca_scale_up(
        state, auto, st, due & any_unsched, K_up, phase_v, attempts_v
    )
    reclaim = auto.ca_alloc is not None
    if reclaim:
        sd_order, node_key = ca_name_order(auto, st, k) if orders is None else orders
    else:
        sd_order, node_key = st.ca_sd_order, st.node_name_rank
    removed, removed_per_group = ca_scale_down(
        state, st, due & ~any_unsched, K_sd, phase_v, alloc_cpu_v, alloc_ram_v, snap, interval,
        sd_order, node_key,
    )

    # Planned slots come alive, removed ones go down, at their effect times.
    def touched(mask):
        tgt = torch.where(mask, st.ca_slots, N).long()
        hit = torch.zeros((C, N + 1), dtype=torch.bool, device=mask.device)
        return hit.scatter_(1, tgt, mask)[:, :N]

    touch_create = touched(planned)
    eff_up = _col(t_add(c_k, st.d_ca_up, interval))
    create_time = t_where(touch_create, t_min(nodes.create_time, eff_up), nodes.create_time)
    touch_remove = touched(removed)
    eff_down = _col(t_add(c_k, st.d_ca_down, interval))
    remove_time = t_where(touch_remove, t_min(nodes.remove_time, eff_down), nodes.remove_time)

    m = state.metrics
    metrics = m._replace(
        scaled_up_nodes=m.scaled_up_nodes + planned.sum(dim=1, dtype=torch.int32),
        scaled_down_nodes=m.scaled_down_nodes + removed.sum(dim=1, dtype=torch.int32),
        ca_reserve_starved=m.ca_reserve_starved + starved,
    )
    new_auto = auto._replace(
        ca_count=auto.ca_count + planned_per_group - removed_per_group,
        ca_cursor=auto.ca_cursor + planned_per_group,
        ca_next=t_where(due, t_add(c_k, st.ca_period, interval), c_k),
    )
    if reclaim:
        # The scale-up opens offsets [cursor, cursor + planned) of each
        # group's reserve in slot order, which is allocation order: an
        # opened slot's allocation index is the group's total so far plus
        # its offset past the cursor.
        Gn = st.ng_ca_start.shape[1]
        S = planned.shape[1]
        gidc = st.ca_slot_group.clamp(0, Gn - 1).long()
        iota_s = torch.arange(S, dtype=torch.int32, device=planned.device)
        alloc_new = (
            torch.gather(auto.ca_total, 1, gidc) + iota_s - torch.gather(st.ng_ca_start, 1, gidc)
            - torch.gather(auto.ca_cursor, 1, gidc)
        )
        new_auto = new_auto._replace(
            ca_alloc=torch.where(planned, alloc_new, auto.ca_alloc).to(torch.int32),
            ca_total=auto.ca_total + planned_per_group,
        )
    return state._replace(
        nodes=nodes._replace(create_time=create_time, remove_time=remove_time),
        metrics=metrics,
        auto=new_auto,
    )


def ca_dead_slots(state: ClusterBatchState, st: AutoscaleStatics) -> torch.Tensor:
    """(C, S) bool: the occupied CA slots whose node is dead with no
    pending create or remove effect, reclaim's candidates (reference
    `ca_reclaim_pass`'s cheap predicate, (C, S) gathers only). With none
    anywhere the compaction is the identity: the reference skips it then
    (`lax.cond(dead.any(), ...)`), and so does the graph executor."""
    nodes = state.nodes
    N = nodes.alive.shape[1]
    slotc = st.ca_slots.clamp(0, N - 1).long()

    def at_slots(a):
        return torch.gather(a, 1, slotc)

    return (
        (state.auto.ca_alloc >= 0) & (st.ca_slots >= 0) & ~at_slots(nodes.alive)
        & (at_slots(nodes.create_time.win) >= INF_WIN) & (at_slots(nodes.remove_time.win) >= INF_WIN)
    )


def reclaim_due(dead: torch.Tensor, W: torch.Tensor, period: int = 1) -> torch.Tensor:
    """0-dim bool: whether reclaim's compaction runs this window
    (reference `ca_reclaim_pass`, autoscale.py:1762-1764): some slot is
    dead (`dead`: ca_dead_slots) and, with `period` N > 1, every lane's
    window W has (W + 1) % N == 0. The graph's conditional node and the
    eager pass test the same predicate."""
    do = dead.any()
    if period > 1:
        do = do & _period_window(W, period)
    return do


def _period_window(W: torch.Tensor, period: int) -> torch.Tensor:
    """0-dim bool: (W + 1) % period == 0 on every lane."""
    return ((W + 1) % period == 0).all()


def ca_reclaim_pass(
    state: ClusterBatchState, st: AutoscaleStatics, W: torch.Tensor, k, dead: Optional[torch.Tensor] = None,
    period: int = 1,
) -> ClusterBatchState:
    """CA slot reclaim (reference `ca_reclaim_pass`): return every retired
    reserve slot to its group by a stable compaction, so ca_cursor is the
    live occupancy and sustained churn never runs the reserve dry (the
    scalar simulator reuses its node components the same way). The window
    runs it first, before its events. A state without the reclaim leaves
    comes back as it is. `dead`: ca_dead_slots(state, st) where the caller
    has it. `k`: step.DeviceConstants.

    A slot retires when its node's removal has drained: the node is dead
    with no pending create or remove effect, no RUNNING pod binds it, and
    no SUCCEEDED pod on it has a finish whose storage visibility (finish
    + ca_finish_vis) is still after (W, 0), which a later CA snapshot could
    still see as running. Keepers pack to the front of their group in slot
    order, so slot order among live CA nodes stays allocation order; the CA
    node segment and every pod's node pointer follow the move (a pointer of
    a pod already past the horizon follows its retired slot, and nothing
    reads it again); retired slots come back at full allocatable and
    allocation index -1. Caps are uniform within a group and the crash
    payload is zero on CA slots, so neither moves. Fixed shapes, no host
    branch: with nothing retired the permutation is the identity and the
    pass returns its input's values bit for bit. With `period` N > 1 a
    window with (W + 1) % N != 0 retires nothing (reference
    autoscale.py:1762-1764), so the pass is the identity there too."""
    auto = state.auto
    if auto is None or auto.ca_alloc is None:
        return state
    nodes, pods = state.nodes, state.pods
    C, S = auto.ca_alloc.shape
    N = nodes.alive.shape[1]
    Gn = st.ng_ca_start.shape[1]
    n_trace = N - S
    dev = auto.ca_alloc.device
    slotc = st.ca_slots.clamp(0, N - 1).long()
    if dead is None:
        dead = ca_dead_slots(state, st)
    occupied = auto.ca_alloc >= 0
    # Pods still bound to a node: RUNNING ones, and SUCCEEDED ones whose
    # finish the storage has not seen by the window's start.
    succ_vis = t_add(
        t_add(pods.start_time, pods.duration, k.interval), _col(st.ca_finish_vis), k.interval
    )
    blocking = (
        (pods.phase == PHASE_RUNNING)
        | ((pods.phase == PHASE_SUCCEEDED) & ~t_le(succ_vis, _col(_window_pair(W))))
    ) & (pods.node >= 0)
    tgt = torch.where(blocking, pods.node, N).long()
    node_blocked = torch.zeros((C, N + 1), dtype=torch.bool, device=dev).scatter_(
        1, tgt, torch.ones_like(blocking)
    )[:, :N]
    retired = dead & ~torch.gather(node_blocked, 1, slotc)
    if period > 1:
        retired = retired & _period_window(W, period)
    keep = occupied & ~retired

    # Keepers first within each group, in slot order (each group's slots
    # are contiguous): one stable sort by (group, kept first).
    grp = torch.where(st.ca_slot_group >= 0, st.ca_slot_group, Gn)
    order = torch.sort(grp * 2 + (~keep).to(torch.int32), dim=1, stable=True).indices
    iota = torch.arange(S, dtype=torch.int32, device=dev).expand(C, S)
    inv = torch.empty((C, S), dtype=torch.int32, device=dev).scatter_(1, order, iota)

    def take(a):
        return torch.gather(a, 1, order)

    retired_n = take(retired)

    def moved(a, fresh=None):
        seg = take(a[:, n_trace:])
        if fresh is not None:
            seg = torch.where(retired_n, fresh[:, n_trace:], seg)
        return torch.cat([a[:, :n_trace], seg], dim=1)

    node_ptr = pods.node
    pod_node = torch.where(
        node_ptr >= n_trace,
        n_trace + torch.gather(inv, 1, (node_ptr - n_trace).clamp(0, S - 1).long()),
        node_ptr,
    )
    new_nodes = nodes._replace(
        alive=moved(nodes.alive),
        alloc_cpu=moved(nodes.alloc_cpu, nodes.cap_cpu),
        alloc_ram=moved(nodes.alloc_ram, nodes.cap_ram),
        create_time=TPair(win=moved(nodes.create_time.win), off=moved(nodes.create_time.off)),
        remove_time=TPair(win=moved(nodes.remove_time.win), off=moved(nodes.remove_time.off)),
    )
    new_auto = auto._replace(
        ca_alloc=torch.where(retired_n, -1, take(auto.ca_alloc)),
        ca_cursor=_group_sum(keep, grp, Gn),
        ca_reclaimed=auto.ca_reclaimed + retired.sum(dim=1, dtype=torch.int32),
    )
    return state._replace(nodes=new_nodes, pods=pods._replace(node=pod_node), auto=new_auto)
