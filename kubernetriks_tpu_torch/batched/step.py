"""The window step: trace-event application, pod finishes, one
scheduling cycle and the autoscaler passes for every cluster at once.

Port of the JAX package's `batched/step.py` along its kernel branches: the
slab events of a window apply in chunks through `fused_event_scatter`,
freed resources return through `fused_free_resources`, and the scheduling
cycle runs on the route the engine chose at build (`CYCLE_ROUTES`; the
reference's `_run_scheduling_cycle`, step.py:1466):
- "megakernel": selection, fit/score/place and commit in
  `fused_select_cycle_commit` (dense batches, >= 128 clusters);
- "two_kernel": `fused_select_schedule_cycle` then `fused_commit_scatter`
  (the reference's KTPU_MEGAKERNEL=0 route);
- "sorted": the queue sorted on the device, its top K through
  `fused_schedule_cycle`, the decisions committed with scatters (below
  128 clusters: the trace-replay shape).
Times are the (win, off) pairs of timerep.py; values applied inside a
window are float32 seconds relative to the previous window's start.
`window_body` runs a window as one eager function; the window executor
(graphs.py) runs the same functions as pieces: under CA slot reclaim
`autoscale.ca_reclaim_pass` first, then `event_chunk` per chunk,
`events_tail`, `run_scheduling_cycle`, then the autoscaler passes; and,
between spans of the sliding pod window, its slide (`slide_shift_core`,
`quantize_shift`, `slide_apply`). The window-skipping functions are here
too: the razor's predicate (`window_work_due`), fast-forward's next
window (`next_window_rows`, then its combine) and catch-up (`catch_up_bookkeeping`), and
the conditional move's scans on the device (`conditional_wake`), each
through a glue kernel of ops/window_kernel.py whose plain version is
beside it; and the flight recorder's: the ring's record
(`telemetry_record`, a glue kernel of ops/telemetry_kernel.py, its plain
version `telemetry_record_plain`) and the gauge reading
(`gauge_snapshot`).

What differs from the reference, and why it is exact:
- The reference's data-dependent `lax.cond` / `while_loop` branches become
  host decisions that need no device read-back: the number of event chunks
  and whether any node removal is due this window follow from the host's
  copy of the trace slab and its mirror of the event cursor (the engine
  keeps both), and which autoscaler passes run follows from its mirror of
  the autoscalers' due times (engine.AutoscaleClock). Branches the
  reference takes only to skip work that is the identity (the
  unschedulable wake block with no parked pod, the node-removal gather
  with no removal) are either always computed or skipped on the same host
  knowledge.
- `xla_cumsum16` reproduces the bits of `jnp.cumsum` on XLA:CPU, which the
  cycle's timing (the megakernel's positional tables, `cycle_timing`) is
  built with (see its note).
- The queue sort orders offsets by their int32 bits, as the kernels'
  argmin does: `jax.lax.sort` puts -0.0 before +0.0, `torch.sort` calls
  them equal, and the bits keep the reference's order.
- Every float division divides by a float32 tensor (timerep.py note).

The scheduler profile (batched/pipeline.py) reaches every cycle route's
kernel as `profile`. With the chaos engine on (`faults`, a FaultStep;
reference step.py:304-310, 424-433, 536-557, 657-921, 1311-1360):
- crashes and recoveries are slab events: a recovery is applied as a node
  creation and a crash as a node removal by `fused_event_scatter` (the
  kinds are mapped before the kernel; min and set commute, so the
  accumulators end as the reference's separate scatter and merge leave
  them), while the chunk keeps the crashes' own removal times apart
  (`EventAccumulators.crash_rm`) for the crash accounting and the
  crash-caused reschedules, which run only in windows whose plan holds a
  crash (`WindowPlan.crash_due`, a host fact from the slab: the
  reference's `lax.cond(crashed_now.any())`);
- failing attempts free their resources like finishes, but only real
  finishes fold into the duration estimator; a failed attempt retries
  after the CrashLoopBackOff backoff or fails for good past the restart
  limit;
- each attempt that starts draws its failure at commit
  (`commit_scattered_tail`, ops/chaos_kernel.py `pod_attempt_draw`),
  keyed on the pod's global plain slot, so the draw follows the pod
  through the sliding pod window.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kubernetriks_tpu_torch.batched.pipeline import DEFAULT_PROFILE
from kubernetriks_tpu_torch.batched.state import (
    EV_CREATE_NODE,
    EV_CREATE_POD,
    EV_NODE_CRASH,
    EV_NODE_RECOVER,
    EV_REMOVE_NODE,
    EV_REMOVE_POD,
    PHASE_EMPTY,
    PHASE_FAILED,
    PHASE_QUEUED,
    PHASE_REMOVED,
    PHASE_RUNNING,
    PHASE_SUCCEEDED,
    PHASE_UNSCHEDULABLE,
    TELEM_COUNTERS,
    ClusterBatchState,
    EstArrays,
    PodArrays,
    StepConstants,
    TelemetryRing,
    TraceSlab,
    clone_state,
    counter_snapshot,
    flatten,
    fresh_pod_arrays,
    strip_telemetry,
)
from kubernetriks_tpu_torch.batched.timerep import (
    INF_WIN,
    TPair,
    t_add,
    t_inf,
    t_le,
    t_lt,
    t_norm,
    t_where,
)
from kubernetriks_tpu_torch.ops import telemetry_kernel, window_kernel
from kubernetriks_tpu_torch.ops.chaos_kernel import pod_attempt_draw
from kubernetriks_tpu_torch.ops.scheduler_kernel import (
    commit_scatter_plain,
    fused_commit_scatter,
    fused_event_scatter,
    fused_free_resources,
    fused_schedule_cycle,
    fused_select_cycle_commit,
    fused_select_schedule_cycle,
)

INF = float("inf")
INT32_MAX = torch.iinfo(torch.int32).max
CUMSUM_BLOCK = 16
CYCLE_ROUTES = ("megakernel", "two_kernel", "sorted")


class DeviceConstants(NamedTuple):
    """StepConstants as 0-dim float32 tensors on the state's device: every
    float op of the step then has tensor operands only, the same float32
    values the reference gets from `jnp.float32(consts.x)`. Also the
    constant tables the step reads, built once so that no window copies a
    host value to the device (a CUDA graph cannot capture such a copy)."""

    interval: torch.Tensor
    time_per_node: torch.Tensor
    delta_pod_enqueue: torch.Tensor
    delta_bind_start: torch.Tensor
    delta_reschedule: torch.Tensor
    flush_interval: torch.Tensor
    max_unschedulable_stay: torch.Tensor
    interval64: torch.Tensor  # float64, for the HPA's elapsed-time math
    inf: torch.Tensor  # float32 +inf
    pow10: torch.Tensor  # (9,) int32 decimal_string_key's digit scales
    decimal_bounds: torch.Tensor  # (7,) int32 10 .. 10^7, decimal_string_key's digit counts

    @staticmethod
    def build(consts: StepConstants, device) -> "DeviceConstants":
        def f32(x):
            return torch.tensor(float(x), dtype=torch.float32, device=device)

        return DeviceConstants(
            interval=f32(consts.scheduling_interval),
            time_per_node=f32(consts.time_per_node),
            delta_pod_enqueue=f32(consts.delta_pod_enqueue),
            delta_bind_start=f32(consts.delta_bind_start),
            delta_reschedule=f32(consts.delta_reschedule),
            flush_interval=f32(consts.flush_interval),
            max_unschedulable_stay=f32(consts.max_unschedulable_stay),
            interval64=torch.tensor(float(consts.scheduling_interval), dtype=torch.float64, device=device),
            inf=f32(INF),
            pow10=torch.tensor(
                [0, 10_000_000, 1_000_000, 100_000, 10_000, 1_000, 100, 10, 1],
                dtype=torch.int32, device=device,
            ),
            decimal_bounds=torch.tensor([10**e for e in range(1, 8)], dtype=torch.int32, device=device),
        )


class WindowPlan(NamedTuple):
    """Host-side facts about one window, from the engine's copy of the
    slab and its autoscaler clock: how many event chunks the reference's
    chunk loop runs, whether a node removal can apply (only then can pods
    be rescheduled), and which autoscaler passes run: an HPA cycle, else
    an HPA metrics collection alone, a CA cycle, and CA slot reclaim's
    compaction before the window's events; whether a chaos-engine crash
    applies (a removal, so removal_due then holds too); and under lane
    clocks whether the window freezes inactive lanes. Under lane clocks
    the facts are the union over the lanes active in the window, each at
    its own virtual window."""

    n_chunks: int
    removal_due: bool
    hpa_cycle: bool = False
    hpa_collect: bool = False
    ca_due: bool = False
    reclaim: bool = False
    crash_due: bool = False
    # Lane clocks (a lane-asynchronous engine): None without them; True
    # where a lane may enter or leave its span in the window's chunk, so
    # the window snapshots the state and reverts its inactive lanes
    # (freeze_lanes_); False where the host mirrors prove every lane
    # active throughout (the reference's all-active fast path).
    freeze: Optional[bool] = None


class FaultStep(NamedTuple):
    """The chaos engine's constants of a window (None in its place: faults
    off): the fault parameters (chaos.FaultParams), the scheduling interval
    and the width of the device pod axis's plain segment (the commit draw's
    launch arguments), the backoff's float32 constants on the state's
    device, and a scenario build's per-lane pod-fault seeds (reference
    step.py:1328-1336: (C,) uint32 on the device, each lane's draws keyed
    on cluster 0; None: the params' seed, keyed on the cluster index)."""

    params: object  # chaos.FaultParams
    interval: float
    plain_width: int
    backoff_base: torch.Tensor  # 0-dim float32
    backoff_cap: torch.Tensor  # 0-dim float32
    fault_seed: Optional[torch.Tensor] = None  # (C,) uint32
    # The global cluster index of row 0: a shard of a batch sharded over a
    # mesh keys its commit draws on the global index.
    row0: int = 0


class WakeEvents(NamedTuple):
    """This window's conditional-move wake events (built by event
    application, consumed by the same window's queue preamble). Rel times
    are float32 seconds from the window base."""

    node_mask: torch.Tensor  # (C, N) nodes created this window
    node_rel: torch.Tensor  # (C, N) creation rel seconds; +inf pad
    freed_mask: torch.Tensor  # (C, P) pods freed (finish/removal)
    freed_rel: torch.Tensor  # (C, P) free rel seconds; +inf pad


def xla_cumsum16(x: torch.Tensor) -> torch.Tensor:
    """Row-wise float32 prefix sum with the bits of `jnp.cumsum` on XLA:CPU.

    XLA lowers the cumsum to a reduce_window and rewrites it into a blocked
    scan with blocks of 16: inside each block a sequential prefix sum; the
    block totals are scanned by the same blocked scheme (recursively, once
    there are more than 16 blocks); each later block then gets the scanned
    total of the blocks before it added (`blk + carry`). That order differs
    from a plain sequential sum (`torch.cumsum`, `np.cumsum`) in the last
    bit on most rows, and the result becomes pod start times, which parity
    requires exactly equal. This function adds in that order with
    elementwise adds, so it gives the same bits on the CPU and on the card.
    """
    C, K = x.shape
    if K == 0:
        return x
    nb = -(-K // CUMSUM_BLOCK)
    pad = nb * CUMSUM_BLOCK - K
    if pad:
        x = torch.cat([x, torch.zeros((C, pad), dtype=x.dtype, device=x.device)], dim=1)
    xb = x.reshape(C, nb, CUMSUM_BLOCK)
    acc = xb[:, :, 0]
    cols = [acc]
    for j in range(1, CUMSUM_BLOCK):
        acc = acc + xb[:, :, j]
        cols.append(acc)
    pre = torch.stack(cols, dim=2)  # (C, nb, 16) in-block prefix sums
    if nb > 1:
        carry = xla_cumsum16(pre[:, :, -1].contiguous())  # (C, nb) scanned block totals
        pre = torch.cat([pre[:, :1], pre[:, 1:] + carry[:, :-1, None]], dim=1)
    return pre.reshape(C, nb * CUMSUM_BLOCK)[:, :K]


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k in float32 for int32 k >= 0, exactly (+inf from 128 on):
    the power of two built from its exponent bits, so no exp2 rounding on
    any device. XLA:CPU's jnp.exp2 is exact up to k = 12 only; the
    reference's restart limits keep its backoffs below that."""
    bits = ((k.clamp(0, 127) + 127) << 23).to(torch.int32)
    return torch.where(k >= 128, float("inf"), bits.view(torch.float32))


def t_seconds_f32(a: TPair, interval: torch.Tensor) -> torch.Tensor:
    """Pair -> float32 seconds (metric values and bounded spans)."""
    return a.win.to(torch.float32) * interval + a.off


def _rel_seconds(t: TPair, base_win: torch.Tensor, interval: torch.Tensor) -> torch.Tensor:
    """Pair -> float32 seconds relative to base_win * interval."""
    return (t.win - base_win).to(torch.float32) * interval + t.off


def lexsort_time_i32(t: TPair, seq: torch.Tensor) -> torch.Tensor:
    """Row-wise stable argsort by (time pair, seq) -> int32 slots: the
    active queue's order (reference step.py:86). The offset sorts by its
    int32 bits (non-negative float32 offsets order like their bits, and
    -0.0 comes before +0.0 as in `jax.lax.sort`)."""
    return stable_lexsort((t.win, t.off.contiguous().view(torch.int32), seq)).to(torch.int32)


def stable_lexsort(keys) -> torch.Tensor:
    """Row-wise stable argsort by lexicographic `keys` (most significant
    first), slot order breaking exact ties — `jax.lax.sort(..., is_stable=
    True)` over (*keys, iota). Chained stable sorts, least significant key
    first, so every tie is decided by position, never by the sort."""
    C, P = keys[0].shape
    idx = torch.arange(P, device=keys[0].device).expand(C, P)
    for key in reversed(keys):
        perm = torch.sort(torch.gather(key, 1, idx), dim=1, stable=True).indices
        idx = torch.gather(idx, 1, perm)
    return idx


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """rank[c, order[c, j]] = j (order rows are permutations: no ties)."""
    return torch.sort(order, dim=1, stable=True).indices


def _stable_queue_rank(keys) -> torch.Tensor:
    """Dense queue ranks from lexicographic (C, P) keys: the inverse of a
    stable sort over the pod axis."""
    return _inverse_permutation(stable_lexsort(keys)).to(torch.int32)


def _scatter_min(acc, slots, mask, values):
    """acc[c, slots[c, e]] = min(acc, values[c, e]) where mask; slots out
    of range drop (into a sink column). Min is exact in any order."""
    C, N = acc.shape
    wide = torch.cat([acc, torch.full((C, 1), INF, dtype=acc.dtype, device=acc.device)], dim=1)
    idx = torch.where(mask & (slots >= 0) & (slots < N), slots, N).long()
    return wide.scatter_reduce(1, idx, torch.where(mask, values, INF), "amin")[:, :N]


class EventAccumulators(NamedTuple):
    """What a window's event chunks gather for its tail (the chunk loop's
    carry in the reference's `_apply_window_events_work`, step.py:274):
    per node slot, created this window and the earliest removal; per pod
    slot, the earliest create time with its queue sequence number and the
    earliest removal; per cluster, the pod creations so far. Times are
    float32 seconds from the window base, +inf = none. With node faults,
    also the crashes' removal times (included in node_removal too) and
    the recoveries so far."""

    created: torch.Tensor  # (C, N) bool
    node_removal: torch.Tensor  # (C, N) float32
    pod_create: torch.Tensor  # (C, P) float32
    pod_create_seq: torch.Tensor  # (C, P) int32
    pod_removal: torch.Tensor  # (C, P) float32
    n_creates: torch.Tensor  # (C,) int32
    crash_rm: Optional[torch.Tensor] = None  # (C, N) float32
    n_recover: Optional[torch.Tensor] = None  # (C,) int32

    @staticmethod
    def fresh(C: int, N: int, P: int, device, node_faults: bool = False) -> "EventAccumulators":
        acc = EventAccumulators(
            created=torch.empty((C, N), dtype=torch.bool, device=device),
            node_removal=torch.empty((C, N), dtype=torch.float32, device=device),
            pod_create=torch.empty((C, P), dtype=torch.float32, device=device),
            pod_create_seq=torch.empty((C, P), dtype=torch.int32, device=device),
            pod_removal=torch.empty((C, P), dtype=torch.float32, device=device),
            n_creates=torch.empty((C,), dtype=torch.int32, device=device),
            crash_rm=torch.empty((C, N), dtype=torch.float32, device=device) if node_faults else None,
            n_recover=torch.empty((C,), dtype=torch.int32, device=device) if node_faults else None,
        )
        acc.reset_()
        return acc

    def reset_(self) -> None:
        """Back to the start of a window, in place."""
        self.created.fill_(False)
        self.node_removal.fill_(INF)
        self.pod_create.fill_(INF)
        self.pod_create_seq.fill_(0)
        self.pod_removal.fill_(INF)
        self.n_creates.fill_(0)
        if self.crash_rm is not None:
            self.crash_rm.fill_(INF)
            self.n_recover.fill_(0)


def event_chunk(
    state: ClusterBatchState,
    slab: TraceSlab,
    W: torch.Tensor,
    consts: StepConstants,
    k: DeviceConstants,
    max_events_per_window: int,
    acc: EventAccumulators,
    node_create_rel: Optional[torch.Tensor] = None,
):
    """One chunk of up to E slab events per cluster from the state's event
    cursor, those with effect time before the cycle time W * interval (the
    reference's chunk-loop body). Reads only the device cursor, so the same
    call serves every chunk of every window. Returns (the cursor past the
    applied events, acc with them folded in, node_create_rel: with
    conditional move, the earliest creation of each node this window)."""
    C = state.time.shape[0]
    dev = state.time.device
    E_total = slab.packed.shape[1]
    E = max_events_per_window
    rows = torch.arange(C, device=dev)[:, None]
    base = W - 1  # the window the applied events fall in
    cursor = state.event_cursor
    offs = cursor[:, None] + torch.arange(E, dtype=torch.int32, device=dev)[None, :]
    pk = slab.packed[rows, offs.clamp(0, E_total - 1).long()]  # (C, E, 4)
    ev_win = pk[..., 0]
    ev_off = pk[..., 1].contiguous().view(torch.float32)
    ev_k = pk[..., 2].contiguous()
    ev_s_raw = pk[..., 3]
    valid = (offs < E_total) & (ev_win < W[:, None])
    # Pod event slots are global; the device slot subtracts pod_base
    # (0 on whole-trace runs). Negative slots drop.
    is_pod_ev = (ev_k == EV_CREATE_POD) | (ev_k == EV_REMOVE_POD)
    seg_shift = torch.where(
        ev_s_raw < consts.trace_pod_bound,
        state.pod_base[:, None],
        consts.resident_shift,
    )
    ev_s = torch.where(is_pod_ev, ev_s_raw - seg_shift, ev_s_raw)
    ev_s = torch.where(is_pod_ev & (ev_s < 0), 1 << 29, ev_s).to(torch.int32)
    ev_rel = (ev_win - base[:, None]).to(torch.float32) * k.interval + ev_off
    is_cp = valid & (ev_k == EV_CREATE_POD)
    # Queue sequence numbers follow slab order across chunks. An integer
    # prefix count: exact in any summation order.
    create_rank = torch.cumsum(is_cp, dim=1, dtype=torch.int32) - 1
    ev_seq = (state.queue_seq_counter[:, None] + acc.n_creates[:, None] + create_rank).to(torch.int32)
    crash_rm, n_recover = acc.crash_rm, acc.n_recover
    if crash_rm is not None:
        # A recovery applies as a creation, a crash as a removal (module
        # note); the crashes' own times go to crash_rm (slot N drops).
        is_crash = valid & (ev_k == EV_NODE_CRASH)
        is_recover = valid & (ev_k == EV_NODE_RECOVER)
        ev_k = torch.where(is_recover, EV_CREATE_NODE, torch.where(is_crash, EV_REMOVE_NODE, ev_k)).to(torch.int32)
        N = crash_rm.shape[1]
        wide = torch.cat([crash_rm, torch.full((C, 1), INF, dtype=torch.float32, device=dev)], dim=1)
        crash_rm = wide.scatter_reduce(
            1, torch.where(is_crash, ev_s, N).long(), torch.where(is_crash, ev_rel, INF), "amin"
        )[:, :N]
        n_recover = n_recover + is_recover.sum(dim=1, dtype=torch.int32)
    created, node_removal, pod_create, pod_create_seq, pod_removal = fused_event_scatter(
        ev_k, ev_s, ev_rel, ev_seq, valid,
        acc.created, acc.node_removal, acc.pod_create, acc.pod_create_seq, acc.pod_removal,
    )
    if node_create_rel is not None:
        is_cn = valid & (ev_k == EV_CREATE_NODE)
        node_create_rel = _scatter_min(node_create_rel, ev_s, is_cn, ev_rel)
    return (
        cursor + valid.sum(dim=1, dtype=torch.int32),
        EventAccumulators(
            created, node_removal, pod_create, pod_create_seq, pod_removal,
            acc.n_creates + is_cp.sum(dim=1, dtype=torch.int32), crash_rm, n_recover,
        ),
        node_create_rel,
    )


def apply_window_events(
    state: ClusterBatchState,
    slab: TraceSlab,
    W: torch.Tensor,
    consts: StepConstants,
    k: DeviceConstants,
    max_events_per_window: int,
    plan: WindowPlan,
    conditional_move: bool = False,
    name_ranks=None,
    node_key=None,
    faults: Optional[FaultStep] = None,
    window_razor: bool = False,
):
    """Apply every trace event with effect time strictly before the cycle
    time W * interval, and resolve every pod finish due in the window
    (reference `_apply_window_events_work`, step.py:274, along its kernel
    branches): plan.n_chunks event chunks, then the tail. With
    `window_razor` (reference `_apply_window_events`, step.py:203) a
    window whose work_due predicate is false only sets time = max(time,
    W), with empty WakeEvents under the conditional move: the predicate is
    read back here, as this eager body decides on the host (the window
    executor puts the tail in a conditional node instead). Returns (state,
    WakeEvents or None)."""
    C, P = state.pods.phase.shape
    N = state.nodes.alive.shape[1]
    dev = state.time.device
    if window_razor and not bool(window_work_due(state, slab, W)):
        wake = empty_wake(C, N, P, dev) if conditional_move else None
        return state._replace(time=torch.maximum(state.time, W)), wake
    acc = EventAccumulators.fresh(C, N, P, dev, node_faults=faults is not None and faults.params.node_faults)
    node_create_rel = (
        torch.full((C, N), INF, dtype=torch.float32, device=dev) if conditional_move else None
    )
    for _ in range(plan.n_chunks):
        cursor, acc, node_create_rel = event_chunk(
            state, slab, W, consts, k, max_events_per_window, acc, node_create_rel
        )
        state = state._replace(event_cursor=cursor)
    return events_tail(
        state, acc, W, k, plan.removal_due, conditional_move, name_ranks, node_create_rel, node_key,
        faults, plan.crash_due,
    )


def events_tail(
    state: ClusterBatchState,
    acc: EventAccumulators,
    W: torch.Tensor,
    k: DeviceConstants,
    removal_due: bool,
    conditional_move: bool = False,
    name_ranks=None,
    node_create_rel: Optional[torch.Tensor] = None,
    node_key: Optional[torch.Tensor] = None,
    faults: Optional[FaultStep] = None,
    crash_due: bool = False,
):
    """The window's events after its chunks: the pending autoscaler node
    effects and pod removals due, creations, pod finishes against node and
    pod removals, freed resources back to their nodes, and reschedules of
    the pods of removed nodes (reference step.py:274, after the chunk
    loop). `removal_due`: whether a node removal can apply this window
    (step.WindowPlan). `name_ranks`: (node, pod) name ranks for the
    reschedules' order; `node_key`: under CA slot reclaim, the nodes'
    current name key (autoscale.ca_name_order's, from the autoscaler
    state the window's reclaim pass left, which events do not change) in
    place of the static node ranks. `faults`, `crash_due`: the chaos
    engine (module note). Returns (state, WakeEvents or None)."""
    pods, nodes, metrics = state.pods, state.nodes, state.metrics
    C, P = pods.phase.shape
    N = nodes.alive.shape[1]
    dev = pods.phase.device
    interval = k.interval
    base = W - 1  # the window the applied events fall in
    created, node_removal = acc.created, acc.node_removal
    pod_create, pod_create_seq, pod_removal = acc.pod_create, acc.pod_create_seq, acc.pod_removal
    n_creates = acc.n_creates

    # --- pending cluster-autoscaler node effects and HPA pod removals due
    # this window ------------------------------------------------------------
    f32inf = k.inf
    pend_create_row = (nodes.create_time.win < W[:, None]) & ~nodes.alive
    created = created | pend_create_row
    if conditional_move:
        node_create_rel = torch.minimum(
            node_create_rel,
            torch.where(
                pend_create_row,
                _rel_seconds(nodes.create_time, base[:, None], interval),
                f32inf,
            ),
        )
    node_create_time = t_where(pend_create_row, t_inf((C, N), dev), nodes.create_time)
    pend_rm_due = nodes.remove_time.win < W[:, None]
    node_removal = torch.minimum(
        node_removal,
        torch.where(pend_rm_due, _rel_seconds(nodes.remove_time, base[:, None], interval), f32inf),
    )
    node_remove_time = t_where(pend_rm_due, t_inf((C, N), dev), nodes.remove_time)
    pend_prm_due = pods.removal_time.win < W[:, None]
    pod_removal = torch.minimum(
        pod_removal,
        torch.where(pend_prm_due, _rel_seconds(pods.removal_time, base[:, None], interval), f32inf),
    )
    pod_removal_time = t_where(pend_prm_due, t_inf((C, P), dev), pods.removal_time)

    node_faults = faults is not None and faults.params.node_faults
    pod_faults = faults is not None and faults.params.pod_faults
    if node_faults:
        # Crash accounting (the slot's pre-sampled repair span is its
        # downtime; a slot crashes at most once: recoveries open new ones).
        metrics = metrics._replace(node_recoveries=metrics.node_recoveries + acc.n_recover)
        if crash_due:
            crashed_now = acc.crash_rm < f32inf
            metrics = metrics._replace(
                node_crashes=metrics.node_crashes + crashed_now.sum(dim=1, dtype=torch.int32),
                node_downtime_s=metrics.node_downtime_s
                + torch.where(crashed_now, nodes.crash_downtime, 0.0).sum(dim=1),
            )

    # --- creations ----------------------------------------------------------
    alive = nodes.alive | created
    alloc_cpu = torch.where(created, nodes.cap_cpu, nodes.alloc_cpu)
    alloc_ram = torch.where(created, nodes.cap_ram, nodes.alloc_ram)
    base_p = base[:, None].expand(C, P)
    was_empty_created = (pods.phase == PHASE_EMPTY) & (pod_create < f32inf)
    enqueue_ts = t_norm(
        base_p,
        torch.where(was_empty_created, pod_create, 0.0) + k.delta_pod_enqueue,
        interval,
    )
    phase = torch.where(was_empty_created, PHASE_QUEUED, pods.phase).to(torch.int32)
    queue_ts = t_where(was_empty_created, enqueue_ts, pods.queue_ts)
    queue_seq = torch.where(was_empty_created, pod_create_seq, pods.queue_seq)
    initial_attempt_ts = t_where(was_empty_created, enqueue_ts, pods.initial_attempt_ts)
    attempts = torch.where(was_empty_created, 1, pods.attempts).to(torch.int32)

    # --- running pods: finish vs node removal vs pod removal ----------------
    running = phase == PHASE_RUNNING
    if removal_due:
        node_idx = pods.node.clamp(min=0).long()
        pod_node_removal = torch.where(
            pods.node >= 0, torch.gather(node_removal, 1, node_idx), f32inf
        )
    else:
        # No removal applies this window: node_removal is all +inf.
        pod_node_removal = torch.full((C, P), INF, dtype=torch.float32, device=dev)
    interrupt = torch.minimum(pod_node_removal, pod_removal)
    has_interrupt = interrupt < f32inf
    cut = t_norm(
        torch.where(has_interrupt, base[:, None], W[:, None]),
        torch.where(has_interrupt, interrupt, 0.0),
        interval,
    )
    finishes = running & t_le(pods.finish_time, cut)
    interrupted = running & ~finishes & has_interrupt
    rescheds = interrupted & (pod_node_removal < pod_removal)
    removed_running = interrupted & (pod_removal <= pod_node_removal)

    # Chaos: a finishing attempt whose draw failed fails at its finish
    # time; it frees its resources like a finish, but only real finishes
    # count and fold into the duration estimator.
    if pod_faults:
        fails = finishes & pods.will_fail
        real_fin = finishes & ~pods.will_fail
    else:
        fails = None
        real_fin = finishes
    if node_faults and crash_due:
        # Crash-caused reschedules: the pod's earliest node removal is its
        # node's crash (a tie counts as the crash).
        pod_crash_rm = torch.where(
            pods.node >= 0, torch.gather(acc.crash_rm, 1, pods.node.clamp(min=0).long()), f32inf
        )
        crash_caused = rescheds & (pod_crash_rm <= pod_node_removal)
        metrics = metrics._replace(
            pod_interruptions=metrics.pod_interruptions + crash_caused.sum(dim=1, dtype=torch.int32)
        )

    # Freed resources back to their nodes + the finished pods' duration
    # estimator fold (one kernel).
    freed = finishes | removed_running
    duration_s = t_seconds_f32(pods.duration, interval)
    alloc_cpu, alloc_ram, dur_stats = fused_free_resources(
        freed, pods.node, pods.req_cpu, pods.req_ram,
        real_fin, duration_s, alloc_cpu, alloc_ram,
    )
    n_done = dur_stats[:, 0].to(torch.int32)
    est = metrics.pod_duration
    metrics = metrics._replace(
        pods_succeeded=metrics.pods_succeeded + n_done,
        terminated_pods=metrics.terminated_pods + n_done,
        pod_duration=EstArrays(
            count=est.count + n_done,
            total=est.total + dur_stats[:, 1],
            total_sq=est.total_sq + dur_stats[:, 2],
            minimum=torch.minimum(est.minimum, dur_stats[:, 3]),
            maximum=torch.maximum(est.maximum, dur_stats[:, 4]),
        ),
        processed_nodes=metrics.processed_nodes + created.sum(dim=1, dtype=torch.int32),
    )
    phase = torch.where(real_fin, PHASE_SUCCEEDED, phase).to(torch.int32)
    finish_time = t_where(finishes, t_inf((C, P), dev), pods.finish_time)

    # Reschedule pods of removed nodes. Same-window reschedules queue in
    # (removal time, node name, pod name) order.
    pod_node = pods.node
    n_rescheds = torch.zeros((C,), dtype=torch.int32, device=dev)
    if removal_due:
        big = 1 << 30
        node_c2 = pods.node.clamp(0, N - 1).long()
        if name_ranks is not None:
            node_name_rank, pod_name_rank = name_ranks
            if node_key is not None:
                node_name_rank = node_key
            nr = torch.gather(node_name_rank, 1, node_c2)
            k3 = torch.where(rescheds, pod_name_rank, big)
        else:
            nr = node_c2.to(torch.int32)
            k3 = torch.zeros((C, P), dtype=torch.int32, device=dev)
        resched_rank = _stable_queue_rank(
            (torch.where(rescheds, pod_node_removal, f32inf), torch.where(rescheds, nr, big), k3)
        )
        resched_ts = t_norm(
            base_p,
            torch.where(rescheds, pod_node_removal, 0.0) + k.delta_reschedule,
            interval,
        )
        phase = torch.where(rescheds, PHASE_QUEUED, phase).to(torch.int32)
        queue_ts = t_where(rescheds, resched_ts, queue_ts)
        queue_seq = torch.where(
            rescheds,
            state.queue_seq_counter[:, None] + n_creates[:, None] + resched_rank,
            queue_seq,
        ).to(torch.int32)
        initial_attempt_ts = t_where(rescheds, resched_ts, initial_attempt_ts)
        attempts = torch.where(rescheds, 1, attempts).to(torch.int32)
        finish_time = t_where(rescheds, t_inf((C, P), dev), finish_time)
        pod_node = torch.where(rescheds, -1, pods.node).to(torch.int32)
        n_rescheds = rescheds.sum(dim=1, dtype=torch.int32)

    # Chaos: the failing attempts' CrashLoopBackOff (reference
    # step.py:818-890): a retry re-enters the queue at fail + min(base *
    # 2^restarts, cap), no earlier than the failure's own delivery
    # (delta_reschedule), with a fresh initial-attempt time; past the
    # restart limit the pod fails for good.
    restarts = pods.restarts
    will_fail = pods.will_fail
    queue_seq_counter = state.queue_seq_counter + n_creates + n_rescheds
    if pod_faults:
        new_restarts = pods.restarts + 1
        retry = fails & (new_restarts <= faults.params.restart_limit)
        perma = fails & ~retry
        fail_rel = _rel_seconds(pods.finish_time, base[:, None], interval)
        backoff = torch.minimum(faults.backoff_base * exp2_int(pods.restarts), faults.backoff_cap)
        retry_ts = t_norm(
            base_p,
            torch.where(retry, fail_rel + torch.maximum(backoff, k.delta_reschedule), 0.0),
            interval,
        )
        # Same-window retries queue in (fail time, pod name) order.
        big = 1 << 30
        k2 = (
            torch.where(retry, name_ranks[1], big)
            if name_ranks is not None
            else torch.zeros((C, P), dtype=torch.int32, device=dev)
        )
        fail_rank = _stable_queue_rank((torch.where(retry, fail_rel, f32inf), k2))
        phase = torch.where(retry, PHASE_QUEUED, torch.where(perma, PHASE_FAILED, phase)).to(torch.int32)
        queue_ts = t_where(retry, retry_ts, queue_ts)
        queue_seq = torch.where(
            retry,
            state.queue_seq_counter[:, None] + n_creates[:, None] + n_rescheds[:, None] + fail_rank,
            queue_seq,
        ).to(torch.int32)
        initial_attempt_ts = t_where(retry, retry_ts, initial_attempt_ts)
        attempts = torch.where(retry, 1, attempts).to(torch.int32)
        pod_node = torch.where(fails, -1, pod_node).to(torch.int32)
        restarts = torch.where(fails, new_restarts, pods.restarts).to(torch.int32)
        will_fail = will_fail & ~fails
        n_fail_retries = retry.sum(dim=1, dtype=torch.int32)
        queue_seq_counter = queue_seq_counter + n_fail_retries
        n_perma = perma.sum(dim=1, dtype=torch.int32)
        metrics = metrics._replace(
            pod_restarts=metrics.pod_restarts + n_fail_retries,
            pods_failed=metrics.pods_failed + n_perma,
            terminated_pods=metrics.terminated_pods + n_perma,
        )

    # Removed-while-running pods terminate as removed.
    n_removed_running = removed_running.sum(dim=1, dtype=torch.int32)
    metrics = metrics._replace(
        pods_removed=metrics.pods_removed + n_removed_running,
        terminated_pods=metrics.terminated_pods + n_removed_running,
    )
    phase = torch.where(removed_running, PHASE_REMOVED, phase).to(torch.int32)
    finish_time = t_where(removed_running, t_inf((C, P), dev), finish_time)
    # Removal of queued/unschedulable pods: dropped, no metrics.
    removed_queued = (
        ((phase == PHASE_QUEUED) | (phase == PHASE_UNSCHEDULABLE))
        & (pod_removal < f32inf)
        & ~removed_running
    )
    phase = torch.where(removed_queued, PHASE_REMOVED, phase).to(torch.int32)
    alive = alive & ~(node_removal < f32inf)

    any_created_node = created.any(dim=1)
    any_freed = (n_done > 0) | (n_removed_running > 0)
    if pod_faults:
        # A failing attempt wakes the unschedulable queue like a finish.
        any_freed = any_freed | fails.any(dim=1)

    wake = None
    if conditional_move:
        wake = WakeEvents(
            node_mask=created,
            node_rel=torch.where(created, node_create_rel, f32inf),
            freed_mask=freed,
            freed_rel=torch.where(
                finishes,
                _rel_seconds(pods.finish_time, base[:, None], interval),
                torch.where(removed_running, pod_removal, f32inf),
            ),
        )

    new_state = state._replace(
        nodes=nodes._replace(
            alive=alive,
            alloc_cpu=alloc_cpu,
            alloc_ram=alloc_ram,
            create_time=node_create_time,
            remove_time=node_remove_time,
        ),
        pods=pods._replace(
            phase=phase,
            queue_ts=queue_ts,
            queue_seq=queue_seq,
            initial_attempt_ts=initial_attempt_ts,
            attempts=attempts,
            node=pod_node,
            finish_time=finish_time,
            removal_time=pod_removal_time,
            restarts=restarts,
            will_fail=will_fail,
        ),
        metrics=metrics,
        queue_seq_counter=queue_seq_counter,
        requeue_signal=state.requeue_signal | any_created_node | any_freed,
        time=torch.maximum(state.time, W),
    )
    return new_state, wake


def _wake_scan_inputs(state, pods, stale, wake: WakeEvents):
    """The conditional move's scan operands (reference
    `_conditional_wake_exact`, step.py:994): the parked pods in (queue_ts,
    queue_seq) order and the wake events in effect-time order, each by a
    stable sort. Returns (the parked order, (o_valid, o_cpu, o_ram) (C,
    P), (s_valid, s_is_node, s_cpu, s_ram) (C, N + P))."""
    C, P = pods.phase.shape
    N = wake.node_mask.shape[1]
    dev = pods.phase.device
    unsched = (pods.phase == PHASE_UNSCHEDULABLE) & ~stale
    u_t = t_where(unsched, pods.queue_ts, t_inf((C, P), dev))
    u_seq = torch.where(unsched, pods.queue_seq, INT32_MAX)
    order = stable_lexsort((u_t.win, u_t.off, u_seq))
    parked = tuple(torch.gather(x, 1, order).contiguous() for x in (unsched, pods.req_cpu, pods.req_ram))
    ev_rel = torch.cat([wake.node_rel, wake.freed_rel], dim=1)
    ev_valid = torch.cat([wake.node_mask, wake.freed_mask], dim=1)
    ev_is_node = torch.cat(
        [torch.ones((C, N), dtype=torch.bool, device=dev), torch.zeros((C, P), dtype=torch.bool, device=dev)],
        dim=1,
    )
    ev_cpu = torch.cat([state.nodes.cap_cpu, pods.req_cpu], dim=1)
    ev_ram = torch.cat([state.nodes.cap_ram, pods.req_ram], dim=1)
    perm = torch.sort(torch.where(ev_valid, ev_rel, INF), dim=1, stable=True).indices
    events = tuple(torch.gather(x, 1, perm).contiguous() for x in (ev_valid, ev_is_node, ev_cpu, ev_ram))
    return order, parked, events


def wake_scan_plain(o_valid, o_cpu, o_ram, s_valid, s_is_node, s_cpu, s_ram) -> torch.Tensor:
    """The conditional move's greedy budget scans, as host loops over the
    event and pod axes (bounded by the most valid events and parked pods
    of any cluster, read back): each valid event, in order, walks the
    parked pods not moved yet, first-fit against its int32 budget (a
    node's capacity, a freed pod's requests). A node-add moves the pods
    that do NOT fit (the reference's behaviour, kept as is); a freed pod
    moves the pods that fit. Returns the (C, P) moves in parked order.
    The plain version of ops/window_kernel.conditional_wake_scan."""
    C, P = o_valid.shape
    dev = o_valid.device
    n_ev = int(s_valid.sum(dim=1).max()) if C else 0
    n_u = int(o_valid.sum(dim=1).max()) if C else 0
    moved = torch.zeros((C, P), dtype=torch.bool, device=dev)
    for e in range(n_ev):
        v_valid = s_valid[:, e]
        v_is_node = s_is_node[:, e]
        bud_cpu = s_cpu[:, e]
        bud_ram = s_ram[:, e]
        cols = []
        for j in range(n_u):
            considered = o_valid[:, j] & ~moved[:, j] & v_valid
            fits = considered & (o_cpu[:, j] <= bud_cpu) & (o_ram[:, j] <= bud_ram)
            bud_cpu = bud_cpu - torch.where(fits, o_cpu[:, j], 0)
            bud_ram = bud_ram - torch.where(fits, o_ram[:, j], 0)
            cols.append(torch.where(v_is_node, considered & ~fits, fits))
        if cols:
            mv = torch.stack(cols, dim=1)
            moved = moved | torch.cat([mv, torch.zeros((C, P - n_u), dtype=torch.bool, device=dev)], dim=1)
    return moved


def conditional_wake_exact(state, pods, stale, wake: WakeEvents) -> torch.Tensor:
    """Resource-aware unschedulable wakes for
    enable_unscheduled_pods_conditional_move (reference
    `_conditional_wake_exact`, step.py:994): each node-add / freed event,
    in effect-time order, runs its own greedy budget scan over the parked
    pods in (queue_ts, queue_seq) order (wake_scan_plain). Returns the
    (C, P) moves in slot order. The host-loop twin of conditional_wake,
    which the window step runs; it reads the device back."""
    order, parked, events = _wake_scan_inputs(state, pods, stale, wake)
    moved = wake_scan_plain(*parked, *events)
    return torch.gather(moved, 1, _inverse_permutation(order))


def conditional_wake(state, pods, stale, wake: WakeEvents) -> torch.Tensor:
    """conditional_wake_exact with no host read: the two stable sorts in
    torch, the scans in ops/window_kernel.conditional_wake_scan (one CUDA
    launch on the card, wake_scan_plain on the CPU). With no parked pod
    every move is False, so it runs in every window."""
    order, parked, events = _wake_scan_inputs(state, pods, stale, wake)
    moved = window_kernel.conditional_wake_scan(*parked, *events)
    return torch.gather(moved, 1, _inverse_permutation(order))


def empty_wake(C: int, N: int, P: int, device) -> WakeEvents:
    """The WakeEvents of a window with no wake event (the razor's skip
    branch)."""
    return WakeEvents(
        node_mask=torch.zeros((C, N), dtype=torch.bool, device=device),
        node_rel=torch.full((C, N), INF, dtype=torch.float32, device=device),
        freed_mask=torch.zeros((C, P), dtype=torch.bool, device=device),
        freed_rel=torch.full((C, P), INF, dtype=torch.float32, device=device),
    )


def prepare_queue(
    state: ClusterBatchState,
    W: torch.Tensor,
    k: DeviceConstants,
    conditional_move: bool = False,
    wake: Optional[WakeEvents] = None,
):
    """Queue preamble (reference `prepare_queue`, step.py:1143): the
    unschedulable wake/flush moves and the eligibility mask. Returns (pods
    with moves applied, last_flush_win, eligible (C, P)). The reference
    skips the move block when no pod is parked; with no parked pod the
    block is the identity, so it runs unconditionally here, the
    conditional move's scan included (no host read)."""
    C, P = state.pods.phase.shape
    pods = state.pods
    dev = pods.phase.device
    interval = k.interval
    Tpair = TPair(
        win=W[:, None].expand(C, P),
        off=torch.zeros((C, P), dtype=torch.float32, device=dev),
    )
    flush_now = (W - state.last_flush_win).to(torch.float32) * interval >= k.flush_interval
    stay_cut = t_norm(pods.queue_ts.win, pods.queue_ts.off + k.max_unschedulable_stay, interval)
    parked = pods.phase == PHASE_UNSCHEDULABLE
    stale = parked & t_lt(stay_cut, Tpair) & flush_now[:, None]
    if conditional_move:
        moves = conditional_wake(state, pods, stale, wake)
    else:
        moves = state.requeue_signal[:, None] & parked
    to_move = stale | moves
    pods = pods._replace(
        phase=torch.where(to_move, PHASE_QUEUED, pods.phase).to(torch.int32),
        attempts=pods.attempts + to_move.to(torch.int32),
    )
    last_flush_win = torch.where(flush_now, W, state.last_flush_win)
    # Eligible = queued strictly before T, i.e. queue_ts.win < W.
    eligible = (pods.phase == PHASE_QUEUED) & (pods.queue_ts.win < W[:, None])
    return pods, last_flush_win, eligible


def commit_scattered_tail(
    state: ClusterBatchState,
    pods,
    last_flush_win,
    W: torch.Tensor,
    k: DeviceConstants,
    alloc_cpu,
    alloc_ram,
    metrics,
    phase,
    node,
    start_tmp,
    park_tmp,
    faults: Optional[FaultStep] = None,
) -> ClusterBatchState:
    """Bottom half of the decision commit (reference step.py:1271): rebuild
    absolute start/finish/park pairs from the float32 second offsets the
    megakernel scattered (+inf = untouched) and write the post-cycle
    state. With pod faults, every attempt that starts draws its failure
    here (reference step.py:1311-1360, ops/chaos_kernel.py): a failing
    attempt's finish time becomes its fail time and will_fail is set."""
    C, P = pods.phase.shape
    dev = pods.phase.device
    interval = k.interval
    Wp = W[:, None].expand(C, P)
    started = start_tmp < INF
    start_pair = t_norm(Wp, torch.where(started, start_tmp, 0.0), interval)
    service = pods.duration.win < 0
    finish_pair = t_add(start_pair, pods.duration, interval)
    start_time = t_where(started, start_pair, pods.start_time)
    finish_val = t_where(service, t_inf((C, P), dev), finish_pair)
    fault_fields = {}
    if faults is not None and faults.params.pod_faults:
        fp = faults.params
        will_fail, fail_rel = pod_attempt_draw(
            start_tmp, pods.restarts, pods.duration.win, pods.duration.off, pods.will_fail,
            state.pod_base, fp.seed if faults.fault_seed is None else faults.fault_seed, min(faults.plain_width, P),
            fp.fail_prob, faults.interval, faults.row0,
        )
        finish_val = t_where(started & will_fail, t_norm(Wp, fail_rel, interval), finish_val)
        fault_fields["will_fail"] = will_fail
    finish_time = t_where(started, finish_val, pods.finish_time)
    parked = park_tmp < INF
    park_pair = t_norm(Wp, torch.where(parked, park_tmp, 0.0), interval)
    queue_ts = t_where(parked, park_pair, pods.queue_ts)
    return state._replace(
        nodes=state.nodes._replace(alloc_cpu=alloc_cpu, alloc_ram=alloc_ram),
        pods=pods._replace(
            phase=phase,
            queue_ts=queue_ts,
            node=node,
            start_time=start_time,
            finish_time=finish_time,
            **fault_fields,
        ),
        metrics=metrics,
        requeue_signal=torch.zeros_like(state.requeue_signal),
        last_flush_win=last_flush_win,
        time=torch.maximum(state.time, W),
    )


class CycleCandidates(NamedTuple):
    """One cycle's compacted candidates per cluster (reference step.py:1093)."""

    pods: object  # PodArrays with the queue's wake/flush moves applied
    last_flush_win: torch.Tensor
    cand: torch.Tensor  # (C, K) int32 pod slots in queue order
    valid: torch.Tensor  # (C, K) bool
    req_cpu: torch.Tensor  # (C, K) int32
    req_ram: torch.Tensor  # (C, K) int32
    waited: torch.Tensor  # (C, K) float32 queue wait at the cycle: T - initial_attempt_ts


def cycle_timing(valid, waited, pod_sched_time, k: DeviceConstants):
    """(pod_queue_time, start_s, park_s), each (C, K) float32 (reference
    step.py:1107): the simulated cycle duration is a prefix sum of the
    per-candidate scheduling time over the valid mask (xla_cumsum16, the
    bits of `jnp.cumsum`); start and park are offsets from the cycle time."""
    step_dur = torch.where(valid, pod_sched_time[:, None], 0.0)
    cd_post = xla_cumsum16(step_dur)
    pod_queue_time = waited + (cd_post - step_dur)
    return pod_queue_time, cd_post + k.delta_bind_start, cd_post


def _est_add_reduced(est: EstArrays, values: torch.Tensor, mask: torch.Tensor) -> EstArrays:
    """Fold a (C, K) masked batch of samples into the (C,) estimator
    accumulators (reference step.py:98). The float32 sums run in PyTorch's
    order, not XLA's: equal within compare_states' rtol 1e-6."""
    maskf = mask.to(torch.float32)
    return EstArrays(
        count=est.count + mask.sum(dim=1, dtype=torch.int32),
        total=est.total + (values * maskf).sum(dim=1),
        total_sq=est.total_sq + (values * values * maskf).sum(dim=1),
        minimum=torch.minimum(est.minimum, torch.where(mask, values, INF).amin(dim=1)),
        maximum=torch.maximum(est.maximum, torch.where(mask, values, -INF).amax(dim=1)),
    )


def decision_metrics(metrics, assign_k, pod_queue_time_k, pod_sched_time):
    """One cycle's decisions folded into the metric accumulators
    (reference step.py:1127)."""
    C, K = assign_k.shape
    return metrics._replace(
        scheduling_decisions=metrics.scheduling_decisions + assign_k.sum(dim=1, dtype=torch.int32),
        queue_time=_est_add_reduced(metrics.queue_time, pod_queue_time_k, assign_k),
        algo_latency=_est_add_reduced(
            metrics.algo_latency, pod_sched_time[:, None].expand(C, K), assign_k
        ),
    )


def candidates_from_slots(pods, last_flush_win, cand, valid, W, k: DeviceConstants) -> CycleCandidates:
    """CycleCandidates from chosen slots: the gathers and the `waited`
    formula shared by the sorted and the two-kernel routes (reference
    step.py:1214)."""
    idx = cand.long()
    init_win = torch.gather(pods.initial_attempt_ts.win, 1, idx)
    init_off = torch.gather(pods.initial_attempt_ts.off, 1, idx)
    waited = (W[:, None] - init_win).to(torch.float32) * k.interval - init_off
    return CycleCandidates(
        pods=pods,
        last_flush_win=last_flush_win,
        cand=cand.to(torch.int32),
        valid=valid,
        req_cpu=torch.gather(pods.req_cpu, 1, idx),
        req_ram=torch.gather(pods.req_ram, 1, idx),
        waited=waited,
    )


def prepare_cycle(state, W, k: DeviceConstants, K: int, conditional_move=False, wake=None):
    """prepare_queue, the queue sort and the top-K compaction (reference
    step.py:1242). K above the pod slot count takes every slot."""
    C, P = state.pods.phase.shape
    pods, last_flush_win, eligible = prepare_queue(state, W, k, conditional_move, wake)
    sort_t = t_where(eligible, pods.queue_ts, t_inf((C, P), pods.phase.device))
    sort_seq = torch.where(eligible, pods.queue_seq, INT32_MAX)
    cand = lexsort_time_i32(sort_t, sort_seq)[:, :K].contiguous()
    return candidates_from_slots(
        pods, last_flush_win, cand, torch.gather(eligible, 1, cand.long()), W, k
    )


def commit_cycle(
    state: ClusterBatchState,
    cc: CycleCandidates,
    W: torch.Tensor,
    k: DeviceConstants,
    alloc_cpu,
    alloc_ram,
    metrics,
    assign_k,
    park_k,
    best_k,
    start_s_k,
    park_s_k,
    use_kernel: bool = False,
    faults: Optional[FaultStep] = None,
) -> ClusterBatchState:
    """Scatter the K decisions per cluster into the (C, P) pod rows and
    write the post-cycle state (reference step.py:1386): through
    `fused_commit_scatter` on the two-kernel route, else with scatters
    (the reference's XLA branch, the kernel's plain version)."""
    commit = fused_commit_scatter if use_kernel else commit_scatter_plain
    phase, node, start_tmp, park_tmp = commit(
        cc.cand, assign_k, park_k, best_k, start_s_k.contiguous(), park_s_k.contiguous(),
        cc.pods.phase, cc.pods.node,
    )
    return commit_scattered_tail(
        state, cc.pods, cc.last_flush_win, W, k, alloc_cpu, alloc_ram,
        metrics, phase, node, start_tmp, park_tmp, faults,
    )


def _run_megakernel_cycle(state, W, k, K, pod_sched_time, conditional_move, wake, profile, faults, terms):
    """The megakernel route (reference step.py:1519-1604). The positional
    timing tables (cycle duration prefix sums) are built with
    xla_cumsum16; valid decisions form a position prefix, so table value k
    is the reference's cycle_timing value for the k-th pick."""
    C = state.pods.phase.shape[0]
    interval = k.interval
    pods, last_flush_win, eligible = prepare_queue(state, W, k, conditional_move, wake)
    waited_p = (W[:, None] - pods.initial_attempt_ts.win).to(torch.float32) * interval - pods.initial_attempt_ts.off
    full_dur = pod_sched_time[:, None].expand(C, K).contiguous()
    cd_post = xla_cumsum16(full_dur)
    qpre_t = (cd_post - full_dur).contiguous()
    start_t = (cd_post + k.delta_bind_start).contiguous()
    park_t = cd_post.contiguous()
    alloc_cpu, alloc_ram, phase, node, start_tmp, park_tmp, qstats = fused_select_cycle_commit(
        state.nodes.alive, state.nodes.alloc_cpu, state.nodes.alloc_ram, eligible,
        pods.queue_ts.win, pods.queue_ts.off, pods.queue_seq,
        pods.req_cpu, pods.req_ram, waited_p, pods.phase, pods.node,
        qpre_t, start_t, park_t, k_pods=K, profile=profile, terms=terms,
    )
    # Metric merge: the queue-time estimator rows from the kernel; the
    # algorithm latency adds the per-cluster pod_sched_time per assignment.
    n_assign = qstats[:, 0].to(torch.int32)
    has = n_assign > 0
    nf = qstats[:, 0]
    m = state.metrics
    qt, al = m.queue_time, m.algo_latency
    metrics = m._replace(
        scheduling_decisions=m.scheduling_decisions + n_assign,
        queue_time=EstArrays(
            count=qt.count + n_assign,
            total=qt.total + qstats[:, 1],
            total_sq=qt.total_sq + qstats[:, 2],
            minimum=torch.minimum(qt.minimum, qstats[:, 3]),
            maximum=torch.maximum(qt.maximum, qstats[:, 4]),
        ),
        algo_latency=EstArrays(
            count=al.count + n_assign,
            total=al.total + nf * pod_sched_time,
            total_sq=al.total_sq + nf * pod_sched_time * pod_sched_time,
            minimum=torch.where(has, torch.minimum(al.minimum, pod_sched_time), al.minimum),
            maximum=torch.where(has, torch.maximum(al.maximum, pod_sched_time), al.maximum),
        ),
    )
    return commit_scattered_tail(
        state, pods, last_flush_win, W, k, alloc_cpu, alloc_ram,
        metrics, phase, node, start_tmp, park_tmp, faults,
    )


def run_scheduling_cycle(
    state: ClusterBatchState,
    W: torch.Tensor,
    k: DeviceConstants,
    max_pods_per_cycle: int,
    route: str = "megakernel",
    conditional_move: bool = False,
    wake: Optional[WakeEvents] = None,
    profile=DEFAULT_PROFILE,
    faults: Optional[FaultStep] = None,
    profile_terms=None,
) -> ClusterBatchState:
    """One scheduling cycle at window W for every cluster along `route`
    (one of CYCLE_ROUTES; reference `_run_scheduling_cycle`, step.py:1466)
    under the scheduler `profile`, whose kernel launch arguments are
    `profile_terms` (scheduler_kernel.profile_terms; None: built at each
    launch). The two-kernel and sorted routes share the timing and metric
    tail (reference step.py:1722-1738)."""
    K = max_pods_per_cycle
    alive = state.nodes.alive
    alive_count = alive.sum(dim=1, dtype=torch.int32).to(torch.float32)
    pod_sched_time = k.time_per_node * alive_count  # (C,)

    if route == "megakernel":
        return _run_megakernel_cycle(
            state, W, k, K, pod_sched_time, conditional_move, wake, profile, faults, profile_terms
        )
    if route == "two_kernel":
        pods, last_flush_win, eligible = prepare_queue(state, W, k, conditional_move, wake)
        cand, valid, assign_k, fitany_k, best_k, alloc_cpu, alloc_ram = fused_select_schedule_cycle(
            alive, state.nodes.alloc_cpu, state.nodes.alloc_ram, eligible,
            pods.queue_ts.win, pods.queue_ts.off, pods.queue_seq,
            pods.req_cpu, pods.req_ram, k_pods=K, profile=profile, terms=profile_terms,
        )
        cc = candidates_from_slots(pods, last_flush_win, cand, valid, W, k)
    elif route == "sorted":
        cc = prepare_cycle(state, W, k, K, conditional_move, wake)
        assign_k, fitany_k, best_k, alloc_cpu, alloc_ram = fused_schedule_cycle(
            alive, state.nodes.alloc_cpu, state.nodes.alloc_ram, cc.valid, cc.req_cpu, cc.req_ram,
            profile=profile, terms=profile_terms,
        )
    else:
        raise ValueError(f"unknown cycle route {route!r} (one of {CYCLE_ROUTES})")
    park_k = cc.valid & ~fitany_k
    pod_queue_time_k, start_s_k, park_s_k = cycle_timing(cc.valid, cc.waited, pod_sched_time, k)
    metrics = decision_metrics(state.metrics, assign_k, pod_queue_time_k, pod_sched_time)
    return commit_cycle(
        state, cc, W, k, alloc_cpu, alloc_ram, metrics,
        assign_k, park_k, best_k, start_s_k, park_s_k,
        use_kernel=route == "two_kernel", faults=faults,
    )


# --- lane clocks (the lane-asynchronous fleet) ---------------------------------
# Reference `_window_body` (step.py:1915-1934) and `_freeze_lanes`
# (step.py:1741-1781): torch glue (jnp.where there), no kernel.


def lane_window(Wg: torch.Tensor, clock: torch.Tensor, horizon: torch.Tensor):
    """(W, active) at global window Wg ((C,) int32): each lane's virtual
    window max(Wg - clock, 0), and whether Wg - clock lies in [0,
    horizon). An inactive lane still runs the window's body at its clamped
    virtual window and is reverted by freeze_lanes_."""
    rel = Wg - clock
    active = (rel >= 0) & (rel < horizon)
    return torch.clamp(rel, min=0), active


def freeze_lanes_(state: ClusterBatchState, state0: ClusterBatchState, active: torch.Tensor) -> None:
    """Revert every leaf of `state` but the telemetry ring to `state0`'s
    (the state without its ring) on the inactive lanes, in place, so a
    lane outside its span parks bit for bit while its neighbours step.
    The ring is left alone: an inactive lane records its zero-delta row
    (the lane column's occupancy needs it). One select a leaf."""
    prev = flatten(state0)
    C = active.shape[0]
    for path, cur in flatten(strip_telemetry(state)).items():
        torch.where(active.reshape((C,) + (1,) * (cur.dim() - 1)), cur, prev[path], out=cur)


def window_body(
    state: ClusterBatchState,
    slab: TraceSlab,
    w: int,
    consts: StepConstants,
    k: DeviceConstants,
    max_events_per_window: int,
    max_pods_per_cycle: int,
    plan: WindowPlan,
    conditional_move: bool = False,
    name_ranks=None,
    autoscale=None,
    cycle_route: str = "megakernel",
    profile=DEFAULT_PROFILE,
    faults: Optional[FaultStep] = None,
    profile_terms=None,
    window_razor: bool = False,
    lanes=None,
    reclaim_period: int = 1,
) -> ClusterBatchState:
    """Advance every cluster through scheduling window `w`: CA slot
    reclaim's compaction where the plan runs it (and, with
    `reclaim_period` N > 1, only in windows with (W + 1) % N == 0), events and finishes, one
    cycle, then the autoscaler passes the plan names, and where the state
    carries a telemetry ring the window's record into a copy of it
    (reference `_window_body`, step.py:1886). `lanes`: None, or the lane
    clocks (state.LaneClocks): each lane then runs its virtual window
    (lane_window), a freezing plan (plan.freeze, True where None) reverts
    the inactive lanes before the record, and the record writes the
    global window and the active lanes.
    `autoscale`: None, or (statics, HPA group-slot bounds, CA scale-up
    candidates per cycle, CA pods per scale-down candidate).
    `cycle_route`, `profile`, `profile_terms`: see run_scheduling_cycle; `faults`: the
    chaos engine's FaultStep or None; `window_razor`: see
    apply_window_events."""
    C = state.time.shape[0]
    W = torch.full((C,), int(w), dtype=torch.int32, device=state.time.device)
    Wg = active = state0 = None
    if lanes is not None:
        Wg = W
        W, active = lane_window(Wg, lanes.lane_clock, lanes.lane_horizon)
        if plan.freeze is not False:
            state0 = clone_state(strip_telemetry(state))
    # The window's incoming counters, which its record takes deltas of.
    m0 = counter_snapshot(state.metrics) if state.telemetry is not None else None
    orders = None
    if autoscale is not None:
        from kubernetriks_tpu_torch.batched.autoscale import ca_reclaim_pass, reclaim_name_orders

        if plan.reclaim:
            state = ca_reclaim_pass(state, autoscale[0], W, k, period=reclaim_period)
        orders = reclaim_name_orders(state.auto, autoscale[0], k, plan.removal_due or plan.ca_due)
    state, wake = apply_window_events(
        state, slab, W, consts, k, max_events_per_window, plan,
        conditional_move=conditional_move, name_ranks=name_ranks,
        node_key=None if orders is None else orders[1], faults=faults, window_razor=window_razor,
    )
    # What the storage saw before this cycle: the CA reads it when its
    # snapshot precedes the cycle's commit visibility.
    pre_cycle = (state.pods.phase, state.pods.attempts, state.nodes.alloc_cpu, state.nodes.alloc_ram)
    state = run_scheduling_cycle(
        state, W, k, max_pods_per_cycle, cycle_route, conditional_move, wake, profile, faults,
        profile_terms,
    )
    if autoscale is not None and (plan.hpa_cycle or plan.hpa_collect or plan.ca_due):
        from kubernetriks_tpu_torch.batched.autoscale import ca_pass, hpa_pass

        statics, hpa_seg, k_up, k_sd = autoscale
        if plan.hpa_cycle or plan.hpa_collect:
            state = hpa_pass(state, statics, W, k, hpa_seg, plan.hpa_cycle)
        if plan.ca_due:
            state = ca_pass(state, statics, W, k, k_up, k_sd, pre_cycle, orders)
    if state0 is not None:
        state = clone_state(state)
        freeze_lanes_(state, state0, active)
    if state.telemetry is not None:
        ring = TelemetryRing(buf=state.telemetry.buf.clone(), cursor=state.telemetry.cursor.clone())
        state = state._replace(telemetry=ring)
        telemetry_record(state, m0, W, consts, window=Wg, active=active)
    return state


# --- the flight recorder: the ring's record and the gauges ---------------------
# Reference `_telemetry_record` (step.py:1784) and `gauge_snapshot`
# (step.py:2086). The record is one glue kernel (ops/telemetry_kernel.py);
# its plain version is here.


def telemetry_record_plain(phase, alive, hpa_head, hpa_tail, ca_cursor, pod_base, W, counters, m0, buf, cursor, *,
                           head_bound: int, window=None, active=None) -> None:
    """The window's ring row, in place: [W, decisions delta, queued and
    unschedulable depths, HPA pod and CA node action deltas, fault event
    delta, alive nodes, live HPA replicas, CA reserve slots in use, pod
    window headroom, 1] at slot cursor % R of each cluster, the deltas
    against the incoming counters m0 ((len(TELEM_COUNTERS), C)); then
    cursor + 1 and m0 = counters (the next window's incoming counters).
    Without the autoscalers (hpa_head None) the reserve columns are 0.
    `head_bound`: trace_pod_bound less the plain window width. Lane
    clocks (reference step.py:1853-1876): `window` ((C,) int32, the
    global window) replaces W in column 0 and `active` ((C,) bool) the
    1 of column 11."""
    queued = (phase == PHASE_QUEUED).sum(dim=1, dtype=torch.int32)
    unsched = (phase == PHASE_UNSCHEDULABLE).sum(dim=1, dtype=torch.int32)
    n_alive = alive.sum(dim=1, dtype=torch.int32)
    if hpa_head is not None:
        hpa_used = (hpa_tail - hpa_head).sum(dim=1, dtype=torch.int32)
        ca_used = ca_cursor.sum(dim=1, dtype=torch.int32)
    else:
        hpa_used = torch.zeros_like(queued)
        ca_used = torch.zeros_like(queued)
    headroom = torch.clamp(head_bound - pod_base, min=0)
    d = [now - m0[i] for i, now in enumerate(counters)]
    row = torch.stack(
        [W if window is None else window, d[0], queued, unsched, d[1] + d[2], d[3] + d[4],
         d[5] + d[6] + d[7] + d[8] + d[9], n_alive, hpa_used, ca_used, headroom,
         torch.ones_like(W) if active is None else active.to(torch.int32)],
        dim=-1,
    ).to(torch.int32)
    C, R = buf.shape[:2]
    rows = torch.arange(C, device=buf.device)
    buf[rows, torch.remainder(cursor, R).long()] = row
    cursor.add_(1)
    m0.copy_(torch.stack(list(counters)))


def telemetry_record(state: ClusterBatchState, m0: torch.Tensor, W: torch.Tensor, consts: StepConstants,
                     window: Optional[torch.Tensor] = None, active: Optional[torch.Tensor] = None) -> None:
    """Write window W's record into state.telemetry in place (the ring's
    buffer and cursor) and set m0 to the counters now, through
    ops/telemetry_kernel.telemetry_record. Pure bookkeeping: it reads the
    simulation state and writes only the ring and m0. `window`, `active`:
    lane clocks' global window and active lanes (telemetry_record_plain)."""
    ring, auto = state.telemetry, state.auto
    P = state.pods.phase.shape[1]
    plain_width = min(P, consts.trace_pod_bound - consts.resident_shift)
    telemetry_kernel.telemetry_record(
        state.pods.phase, state.nodes.alive,
        None if auto is None else auto.hpa_head, None if auto is None else auto.hpa_tail,
        None if auto is None else auto.ca_cursor,
        state.pod_base, W, [getattr(state.metrics, name) for name in TELEM_COUNTERS], m0, ring.buf, ring.cursor,
        head_bound=consts.trace_pod_bound - plain_width, window=window, active=active,
    )


def gauge_snapshot(state: ClusterBatchState) -> torch.Tensor:
    """(C, 7) float32 gauge readings after a window: alive nodes, live pods
    (queued, parked or running), pods in the scheduling queues, the nodes'
    average cpu and ram utilization, and the cluster's total cpu and ram
    utilization, utilization being requests over the capacity of the alive
    nodes (reference `gauge_snapshot`, step.py:2086; the scalar
    collector's GaugeMetrics). Float32 sums: held to the reference at rtol
    1e-6, the three counts exact."""
    nodes, pods = state.nodes, state.pods
    alive_f = nodes.alive.to(torch.float32)
    n_alive = nodes.alive.sum(dim=1, dtype=torch.int32)
    n_alive_f = torch.clamp(n_alive, min=1).to(torch.float32)
    live_pod = (pods.phase == PHASE_QUEUED) | (pods.phase == PHASE_UNSCHEDULABLE) | (pods.phase == PHASE_RUNNING)
    queued = (pods.phase == PHASE_QUEUED) | (pods.phase == PHASE_UNSCHEDULABLE)
    cap_cpu = torch.clamp(nodes.cap_cpu, min=1).to(torch.float32)
    cap_ram = torch.clamp(nodes.cap_ram, min=1).to(torch.float32)
    used_cpu = (nodes.cap_cpu - nodes.alloc_cpu).to(torch.float32) * alive_f
    used_ram = (nodes.cap_ram - nodes.alloc_ram).to(torch.float32) * alive_f
    node_avg_cpu = (used_cpu / cap_cpu).sum(dim=1) / n_alive_f
    node_avg_ram = (used_ram / cap_ram).sum(dim=1) / n_alive_f
    total_cap_cpu = torch.clamp((cap_cpu * alive_f).sum(dim=1), min=1.0)
    total_cap_ram = torch.clamp((cap_ram * alive_f).sum(dim=1), min=1.0)
    return torch.stack(
        [
            n_alive.to(torch.float32),
            live_pod.sum(dim=1, dtype=torch.int32).to(torch.float32),
            queued.sum(dim=1, dtype=torch.int32).to(torch.float32),
            node_avg_cpu,
            node_avg_ram,
            used_cpu.sum(dim=1) / total_cap_cpu,
            used_ram.sum(dim=1) / total_cap_ram,
        ],
        dim=-1,
    )


# --- window skipping: the razor's predicate and fast-forward -------------------
# Plain versions, op for op with the reference, of the glue kernels in
# ops/window_kernel.py (their CPU path), and the state-level functions the
# window executor calls (reference `_window_work_due`, step.py:157,
# `_next_interesting_window` :2239, `_catch_up_bookkeeping` :2322).


def window_work_due_plain(cursor, packed, node_create_win, node_remove_win, pod_removal_win, phase, finish_win,
                          finish_off, W) -> torch.Tensor:
    """0-dim bool: could the window's event application change any state
    leaf at window W (the window-cost razor's predicate)? True where a
    trace event is due, a pending CA node creation or removal or an HPA
    pod removal is due (win < W), or a running pod finishes by the
    window's start; where it is false the application is the identity but
    for time = max(time, W). Conservative, as the reference's."""
    C, P = phase.shape
    E_total = packed.shape[1]
    rows = torch.arange(C, device=cursor.device)
    nxt = packed[rows, cursor.clamp(0, E_total - 1).long(), 0]
    ev_due = ((cursor < E_total) & (nxt < W)).any()
    Wc = W[:, None]
    pend_due = (node_create_win < Wc).any() | (node_remove_win < Wc).any() | (pod_removal_win < Wc).any()
    window_end = TPair(win=Wc.expand(C, P), off=torch.zeros((C, P), dtype=torch.float32, device=phase.device))
    fin_due = ((phase == PHASE_RUNNING) & t_le(TPair(finish_win, finish_off), window_end)).any()
    return ev_due | pend_due | fin_due


def window_work_due(state: ClusterBatchState, slab: TraceSlab, W: torch.Tensor) -> torch.Tensor:
    """The razor's predicate at window W (0-dim bool on the state's
    device), through ops/window_kernel.window_work_due."""
    nodes, pods = state.nodes, state.pods
    return window_kernel.window_work_due(
        state.event_cursor, slab.packed, nodes.create_time.win, nodes.remove_time.win, pods.removal_time.win,
        pods.phase, pods.finish_time.win, pods.finish_time.off, W,
    )


def next_window_span_plain(cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win,
                           queue_win, last_flush_win, W, limit, ca_next_win=None, ca_next_off=None,
                           ca_snap_win=None, ca_snap_off=None, hpa_next_win=None, col_next_win=None,
                           ca_count=None, *, flush_windows: int, interval: float) -> torch.Tensor:
    """(2,) int32 [W + 1, next]: next is the first window after W whose
    body could change state (min over every cluster of every trigger: the
    next trace event's window + 1, a running pod's finish window, a
    pending node creation or removal or pod removal's window + 1, a queued
    pod's queue window + 1, the flush cadence while a pod is parked, and
    with the autoscalers (ca_next given) the CA cycle's snapshot window
    where the CA can act, the HPA tick and the collection latch), at least
    W + 1 and at most `limit` (1,), the span's last window + 1. W is the
    (C,) window buffer (one value). The kernel's two passes: each
    cluster's words (next_window_rows_plain), then their combine
    (next_window_combine_plain)."""
    rows = next_window_rows_plain(
        cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win, queue_win,
        last_flush_win, ca_next_win, ca_next_off, ca_snap_win, ca_snap_off, hpa_next_win, col_next_win, ca_count,
        interval=interval,
    )
    return next_window_combine_plain(rows, W, limit, flush_windows=flush_windows, has_auto=ca_next_win is not None)


def next_window_rows_plain(cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win,
                           queue_win, last_flush_win, ca_next_win=None, ca_next_off=None, ca_snap_win=None,
                           ca_snap_off=None, hpa_next_win=None, col_next_win=None, ca_count=None, *,
                           interval: float) -> torch.Tensor:
    """(C, 5) int32 words a cluster, next_window_span_plain's terms before
    the reduction over the clusters (the kernel's first pass): its least
    unconditional trigger, whether a pod is parked, its last flush window,
    its CA snapshot window (INF_WIN without the autoscalers) and whether
    it has a CA node. A batch sharded over a mesh gathers every shard's
    rows and combines them (next_window_combine_plain), so its span is the
    whole batch's."""
    big = INF_WIN
    C = cursor.shape[0]
    E_total = packed.shape[1]
    rows = torch.arange(C, device=cursor.device)
    ev_win = packed[rows, cursor.clamp(0, E_total - 1).long(), 0]
    m = torch.where(cursor < E_total, ev_win, big) + 1
    m = torch.minimum(m, torch.where(phase == PHASE_RUNNING, finish_win, big).amin(dim=1))
    m = torch.minimum(m, node_create_win.amin(dim=1) + 1)
    m = torch.minimum(m, node_remove_win.amin(dim=1) + 1)
    m = torch.minimum(m, pod_removal_win.amin(dim=1) + 1)
    m = torch.minimum(m, torch.where(phase == PHASE_QUEUED, queue_win, big).amin(dim=1) + 1)
    parked = (phase == PHASE_UNSCHEDULABLE).any(dim=1).to(torch.int32)
    snap = torch.full((C,), big, dtype=torch.int32, device=cursor.device)
    ca_any = torch.zeros((C,), dtype=torch.int32, device=cursor.device)
    if ca_next_win is not None:
        interval_t = torch.tensor(float(interval), dtype=torch.float32, device=cursor.device)
        snap = t_add(TPair(ca_next_win, ca_next_off), TPair(ca_snap_win, ca_snap_off), interval_t).win
        ca_any = (ca_count != 0).any(dim=1).to(torch.int32)
        m = torch.minimum(m, hpa_next_win)
        if col_next_win is not None:
            m = torch.minimum(m, col_next_win)
    return torch.stack([m, parked, last_flush_win, snap, ca_any], dim=1).to(torch.int32)


def next_window_combine_plain(rows: torch.Tensor, W: torch.Tensor, limit: torch.Tensor, *, flush_windows: int,
                              has_auto: bool) -> torch.Tensor:
    """(2,) int32 [W + 1, next] from every cluster's (C, 5) words
    (next_window_rows_plain), in the kernel's combine order."""
    big = INF_WIN
    parked = rows[:, 1].any()
    cand = rows[:, 0].amin()
    cand = torch.minimum(cand, torch.where(parked, rows[:, 2].amin() + flush_windows, big))
    if has_auto:
        cand = torch.minimum(cand, torch.where(parked | rows[:, 4].any(), rows[:, 3].amin(), big))
    first = W[:1] + 1
    nxt = torch.maximum(first, cand.reshape(1))
    return torch.cat([first, torch.minimum(nxt, limit)]).to(torch.int32)


def next_window_rows(state: ClusterBatchState, slab: TraceSlab, statics, interval: float) -> torch.Tensor:
    """The (C, 5) words of each cluster of the state after a window
    (next_window_rows_plain), through ops/window_kernel.next_window_rows;
    `statics`: the autoscaler statics or None. window_kernel.
    next_window_combine over them, with has_auto = whether the autoscaler
    operands were given (statics and state.auto), gives the span."""
    pods, nodes, auto = state.pods, state.nodes, state.auto
    extra = ()
    if statics is not None and auto is not None:
        extra = (
            auto.ca_next.win, auto.ca_next.off, statics.ca_snap.win, statics.ca_snap.off, auto.hpa_next.win,
            None if auto.col_next is None else auto.col_next.win, auto.ca_count,
        )
    return window_kernel.next_window_rows(
        state.event_cursor, slab.packed, pods.phase, pods.finish_time.win, nodes.create_time.win,
        nodes.remove_time.win, pods.removal_time.win, pods.queue_ts.win, state.last_flush_win, *extra,
        interval=interval,
    )


def catch_up_plain(span, last_flush_win, time, hpa_next_win=None, hpa_next_off=None, ca_next_win=None,
                   ca_next_off=None, hpa_int_win=None, hpa_int_off=None, ca_snap_win=None, ca_snap_off=None,
                   ca_period_win=None, ca_period_off=None, *, interval: float, flush_interval: float):
    """The cadence bookkeeping of the skipped windows [span[0], span[1])
    with the window body's own per-window float32 arithmetic: the flush
    window advances at the flush cadence, due HPA ticks and CA cycles
    (hpa_next given) advance once a window, and time becomes max(time,
    span[1] - 1). Returns (last_flush_win, time, hpa_next_win, hpa_next_off,
    ca_next_win, ca_next_off), the last four None without the
    autoscalers. Reads the span on the host: the CPU's path."""
    lo, hi = (int(x) for x in span.tolist())
    dev = last_flush_win.device
    interval_t = torch.tensor(float(interval), dtype=torch.float32, device=dev)
    flush_t = torch.tensor(float(flush_interval), dtype=torch.float32, device=dev)
    has_auto = hpa_next_win is not None
    hpa = TPair(hpa_next_win, hpa_next_off) if has_auto else None
    ca = TPair(ca_next_win, ca_next_off) if has_auto else None
    last_flush = last_flush_win
    for w in range(lo, hi):
        wc = torch.full_like(last_flush, w)
        flush_now = (wc - last_flush).to(torch.float32) * interval_t >= flush_t
        last_flush = torch.where(flush_now, wc, last_flush)
        if has_auto:
            T = TPair(win=wc, off=torch.zeros_like(hpa.off))
            hpa = t_where(t_le(hpa, T), t_add(hpa, TPair(hpa_int_win, hpa_int_off), interval_t), hpa)
            T1 = TPair(win=wc + 1, off=torch.zeros_like(ca.off))
            due = t_lt(t_add(ca, TPair(ca_snap_win, ca_snap_off), interval_t), T1)
            ca = t_where(due, t_add(ca, TPair(ca_period_win, ca_period_off), interval_t), ca)
    time = torch.maximum(time, torch.full_like(time, hi - 1))
    if not has_auto:
        return last_flush, time, None, None, None, None
    return last_flush, time, hpa.win, hpa.off, ca.win, ca.off


def catch_up_bookkeeping(state: ClusterBatchState, span: torch.Tensor, statics, interval: float,
                         flush_interval: float) -> ClusterBatchState:
    """The state after the skipped windows [span[0], span[1]) (catch_up_plain),
    through ops/window_kernel.catch_up (span read on the device)."""
    auto = state.auto
    autoscaled = statics is not None and auto is not None
    extra = ()
    if autoscaled:
        extra = (
            auto.hpa_next.win, auto.hpa_next.off, auto.ca_next.win, auto.ca_next.off,
            statics.hpa_interval.win, statics.hpa_interval.off, statics.ca_snap.win, statics.ca_snap.off,
            statics.ca_period.win, statics.ca_period.off,
        )
    last_flush, time, hw, ho, cw, co = window_kernel.catch_up(
        span, state.last_flush_win, state.time, *extra, interval=interval, flush_interval=flush_interval,
    )
    state = state._replace(last_flush_win=last_flush, time=time)
    if autoscaled:
        state = state._replace(auto=auto._replace(hpa_next=TPair(hw, ho), ca_next=TPair(cw, co)))
    return state


# --- the sliding pod window's slide -------------------------------------------
# Plain tensor functions of fixed shapes with the shift a device tensor, so
# the window executor captures one slide graph per window and stage width
# (reference `_slide_shift_core`, `_quantize_shift_device`,
# `_slide_apply_traced`, step.py:2601-2710). The device pod axis is [window
# over the plain slots [pod_base, pod_base + W) | resident pod-group ring];
# the payload is a stage (state.RefillStage) over plain columns [stage_lo,
# stage_lo + L), read at columns base - stage_lo, as the reference's
# superspan reads its stage (step.py:2795-2916): the whole-trace payload
# (stage_lo = 0, L = T + W) or a bounded slab that covers [base, base + W +
# W/2), the columns a slide reads (trace_compile.stage_segment pads both).


def _stage_col(base: torch.Tensor, stage_lo: Optional[torch.Tensor]) -> torch.Tensor:
    return base if stage_lo is None else base - stage_lo


def slide_shift_core(
    phase: torch.Tensor, create_win: torch.Tensor, base: torch.Tensor, stage_lo: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The shift the window can take: the leading run of terminal or
    padding slots, the least over the clusters of each row's first
    blocking slot. `phase` is the window's (C, W) rows; `create_win` the
    stage's create windows, read at columns [base - stage_lo, base -
    stage_lo + W) (base and stage_lo 0-dim int32 tensors, stage_lo None
    for 0, the column clamped as a dynamic slice clamps). An EMPTY slot
    blocks while its create event is pending, and a padding slot (no create
    event) never does. Returns a 0-dim int32 tensor in [0, W]."""
    C, W = phase.shape
    iota = torch.arange(W, dtype=torch.int32, device=phase.device)
    start = _stage_col(base, stage_lo).clamp(0, create_win.shape[1] - W)
    seg = torch.gather(create_win, 1, (start + iota).long()[None, :].expand(C, W))
    terminal = (phase == PHASE_SUCCEEDED) | (phase == PHASE_REMOVED) | (phase == PHASE_FAILED)
    padding = (phase == PHASE_EMPTY) & (seg == torch.iinfo(torch.int32).max)
    first = torch.where(terminal | padding, W, iota[None, :]).amin(dim=1)
    return first.amin().to(torch.int32)


def quantize_shift(s0: torch.Tensor, W: int) -> torch.Tensor:
    """The shift taken, from a small set of amounts: W/2, W/4 or W/8 where
    s0 reaches them, else the largest power of two not above s0; 0 stays 0
    (no slide possible: the engine grows the window)."""
    quantum = max(W // 8, 1)
    v = s0
    for sh in (1, 2, 4, 8, 16):
        v = v | (v >> sh)
    s = torch.where(s0 >= quantum, quantum, v - (v >> 1))
    if W // 4 > 0:
        s = torch.where(s0 >= W // 4, W // 4, s)
    if W // 2 > 0:
        s = torch.where(s0 >= W // 2, W // 2, s)
    return s.to(torch.int32)


def slide_apply(
    pods: PodArrays, rank: Optional[torch.Tensor], pay, base: torch.Tensor, s: torch.Tensor, W: int,
    stage_lo: Optional[torch.Tensor] = None,
):
    """The window slid by s slots (s == 0 is the identity), as gathers:
    window slots [0, W - s) take slots [s, W), the refill slots [W - s, W)
    take plain columns base + W .. base + W + s - 1 through
    fresh_pod_arrays, the constructor init_state uses, and the resident
    ring (slots >= W) stays. `pay`: the stage's tensors by name (req_cpu,
    req_ram, dur_win, dur_off, rank), (C, L), over plain columns
    [stage_lo, stage_lo + L) (stage_lo None for 0). `rank`: the device
    pod-name ranks, which move with the pods, or None. Returns (pods, rank
    or None)."""
    C, P = pods.phase.shape
    idx = torch.arange(P, dtype=torch.int32, device=pods.phase.device)[None, :]
    in_window = idx < W
    refill = in_window & (idx >= W - s)
    src_old = torch.where(in_window & ~refill, idx + s, idx).long().expand(C, P)
    pay_col = (_stage_col(base, stage_lo) + s + idx).clamp(0, pay["req_cpu"].shape[1] - 1).long().expand(C, P)

    def pg(a):
        return torch.gather(a, 1, pay_col)

    fresh = fresh_pod_arrays(
        C, P, pg(pay["req_cpu"]), pg(pay["req_ram"]), TPair(win=pg(pay["dur_win"]), off=pg(pay["dur_off"]))
    )

    def move(old, fr):
        return torch.where(refill, fr, torch.gather(old, 1, src_old))

    new_pods = PodArrays(*[
        TPair(move(o.win, f.win), move(o.off, f.off)) if isinstance(o, TPair) else move(o, f)
        for o, f in zip(pods, fresh)
    ])
    new_rank = None if rank is None else move(rank, pg(pay["rank"]))
    return new_pods, new_rank
