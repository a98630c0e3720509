"""Batched simulation engine: builds the device state from compiled traces
and steps it window by window.

Port of the JAX package's `batched/engine.py` (`BatchedSimulation` slot
sizing :686-1560, `step_until_time` :2504, `run_to_completion` :3640,
`metrics_summary` :3784, `build_batched_from_traces` :4564): no mesh, no
buffer donation, no superspan executor (the window executor,
graphs.WindowExecutor, takes its place: `_dispatch_windows`, :1965). A
whole-resident pod axis is 128-aligned as in the reference's default
build, so states compare leaf for leaf.

The sliding pod window (`pod_window=W`, reference engine.py:1168-1380,
:2533-2610, :3139-3460): the device pod axis is [window over the plain
pod slots [pod_base, pod_base + W) | the pod groups' resident ring], at
its exact width. Windows run in spans up to the last window whose pod
creations fit the device window; after each span the slide piece
computes, quantizes and applies the shift on the device (step.slide_*)
and the host reads the shift back: one read a span, none inside it. Where
no slide is possible the window doubles (`_grow_pod_window`); K and the
cycle route keep their build values.

The slide refills from a stage (state.RefillStage), read in place at
columns base - stage_lo (reference engine.py:2644-2987, the superspan's
staging):
- the whole-trace payload on the device (stage_lo = 0, L = T + W), where
  it fits SLIDE_PAYLOAD_BUDGET_BYTES and streaming is off;
- else the slots of a StreamFeeder's ring (batched/stream.py): with
  streaming (`stream=`, None: KTPU_STREAM, unset: on for the card, off on
  the CPU) a producer thread assembles slabs of `_stage_width()` columns
  ahead of the engine into a ring of `stream_depth` (KTPU_STREAM_DEPTH, 3)
  slots, uploaded on a copy stream; over the budget without streaming the
  same feeder runs without a thread, two slots, on the engine's thread
  (the slab at the base where none covers it, the successor built while
  the device runs a span). A ring has at most as many slots as the trace
  still needs from its base, and a ring of the default width that would
  hold the whole payload is one slab of it, so the staging never holds
  more than the whole payload would.
Before each slide the engine makes sure the installed stage covers
[base, base + W + W/2) (a shift is at most W/2) and installs the next
slab where it does not: the compute stream waits on the slab's upload
event and stage_lo is written, no host read, and the slide replays its
slot's graph. This also stands for the reference's host slide path
(engine.py:3120-3317): the same states, without its reads. The feeder
starts at the build; a growth, install_state and attach_payload_source
re-seek it (close it and build it again at the new base and width); its
producer's deaths restart it with a backoff, at most 5 times, keeping its
retired high-water mark.
`dispatch_stats` counts stage_refills (slabs installed),
feeder_slabs_produced (across re-seeks; the producer runs ahead, so the
count depends on its timing) and feeder_restarts.

With an enabled `horizontal_pod_autoscaler` or `cluster_autoscaler`
block the engine also builds the autoscaler tables
(`build_autoscale_statics`, reference engine.py:395) and appends the CA's
reserved node slots after the trace's nodes (reference engine.py:1380-
1460), and every window runs the autoscaler passes after the scheduling
cycle (batched/autoscale.py). CA slot reclaim (`reclaim=`, reference
engine.py:1021-1049, 1408-1436) returns retired reserve slots to their
group at the head of every window (the reference's default period, 1):
on by default on the card, off on the CPU, and off, with a RuntimeWarning,
where the node names make its name orders unsound (an explicit
reclaim=True raises there).

A scenario build (`scenario=`: per-lane (C,) vectors over
fleet.SCENARIO_KEYS, reference engine.py:404-432, 722-756) composes the
control-law statics per lane through fleet.scenario_leaves, keeps the
pristine build state for fleet_reset, keys every lane's crash chains on
cluster 0 with the lane's own seed (build_batched_from_traces) and, with
pod faults, gives the commit draw a (C,) seed vector on the device, keyed
on cluster 0 too, so a lane is a pure function of its scenario.
`update_scenario` writes new vectors into the statics and the seed vector
in place (the captured graphs read those tensors) and refreshes the host
clock's copies; `fleet_reset` selects lanes of the state against the
pristine snapshot in place and, at a wave boundary, rewinds the host
mirrors from the build's own (batched/fleet.py runs the waves).

Lane clocks (`lane_async=True`, a scenario build; reference engine.py:
1106-1143, 2293-2504, DESIGN §13 there): each lane c runs its own virtual
window w - clock[c] inside the shared window pieces and is active while
that lies in [0, horizon[c]); state.LaneClocks holds the (C,) clocks on
the device (written in place, the graphs read them) and `_lane_clock_np`
/ `_lane_horizon_np` their host mirrors. The build refuses a pod window
and the streaming feeder (their clock is fleet-global) and turns
fast-forward off; every lane starts inactive. A window's plan is the
union over its active lanes, each at its virtual window (the cursor
mirror, the slab tables and the autoscaler clock of an inactive lane stay
put; CA removal windows are kept as global windows); its head piece
writes each lane's virtual window and the active lanes; where a lane can
enter or leave its span within a chunk the window snapshots the state and
its end reverts the inactive lanes (the freeze), else the host mirrors
prove every lane active and both are left out. `set_lane_plan`,
`lane_windows_done` / `lane_windows_remaining` (host arithmetic),
`step_windows(n)`, `lane_reset` (fleet_reset of lanes but the telemetry
ring) and `set_lane_trace` (stream.LaneTraceMux: a lane's row range,
written into the slab in place with the lane's host tables) drive it;
batched/fleet.py's pump runs them. The ring's record writes the global
window and the active lanes in its columns 0 and 11.

Checkpoints (`save_checkpoint` / `load_checkpoint`, reference
engine.py:4284-4455; the file format in checkpoint.py): the state and the
window cursor, a `.meta.json` of the build facts a restore must match
(pod_window, telemetry_ring, reclaim, scheduler_profile) and the gauge
series' sidecar; with lane clocks the clocks and their host mirrors. A
restore grows the pod window to the saved width, checks the ring, the
profile and reclaim (an engine left to reclaim's default follows the
checkpoint with a RuntimeWarning, an explicit one raises), and goes
through install_state.

The scheduler profile (`scheduler_profile=`, else the config's, else
KTPU_PROFILE, else the default; reference engine.py:759-770) is
compiled once here (batched/pipeline.py) and runs in every cycle. With an
enabled `fault_injection` block (chaos.py) each cluster's trace gets its
own crash chains at build (build_batched_from_traces, keyed on the
cluster index), and every window runs the chaos engine's step
(step.FaultStep); which windows apply a crash is a host fact of the slab
(step.WindowPlan.crash_due).

Entry points run on `torch.device("cuda")` unless the caller passes
`device="cpu"`; a CUDA device where there is none raises. On the
card the window step goes through the CUDA kernels (ops/); on the CPU
through their plain PyTorch versions.

The scheduling cycle's route (`cycle_route`, step.CYCLE_ROUTES) is fixed at
build, as the reference fixes its kernel flags (engine.py:1505-1546): from
128 clusters on, "megakernel", or "two_kernel" where KTPU_MEGAKERNEL is 0;
below that "sorted" (one cluster per block leaves the card idle, and the
queue sort plus the candidate kernel's early exit is what the reference
runs there). The reference also gates its megakernel on its selection
kernel fitting its memory; the port's dense kernels use a fixed amount of
shared memory whatever the shape, so the cluster count alone decides.
Nothing else picks the route, and a build or launch failure never changes
it.

The state lies in fixed buffers (`state` is read-only; `install_state`
copies into them): on the card each window replays CUDA graphs of its
pieces (graphs.py) in the order of its plan, captured lazily or up front
with `precompile_pieces`. The `graphs` build argument chooses that (the
reference's `superspan=` argument, engine.py:866-885): None, the default,
means on for the card; off, or on the CPU, the same pieces run
uncaptured. Asking for graphs on the CPU raises. `dispatch_stats` counts captures, replays and windows run
through graphs or eagerly (the conditional move's windows run on graphs
too: its scans run on the device).

Two ways of skipping work (reference engine.py:995-1012, 1149-1166,
1673-1681, 2013-2035), each bit for bit equal to stepping every window:
- the window-cost razor (`window_razor=`; None: on for the card, off on
  the CPU, as the reference decides it by backend): a window with no
  event chunk runs its events' tail only where step.window_work_due
  holds, in a conditional node on graphs;
- fast-forward (`fast_forward=`; None: on below 0.25 trace events a
  window, the density computed as the reference does from the finite
  event times, per cluster, over the span): after each executed window
  the device finds the next window that could change state
  (step.next_window_span), the host reads it back (one read an executed
  window, in host_syncs), brings its mirrors through the windows between
  and the catch-up piece replays their bookkeeping
  (step.catch_up_bookkeeping). A span never runs past its last window;
  under the sliding pod window a span is cut along the reference's chunk
  ladder (128, 64, ..., 1), whose first windows it always runs, so the
  set of executed windows, on which slot reclaim's leaves depend, is the
  reference's. `dispatch_stats` counts executed_windows and
  skipped_windows.

The flight recorder (`telemetry=`, None: KTPU_TRACE; `telemetry_ring=`
R windows; `watchdog=`, None: KTPU_WATCHDOG, unset armed exactly with
telemetry; reference engine.py:771-812, 1632-1653, 3957-4200): the state
carries a (C, R, 12) int32 ring that every executed window's record
writes on the device (graphs.py), which the engine drains only where the
host blocks anyway: the entry of step_until_time where the call could
wrap past undrained rows, its exit and a slide's or fast-forward's read
where the ring is half full (host arithmetic on the windows recorded),
and readout. The drains feed the host series (`telemetry_window_series`,
at most `telemetry_series_windows` windows) and the capacity observatory
(telemetry/observatory.py: occupancy, memory watermarks, the saturation
watchdog, export hooks). The span tracer (`tracer`) times the window
spans, slides, growths, captures and fast-forward's reads. None of it
adds a host read or a replay to the stepping loop: host_syncs and
dispatch_stats are those of the same run with telemetry off.
`collect_gauges` (an attribute, off by default) samples the gauges after
every window (fast-forward then steps every window, as the reference's
does) into a device buffer read once GAUGE_SPAN windows
(`gauge_series`, `write_gauge_csv`).

The window loop reads nothing back from the device: the engine keeps the
trace slab's window column on the host and mirrors the event cursor there,
which tells it, per window, how many event chunks to run and whether a
node removal is due (step.WindowPlan). The autoscalers' due times advance
by fixed periods, so `AutoscaleClock` mirrors them on the host with the
same float32 pair arithmetic and decides which autoscaler passes a window
runs, and in which windows a CA removal can take effect. The mirrors are
read from the device once, when a state is installed; `run_to_completion`
reads once per chunk of windows to test for the end of the run, the
sliding pod window once a span, for its shift, fast-forward once an
executed window, for the next, and gauge collection once a span.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kubernetriks_tpu_torch import chaos
from kubernetriks_tpu_torch.batched.autoscale import AutoscaleStatics, init_autoscale_state
from kubernetriks_tpu_torch.batched.fleet import normalize_scenario, scenario_leaves
from kubernetriks_tpu_torch.batched.graphs import GAUGE_SPAN, CudaGraphs, WindowExecutor
from kubernetriks_tpu_torch.batched.pipeline import DEFAULT_PROFILE, CompiledProfile, compile_profile
from kubernetriks_tpu_torch.batched.state import (
    DEFAULT_RAM_UNIT,
    EV_CREATE_POD,
    EV_NODE_CRASH,
    EV_REMOVE_NODE,
    PHASE_QUEUED,
    PHASE_RUNNING,
    PHASE_UNSCHEDULABLE,
    ClusterBatchState,
    LaneClocks,
    PodArrays,
    clone_state,
    RefillStage,
    TraceSlab,
    copy_state_into,
    flatten,
    fresh_pods_np,
    init_state,
    make_step_constants,
    stage_arrays_np,
    stage_nbytes,
    unflatten,
)
from kubernetriks_tpu_torch.batched.step import DeviceConstants, FaultStep, WindowPlan, window_body
from kubernetriks_tpu_torch.batched.timerep import INF_WIN, TPair, from_f64_np, t_add, t_inf, t_le, t_lt, t_where
from kubernetriks_tpu_torch.batched.trace_compile import (
    BIG_RANK,
    NO_CREATE,
    ArrayPayloadSource,
    CompiledClusterTrace,
    PayloadSource,
    _pad_cols,
    compile_cluster_trace,
    pad_and_batch,
    segment_pod_slots,
    stage_segment,
)
from kubernetriks_tpu_torch.flags import flag_bool, flag_int, flag_str, flag_tristate
from kubernetriks_tpu_torch.ops.scheduler_kernel import profile_terms
from kubernetriks_tpu_torch.telemetry import NULL_TRACER, GaugeSeries, SpanTracer
from kubernetriks_tpu_torch.telemetry.tracer import (
    PH_CKPT_RESTORE,
    PH_CKPT_SAVE,
    PH_SLIDE,
    PH_WINDOW_CHUNK,
    PH_WINDOW_GROW,
)

POD_ALIGN = 128
# Device bytes the whole-trace slide payload may take (reference
# engine.py:103); over it the slide refills from bounded stages.
SLIDE_PAYLOAD_BUDGET_BYTES = 2 << 30
# The feeder supervisor's restarts at most, and its first backoff
# (doubling; reference engine.py:964-966).
FEEDER_RESTART_CAP = 5
FEEDER_BACKOFF_S = 0.005
# Clusters per device from which the dense cycle kernels take the cycle
# (reference engine.py:1524).
DENSE_CLUSTERS = 128
# The metrics collector's pod-utilization cadence, which the HPA reads.
COLLECTION_INTERVAL = 60.0
# Fast-forward's default: on below this many trace events a window and a
# cluster (reference engine.py:1681).
FAST_FORWARD_DENSITY = 0.25
# The reference's span ladder under the sliding pod window (engine.py:131):
# a span runs as chunks of these sizes, the largest that fits first.
CHUNK_LADDER = (128, 64, 32, 16, 8, 4, 2, 1)


def resolve_device(device=None) -> torch.device:
    """`device` as given; None means the CUDA card. A CUDA device raises
    where there is none (the port never carries on on the CPU unasked), and
    comes back with its index, as tensors report theirs."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: kubernetriks_tpu_torch runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch path"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def trace_event_density(ev_time: np.ndarray, interval: float, copies: Optional[np.ndarray] = None) -> float:
    """Trace events a window and a cluster, as the reference measures it
    for fast-forward's default (engine.py:1673-1681): the finite event
    times over the clusters times the span of windows to the last one (at
    least 1). `copies`: how many clusters each row of `ev_time` stands for
    (None: one each)."""
    counts = np.isfinite(ev_time).sum(axis=1)
    C = ev_time.shape[0] if copies is None else int(copies.sum())
    n = int(counts.sum() if copies is None else (counts * copies).sum())
    span = max(1.0, float(ev_time[np.isfinite(ev_time)].max()) / interval) if n else 1.0
    return n / (max(C, 1) * span)


def flush_windows(interval: float, flush_interval: float) -> int:
    """Windows per flush period in the float32 arithmetic of the queue
    preamble's compare (reference engine.py:1158-1166), at least 1."""
    d = 1
    while np.float32(d) * np.float32(interval) < np.float32(flush_interval):
        d += 1
    return d


def choose_cycle_route(n_clusters: int, megakernel: bool = True) -> str:
    """The cycle route for a batch of n_clusters (module note);
    `megakernel` is the KTPU_MEGAKERNEL flag."""
    if n_clusters < DENSE_CLUSTERS:
        return "sorted"
    return "megakernel" if megakernel else "two_kernel"


def _distinct_rows(compiled_traces):
    """(rows, inverse): the first cluster of each distinct compiled trace
    (the same object replicated, as build_batched_from_traces and the CLI
    replicate one trace, counts once) and each cluster's place among them,
    so host tables of a replicated batch are computed once a trace."""
    first: Dict[int, int] = {}
    rows: List[int] = []
    inverse = np.empty(len(compiled_traces), np.int64)
    for ci, c in enumerate(compiled_traces):
        k = first.get(id(c))
        if k is None:
            k = first[id(c)] = len(rows)
            rows.append(ci)
        inverse[ci] = k
    return np.asarray(rows, np.int64), inverse


def _name_ranks(names) -> np.ndarray:
    """Rank of each slot's name in the stable lexicographic sort of
    `names` (the scalar reference walks name-sorted snapshots)."""
    order = np.argsort(np.asarray(names, dtype=object), kind="stable")
    out = np.empty(len(names), np.int32)
    out[order] = np.arange(len(names), dtype=np.int32)
    return out


def _reclaim_class_tables(compiled_traces, group_names, reserves, n_trace_nodes: int, S: int):
    """Slot reclaim's static name-class tables (reference
    `_reclaim_class_tables`, engine.py:298): one class per trace node and
    one per CA group, the decimal name family "{group}_{d}" (d >= 1),
    which covers the interval ["{group}_1", "{group}_:") since ':' follows
    '9'. A node's name order is then its class's rank, then the suffix's
    decimal order within a group, provided no class interleaves another,
    which this checks for each cluster. Returns (ca_slot_class (C, S),
    ca_class_start (C, Gn), node_class_key (C, N), None), or (None, None,
    None, reason) where the name sets make that decomposition unsound."""
    C = len(compiled_traces)
    Gn = len(group_names)
    fams = [(f"{name}_1", f"{name}_:") for name in group_names]
    for i in range(Gn):
        for j in range(i + 1, Gn):
            if fams[i][0] < fams[j][1] and fams[j][0] < fams[i][1]:
                return None, None, None, (
                    f"CA node-group name families {group_names[i]!r} and "
                    f"{group_names[j]!r} interleave lexicographically"
                )
    ca_slot_class = np.zeros((C, S), np.int32)
    ca_class_start = np.zeros((C, Gn), np.int32)
    node_class_key = np.full((C, n_trace_nodes + S), BIG_RANK, np.int32)
    memo: Dict[int, tuple] = {}
    for ci, trace in enumerate(compiled_traces):
        names = list(trace.node_names[:n_trace_nodes])
        got = memo.get(id(trace))
        if got is None:
            for t in names:
                for gi, (lo, hi) in enumerate(fams):
                    if lo <= t < hi:
                        return None, None, None, (
                            f"trace node name {t!r} falls inside CA group "
                            f"{group_names[gi]!r}'s name family"
                        )
            # The class order: trace names, and each family by its first
            # name (disjoint intervals: every present and future name).
            entries = [(t, ("t", slot)) for slot, t in enumerate(names)]
            entries += [(fams[gi][0], ("f", gi)) for gi in range(Gn)]
            entries.sort(key=lambda e: e[0])
            if len(entries) * (S + 1) >= (1 << 31) - (S + 1):
                return None, None, None, (
                    f"{len(entries)} name classes x (S + 1 = {S + 1}) overflows the int32 name-key space"
                )
            trace_rank = np.full(n_trace_nodes, -1, np.int64)
            fam_rank = np.zeros(Gn, np.int64)
            for rank, (_, tag) in enumerate(entries):
                if tag[0] == "t":
                    trace_rank[tag[1]] = rank
                else:
                    fam_rank[tag[1]] = rank
            got = memo[id(trace)] = (trace_rank, fam_rank)
        trace_rank, fam_rank = got
        nk = node_class_key[ci]
        named = trace_rank >= 0
        nk[:n_trace_nodes][named] = (trace_rank[named] * (S + 1)).astype(np.int32)
        cursor = 0
        for gi, reserve in enumerate(reserves):
            ca_slot_class[ci, cursor : cursor + reserve] = fam_rank[gi]
            nk[n_trace_nodes + cursor : n_trace_nodes + cursor + reserve] = fam_rank[gi] * (S + 1)
            cursor += reserve
        # Each group's first position among the slots sorted by class: the
        # groups in class order, their reserves' widths summed.
        pos = 0
        for gi in np.argsort(fam_rank, kind="stable"):
            ca_class_start[ci, gi] = pos
            pos += reserves[gi]
    return ca_slot_class, ca_class_start, node_class_key, None


def decide_reclaim(requested: Optional[bool], on_card: bool, ca_on: bool, unsupported: Optional[str]) -> bool:
    """Whether CA slot reclaim runs (reference engine.py:1408-1436):
    `requested` None means on for the card and off on the CPU. Where the
    build does not support it (`unsupported`: the reason), an explicit
    True raises and the default turns it off, with a RuntimeWarning when
    the CA is on."""
    want = on_card if requested is None else bool(requested)
    if want and unsupported is not None:
        if requested:
            raise ValueError(
                f"reclaim=True is unsupported for this build: {unsupported}; the allocation-name "
                "order decomposition would be unsound. Rename the conflicting nodes or groups, "
                "or run without reclaim"
            )
        if ca_on:
            warnings.warn(
                f"CA slot reclaim, on by default on the card, is off: {unsupported}; the CA "
                "reserve stays monotone (check_autoscaler_bounds raises when it runs dry)",
                RuntimeWarning,
                stacklevel=3,
            )
        want = False
    return want


def build_autoscale_statics(
    config,
    compiled_traces: Sequence[CompiledClusterTrace],
    n_pods: int,
    n_trace_nodes: int,
    ram_unit: int,
    device,
    ca_slot_multiplier: int = 2,
    pod_slot_offset: int = 0,
    sliding: bool = False,
    scenario: Optional[Dict[str, np.ndarray]] = None,
):
    """Host-side compilation of the pod-group (HPA) and node-group (CA)
    tables (reference `build_autoscale_statics`, engine.py:395), in device
    pod slots. The control-law leaves are per lane, from
    fleet.scenario_leaves over `scenario` (normalized (C,) override
    vectors; None: the base config's values everywhere). Also: `pod_slot_offset` is the
    global-to-device shift of the resident pod-group ring under a sliding
    pod window (0 whole-resident), and with `sliding` the pod-name ranks
    start at BIG_RANK, for the engine to fill from the window's slice
    (BatchedSimulation._refresh_name_ranks). Each CA group
    reserves `ca_slot_multiplier` x its node cap slots (without slot
    reclaim a slot is used once; check_autoscaler_bounds raises when the
    reserve runs dry). Slot reclaim's name-class tables are built where
    the CA has a reserve and the names allow them (_reclaim_class_tables),
    else left None. Returns (statics, extra node cap cpu (S,), extra node
    cap ram (S,), extra node names, why reclaim cannot run on this build
    or None, aux): the extra node slots are the CA's reserved slots,
    appended after the trace's node slots, named "{group}_{k+1}"; aux
    holds the host table update_scenario recomposes from,
    pg_active_when_on ((C, Gp) float64 activation seconds as if every
    lane's HPA were on; +inf on padding groups)."""
    C = len(compiled_traces)
    ca_on = config.cluster_autoscaler.enabled
    law = scenario_leaves(config, C, scenario)

    # --- HPA pod groups -----------------------------------------------------
    Gp = max((len(c.pod_groups) for c in compiled_traces), default=0) or 1
    U = 1
    for c in compiled_traces:
        for g in c.pod_groups:
            U = max(U, len(g.cpu_units), len(g.ram_units))
    pg = {
        "slot_start": np.zeros((C, Gp), np.int32),
        "slot_count": np.zeros((C, Gp), np.int32),
        "initial": np.zeros((C, Gp), np.int32),
        "max_pods": np.zeros((C, Gp), np.int32),
        "target_cpu": np.zeros((C, Gp), np.float32),
        "target_ram": np.zeros((C, Gp), np.float32),
    }
    pg_active_from = np.full((C, Gp), np.inf, np.float64)
    pg_active_when_on = np.full((C, Gp), np.inf, np.float64)
    pg_creation_s = np.zeros((C, Gp), np.float64)
    curves = {k: np.zeros((C, Gp, U), np.float32) for k in ("cpu_dur", "cpu_load", "ram_dur", "ram_load")}
    pg_cpu_const = np.zeros((C, Gp), bool)
    pg_ram_const = np.zeros((C, Gp), bool)
    pod_group_id = np.full((C, n_pods), -1, np.int32)
    for ci, c in enumerate(compiled_traces):
        for gi, g in enumerate(c.pod_groups):
            pg["slot_start"][ci, gi] = g.slot_start - pod_slot_offset
            pg["slot_count"][ci, gi] = g.slot_count
            pg["initial"][ci, gi] = g.initial
            pg["max_pods"][ci, gi] = g.max_pods
            pg["target_cpu"][ci, gi] = g.target_cpu
            pg["target_ram"][ci, gi] = g.target_ram
            # With the HPA off (on this lane) the group's initial pods
            # still run, but no cycle ever acts: active_from stays +inf.
            pg_creation_s[ci, gi] = g.creation_time
            pg_active_when_on[ci, gi] = g.creation_time + config.as_to_hpa_network_delay
            if law["hpa_enabled"][ci]:
                pg_active_from[ci, gi] = pg_active_when_on[ci, gi]
            for ui, (dur, load) in enumerate(g.cpu_units):
                curves["cpu_dur"][ci, gi, ui] = dur
                curves["cpu_load"][ci, gi, ui] = load
            pg_cpu_const[ci, gi] = g.cpu_const
            for ui, (dur, load) in enumerate(g.ram_units):
                curves["ram_dur"][ci, gi, ui] = dur
                curves["ram_load"][ci, gi, ui] = load
            pg_ram_const[ci, gi] = g.ram_const
            dev_start = g.slot_start - pod_slot_offset
            pod_group_id[ci, dev_start : dev_start + g.slot_count] = gi

    # --- CA node groups, in template-name order ------------------------------
    ca_config = config.cluster_autoscaler
    groups = sorted(ca_config.node_groups, key=lambda g: g.node_template.metadata.name) if ca_on else []
    Gn = len(groups) or 1
    reserves = []
    for g in groups:
        cap = g.max_count if g.max_count is not None else ca_config.max_node_count
        reserves.append(min(cap, ca_config.max_node_count) * ca_slot_multiplier)
    S = sum(reserves) or 1
    ng = {
        "ca_start": np.zeros((C, Gn), np.int32),
        "slot_count": np.zeros((C, Gn), np.int32),
        "max_count": np.full((C, Gn), -1, np.int32),
        "tmpl_cpu": np.zeros((C, Gn), np.int32),
        "tmpl_ram": np.zeros((C, Gn), np.int32),
    }
    ca_slots = np.full((C, S), -1, np.int32)
    ca_slot_group = np.full((C, S), -1, np.int32)
    extra_cap_cpu = np.zeros((S,), np.int32)
    extra_cap_ram = np.zeros((S,), np.int32)
    extra_names: List[str] = []
    cursor = 0
    for gi, (g, reserve) in enumerate(zip(groups, reserves)):
        name = g.node_template.metadata.name
        if not name:
            raise ValueError("cluster-autoscaler node templates must be named")
        cap = g.node_template.status.capacity
        ng["ca_start"][:, gi] = cursor
        ng["slot_count"][:, gi] = reserve
        ng["max_count"][:, gi] = -1 if g.max_count is None else g.max_count
        ng["tmpl_cpu"][:, gi] = int(cap.cpu)
        ng["tmpl_ram"][:, gi] = int(cap.ram) // ram_unit
        for k in range(reserve):
            ca_slots[:, cursor + k] = n_trace_nodes + cursor + k
            ca_slot_group[:, cursor + k] = gi
            extra_cap_cpu[cursor + k] = int(cap.cpu)
            extra_cap_ram[cursor + k] = int(cap.ram) // ram_unit
            extra_names.append(f"{name}_{k + 1}")
        cursor += reserve

    # --- name orders -----------------------------------------------------------
    # The CA bin-packs its unscheduled cache in pod-name order and walks
    # scale-down candidates and re-placements in node-name order (the
    # storage's snapshots are name-sorted); CA slot k of group g is always
    # named "{g}_{k+1}".
    memo: Dict[tuple, np.ndarray] = {}

    def ranks(names):
        key = tuple(names)
        if key not in memo:
            memo[key] = _name_ranks(names)
        return memo[key]

    pod_name_rank = np.full((C, n_pods), BIG_RANK, np.int32)
    if not sliding and pod_slot_offset == 0:
        for ci, trace in enumerate(compiled_traces):
            r = ranks(trace.pod_names[:n_pods])
            pod_name_rank[ci, : len(r)] = r
    N_total = n_trace_nodes + (S if extra_names else 0)
    node_name_rank = np.full((C, N_total), BIG_RANK, np.int32)
    ca_sd_order = np.tile(np.arange(S, dtype=np.int64), (C, 1))
    for ci, trace in enumerate(compiled_traces):
        r = ranks(list(trace.node_names[:n_trace_nodes]) + extra_names)
        node_name_rank[ci, : len(r)] = r
        if extra_names:
            ca_sd_order[ci] = np.argsort(node_name_rank[ci, n_trace_nodes:], kind="stable")

    rc_tables = (None, None, None)
    if ca_on and extra_names:
        *rc_tables, reclaim_reason = _reclaim_class_tables(
            compiled_traces, [g.node_template.metadata.name for g in groups], reserves, n_trace_nodes, S
        )
    elif ca_on:
        reclaim_reason = "the CA reserve is empty (no named node groups)"
    else:
        reclaim_reason = "the cluster autoscaler is disabled"

    interval = config.scheduling_cycle_interval
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def pair(x) -> TPair:
        w, o = from_f64_np(np.asarray(x, np.float64), interval)
        return TPair(win=t(w), off=t(o))

    statics = AutoscaleStatics(
        pg_slot_start=t(pg["slot_start"]),
        pg_slot_count=t(pg["slot_count"]),
        pg_initial=t(pg["initial"]),
        pg_max_pods=t(pg["max_pods"]),
        pg_target_cpu=t(pg["target_cpu"]),
        pg_target_ram=t(pg["target_ram"]),
        pg_active_from=pair(pg_active_from),
        pg_creation_s=t(pg_creation_s),
        pg_cpu_dur=t(curves["cpu_dur"]),
        pg_cpu_load=t(curves["cpu_load"]),
        pg_cpu_total=t(curves["cpu_dur"].sum(axis=-1)),
        pg_cpu_const=t(pg_cpu_const),
        pg_ram_dur=t(curves["ram_dur"]),
        pg_ram_load=t(curves["ram_load"]),
        pg_ram_total=t(curves["ram_dur"].sum(axis=-1)),
        pg_ram_const=t(pg_ram_const),
        pod_group_id=t(pod_group_id),
        ng_ca_start=t(ng["ca_start"]),
        ng_slot_count=t(ng["slot_count"]),
        ng_max_count=t(ng["max_count"]),
        ng_tmpl_cpu=t(ng["tmpl_cpu"]),
        ng_tmpl_ram=t(ng["tmpl_ram"]),
        ca_max_nodes=t(law["ca_max_nodes"].astype(np.int32)),
        ca_slots=t(ca_slots),
        ca_slot_group=t(ca_slot_group),
        hpa_interval=pair(law["hpa_interval_s"]),
        hpa_tolerance=t(law["hpa_tolerance"]),
        ca_threshold=t(law["ca_threshold"]),
        d_hpa_up=pair(law["d_hpa_up_s"]),
        d_hpa_down=pair(law["d_hpa_down_s"]),
        d_ca_up=pair(law["d_ca_up_s"]),
        d_ca_down=pair(law["d_ca_down_s"]),
        ca_period=pair(law["ca_period_s"]),
        ca_snap=pair(law["ca_snap_s"]),
        ca_finish_vis=pair(law["ca_finish_vis_s"]),
        ca_commit_vis=pair(law["ca_commit_vis_s"]),
        col_interval=pair(np.full((C,), COLLECTION_INTERVAL, np.float64)),
        pod_name_rank=t(pod_name_rank),
        node_name_rank=t(node_name_rank),
        ca_sd_order=t(ca_sd_order),
        **{
            name: None if table is None else t(table)
            for name, table in zip(("ca_slot_class", "ca_class_start", "node_class_key"), rc_tables)
        },
    )
    return statics, extra_cap_cpu, extra_cap_ram, extra_names, reclaim_reason, {"pg_active_when_on": pg_active_when_on}


def slab_tables(ev_win: np.ndarray, ev_kind: np.ndarray, wmax: int):
    """The host tables of (rows, E) slab windows and kinds that the plans
    read: due_upto[r, w] = events of row r with window < w (clamped at
    wmax, the last finite window + 1), rm_prefix[r, i] = node removals
    (trace removals and crashes) among the first i events, crash_prefix[r,
    i] the crashes among them."""
    finite = ev_win < INF_WIN
    bucket = np.clip(ev_win, -1, wmax - 1) + 1
    R = ev_win.shape[0]
    flat = (np.arange(R)[:, None] * (wmax + 1) + bucket)[finite]
    hist = np.bincount(flat, minlength=R * (wmax + 1)).reshape(R, wmax + 1)
    zero = np.zeros((R, 1), np.int64)
    is_crash = ev_kind == EV_NODE_CRASH
    removals = np.cumsum((ev_kind == EV_REMOVE_NODE) | is_crash, axis=1)
    return (
        np.cumsum(hist, axis=1),
        np.concatenate([zero, removals], axis=1),
        np.concatenate([zero, np.cumsum(is_crash, axis=1)], axis=1),
    )


def _cpu_pair(p: TPair) -> TPair:
    return TPair(win=p.win.cpu(), off=p.off.cpu())


class AutoscaleClock:
    """Host mirror of the autoscalers' due times: the HPA tick, the metrics
    collection and the CA cycle fire time, (C,) pairs on the CPU advanced
    with the device's own pair arithmetic (timerep, float32 tensors), so
    they stay equal to the state's `.auto.hpa_next` / `col_next` /
    `ca_next` without reading them back. `advance(w)` says which passes
    window w runs — the branches the reference's `lax.cond`s take — and
    records the windows in which a CA removal decided now can take effect
    (a superset: every due cycle counts, whether or not it removed a
    node)."""

    def __init__(self, statics: AutoscaleStatics, interval: float, hpa_on: bool, ca_on: bool):
        self.interval = torch.tensor(float(interval), dtype=torch.float32)
        self.hpa_on = hpa_on
        self.ca_on = ca_on
        self.col_interval = _cpu_pair(statics.col_interval)
        self.set_law(
            _cpu_pair(statics.hpa_interval), _cpu_pair(statics.ca_period), _cpu_pair(statics.ca_snap),
            _cpu_pair(statics.d_ca_down),
        )
        self.removal_windows = set()

    def set_law(self, hpa_interval: TPair, ca_period: TPair, ca_snap: TPair, d_ca_down: TPair) -> None:
        """The per-lane control law the mirror advances by, (C,) CPU pairs
        (a scenario update hands in the values it wrote to the device)."""
        self.hpa_interval = hpa_interval
        self.ca_period = ca_period
        self.ca_snap = ca_snap
        self.d_ca_down = d_ca_down

    def due_times(self):
        """Copies of the mirrored due times (hpa_next, col_next, ca_next)."""
        return tuple(None if p is None else TPair(win=p.win.clone(), off=p.off.clone())
                     for p in (self.hpa_next, self.col_next, self.ca_next))

    def set_due_times(self, due, lanes=None) -> None:
        """Install due times from due_times(), on every lane or on `lanes`
        ((C,) bool) alone."""
        for name, src in zip(("hpa_next", "col_next", "ca_next"), due):
            if src is None:
                continue
            if lanes is None:
                setattr(self, name, TPair(win=src.win.clone(), off=src.off.clone()))
            else:
                setattr(self, name, t_where(lanes, src, getattr(self, name)))

    def seed(self, auto) -> None:
        """Copy the due times from a state's autoscaler leaves."""
        self.hpa_next = _cpu_pair(auto.hpa_next)
        self.col_next = None if auto.col_next is None else _cpu_pair(auto.col_next)
        self.ca_next = _cpu_pair(auto.ca_next)

    def advance(self, w, active=None, shift=None):
        """(hpa_cycle, hpa_collect, ca_due) for window w; moves the mirror
        to where the window leaves the state. Under lane clocks `w` is the
        (C,) virtual windows, `active` the (C,) bool lanes in their span
        (the others' due times stay put) and `shift` the (C,) lane clocks
        that turn a lane's virtual removal window into a global one."""
        C = self.ca_next.win.shape[0]
        if active is None:
            T = TPair(win=torch.full((C,), w, dtype=torch.int32), off=torch.zeros((C,), dtype=torch.float32))
        else:
            T = TPair(win=torch.from_numpy(np.asarray(w, np.int32)), off=torch.zeros((C,), dtype=torch.float32))
            active = torch.from_numpy(np.asarray(active, bool))
        hpa_cycle = hpa_collect = False
        if self.hpa_on:
            due = t_le(self.hpa_next, T)
            col_due = t_le(self.col_next, T)
            if active is not None:
                due &= active
                col_due &= active
            hpa_cycle = bool(due.any())
            hpa_collect = bool(col_due.any())
            self.hpa_next = t_where(due, t_add(self.hpa_next, self.hpa_interval, self.interval), self.hpa_next)
            self.col_next = t_where(col_due, t_add(self.col_next, self.col_interval, self.interval), self.col_next)
        snap = t_add(self.ca_next, self.ca_snap, self.interval)
        T1 = TPair(win=T.win + 1, off=T.off)
        due = t_lt(snap, T1)
        if active is not None:
            due &= active
        ca_due = bool(due.any())
        if ca_due and self.ca_on:
            eff = t_add(self.ca_next, self.d_ca_down, self.interval)
            if shift is None:
                for win in torch.unique(eff.win[due]).tolist():
                    self.removal_windows.add(max(int(win) + 1, w + 1))
            else:
                for c in torch.nonzero(due).flatten().tolist():
                    vw = max(int(eff.win[c]) + 1, int(T.win[c]) + 1)
                    self.removal_windows.add(vw + int(shift[c]))
        self.ca_next = t_where(due, t_add(self.ca_next, self.ca_period, self.interval), self.ca_next)
        return hpa_cycle, hpa_collect, ca_due


class BatchedSimulation:
    def __init__(
        self,
        config,
        compiled_traces: Sequence[CompiledClusterTrace],
        device=None,
        ram_unit: int = DEFAULT_RAM_UNIT,
        max_events_per_window: Optional[int] = None,
        max_pods_per_cycle: Optional[int] = None,
        scheduler_profile=None,
        max_ca_pods_per_cycle: int = 64,
        max_pods_per_scale_down: int = 8,
        ca_slot_multiplier: int = 2,
        graphs: Optional[bool] = None,
        pod_window: Optional[int] = None,
        reclaim: Optional[bool] = None,
        fast_forward: Optional[bool] = None,
        window_razor: Optional[bool] = None,
        telemetry: Optional[bool] = None,
        telemetry_ring: int = 1024,
        watchdog: Optional[bool] = None,
        stream: Optional[bool] = None,
        stream_depth: Optional[int] = None,
        stream_segment: Optional[int] = None,
        scenario: Optional[Dict[str, object]] = None,
        lane_async: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        # Lane clocks (module note; reference engine.py:1106-1143): each
        # lane runs its own virtual span inside the shared window pieces.
        # They need a scenario build (the lane reset re-seeds from its
        # pristine state) and the whole-resident path, whose clock the
        # sliding window and the feeder would otherwise share; fast-forward
        # is turned off (its skips are fleet-global).
        self.lane_async = bool(lane_async)
        if self.lane_async:
            if scenario is None:
                raise ValueError(
                    "lane_async=True requires a scenario build (scenario={...} / ScenarioFleet): per-lane resets "
                    "re-seed from the scenario pristine"
                )
            if pod_window is not None:
                raise ValueError(
                    "lane_async=True requires the full-resident pod path (pod_window=None): the sliding window's "
                    "refill cursor is fleet-global"
                )
            if stream:
                raise ValueError(
                    "lane_async=True is incompatible with the streaming feeder: its progress carries assume one "
                    "fleet-global window clock"
                )
            stream = False
            fast_forward = False
        # The streaming feeder (module note): None reads KTPU_STREAM, unset
        # on for the card; it acts only under the sliding pod window.
        if stream is None:
            stream = flag_tristate("KTPU_STREAM")
        self._stream = self.device.type == "cuda" if stream is None else bool(stream)
        self._stream_depth = max(1, int(flag_int("KTPU_STREAM_DEPTH") if stream_depth is None else stream_depth))
        if stream_segment is None:
            stream_segment = flag_int("KTPU_STREAM_SEGMENT")
        self._stream_segment = None if stream_segment is None else int(stream_segment)
        # The live feeder, built with the stage and closed and built again
        # at a re-seek; its ring and the copy stream its uploads run on (the
        # card's); slabs produced by closed feeders; the supervisor's
        # restarts; a host chaos injector (KTPU_HOST_CHAOS, or set by
        # tests) that every feeder built draws from.
        self._feeder = None
        self._feeder_uploads = None
        self._feeder_finalizer = None
        self._copy_stream = None
        self._feeder_produced_total = 0
        self._last_feeder_report = None  # the last closed feeder's report
        self._feeder_restarts = 0
        self._feeder_chaos = None
        if flag_str("KTPU_HOST_CHAOS") is not None:
            from kubernetriks_tpu_torch.batched.faults import HostChaos

            self._feeder_chaos = HostChaos.from_flag(flag_str("KTPU_HOST_CHAOS"))
        # The installed stage's first plain column and slab (None: none
        # installed; the whole payload has no slab), and the most device
        # bytes the staging held at once.
        self._stage_lo = None
        self._stage_slab = None
        self._staging_peak_bytes = 0
        # The flight recorder (module note): None reads KTPU_TRACE; the
        # watchdog rides it (None reads KTPU_WATCHDOG, unset: armed exactly
        # when telemetry is), and armed without it raises.
        self._telemetry = flag_bool("KTPU_TRACE") if telemetry is None else bool(telemetry)
        self.tracer = SpanTracer() if self._telemetry else NULL_TRACER
        self._telemetry_ring_size = max(8, int(telemetry_ring))
        if watchdog is None:
            env = flag_tristate("KTPU_WATCHDOG")
            watchdog = self._telemetry if env is None else env
        self._watchdog = bool(watchdog)
        if self._watchdog and not self._telemetry:
            raise ValueError(
                "watchdog=True requires the flight recorder (telemetry=True / KTPU_TRACE=1): the "
                "saturation watchdog reads the device ring's reserve-occupancy columns"
            )
        # Drained ring rows, window -> (C, K), at most
        # telemetry_series_windows of them (the oldest dropped first and
        # counted); the ring's windows recorded as the host counts them
        # (_ring_host_cursor) and at the last drain; the device cursor's
        # high-water mark as the drains read it.
        self._ring_seen: dict = {}
        self.telemetry_series_windows = 1 << 16
        self._ring_series_dropped = 0
        self._ring_windows_recorded = 0
        self._ring_host_cursor = 0
        self._ring_drained_at = 0
        # What the drains cost (telemetry_report's ring_drains): their
        # count, the windows they read, the wall ns of the ring's read (a
        # blocking copy to the host, which waits for the queued windows)
        # and of the host work after it (series, observatory, exporters).
        self._ring_drain_stats = {"drains": 0, "windows": 0, "read_ns": 0, "host_ns": 0}
        # Reads the stepping loop makes (slides' shifts, fast-forward's next
        # windows): the observed side of telemetry_report's sync budget.
        self._loop_reads = 0
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(
                f"graphs=True needs the card: CUDA graphs do not run on {self.device} "
                "(pass graphs=False)"
            )
        self.graphs = bool(graphs)
        self.config = config
        # The scheduler profile: the argument, then the config's, then
        # KTPU_PROFILE, then the default (reference engine.py:759-770);
        # compile_profile raises on a name or plugin it cannot lower.
        if scheduler_profile is None:
            scheduler_profile = config.scheduler_profile
        if scheduler_profile is None:
            scheduler_profile = flag_str("KTPU_PROFILE")
        self.profile = compile_profile(scheduler_profile)
        # The cycle kernels' launch arguments for it, on the card before
        # any capture (the CPU's plain versions take the profile alone).
        self.profile_terms = profile_terms(self.profile, self.device) if self.device.type == "cuda" else None
        self.fault_params = chaos.make_fault_params(config)
        self.conditional_move = bool(config.enable_unscheduled_pods_conditional_move)
        self.consts = make_step_constants(config)
        self.window_razor = self.device.type == "cuda" if window_razor is None else bool(window_razor)
        self.flush_windows = flush_windows(config.scheduling_cycle_interval, self.consts.flush_interval)
        self.ram_unit = ram_unit
        interval = config.scheduling_cycle_interval
        compiled_traces = list(compiled_traces)
        C = len(compiled_traces)
        # Per-lane scenario vectors (module note), normalized to owned (C,)
        # numpy arrays; None: every lane runs the base config.
        self._scenario = normalize_scenario(scenario, C)
        # The commit draw's per-lane seeds under a scenario build with pod
        # faults: (C,) uint32 on the device, written in place by
        # update_scenario (the captured graphs read this tensor).
        self._fault_seeds = None
        if self._scenario is not None and self.fault_params is not None and self.fault_params.pod_faults:
            seeds = scenario_leaves(config, C, self._scenario)["fault_seed"]
            self._fault_seeds = torch.from_numpy(seeds.astype(np.uint32)).to(self.device)
        # Pod groups put their reserved slots after every plain pod, the
        # reference's canonical layout whenever groups exist.
        has_groups = any(c.pod_groups for c in compiled_traces)
        self._has_pod_groups = has_groups
        compiled_traces, trace_pod_bound = segment_pod_slots(compiled_traces)
        # Host tables of the trace are computed once for each distinct
        # trace and given to every cluster that replays it.
        rows, inverse = _distinct_rows(compiled_traces)
        # The sliding pod window (module note); 0 or less means
        # whole-resident, and so does a trace of pod groups alone.
        if pod_window is not None and (pod_window <= 0 or (has_groups and trace_pod_bound == 0)):
            pod_window = None

        p_max = max((c.n_pods for c in compiled_traces), default=0)
        # Whole-resident runs 128-align the pod axis; the window keeps exact
        # widths (reference engine.py:1206-1213).
        n_pods_aligned = None if pod_window is not None else -(-max(p_max, 1) // POD_ALIGN) * POD_ALIGN
        (
            ev_time,
            ev_kind,
            ev_slot,
            node_cap_cpu,
            node_cap_ram,
            pod_req_cpu,
            pod_req_ram,
            pod_duration,
            node_crash_downtime,
        ) = pad_and_batch(compiled_traces, n_pods=n_pods_aligned)
        self.pod_window = None
        self._pod_base = 0
        if pod_window is not None:
            T = trace_pod_bound if has_groups else pod_req_cpu.shape[1]
            pod_req_cpu, pod_req_ram, pod_duration = self._window_layout(
                compiled_traces, T, min(pod_window, T), ev_time[rows], ev_kind[rows], ev_slot[rows], inverse,
                pod_req_cpu, pod_req_ram, pod_duration,
            )

        # Autoscaler tables; the CA's reserved node slots follow the trace's.
        hpa_on = config.horizontal_pod_autoscaler.enabled
        ca_on = config.cluster_autoscaler.enabled
        self.autoscale_statics = None
        self.max_ca_pods_per_cycle = max_ca_pods_per_cycle
        self.max_pods_per_scale_down = max_pods_per_scale_down
        self.reclaim = False
        # The build's reclaim argument: None (the default) lets a restore
        # follow the checkpoint's mode.
        self._reclaim_requested = reclaim
        self._autoscale_aux = None
        self._reserve_capacities: dict = {}
        # Why reclaim cannot run on this build (None: it can).
        self.reclaim_unsupported = "no autoscaler is configured"
        if hpa_on or ca_on:
            statics, extra_cpu, extra_ram, extra_names, self.reclaim_unsupported, self._autoscale_aux = (
                build_autoscale_statics(
                    config, compiled_traces, n_pods=pod_req_cpu.shape[1],
                    n_trace_nodes=node_cap_cpu.shape[1], ram_unit=ram_unit, device=self.device,
                    ca_slot_multiplier=ca_slot_multiplier, pod_slot_offset=self.consts.resident_shift,
                    sliding=self.pod_window is not None, scenario=self._scenario,
                )
            )
            self.autoscale_statics = statics
            self.reclaim = decide_reclaim(reclaim, self.device.type == "cuda", ca_on, self.reclaim_unsupported)
            # Each cluster's reserve sizes, for the capacity observatory
            # (reference engine.py:1437-1446), read once here.
            self._reserve_capacities = {
                "hpa_reserve": [int(v) for v in statics.pg_slot_count.sum(dim=1).tolist()],
                "ca_reserve": [int(v) for v in statics.ng_slot_count.sum(dim=1).tolist()],
            }
            if ca_on and extra_names:
                node_cap_cpu = np.concatenate([node_cap_cpu, np.tile(extra_cpu, (C, 1))], axis=1)
                node_cap_ram = np.concatenate([node_cap_ram, np.tile(extra_ram, (C, 1))], axis=1)
                # The CA's reserved slots never crash.
                node_crash_downtime = np.concatenate(
                    [node_crash_downtime, np.zeros((C, len(extra_cpu)), np.float32)], axis=1
                )

        self.n_clusters = C
        self.n_nodes = node_cap_cpu.shape[1]
        self.n_pods = pod_req_cpu.shape[1]
        self.n_real_pods = p_max
        self.n_events = ev_time.shape[1]
        replicated = len(rows) < C

        def each_cluster(a: np.ndarray) -> np.ndarray:
            return a[inverse] if replicated else a

        ev_time_u, ev_kind_u = ev_time[rows], ev_kind[rows]
        finite_times = ev_time_u[np.isfinite(ev_time_u)]
        self.last_event_time = float(finite_times.max()) if finite_times.size else 0.0
        if fast_forward is None:
            copies = np.bincount(inverse, minlength=len(rows))
            fast_forward = trace_event_density(ev_time_u, interval, copies) < FAST_FORWARD_DENSITY
        self.fast_forward = bool(fast_forward)
        if max_events_per_window is None:
            max_events_per_window = min(self._max_events_in_any_window(ev_time_u), 32)
        self.max_events_per_window = max(1, max_events_per_window)
        # K is fixed here: a growth of the pod window does not change it
        # (reference engine.py:1486).
        self.max_pods_per_cycle = max(1, max_pods_per_cycle or self.n_pods)
        self.cycle_route = choose_cycle_route(C, flag_bool("KTPU_MEGAKERNEL"))

        state = init_state(
            C,
            self.n_nodes,
            self.n_pods,
            node_cap_cpu,
            node_cap_ram,
            pod_req_cpu,
            pod_req_ram,
            pod_duration,
            interval=interval,
            device=self.device,
            node_crash_downtime=node_crash_downtime,
        )
        # The group-slot bounds (lo, hi) the HPA pass works on; (0, 0): the
        # HPA can never act, its tick parks at +inf and the pass never runs.
        self.hpa_seg = (0, 0)
        self.clock = None
        if self.autoscale_statics is not None:
            st = self.autoscale_statics
            if hpa_on and any(c.pod_groups for c in compiled_traces):
                starts = st.pg_slot_start.cpu().numpy()
                counts = st.pg_slot_count.cpu().numpy()
                gmask = counts > 0
                if gmask.any():
                    lo = max(int(starts[gmask].min()), 0)
                    hi = min(int((starts + counts)[gmask].max()), self.n_pods)
                    self.hpa_seg = (lo, hi) if hi > lo else (0, 0)
            auto = init_autoscale_state(st, collect=self.hpa_seg != (0, 0), reclaim=self.reclaim)
            if self.hpa_seg == (0, 0):
                auto = auto._replace(hpa_next=t_inf((C,), self.device))
            # The trace's initial replicas are "{group}_{i}" in the i-th
            # reserved slot.
            gid = st.pod_group_id.cpu().numpy()
            gidc = np.clip(gid, 0, None)
            off = np.arange(self.n_pods, dtype=np.int32)[None, :] - np.take_along_axis(
                st.pg_slot_start.cpu().numpy(), gidc, axis=1
            )
            seeded = (gid >= 0) & (off < np.take_along_axis(st.pg_initial.cpu().numpy(), gidc, axis=1))
            hpa_idx = torch.from_numpy(np.where(seeded, off, -1).astype(np.int32)).to(self.device)
            state = state._replace(pods=state.pods._replace(hpa_idx=hpa_idx), auto=auto)
            self.clock = AutoscaleClock(st, interval, hpa_on=self.hpa_seg != (0, 0), ca_on=ca_on)
            self.clock.seed(auto)
        # The autoscaler clock's due times as the build left them, for the
        # plans of a run from the build state (initial_window_plans).
        self._build_due = None if self.clock is None else self.clock.due_times()
        ev_win, ev_off = from_f64_np(ev_time_u, interval)
        self.slab = TraceSlab.build(each_cluster(ev_win), each_cluster(ev_off), ev_kind, ev_slot, self.device)
        self._k = DeviceConstants.build(self.consts, self.device)

        # Host copy of the slab's window column, as lookup tables:
        # _due_upto[c, w] = events of cluster c with window < w (clamped at
        # the last finite window), _rm_prefix[c, i] = node removals (trace
        # removals and crashes) among the first i slab events,
        # _crash_prefix[c, i] the crashes among them.
        finite = ev_win < INF_WIN
        self._wmax = int(ev_win[finite].max()) + 1 if finite.any() else 0
        self._due_upto, self._rm_prefix, self._crash_prefix = (
            each_cluster(t) for t in slab_tables(ev_win, ev_kind_u, self._wmax)
        )
        self._cursor = np.zeros(C, np.int64)

        # Name-rank tables: same-window reschedules queue in (removal time,
        # node name, pod name) order, like the reference's name-sorted walks.
        # With autoscalers on, the statics' tables (which rank the CA slot
        # names among the trace's) take their place. Under the window
        # without autoscalers the reference keeps none (engine.py:1736-
        # 1741): such reschedules queue in slot order.
        self.node_names = [c.node_names for c in compiled_traces]
        self.pod_names = [c.pod_names for c in compiled_traces]
        self.pod_group_names = [[g.name for g in c.pod_groups] for c in compiled_traces]
        self.name_ranks = None
        if self.autoscale_statics is not None:
            self.name_ranks = (self.autoscale_statics.node_name_rank, self.autoscale_statics.pod_name_rank)
        elif self.pod_window is None:
            self.name_ranks = self._trace_name_ranks(C)

        self.next_window_idx = 0
        self.windows_run = 0
        self.host_syncs = 0
        self.dispatch_stats = {
            "captures": 0, "replays": 0, "graph_windows": 0, "eager_windows": 0, "slides": 0, "grows": 0,
            "executed_windows": 0, "skipped_windows": 0,
            "stage_refills": 0, "feeder_slabs_produced": 0, "feeder_restarts": 0,
        }
        self.observatory = None
        if self._telemetry:
            from kubernetriks_tpu_torch.telemetry.observatory import Observatory
            from kubernetriks_tpu_torch.telemetry.ring import init_ring

            state = state._replace(telemetry=init_ring(C, self._telemetry_ring_size, self.device))
            self.observatory = Observatory(
                interval=interval, capacities=self._reserve_capacities, watchdog=self._watchdog,
            )
        # Per-window gauge samples (collect_gauges; module note).
        self.collect_gauges = False
        self._gauges = GaugeSeries()
        self._state = state
        if self.pod_window is not None:
            self._refresh_name_ranks()
            self._init_stage()
        self.faults = self._fault_step()
        # Lane clocks and their host mirrors (module note); every lane
        # starts inactive (horizon 0) until set_lane_plan arms it. The lane
        # trace multiplexer holds a host copy of the slab (one read at the
        # build) and serves each lane's row range.
        self._lane_clocks = self._lane_clock_np = self._lane_horizon_np = self._lane_mux = None
        if self.lane_async:
            from kubernetriks_tpu_torch.batched.stream import LaneTraceMux

            self._lane_clocks = LaneClocks.fresh(C, self.device)
            self._lane_clock_np = np.zeros((C,), np.int64)
            self._lane_horizon_np = np.zeros((C,), np.int64)
            self._lane_mux = LaneTraceMux(self.slab.packed.cpu().numpy())
            self._lane_mux.offer(0)
            self._lane_mux.retire([0])
        self._executor = WindowExecutor(self, CudaGraphs(self.device) if self.graphs else None)
        # The pristine build state fleet_reset selects lanes against, and
        # the host mirrors as the build left them, for scenario builds
        # alone (a plain engine pays no second copy of the state).
        self._pristine = None
        self._pristine_pod_window = self.pod_window
        self._pristine_due = None
        if self._scenario is not None:
            self._pristine = clone_state(self._state)
            self._pristine_due = None if self.clock is None else self.clock.due_times()

    def _fault_step(self) -> Optional[FaultStep]:
        """The chaos engine's window constants (None: faults off); the
        plain segment's width follows the pod window's growths, and a
        scenario build's seed vector is the engine's one tensor."""
        fp = self.fault_params
        if fp is None:
            return None

        def f32(x):
            return torch.tensor(float(x), dtype=torch.float32, device=self.device)

        return FaultStep(
            params=fp,
            interval=float(self.config.scheduling_cycle_interval),
            plain_width=int(self.consts.trace_pod_bound - self.consts.resident_shift),
            backoff_base=f32(fp.backoff_base),
            backoff_cap=f32(fp.backoff_cap),
            seeds=self._fault_seeds,
        )

    def _trace_name_ranks(self, C: int):
        nnr = np.full((C, self.n_nodes), BIG_RANK, np.int32)
        pnr = np.full((C, self.n_pods), BIG_RANK, np.int32)
        memo: Dict[tuple, np.ndarray] = {}

        def ranks(names):
            key = tuple(names)
            if key not in memo:
                memo[key] = _name_ranks(names)
            return memo[key]

        for ci in range(C):
            r = ranks(self.node_names[ci])
            nnr[ci, : len(r)] = r
            r = ranks(self.pod_names[ci])
            pnr[ci, : min(len(r), self.n_pods)] = r[: self.n_pods]
        return (
            torch.from_numpy(nnr).to(self.device),
            torch.from_numpy(pnr).to(self.device),
        )

    def _max_events_in_any_window(self, ev_time: np.ndarray) -> int:
        """Most events falling into one (cluster, window) bucket."""
        interval = self.config.scheduling_cycle_interval
        rows, cols = np.nonzero(np.isfinite(ev_time))
        if rows.size == 0:
            return 1
        win = np.floor_divide(ev_time[rows, cols], interval).astype(np.int64)
        keys = rows * (win.max() + 2) + win
        _, per_key = np.unique(keys, return_counts=True)
        return int(per_key.max())

    # --- the sliding pod window ---------------------------------------------

    def _window_layout(
        self, compiled_traces, T, W, ev_time, ev_kind, ev_slot, inverse, pod_req_cpu, pod_req_ram, pod_duration
    ):
        """Set up the sliding pod window of width W over the T plain pod
        slots (reference engine.py:1301-1380): the host tables the slides
        read (each plain slot's create window, the whole-trace payload and
        pod-name ranks) and StepConstants' segment mapping. The event arrays
        are those of the distinct traces, `inverse` each cluster's among
        them (_distinct_rows). Returns the device pod payload [window over
        plain slots [0, W) | resident pod-group ring]."""
        C = len(compiled_traces)
        self.pod_window = W
        self.consts = self.consts._replace(trace_pod_bound=T, resident_shift=T - W)
        # Window of each plain slot's create event (slots are assigned in
        # event order, so rows are nondecreasing): the capacity lookup.
        ev_win, _ = from_f64_np(ev_time, self.config.scheduling_cycle_interval)
        Cu = ev_time.shape[0]
        create_win = np.full((Cu, T), NO_CREATE, np.int32)
        is_cp = (ev_kind == EV_CREATE_POD) & (ev_slot < T)
        create_win[np.broadcast_to(np.arange(Cu)[:, None], ev_kind.shape)[is_cp], ev_slot[is_cp]] = ev_win[is_cp]
        self._pod_create_win = create_win[inverse] if Cu < C else create_win
        self._payload_source = ArrayPayloadSource({
            "req_cpu": pod_req_cpu[:, :T], "req_ram": pod_req_ram[:, :T], "duration": pod_duration[:, :T],
        })
        # Whole-trace pod-name ranks (global slots): the window's slice
        # moves with every slide, so name-ordered passes order as in a
        # whole-resident run.
        P_full = pod_req_cpu.shape[1]
        self._pod_name_rank_full = np.full((C, P_full), BIG_RANK, np.int32)
        memo: Dict[int, np.ndarray] = {}
        for ci, trace in enumerate(compiled_traces):
            if id(trace) not in memo:
                memo[id(trace)] = _name_ranks(trace.pod_names)
            r = memo[id(trace)]
            self._pod_name_rank_full[ci, : len(r)] = r
        return tuple(np.concatenate([a[:, :W], a[:, T:]], axis=1) for a in (pod_req_cpu, pod_req_ram, pod_duration))

    def _whole_payload_bytes(self, W: int) -> int:
        """Device bytes of the whole-trace slide payload at window width W:
        requests, duration pair and create window (and the name ranks with
        the autoscalers) over T + W columns (reference engine.py:1805)."""
        C, T = self._pod_create_win.shape
        return C * (T + W) * 4 * (5 + (self.autoscale_statics is not None))

    def _stream_on(self) -> bool:
        """Whether the streaming feeder stages this engine's slabs."""
        return self._stream and self.pod_window is not None

    def _init_stage(self) -> None:
        """The slide's payload at the current width (module note): the
        whole-trace payload on the device (reference `_init_device_slide`,
        engine.py:1820: stage_segment's columns [0, T + W), so a refill
        past the trace's end reads padding) where it fits and the feeder
        is off, else a feeder, started here, whose slabs are installed
        before the slides that need them."""
        self.close()
        self._slide_payload = None
        self._stage_lo = None
        W, T = self.pod_window, self.consts.trace_pod_bound
        if self._stream_on() or self._whole_payload_bytes(W) > SLIDE_PAYLOAD_BUDGET_BYTES:
            self._ensure_feeder()
            return
        seg = stage_arrays_np(self._stage_arrays(0, T + W), self.config.scheduling_cycle_interval)
        self._slide_payload = {k: torch.from_numpy(v).to(self.device) for k, v in seg.items()}
        self._stage_lo = 0
        self.staging_bytes()  # the peak

    def _ring_depth(self) -> int:
        """Slots of the feeder's ring: stream_depth with the thread, two
        (the installed slab and its successor) without."""
        return self._stream_depth if self._stream_on() else 2

    def _slabs_needed(self, L: int, base: int) -> int:
        """The most slabs of L columns the ring can use: those the schedule
        builds from `base` to the end of the payload's T + W columns; one
        on demand (stride 0: a slab is built only once the last is
        retired)."""
        W, T = self.pod_window, self.consts.trace_pod_bound
        stride = L - W - W // 2
        if stride <= 0:
            return 1
        return 1 + max(0, -(-(T + W - L - base) // stride))

    def _stage_width(self) -> int:
        """Columns of a bounded stage (reference engine.py:2644): 4W (3W of
        shift headroom), or the feeder's stream_segment; at least W + W/2
        (a slide reads W + W/2 columns) and at most the whole payload, T +
        W. At the default width, a ring whose slots would hold the whole
        payload's columns or more is one slab of the whole payload (an
        explicit stream_segment is kept as given)."""
        W, T = self.pod_window, self.consts.trace_pod_bound
        explicit = self._stream_on() and self._stream_segment is not None
        L = min(max(self._stream_segment if explicit else 4 * W, W + max(W // 2, 1)), T + W)
        if not explicit and min(self._ring_depth(), self._slabs_needed(L, 0)) * L >= T + W:
            return T + W
        return L

    def _stage_cols(self) -> int:
        """Columns of the current stage (the slide key's L)."""
        if self._slide_payload is not None:
            return int(self._slide_payload["req_cpu"].shape[1])
        return self._feeder_uploads.width if self._feeder_uploads is not None else self._stage_width()

    def _stage_tags(self) -> List[int]:
        """The stage's slots: -1 for the whole payload, else the ring's."""
        if self._slide_payload is not None:
            return [-1]
        return list(range(self._feeder_uploads.depth)) if self._feeder_uploads is not None else []

    def _stage_tag(self) -> int:
        """The installed slot."""
        return -1 if self._stage_slab is None else self._stage_slab.index

    def _stage_slot(self, tag: int) -> RefillStage:
        """The stage in slot `tag` (the slide piece reads it in place)."""
        if tag < 0:
            return RefillStage(**self._slide_payload)
        return self._feeder_uploads.slots[tag]

    def _stage_arrays(self, lo: int, width: int) -> Dict[str, np.ndarray]:
        """The host half of a stage: payload columns [lo, lo + width)
        (trace_compile.stage_segment owns the layout and padding). Host
        numpy alone, so the feeder thread calls it too."""
        return stage_segment(
            self._payload_source,
            self._pod_create_win,
            self._pod_name_rank_full[:, : self.consts.trace_pod_bound] if self.autoscale_statics is not None else None,
            lo,
            width,
        )

    def _stage_covers(self, lo: Optional[int], width: int) -> bool:
        """Whether a stage over [lo, lo + width) holds every column the
        next slide can read: [base, base + W + W/2)."""
        W, base = self.pod_window, self._pod_base
        return lo is not None and lo <= base and base + W + max(W // 2, 1) <= lo + width

    def _ensure_stage(self) -> None:
        """Before a slide: install the next slab where the installed stage
        does not cover it (module note)."""
        from kubernetriks_tpu_torch.batched.faults import FeederProducerError

        L = self._stage_cols()
        if self._slide_payload is not None or self._stage_covers(self._stage_lo, L):
            return
        feeder = self._ensure_feeder()
        for _ in range(3):
            if self._stage_lo is not None:
                lo = self._stage_lo
                self._release_stage()
                feeder.retire(lo)
            while True:
                try:
                    slab, lo, fresh = feeder.get_stage(self._pod_base, tracer=self.tracer)
                    break
                except FeederProducerError as err:
                    feeder = self._restart_feeder(feeder, err)
            self._install(slab, lo)
            if self._stage_covers(lo, L):
                return
        raise RuntimeError(
            f"stream feeder: no slab of {L} columns covers the slide at pod base {self._pod_base} "
            f"(window {self.pod_window}); a stream_segment between W + W/2 and 2W cannot keep ahead"
        )

    def _install(self, slab, lo: int) -> None:
        """Install a slab (graphs.py install_stage): the next slides read
        its slot."""
        self._executor.install_stage(lo, slab.ready)
        self._stage_lo, self._stage_slab = lo, slab
        self.dispatch_stats["stage_refills"] += 1
        if self._feeder is not None:
            self.dispatch_stats["feeder_slabs_produced"] = self._feeder_produced_total + self._feeder.produced

    def _release_stage(self) -> None:
        """Stop reading the installed slab: its ring may refill its slot
        once the slides queued so far have run (an event on the compute
        stream; on the CPU they have run)."""
        slab, self._stage_slab = self._stage_slab, None
        self._stage_lo = None
        if slab is None:
            return
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        slab.release(done)

    def staging_bytes(self) -> Dict[str, int]:
        """Bytes the slide's payload holds on the engine's device now: the
        whole-trace payload or the feeder ring's slots; their peak so far;
        what the whole-trace payload would take at the current width; and
        the ring's pinned host buffers."""
        whole = stage_nbytes(None if self._slide_payload is None else RefillStage(**self._slide_payload))
        ring = self._feeder_uploads.nbytes() if self._feeder_uploads is not None else 0
        now = whole + ring
        self._staging_peak_bytes = max(self._staging_peak_bytes, now)
        return {
            "device_bytes": now,
            "device_peak_bytes": self._staging_peak_bytes,
            "whole_payload_bytes": 0 if self.pod_window is None else self._whole_payload_bytes(self.pod_window),
            "pinned_host_bytes": self._feeder_uploads.pinned_nbytes() if self._feeder_uploads is not None else 0,
        }

    # --- the streaming feeder's lifecycle ---------------------------------------

    def _ensure_feeder(self, retired_lo: int = -1):
        """The live StreamFeeder, built at the current base and width
        (reference engine.py:2829) with its ring: a producer thread with
        streaming, none over the budget without it; `retired_lo`: a dead
        predecessor's retired high-water mark (the supervisor's restart)."""
        if self._feeder is not None:
            return self._feeder
        import weakref

        from kubernetriks_tpu_torch.batched.stream import SlabRing, StreamFeeder

        W, L, T = self.pod_window, self._stage_width(), self.consts.trace_pod_bound
        depth = min(self._ring_depth(), self._slabs_needed(L, self._pod_base))
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        ring = SlabRing(
            self.n_clusters, L, self.autoscale_statics is not None, depth, self.device,
            self.config.scheduling_cycle_interval, self._copy_stream,
        )
        # The producer holds the engine weakly: an engine dropped without
        # close() stops its feeder when it is collected.
        engine = weakref.ref(self)

        def assemble(lo: int, width: int):
            sim = engine()
            if sim is None:
                raise RuntimeError("the engine that owns this stream feeder is gone")
            return sim._stage_arrays(lo, width)

        feeder = StreamFeeder(
            assemble, ring.upload, base=self._pod_base, width=L, window=W, trace_cols=T + W, depth=depth,
            retired_lo=retired_lo, chaos=self._feeder_chaos, thread=self._stream_on(),
        )
        self._feeder, self._feeder_uploads = feeder, ring
        self._feeder_finalizer = weakref.finalize(self, feeder.stop)
        self.staging_bytes()  # the peak
        return feeder

    def _restart_feeder(self, feeder, err):
        """The supervisor (reference engine.py:2855): after a producer's
        death, close the feeder, back off (doubling from FEEDER_BACKOFF_S)
        and build it again at the current base with its retired
        high-water mark; past FEEDER_RESTART_CAP restarts the error
        propagates."""
        import logging

        self._feeder_restarts += 1
        self.dispatch_stats["feeder_restarts"] = self._feeder_restarts
        if self._feeder_restarts > FEEDER_RESTART_CAP:
            raise err
        retired = feeder.retired_watermark()
        self.close(timeout=1.0)
        delay = FEEDER_BACKOFF_S * (2 ** (self._feeder_restarts - 1))
        logging.getLogger(__name__).warning(
            "stream feeder producer died (%s); supervisor restart %d/%d after %.0f ms backoff",
            err, self._feeder_restarts, FEEDER_RESTART_CAP, delay * 1e3,
        )
        time.sleep(delay)
        return self._ensure_feeder(retired_lo=retired)

    def close(self, timeout: float = 30.0) -> None:
        """Stop and drop the feeder, its thread and its ring, and the slide
        graphs on its slots (also a re-seek's first half): the next span
        builds one at the then current base and width."""
        feeder = self._feeder
        if feeder is None:
            return
        self._release_stage()
        executor = getattr(self, "_executor", None)
        if executor is not None:
            executor.drop_slide()
        self._feeder_produced_total += feeder.produced
        self.dispatch_stats["feeder_slabs_produced"] = self._feeder_produced_total
        self._feeder_finalizer.detach()
        self._feeder = self._feeder_uploads = self._feeder_finalizer = None
        feeder.close(timeout)
        self._last_feeder_report = feeder.report()

    def _feeder_report(self) -> Optional[Dict]:
        """The live feeder's report with the supervisor's restarts, and
        dispatch_stats' feeder_slabs_produced brought up to it."""
        if self._feeder is None:
            return None
        rep = self._feeder.report()
        rep["restarts"] = self._feeder_restarts
        self.dispatch_stats["feeder_slabs_produced"] = self._feeder_produced_total + rep["slabs_produced"]
        return rep

    def attach_payload_source(self, source) -> None:
        """Read the slide's payload from `source` (a trace_compile
        PayloadSource, e.g. FeederPayloadSource over the native feeder's
        WorkloadSegmentReader) and release the whole-trace host payload
        arrays (reference engine.py:2731): the host then holds the payload
        a segment at a time, beside the per-pod create windows and name
        ranks. Needs the streaming feeder and a trace of plain pods alone
        (a pod group's ring renumbers the payload axis). The source must
        give exactly the compiled payload over the whole trace, which this
        checks (a segment reader gives every cluster the same rows) before
        anything is released; the feeder is re-seeked."""
        if not isinstance(source, PayloadSource):
            raise TypeError(f"attach_payload_source wants a trace_compile.PayloadSource, got {type(source).__name__}")
        if not self._stream_on():
            raise ValueError(
                "attach_payload_source needs the streaming feeder (pod_window and stream=True / KTPU_STREAM): "
                "without it the slide keeps the whole payload"
            )
        T = self.consts.trace_pod_bound
        if source.total_rows < T:
            raise ValueError(f"payload source covers {source.total_rows} plain pod columns; this trace has {T}")
        if self._has_pod_groups:
            raise ValueError(
                "attach_payload_source does not support pod-group workloads: the resident group ring renumbers "
                "the payload axis past the plain segment, so payload column i would not be workload row i"
            )
        chunk = 1 << 16
        for lo in range(0, T, chunk):
            w = min(chunk, T - lo)
            want, got = self._payload_source.segment(lo, w), source.segment(lo, w)
            for k in ("req_cpu", "req_ram", "duration"):
                if not np.array_equal(want[k], got[k]):
                    c_bad, j_bad = (int(v) for v in np.argwhere(want[k] != got[k])[0])
                    raise ValueError(
                        f"attach_payload_source: the source disagrees with the compiled payload at {k}[cluster "
                        f"{c_bad}, column {lo + j_bad}] ({want[k][c_bad, j_bad]} != {got[k][c_bad, j_bad]}); "
                        "a payload source serves every cluster the same workload"
                    )
        self.close()
        self._payload_source = source
        self._ensure_feeder()

    def _pod_capacity_window(self) -> int:
        """The last window that can run before a pod creation would land
        past the device window (reference engine.py:3139): slots are
        created in event order, so the first slot past it bounds every
        cluster."""
        L = self._pod_base + self.pod_window
        if L >= self._pod_create_win.shape[1]:
            return 1 << 30
        return int(self._pod_create_win[:, L].min())

    def _refresh_name_ranks(self) -> None:
        """Write the window's slice of the whole-trace pod-name ranks into
        the statics' rank tensor, in place: the captured graphs read that
        tensor (reference engine.py:3148-3175). Window slots past the plain
        segment rank BIG_RANK, as the slide payload pads them (no event
        creates such a slot, so no pass reads its rank)."""
        if self.autoscale_statics is None:
            return
        W, T = self.pod_window, self.consts.trace_pod_bound
        full = self._pod_name_rank_full
        win = _pad_cols(full[:, :T], self._pod_base, W, BIG_RANK, np.int32)
        ranks = np.concatenate([win, full[:, T:]], axis=1)
        self.autoscale_statics.pod_name_rank.copy_(torch.from_numpy(ranks))

    def _slide(self) -> bool:
        """Slide the window on the device past its leading terminal slots
        and read the shift back: the span's one host read. False when no
        slide was possible (the state is unchanged)."""
        with self.tracer.span(PH_SLIDE):
            s = self._executor.slide()
        self.host_syncs += 1
        self._loop_reads += 1
        if s <= 0:
            return False
        self._pod_base += s
        self.dispatch_stats["slides"] += 1
        return True

    def _grow_pod_window(self) -> bool:
        """Double the window in place when the live pods outgrow it
        (reference `_grow_pod_window_impl`, engine.py:3354): fresh slots
        for global plain slots [pod_base + W, pod_base + new_W), with the
        constructor init_state uses, go in between the window and the
        ring, which moves right with its statics; the name ranks and the
        payload follow the new width, and the executor rebuilds its
        buffers at the new P and captures again. K stays at its build
        value, and so does the cycle route, which the cluster count alone
        decides (choose_cycle_route). Returns False when the window
        already covers the whole plain segment."""
        W, T = self.pod_window, self.consts.trace_pod_bound
        if W >= T:
            return False
        with self.tracer.span(PH_WINDOW_GROW):
            self._grow_to(min(2 * W, T))
        return True

    def _grow_to(self, new_W: int) -> None:
        W, T = self.pod_window, self.consts.trace_pod_bound
        insert = new_W - W
        self.close()  # a re-seek at the new width
        C = self.n_clusters
        cols = self._payload_source.segment(self._pod_base + W, insert)
        fresh = fresh_pods_np(
            cols["req_cpu"], cols["req_ram"], cols["duration"], self.config.scheduling_cycle_interval, self.device
        )

        def widen(a, b):
            return torch.cat([a[:, :W], b, a[:, W:]], dim=1)

        old = flatten(self._state.pods)
        new = flatten(fresh)
        self._state = self._state._replace(pods=unflatten(PodArrays, {p: widen(old[p], new[p]) for p in old}))
        self.pod_window = new_W
        self.n_pods += insert
        self.consts = self.consts._replace(resident_shift=T - new_W)
        self.faults = self._fault_step()
        st = self.autoscale_statics
        if st is not None:
            gap = torch.full((C, insert), -1, dtype=torch.int32, device=self.device)
            st = self.autoscale_statics = st._replace(
                pod_group_id=widen(st.pod_group_id, gap),
                pg_slot_start=st.pg_slot_start + insert,
                pod_name_rank=torch.empty((C, self.n_pods), dtype=torch.int32, device=self.device),
            )
            self.name_ranks = (st.node_name_rank, st.pod_name_rank)
            if self.hpa_seg != (0, 0):
                self.hpa_seg = (self.hpa_seg[0] + insert, self.hpa_seg[1] + insert)
            self._refresh_name_ranks()
        self._init_stage()
        self.dispatch_stats["grows"] += 1
        self._executor.rebuild()

    # --- state ------------------------------------------------------------

    @property
    def state(self) -> ClusterBatchState:
        """The simulation state: fixed buffers, updated in place by every
        window (copy it, e.g. with state.clone_state, to keep a snapshot).
        Read-only: `install_state` copies another state into it."""
        return self._state

    def install_state(self, state: ClusterBatchState, next_window_idx: int) -> None:
        """Continue from `state` (e.g. one carried over from the JAX engine
        by convert.state_from_numpy) at window `next_window_idx`: its leaves
        are copied into the engine's buffers. Reads the event cursor, the
        autoscalers' due times and the pending node removals back once to
        seed the host mirrors. Raises if a leaf is not on this engine's
        device or differs in shape or dtype, or if the state's autoscaler
        leaves do not match this engine's autoscaler configuration."""
        for path, leaf in flatten(state).items():
            if leaf.device != self.device:
                raise ValueError(
                    f"install_state: leaf {path} is on {leaf.device}, the engine "
                    f"runs on {self.device}"
                )
        if (state.auto is None) != (self.autoscale_statics is None) or (
            state.auto is not None
            and (
                (state.auto.col_next is None) != (self.state.auto.col_next is None)
                or (state.auto.ca_alloc is None) != (self.state.auto.ca_alloc is None)
            )
        ):
            raise ValueError(
                "install_state: the state's autoscaler leaves do not match this "
                "engine's autoscaler configuration"
            )
        if (state.telemetry is None) != (self.state.telemetry is None):
            raise ValueError(
                "install_state: telemetry ring mismatch: the state "
                + ("carries" if state.telemetry is not None else "lacks")
                + " a telemetry ring and this engine was built with telemetry "
                + ("off" if self.state.telemetry is None else "on")
            )
        if self.pod_window is not None:
            # A state saved after growths: grow to its width first (its
            # leaves then replace every slot); the feeder re-seeks at the
            # state's base.
            while state.pods.phase.shape[1] > self.n_pods and self._grow_pod_window():
                pass
            self.close()
        copy_state_into(self._state, state)
        self._executor.reset_after_install()
        self.host_syncs += 1
        if state.telemetry is not None:
            # The installed ring's rows count as undrained, so a drain
            # reads them before later windows overwrite them.
            self._ring_host_cursor = int(state.telemetry.cursor.max())
            self._ring_drained_at = max(0, self._ring_host_cursor - self._telemetry_ring_size)
            if self.observatory is not None:
                self.observatory.reset()
        self._cursor = state.event_cursor.cpu().numpy().astype(np.int64)
        if self.pod_window is not None:
            self._pod_base = int(state.pod_base[0])
            self._refresh_name_ranks()
            if self._slide_payload is None:
                self._ensure_feeder()
        self.next_window_idx = int(next_window_idx)
        if self.clock is not None:
            self.clock.seed(state.auto)
            win = state.nodes.remove_time.win.cpu().numpy().astype(np.int64)
            finite = win < INF_WIN
            if self.lane_async:
                win = win + self._lane_clock_np[:, None]  # lanes' virtual windows, as global ones
            self.clock.removal_windows = {max(int(w) + 1, self.next_window_idx) for w in np.unique(win[finite])}

    # --- checkpoint / resume ---------------------------------------------------

    def _ckpt_payload(self) -> Dict[str, object]:
        out = {"state": self.state, "next_window_idx": torch.tensor(self.next_window_idx, dtype=torch.int32)}
        if self.lane_async:
            # The lane clocks and their host mirrors.
            out["lanes"] = {
                "clock": self._lane_clocks.clock, "horizon": self._lane_clocks.horizon,
                "clock_host": torch.from_numpy(self._lane_clock_np), "horizon_host": torch.from_numpy(self._lane_horizon_np),
            }
        return out

    def save_checkpoint(self, path: str) -> None:
        """Save the state and the window cursor to the checkpoint file
        `path` (checkpoint.ckpt_save: atomic, overwrites), the build facts
        a restore must match to `path.meta.json` (written only where one
        differs from a plain build's, else a stale one is removed) and the
        gauge series to `path.gauges.npz` (reference engine.py:4297)."""
        from kubernetriks_tpu_torch.checkpoint import ckpt_save

        with self.tracer.span(PH_CKPT_SAVE):
            ckpt_save(path, self._ckpt_payload())
            meta_path = os.path.abspath(path) + ".meta.json"
            meta: Dict[str, object] = {}
            if self.pod_window is not None:
                # Growths change the pod arrays' width: a restore grows to it.
                meta["pod_window"] = int(self.pod_window)
            if self.state.telemetry is not None:
                meta["telemetry_ring"] = int(self._telemetry_ring_size)
            if self.reclaim:
                meta["reclaim"] = True
            if self.profile != DEFAULT_PROFILE:
                meta["scheduler_profile"] = {
                    "name": self.profile.name,
                    "filters": list(self.profile.filters),
                    "scores": [list(sc) for sc in self.profile.scores],
                }
            if meta:
                with open(meta_path, "w") as fh:
                    json.dump(meta, fh)
            elif os.path.exists(meta_path):
                os.remove(meta_path)
            self._gauges.save_sidecar(os.path.abspath(path) + ".gauges.npz")

    def _follow_reclaim(self, saved: bool) -> None:
        """Switch slot reclaim to the checkpoint's mode (load_checkpoint's
        tristate rule): the state gains fresh reclaim leaves or drops them,
        and the executor binds its buffers anew (the captured graphs held
        the old leaves)."""
        warnings.warn(
            f"checkpoint saved with reclaim={saved} but this engine defaulted to {self.reclaim} "
            f"(the reclaim= default): following the checkpoint, continuing with reclaim={saved}",
            RuntimeWarning,
            stacklevel=3,
        )
        self.reclaim = saved
        auto = self._state.auto
        if saved:
            fresh = init_autoscale_state(self.autoscale_statics, collect=auto.col_next is not None, reclaim=True)
            auto = auto._replace(ca_alloc=fresh.ca_alloc, ca_total=fresh.ca_total, ca_reclaimed=fresh.ca_reclaimed)
        else:
            auto = auto._replace(ca_alloc=None, ca_total=None, ca_reclaimed=None)
        self._state = self._state._replace(auto=auto)
        self._executor._bind_buffers()

    def load_checkpoint(self, path: str) -> None:
        """Restore a save_checkpoint save into this engine, which must be
        built from the same config and traces (reference engine.py:4374):
        the guards first (a telemetry ring mismatch raises either way, a
        scheduler-profile mismatch raises, reclaim follows its tristate
        rule, the pod window grows to the saved width), then the state
        through install_state (a copy into the executor's buffers: graphs
        of the same width stay valid; the host mirrors are seeded, the
        feeder re-seeks, the ring's bookkeeping and the observatory
        reset), and the gauge series from its sidecar."""
        from kubernetriks_tpu_torch.checkpoint import ckpt_restore

        meta_path = os.path.abspath(path) + ".meta.json"
        meta: Dict[str, object] = {}
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                meta = json.load(fh)
        saved_reclaim = bool(meta.get("reclaim", False))
        if saved_reclaim != self.reclaim:
            # An engine left to the default follows the checkpoint (the
            # card defaults reclaim on, so older saves would otherwise not
            # restore there); an explicit reclaim= raises.
            followable = self._reclaim_requested is None and (
                not saved_reclaim
                or (self.autoscale_statics is not None and self.autoscale_statics.ca_slot_class is not None)
            )
            if not followable:
                raise ValueError(
                    f"checkpoint reclaim mismatch: saved with reclaim={saved_reclaim}, this engine built with "
                    f"{self.reclaim}; the slot-reclaim leaves are part of the state: build the restoring "
                    f"engine with reclaim={saved_reclaim} to continue the run"
                )
        saved_ring = meta.get("telemetry_ring")
        have_ring = self._telemetry_ring_size if self.state.telemetry is not None else None
        if saved_ring != have_ring:
            raise ValueError(
                f"checkpoint telemetry ring mismatch: saved telemetry_ring={saved_ring}, this engine has "
                f"{have_ring}; build with telemetry={saved_ring is not None} and telemetry_ring={saved_ring} "
                "(or KTPU_TRACE) to restore it"
            )
        saved_prof = meta.get("scheduler_profile")
        if saved_prof is not None:
            saved_prof = CompiledProfile(
                name=saved_prof["name"],
                filters=tuple(saved_prof["filters"]),
                scores=tuple((str(n), float(w)) for n, w in saved_prof["scores"]),
            )
        want = saved_prof or DEFAULT_PROFILE
        if want != self.profile:
            raise ValueError(
                f"checkpoint scheduler-profile mismatch: saved {want.name!r} {want.scores}, this engine "
                f"compiled {self.profile.name!r} {self.profile.scores}; build the restoring engine with the "
                "same scheduler_profile to continue the run"
            )
        saved_window = meta.get("pod_window")
        if saved_window is not None and self.pod_window is not None:
            while self.pod_window < saved_window and self._grow_pod_window():
                pass
            if self.pod_window != saved_window:
                raise ValueError(
                    f"checkpoint was saved at pod_window={saved_window}; this engine is at "
                    f"{self.pod_window} and cannot match"
                )
        if saved_reclaim != self.reclaim:
            self._follow_reclaim(saved_reclaim)
        with self.tracer.span(PH_CKPT_RESTORE):
            restored = ckpt_restore(path, self._ckpt_payload())
            # Rows drained before the restore described another trajectory.
            self._ring_seen = {}
            self._ring_series_dropped = 0
            self._ring_windows_recorded = 0
            if self.lane_async:
                lanes = restored["lanes"]
                self._lane_clocks.clock.copy_(lanes["clock"])
                self._lane_clocks.horizon.copy_(lanes["horizon"])
                self._lane_clock_np[:] = lanes["clock_host"].numpy()
                self._lane_horizon_np[:] = lanes["horizon_host"].numpy()
            self.install_state(restored["state"], int(restored["next_window_idx"]))
            self._gauges = GaugeSeries.load_sidecar(os.path.abspath(path) + ".gauges.npz")

    # --- the scenario fleet's engine side (batched/fleet.py) ----------------------

    def _host_pair(self, seconds) -> TPair:
        """float64 seconds (host numpy) as a CPU time pair."""
        w, o = from_f64_np(np.asarray(seconds, np.float64), self.config.scheduling_cycle_interval)
        return TPair(win=torch.from_numpy(np.ascontiguousarray(w)), off=torch.from_numpy(np.ascontiguousarray(o)))

    def update_scenario(self, scenario) -> None:
        """Install per-lane scenario vectors (fleet.SCENARIO_KEYS, each a
        scalar or (C,)) into this scenario-built engine (reference
        engine.py:2167): every scenario-bearing statics leaf and the pod-
        fault seed vector is written in place (copy_ into the tensor the
        captured graphs read: no capture, no eager window), and the
        autoscaler clock's host copies of the law are refreshed from the
        same host values (no read of the device). Raises on an engine
        built without scenario=."""
        if self._scenario is None:
            raise ValueError(
                "update_scenario requires an engine built with scenario= (the fleet build): a scenario-less "
                "engine keys its fault draws on the cluster index and has no seed vector to write"
            )
        self._scenario.update(normalize_scenario(scenario, self.n_clusters) or {})
        law = scenario_leaves(self.config, self.n_clusters, self._scenario)
        st = self.autoscale_statics
        if st is not None:
            active = np.where(law["hpa_enabled"][:, None], self._autoscale_aux["pg_active_when_on"], np.inf)
            host = {
                name: self._host_pair(law[f"{name}_s"])
                for name in ("hpa_interval", "d_hpa_up", "d_hpa_down", "d_ca_up", "d_ca_down", "ca_period",
                             "ca_snap", "ca_finish_vis", "ca_commit_vis")
            }
            host["pg_active_from"] = self._host_pair(active)
            for name, pair in host.items():
                dst = getattr(st, name)
                dst.win.copy_(pair.win)
                dst.off.copy_(pair.off)
            st.hpa_tolerance.copy_(torch.from_numpy(law["hpa_tolerance"].astype(np.float64)))
            st.ca_threshold.copy_(torch.from_numpy(law["ca_threshold"].astype(np.float64)))
            st.ca_max_nodes.copy_(torch.from_numpy(law["ca_max_nodes"].astype(np.int32)))
            if self.clock is not None:
                self.clock.set_law(host["hpa_interval"], host["ca_period"], host["ca_snap"], host["d_ca_down"])
        if self._fault_seeds is not None:
            self._fault_seeds.copy_(torch.from_numpy(law["fault_seed"].astype(np.uint32)))

    def fleet_reset(self, lanes=None) -> None:
        """Reset lanes to the pristine build state in place (reference
        engine.py:2238): each state leaf takes the snapshot's rows on the
        lanes, keeping its tensor (the captured graphs read it). lanes=None
        resets every lane and rewinds the host side to the build's, from
        the build's own mirrors (no read of the device): the window cursor,
        the event cursor and pod base mirrors, the autoscaler clock's due
        times and removal windows (fast-forward's mirrors), the feeder
        (re-seeked at base 0) and the stage, the name ranks, the telemetry
        ring's host cursor and bookkeeping, and the observatory: a wave
        boundary. A lane list resets those lanes' rows and their event
        cursor and clock mirrors alone, and is meant for a wave boundary
        (the window clock is fleet-global). Raises on an engine built
        without scenario=, and where the pod window grew since the build
        (the snapshot's pod arrays are narrower)."""
        if self._pristine is None:
            raise ValueError(
                "fleet_reset requires an engine built with scenario= (the fleet build keeps the pristine "
                "state snapshot)"
            )
        if self.pod_window != self._pristine_pod_window:
            raise RuntimeError(
                f"fleet_reset: the pod window grew ({self._pristine_pod_window} -> {self.pod_window}) during a "
                "wave, so the pristine snapshot's shapes are stale; build the fleet with a larger pod_window so "
                "a wave never grows it"
            )
        C = self.n_clusters
        if lanes is None:
            copy_state_into(self._state, self._pristine)
            self._cursor = np.zeros(C, np.int64)
            if self.clock is not None:
                self.clock.set_due_times(self._pristine_due)
                self.clock.removal_windows = set()
            self._rewind_host()
            return
        self._reset_rows(lanes, keep_ring=False)

    def _reset_rows(self, lanes, keep_ring: bool) -> None:
        """The lanes' state rows back to the pristine snapshot's in place
        (with `keep_ring` every leaf but the telemetry ring's), their
        event cursor and clock mirrors with them."""
        C = self.n_clusters
        idx = np.asarray(list(lanes), np.int64)
        if idx.size == 0:
            return
        mask_np = np.zeros(C, bool)
        mask_np[idx] = True
        mask = torch.from_numpy(mask_np).to(self.device)
        cur, ini = flatten(self._state), flatten(self._pristine)
        for path, leaf in cur.items():
            if keep_ring and path.startswith(".telemetry."):
                continue
            m = mask.reshape((C,) + (1,) * (leaf.dim() - 1))
            leaf.copy_(torch.where(m, ini[path], leaf))
        self._cursor[idx] = 0
        if self.clock is not None:
            self.clock.set_due_times(self._pristine_due, torch.from_numpy(mask_np))
        self._executor.reset_after_install()

    def _rewind_host(self) -> None:
        """fleet_reset's wave boundary on the host side (its docstring)."""
        self.next_window_idx = 0
        if self.pod_window is not None:
            self._pod_base = 0
            self.close()
            self._refresh_name_ranks()
            if self._slide_payload is None:
                self._ensure_feeder()
        self._executor.reset_after_install()
        if self.state.telemetry is not None:
            self._ring_seen.clear()
            self._ring_series_dropped = 0
            self._ring_windows_recorded = 0
            self._ring_host_cursor = 0
            self._ring_drained_at = 0
        if self.observatory is not None:
            self.observatory.reset()

    # --- lane clocks (the lane-asynchronous fleet; reference engine.py:2293-2504) ---

    def _need_lanes(self, what: str) -> None:
        if not self.lane_async:
            raise ValueError(f"{what} requires an engine built with lane_async=True (per-lane window clocks)")

    def horizon_windows(self, horizon: float) -> int:
        """The windows a fresh run to `horizon` simulated seconds executes:
        the lane horizon a query needs to equal the wave-aligned path."""
        return int(math.floor(horizon / self.config.scheduling_cycle_interval)) + 1

    def set_lane_plan(self, lanes, start_window: int, horizons) -> None:
        """Arm lanes' clocks: their virtual window 0 at global window
        `start_window`, and `horizons[i]` windows to run. Writes the host
        mirrors and the clock tensors in place (the captured graphs read
        them), so a re-seed never captures."""
        self._need_lanes("set_lane_plan")
        lanes = np.asarray(list(lanes), np.int64)
        self._lane_clock_np[lanes] = int(start_window)
        self._lane_horizon_np[lanes] = np.asarray(horizons, np.int64)
        self._lane_clocks.clock.copy_(torch.from_numpy(self._lane_clock_np.astype(np.int32)))
        self._lane_clocks.horizon.copy_(torch.from_numpy(self._lane_horizon_np.astype(np.int32)))

    def lane_windows_done(self) -> np.ndarray:
        """(C,) bool: lanes whose planned span is dispatched (the global
        cursor past clock + horizon). Host arithmetic on the mirrors."""
        return self._lane_clock_np + self._lane_horizon_np <= self.next_window_idx

    def lane_windows_remaining(self) -> np.ndarray:
        """(C,) windows left on each lane's plan from the global cursor (0
        for idle and finished lanes): the pump's occupancy ledger."""
        return np.clip(self._lane_clock_np + self._lane_horizon_np - self.next_window_idx, 0, None)

    def step_windows(self, n_windows: int) -> None:
        """Run exactly `n_windows` windows from the global cursor: the
        lane-asynchronous pump's dispatch. Where the host mirrors prove
        every lane inside its span for the whole chunk, the windows run
        the no-freeze pieces, else the freezing ones (reference
        engine.py:2396-2420). The ring's entry guard and exit drain are
        step_until_time's."""
        n = int(n_windows)
        if n <= 0:
            return
        if self.pod_window is not None:
            raise ValueError(
                "step_windows requires the full-resident pod path (pod_window=None); sliding-window engines "
                "advance with step_until_time"
            )
        if self.state.telemetry is not None:
            pending = self._ring_host_cursor - self._ring_drained_at
            if pending > 0 and pending + n > self._telemetry_ring_size:
                self._maybe_drain_ring(force=True)
        start = self.next_window_idx
        freeze = True
        if self.lane_async:
            freeze = not (
                bool(np.all(self._lane_clock_np <= start))
                and bool(np.all(start + n <= self._lane_clock_np + self._lane_horizon_np))
            )
        self._run_span(start, start + n - 1, freeze)
        self._maybe_drain_ring()

    def lane_reset(self, lanes) -> None:
        """Reset lanes to the pristine build state mid-flight: fleet_reset
        of the lanes but for the telemetry ring's buffer and cursor, which
        keep running (reference engine.py:2469-2504), and the retirement
        of the lanes' trace ranges in the multiplexer."""
        self._need_lanes("lane_reset")
        if self._pristine is None:
            raise ValueError(
                "lane_reset requires an engine built with scenario= (the fleet build keeps the pristine state "
                "snapshot)"
            )
        lanes = [int(v) for v in lanes]
        self._lane_mux.retire(lanes)
        self._reset_rows(lanes, keep_ring=True)

    def set_lane_trace(self, lane: int, lo: int = 0, hi=None) -> None:
        """Install a lane's workload row range (stream.LaneTraceMux): the
        lane replays slab rows [lo, hi) alone (pod creates outside it and
        their removes masked to EV_NONE). Written into the resident slab's
        row in place, with the host tables the plans read for the lane;
        refused while the lane's previous range flies (lane_reset retires
        it)."""
        self._need_lanes("set_lane_trace")
        rows = self._lane_mux.offer(int(lane), lo, hi)
        if rows is not None:
            self._install_lane_rows(int(lane), rows)

    def _install_lane_rows(self, lane: int, rows: np.ndarray) -> None:
        """One lane's (E, 4) slab rows into the slab in place, and that
        lane's rows of the host tables recomputed from them."""
        self.slab.packed[lane].copy_(torch.from_numpy(np.ascontiguousarray(rows, np.int32)))
        for table, row in zip(
            (self._due_upto, self._rm_prefix, self._crash_prefix),
            slab_tables(rows[None, :, 0], rows[None, :, 2], self._wmax),
        ):
            table[lane] = row[0]

    # --- stepping -----------------------------------------------------------

    @property
    def next_window(self) -> float:
        return self.next_window_idx * self.config.scheduling_cycle_interval

    def window_idxs(self, until_time: float) -> np.ndarray:
        interval = self.config.scheduling_cycle_interval
        first = self.next_window_idx
        count = int(math.floor(until_time / interval)) - first + 1
        return first + np.arange(max(count, 0), dtype=np.int32)

    def _plan(self, w: int, freeze: bool = True) -> WindowPlan:
        """Host facts of window w from the slab tables and the cursor
        mirror; advances the mirror to where the window leaves it. Under
        lane clocks, those of `_lane_plan` (`freeze`: the plan's)."""
        if self.lane_async:
            return self._lane_plan(w, freeze)
        due = self._due_upto[:, min(max(w, 0), self._wmax)]
        target = np.maximum(self._cursor, due)
        E = self.max_events_per_window
        span = target - self._cursor
        n_chunks = int(((span + E - 1) // E).max()) if span.size else 0
        rows = np.arange(self.n_clusters)
        removal_due = bool(
            (self._rm_prefix[rows, target] > self._rm_prefix[rows, self._cursor]).any()
        )
        crash_due = bool(
            (self._crash_prefix[rows, target] > self._crash_prefix[rows, self._cursor]).any()
        )
        self._cursor = target
        if self.clock is None:
            return WindowPlan(n_chunks=n_chunks, removal_due=removal_due, crash_due=crash_due)
        # A CA removal decided in an earlier window takes effect here.
        removal_due = removal_due or w in self.clock.removal_windows
        self.clock.removal_windows.discard(w)
        hpa_cycle, hpa_collect, ca_due = self.clock.advance(w)
        return WindowPlan(
            n_chunks=n_chunks,
            removal_due=removal_due,
            hpa_cycle=hpa_cycle,
            hpa_collect=hpa_collect,
            ca_due=ca_due,
            reclaim=self.reclaim,
            crash_due=crash_due,
        )

    def initial_window_plans(self, n_windows: int) -> List[WindowPlan]:
        """The host WindowPlans of windows 0..n_windows-1 from the host
        mirrors as the build left them (the event cursor at 0, the
        autoscaler clock at its build due times, no CA removal pending),
        whatever the engine has run since. The plans depend on the trace
        and the due times alone, never on the scheduling decisions, so a
        run that restarts from the build state under another scheduler
        (the RL rollout, rl/env.py) replays them as they are. The live
        mirrors are left as they are."""
        if self.lane_async:
            raise ValueError("initial_window_plans: a lane-asynchronous engine plans each lane at its own clock")
        live = (self._cursor, self.clock)
        self._cursor = np.zeros(self.n_clusters, np.int64)
        if self.clock is not None:
            self.clock = copy.copy(self.clock)
            self.clock.removal_windows = set()
            self.clock.set_due_times(self._build_due)
        try:
            return [self._plan(w) for w in range(int(n_windows))]
        finally:
            self._cursor, self.clock = live

    def _lane_plan(self, w: int, freeze: bool) -> WindowPlan:
        """_plan under lane clocks: each lane active at global window w
        contributes its facts at its own virtual window w - clock (the
        slab tables, the cursor mirror, the autoscaler clock); an inactive
        lane contributes nothing and its mirrors stay put (the window's
        freeze reverts its state). The plan is the union over the active
        lanes; CA removal windows are kept as global windows."""
        rel = w - self._lane_clock_np
        active = (rel >= 0) & (rel < self._lane_horizon_np)
        vw = np.maximum(rel, 0)
        rows = np.flatnonzero(active)
        cur = self._cursor[rows]
        target = np.maximum(cur, self._due_upto[rows, np.minimum(vw[rows], self._wmax)])
        E = self.max_events_per_window
        n_chunks = int(((target - cur + E - 1) // E).max()) if rows.size else 0
        removal_due = bool((self._rm_prefix[rows, target] > self._rm_prefix[rows, cur]).any())
        crash_due = bool((self._crash_prefix[rows, target] > self._crash_prefix[rows, cur]).any())
        self._cursor[rows] = target
        if self.clock is None:
            return WindowPlan(n_chunks=n_chunks, removal_due=removal_due, crash_due=crash_due, freeze=freeze)
        removal_due = removal_due or w in self.clock.removal_windows
        self.clock.removal_windows.discard(w)
        hpa_cycle, hpa_collect, ca_due = self.clock.advance(vw, active, self._lane_clock_np)
        return WindowPlan(
            n_chunks=n_chunks,
            removal_due=removal_due,
            hpa_cycle=hpa_cycle,
            hpa_collect=hpa_collect,
            ca_due=ca_due,
            reclaim=self.reclaim,
            crash_due=crash_due,
            freeze=freeze,
        )

    def _window_body(self, state: ClusterBatchState, w: int, plan: WindowPlan) -> ClusterBatchState:
        """Window w on `state` as one eager step (step.window_body), the
        pieces' yardstick; under the razor it reads its predicate back."""
        return window_body(
            state,
            self.slab,
            w,
            self.consts,
            self._k,
            self.max_events_per_window,
            self.max_pods_per_cycle,
            plan,
            conditional_move=self.conditional_move,
            name_ranks=self.name_ranks,
            autoscale=None if self.clock is None else (
                self.autoscale_statics, self.hpa_seg,
                self.max_ca_pods_per_cycle, self.max_pods_per_scale_down,
            ),
            cycle_route=self.cycle_route,
            profile=self.profile,
            faults=self.faults,
            profile_terms=self.profile_terms,
            window_razor=self.window_razor,
            lanes=self._lane_clocks,
        )

    def _run_span(self, first: int, last: int, freeze: bool = True) -> None:
        """Plan windows first..last on the host and run them through the
        window executor (reference `_dispatch_windows`, engine.py:1965),
        with fast-forward its executed windows only (module note); with
        gauges on, every window, read back once GAUGE_SPAN windows.
        `freeze`: lane clocks' freeze (step.WindowPlan.freeze)."""
        if last < first:
            return
        with self.tracer.span(PH_WINDOW_CHUNK):
            if self.collect_gauges:
                self._run_gauged(first, last, freeze)
            elif self.fast_forward:
                self._executor.run_windows_skipping(first, last, self._plan, self._skip_windows)
            else:
                self._executor.run_windows([(w, self._plan(w, freeze)) for w in range(first, last + 1)])
                self._ring_host_cursor += last - first + 1
        self.next_window_idx = last + 1
        self.windows_run += last - first + 1

    def _run_gauged(self, first: int, last: int, freeze: bool = True) -> None:
        """Windows first..last, each followed by a gauge sample into the
        executor's gauge buffer (a slot indexed on the device), read back
        once GAUGE_SPAN windows and at the end: one host read each (counted
        in host_syncs), none a window. Gauge collection steps every window
        (no fast-forward), as the reference's does (engine.py:2013)."""
        ex = self._executor
        ex.enable_gauges()
        for lo in range(first, last + 1, GAUGE_SPAN):
            hi = min(lo + GAUGE_SPAN - 1, last)
            ex.run_windows([(w, self._plan(w, freeze)) for w in range(lo, hi + 1)])
            self._ring_host_cursor += hi - lo + 1
            self._gauges.append(np.arange(lo, hi + 1, dtype=np.int32), ex.read_gauges(hi - lo + 1))
            self.host_syncs += 1

    def _after_executed_read(self) -> None:
        """After fast-forward's read of the next window (executor): the
        executed window's record counts, and the ring drains there if it
        fills, riding the read that just blocked."""
        if self.state.telemetry is not None:
            self._ring_host_cursor += 1
            self._maybe_drain_ring()

    def _skip_windows(self, lo: int, hi: int) -> None:
        """The host mirrors through the skipped windows [lo, hi): the event
        cursor's does not move (a due event would have made a window
        interesting), the autoscaler clock advances a window at a time as
        the catch-up piece advances the device's due times, and no CA
        removal can take effect in a skipped window (a pending removal's
        window is a trigger), so none stays recorded there."""
        if self.clock is None:
            return
        for w in range(lo, hi):
            self.clock.removal_windows.discard(w)
            self.clock.advance(w)

    def _dispatch_windows(self, idxs: Sequence[int]) -> None:
        """Run windows `idxs` (consecutive, from next_window_idx). Under the
        sliding pod window, in spans up to the last window whose pod
        creations fit the device window, each followed by a slide, or a
        growth where no slide is possible (reference `_step_until_time`,
        engine.py:2533-2610): one host read a span, none inside it."""
        if len(idxs) == 0:
            return
        target = int(idxs[-1])
        if self.pod_window is None:
            self._run_span(int(idxs[0]), target)
            return
        if self._slide_payload is None:
            self._ensure_feeder()  # after a close(): produces ahead while the spans run
        while self.next_window_idx <= target:
            sub = min(target, self._pod_capacity_window())
            if self.fast_forward:
                # The reference's ladder chunks (module note).
                while self.next_window_idx <= sub:
                    span = sub - self.next_window_idx + 1
                    chunk = next(c for c in CHUNK_LADDER if c <= span)
                    self._run_span(self.next_window_idx, self.next_window_idx + chunk - 1)
            else:
                self._run_span(self.next_window_idx, sub)
            if sub >= target:
                return
            if self._feeder is not None:
                self._feeder.prefetch(self.tracer)  # without a thread: the successor, while the span runs
            self._ensure_stage()
            if not self._slide() and not self._grow_pod_window():
                raise RuntimeError(
                    f"pod_window={self.pod_window} is too small: window {sub + 1} needs pod slots "
                    "beyond the device window and no leading pod is terminal yet, and the window "
                    "already covers the whole plain trace segment"
                )
            # The ring drains here if it fills, riding the slide's read.
            self._maybe_drain_ring()

    def precompile_pieces(self) -> int:
        """Capture every window piece the engine's plans can reach on its
        current cycle route, so that no capture lands inside a timed span
        (the counterpart of the reference's precompile_chunks, engine.py:
        2064). Returns the number of graphs captured; 0 with graphs off."""
        if not self.graphs:
            return 0
        if self.collect_gauges:
            self._executor.enable_gauges()
        return self._executor.capture(self._executor.reachable_keys())

    def graph_pool_bytes(self) -> int:
        """Device memory held by the window graphs' memory pool."""
        backend = self._executor.backend
        return backend.pool_bytes() if backend is not None else 0

    def step_window(self) -> None:
        """Advance one scheduling window (under the pod window, without a
        slide: it raises where the window would need one)."""
        w = self.next_window_idx
        if self.pod_window is not None and w > self._pod_capacity_window():
            raise RuntimeError(
                "step_window would apply a pod creation beyond the sliding pod window; "
                "use step_until_time (which slides the window) or a larger pod_window"
            )
        self._run_span(w, w)

    def step_until_time(self, until_time: float) -> None:
        """Advance through every window whose cycle time is <= until_time.
        With telemetry on, the ring drains at the entry where this call
        could wrap past undrained rows, and at the exit where it is half
        full (host arithmetic decides; the reads land where the host
        blocks anyway, reference engine.py:2509-2531)."""
        idxs = self.window_idxs(until_time)
        if self.state.telemetry is not None:
            pending = self._ring_host_cursor - self._ring_drained_at
            if pending > 0 and pending + len(idxs) > self._telemetry_ring_size:
                self._maybe_drain_ring(force=True)
        self._dispatch_windows(idxs)
        self._maybe_drain_ring()

    def run_to_completion(self, max_time: float = 1e7) -> None:
        """Step until every trace pod has terminated (reference
        engine.py:3640): in chunks of 64 windows (or the event chunk, if
        larger), the run ends once it is past the last event plus one
        interval (an event in window w applies when window w + 1 steps)
        and no finite-duration pod is queued, parked or running. One host
        read-back per chunk past that point, counted in host_syncs.
        Raises once the run passes max_time with pods still live."""
        interval = self.config.scheduling_cycle_interval
        chunk = max(64, self.max_events_per_window)
        while True:
            self.step_until_time(self.next_window + chunk * interval)
            if self.next_window <= self.last_event_time + interval:
                continue
            pods = self.state.pods
            live_mask = (
                (pods.phase == PHASE_QUEUED)
                | (pods.phase == PHASE_UNSCHEDULABLE)
                | ((pods.phase == PHASE_RUNNING) & (pods.duration.win >= 0))
            )
            self.host_syncs += 1
            live = int(live_mask.sum())
            if live == 0:
                return
            if self.next_window > max_time:
                raise RuntimeError(
                    f"run_to_completion exceeded max_time={max_time}; {live} pods still live"
                )

    # --- readout ------------------------------------------------------------

    def decisions_total(self) -> int:
        self.host_syncs += 1
        return int(self.state.metrics.scheduling_decisions.sum())

    def check_autoscaler_bounds(self) -> None:
        """Raise when a documented autoscaler work bound was crossed, so the
        trajectory has left the reference's semantics (reference
        engine.py:3672): an HPA cycle wanted more replicas than the group's
        slot reserve could seat, a CA scale-up found quota and a fitting
        template but no reserved slot left, or a replica index reached the
        10^8 bound of the decimal name keys (an HPA replica index or, under
        slot reclaim, a CA group's allocation count)."""
        if self.autoscale_statics is None:
            return
        m = self.state.metrics
        clamped = m.hpa_reserve_clamped.cpu().numpy()
        if clamped.sum() > 0:
            raise RuntimeError(
                f"HPA slot reserve exhausted: {int(clamped.sum())} wanted replica(s) "
                f"across {int((clamped > 0).sum())} cluster(s) could not be activated "
                "because no reusable slot remained in the pod group's reserve; the "
                "reported replica counts have diverged from the reference semantics"
            )
        starved = m.ca_reserve_starved.cpu().numpy()
        if starved.sum() > 0:
            if self.reclaim:
                hint = (
                    "slot reclaim is on, so every retired slot was already returned: live "
                    "demand (with removals still inside their visibility horizon) filled the "
                    "reserve. Raise ca_slot_multiplier (build argument) to widen it"
                )
            else:
                hint = (
                    "slots are not reclaimed on this build: raise ca_slot_multiplier (build "
                    "argument) to widen the reserve, or build with reclaim=True so retired "
                    "slots return to it"
                )
            raise RuntimeError(
                f"CA slot reserve exhausted: {int(starved.sum())} scale-up attempt(s) "
                f"across {int((starved > 0).sum())} cluster(s) found quota headroom and "
                "a fitting node-group template but no reserved slot left; the demand "
                "starved where the reference semantics would have provisioned a node. "
                + hint
            )
        auto = self.state.auto
        tail_max = int(auto.hpa_tail.max())
        total_max = 0 if auto.ca_total is None else int(auto.ca_total.max())
        if max(tail_max, total_max) >= 10**8:
            raise RuntimeError(
                f"allocation-name counter overflow: hpa_tail max {tail_max}, ca_total max "
                f"{total_max} reached the 10^8 bound of the decimal-suffix name keys"
            )

    def hpa_replicas(self, cluster: int) -> Dict[str, int]:
        """Created replicas of each of the cluster's pod groups (the
        scalar reference's len(created_pods); reference engine.py:3846),
        by group name: one host read."""
        auto = self.state.auto
        if auto is None:
            raise ValueError("hpa_replicas: autoscaling is not enabled on this engine")
        counts = (auto.hpa_tail[cluster] - auto.hpa_head[cluster]).cpu().tolist()
        return {name: int(counts[i]) for i, name in enumerate(self.pod_group_names[cluster])}

    def ca_node_counts(self, cluster: int) -> np.ndarray:
        """The cluster autoscaler's current node count per node group
        (reference engine.py:3872): one host read."""
        auto = self.state.auto
        if auto is None:
            raise ValueError("ca_node_counts: autoscaling is not enabled on this engine")
        return auto.ca_count[cluster].cpu().numpy()

    def ca_slots_reclaimed(self) -> np.ndarray:
        """(C,) CA reserve slots the reclaim compaction returned (zeros
        when reclaim is off)."""
        auto = self.state.auto
        if auto is None or auto.ca_reclaimed is None:
            return np.zeros(self.n_clusters, np.int32)
        return auto.ca_reclaimed.cpu().numpy()

    def metrics_summary(self) -> Dict:
        """Cross-cluster reduction into the reference's printer shape, with
        the CA slots reclaimed among the counters when reclaim runs.
        Raises via check_autoscaler_bounds when an autoscaler work bound
        was crossed."""
        self.check_autoscaler_bounds()
        m = self.state.metrics

        def host(x):
            return x.cpu().numpy()

        def est(e):
            count = host(e.count).astype(np.int64)
            total = host(e.total).astype(np.float64)
            total_sq = host(e.total_sq).astype(np.float64)
            n = count.sum()
            if n == 0:
                return {"min": math.inf, "max": -math.inf, "mean": math.nan, "variance": math.nan}
            mean = total.sum() / n
            return {
                "min": float(host(e.minimum).min()),
                "max": float(host(e.maximum).max()),
                "mean": float(mean),
                "variance": float(total_sq.sum() / n - mean * mean),
            }

        def total(x):
            return int(host(x).sum())

        return {
            "counters": {
                "pods_succeeded": total(m.pods_succeeded),
                "pods_removed": total(m.pods_removed),
                "terminated_pods": total(m.terminated_pods),
                "processed_nodes": total(m.processed_nodes),
                "scheduling_decisions": total(m.scheduling_decisions),
                "total_scaled_up_pods": total(m.scaled_up_pods),
                "total_scaled_down_pods": total(m.scaled_down_pods),
                "total_scaled_up_nodes": total(m.scaled_up_nodes),
                "total_scaled_down_nodes": total(m.scaled_down_nodes),
                "node_crashes": total(m.node_crashes),
                "node_recoveries": total(m.node_recoveries),
                "node_downtime_s": float(host(m.node_downtime_s).astype(np.float64).sum()),
                "pod_interruptions": total(m.pod_interruptions),
                "pod_restarts": total(m.pod_restarts),
                "pods_failed": total(m.pods_failed),
                **({"ca_slots_reclaimed": int(self.ca_slots_reclaimed().sum())} if self.reclaim else {}),
            },
            "timings": {
                "pod_duration": est(m.pod_duration),
                "pod_schedule_time": est(m.algo_latency),
                "pod_queue_time": est(m.queue_time),
            },
        }


    # --- telemetry readout --------------------------------------------------

    def _maybe_drain_ring(self, force: bool = False) -> Optional[Dict]:
        """Drain the telemetry ring before its rows wrap out (reference
        engine.py:3959): host arithmetic on the windows recorded since the
        last drain decides (half the ring, or `force`), and only those rows
        are read (telemetry/ring.snapshot; the reference reads the whole
        ring), where the host already blocks: step_until_time's entry and
        exit, a slide's or an executed window's read, readout. It is not counted in host_syncs, and adds
        no graph replay. Returns the observatory's drain record where a
        drain happened, else None."""
        if self.state.telemetry is None:
            return None
        pending = self._ring_host_cursor - self._ring_drained_at
        if not force and pending * 2 < self._telemetry_ring_size:
            return None
        from kubernetriks_tpu_torch.telemetry import ring as dring

        # The rows recorded since the last drain, as the host counts them.
        t0 = time.perf_counter_ns()
        buf, cursor = dring.snapshot(self.state.telemetry, self._ring_drained_at, self._ring_host_cursor)
        t1 = time.perf_counter_ns()
        if cursor != self._ring_host_cursor:
            raise RuntimeError(
                f"telemetry ring: the card recorded {cursor} windows, the host counted {self._ring_host_cursor}"
            )
        dring.merge_snapshot(self._ring_seen, buf)
        cap = self.telemetry_series_windows
        if cap and len(self._ring_seen) > cap:
            # Drop the oldest windows past the series bound (reported as
            # ring.series_dropped_windows).
            for w in sorted(self._ring_seen)[: len(self._ring_seen) - cap]:
                del self._ring_seen[w]
                self._ring_series_dropped += 1
        self._ring_windows_recorded = max(self._ring_windows_recorded, cursor)
        drained = self._ring_host_cursor - self._ring_drained_at
        self._ring_drained_at = self._ring_host_cursor
        record = self._observe_drain(buf)
        cost = self._ring_drain_stats
        cost["drains"] += 1
        cost["windows"] += drained
        cost["read_ns"] += t1 - t0
        cost["host_ns"] += time.perf_counter_ns() - t1
        return record

    def _sync_budget(self) -> Dict[str, int]:
        """The stepping loop's documented reads (one a slide or growth, one
        an executed window under fast-forward) against the reads it made."""
        stats = self.dispatch_stats
        return {
            "steady_state_expected": stats["slides"] + stats["grows"] + stats["executed_windows"],
            "observed_slide_syncs": self._loop_reads,
        }

    def _observe_drain(self, buf: np.ndarray) -> Optional[Dict]:
        """Feed one drained ring (an owned host copy) to the capacity
        observatory: occupancy, a memory sample, the watchdog, the
        exporters. Host work only."""
        if self.observatory is None:
            return None
        fresh = self.observatory.ingest(buf)
        feeder = self._feeder_report()
        return self.observatory.observe(
            resources=self._sample_resources(),
            dispatch_stats=dict(self.dispatch_stats),
            sync_budget=self._sync_budget(),
            feeder=feeder,
            fresh=fresh,
        )

    def drain_telemetry(self) -> Dict:
        """Drain the ring and run the observatory now; returns the drain
        record ({} with telemetry off). The rows it read are owned host
        copies: later windows, which write the ring in place, leave them
        as they are."""
        return self._maybe_drain_ring(force=True) or {}

    def attach_metrics_exporter(self, exporter) -> None:
        """Register an export hook, an object with .emit(record: dict) (e.g.
        telemetry/export.JsonlExporter), called once a ring drain that
        found new windows, with the observatory's record."""
        if self.observatory is None:
            raise ValueError("telemetry is off — build with telemetry=True or KTPU_TRACE=1 to attach metrics exporters")
        self.observatory.exporters.append(exporter)

    def _sample_resources(self) -> Dict:
        """The observatory's memory sample: host RSS, the CUDA caching
        allocator's bytes in use and their peak (torch.cuda.memory_stats,
        where the reference reads its devices' memory_stats), and the
        engine's own buffer accounting. Host calls, no read of the state."""
        from kubernetriks_tpu_torch.telemetry.observatory import sample_host_memory

        res: Dict = dict(sample_host_memory())
        if self.device.type == "cuda":
            ms = torch.cuda.memory_stats(self.device)
            res["device_bytes_in_use"] = int(ms.get("allocated_bytes.all.current", 0))
            res["device_peak_bytes_in_use"] = int(ms.get("allocated_bytes.all.peak", 0))
        res["slabs"] = self._slab_accounting()
        return res

    def _slab_accounting(self) -> Dict[str, int]:
        """Bytes of the buffers the port keeps beside the state: the
        whole-trace slide payload on the device (the sliding pod window's),
        the host tables of the trace (create windows, name ranks, the
        payload source), the telemetry ring and the gauge buffer."""

        def nbytes(tensors) -> int:
            return sum(int(t.numel() * t.element_size()) for t in tensors if t is not None)

        host = 0
        for name in ("_pod_create_win", "_pod_name_rank_full"):
            arr = getattr(self, name, None)
            if arr is not None:
                host += int(arr.nbytes)
        source = getattr(self, "_payload_source", None)
        for arr in getattr(source, "full_pods", {}).values():
            host += int(np.asarray(arr).nbytes)
        ring = self.state.telemetry
        return {
            "device_slide_bytes": nbytes((getattr(self, "_slide_payload", None) or {}).values()),
            "device_stage_bytes": self.staging_bytes()["device_bytes"] if self.pod_window is not None else 0,
            "host_payload_bytes": host,
            "telemetry_ring_bytes": 0 if ring is None else nbytes([ring.buf, ring.cursor]),
            "gauge_buffer_bytes": nbytes([self._executor.bufs.gauges, self._executor.bufs.gauge_slot]),
        }

    def telemetry_window_series(self):
        """(windows (Wn,), records (Wn, C, K)): the ring's per-window series
        (columns telemetry.ring.RING_COLUMNS), drained first; empty arrays
        with telemetry off."""
        from kubernetriks_tpu_torch.telemetry import ring as dring

        self._maybe_drain_ring(force=True)
        return dring.series(self._ring_seen, self.n_clusters)

    def telemetry_report(self) -> Dict:
        """The flight recorder's readout (reference engine.py:4147): the
        tracer's per-phase host times and counters, dispatch_stats, the
        sync budget, the ring's totals and high-water marks, the
        observatory's section and the host ms a recorded window. With
        telemetry off: dispatch stats and the budget, enabled False."""
        from kubernetriks_tpu_torch.telemetry.tracer import PHASE_NAMES

        # One snapshot of the feeder keeps the counter and the section
        # consistent while the producer runs on.
        feeder = self._feeder_report()
        stats = dict(self.dispatch_stats)
        rep = {"enabled": self._telemetry, "dispatch_stats": stats}
        if feeder is not None:
            # Production, the ring's depth and the stall split, kept here so
            # that untraced runs show them too.
            rep["feeder"] = feeder
        if self.state.telemetry is not None:
            # The drains made before this readout (its own comes after).
            cost = self._ring_drain_stats
            n = cost["drains"]
            rep["ring_drains"] = {
                "drains": n,
                "windows": cost["windows"],
                "read_ms": cost["read_ns"] / 1e6,
                "host_ms": cost["host_ns"] / 1e6,
                "ms_per_drain": (cost["read_ns"] + cost["host_ns"]) / 1e6 / n if n else 0.0,
            }
        rep.update(self.tracer.report())
        rep["sync_budget"] = self._sync_budget()
        # Host ms a recorded window: the window spans and the slides
        # (their reads included) over the windows the ring recorded.
        win_ms = sum(
            rep["spans"][PHASE_NAMES[p]]["total_ms"]
            for p in (PH_WINDOW_CHUNK, PH_SLIDE)
            if PHASE_NAMES[p] in rep["spans"]
        )
        if self.state.telemetry is not None:
            from kubernetriks_tpu_torch.telemetry import ring as dring

            wins, data = self.telemetry_window_series()
            rep["ring"] = {
                "columns": list(dring.RING_COLUMNS),
                "windows_recorded": self._ring_windows_recorded,
                "windows_kept": int(len(wins)),
                "series_dropped_windows": self._ring_series_dropped,
                # Sums for the per-window deltas; high-water marks for the
                # point-in-time readings.
                "totals": {
                    name: int(data[:, :, col].sum()) if len(wins) else 0
                    for col, name in enumerate(dring.RING_COLUMNS)
                    if col > 0 and name not in dring.GAUGE_COLUMNS
                },
                "high_water": {
                    name: int(data[:, :, col].max()) if len(wins) else 0
                    for col, name in enumerate(dring.RING_COLUMNS)
                    if name in dring.GAUGE_COLUMNS
                },
            }
        if self.observatory is not None:
            self.observatory.update_memory(self._sample_resources())
            rep["resources"] = self.observatory.report()
            windows = int(self._ring_windows_recorded)
            if windows > 0:
                rep["per_window"] = {
                    "windows": windows,
                    "window_program_ms_total": win_ms,
                    "ms_per_window": win_ms / windows,
                }
        return rep

    def write_chrome_trace(self, path: str) -> str:
        """Write the Chrome trace-event JSON (Perfetto loads it): the host
        spans and the ring's series as sim-time counter tracks. Needs
        telemetry on."""
        if not self._telemetry:
            raise ValueError("telemetry is off — build with telemetry=True or KTPU_TRACE=1")
        from kubernetriks_tpu_torch.telemetry import ring as dring

        wins, data = self.telemetry_window_series()
        extra = dring.counter_events(wins, data, self.config.scheduling_cycle_interval)
        return self.tracer.write_chrome_trace(path, extra)

    def gauge_series(self):
        """(times (W,), samples (W, C, 7)): the gauge samples collected so
        far (columns telemetry.gauges.GAUGE_CSV_COLUMNS after the
        timestamp)."""
        return self._gauges.series(self.n_clusters, self.config.scheduling_cycle_interval)

    def write_gauge_csv(self, path: str, cluster: int = 0) -> None:
        """One cluster's gauge series in the scalar collector's 8-column
        CSV schema (reference src/metrics/collector.rs:216-228)."""
        self._gauges.write_csv(path, cluster, self.n_clusters, self.config.scheduling_cycle_interval)


def build_batched_from_traces(
    config,
    cluster_events,
    workload_events,
    n_clusters: int = 1,
    device=None,
    **kwargs,
) -> BatchedSimulation:
    """Replicate one (cluster trace, workload trace) pair across n_clusters
    — the homogeneous-batch benchmark shape. `device`: see resolve_device.

    With node faults configured, each cluster gets its own crash chains
    (chaos.inject_node_faults; reference engine.py:4581-4640), so the trace
    is compiled once per chain: keyed on the cluster index with the
    config's seed, or, under a scenario build (`scenario=`), on cluster 0
    with each lane's own fault_seed (the config's where the scenario gives
    none), so that a lane's crash schedule is a function of its seed alone
    (lanes of one seed share one compiled trace)."""
    device = resolve_device(device)
    ram_unit = kwargs.pop("ram_unit", DEFAULT_RAM_UNIT)
    fault_cfg = getattr(config, "fault_injection", None)
    if chaos.has_node_faults(fault_cfg):
        seed = fault_cfg.seed if fault_cfg.seed is not None else config.seed
        lane_seeds = None
        scenario = kwargs.get("scenario")
        if scenario is not None:
            seeds = scenario.get("fault_seed")
            lane_seeds = np.broadcast_to(np.asarray(seeds if seeds is not None else seed, np.int64), (n_clusters,))
        horizon = chaos.fault_horizon(fault_cfg, cluster_events, workload_events)
        chains: Dict[tuple, CompiledClusterTrace] = {}

        def compiled_for(c: int) -> CompiledClusterTrace:
            key = (seed, c) if lane_seeds is None else (int(lane_seeds[c]), 0)
            got = chains.get(key)
            if got is None:
                got = chains[key] = compile_cluster_trace(
                    chaos.inject_node_faults(
                        cluster_events, fault_cfg, key[0], key[1], horizon, config.scheduling_cycle_interval
                    ),
                    workload_events, config, ram_unit=ram_unit,
                )
            return got

        compiled_list = [compiled_for(c) for c in range(n_clusters)]
    else:
        compiled_list = [compile_cluster_trace(cluster_events, workload_events, config, ram_unit=ram_unit)] * n_clusters
    return BatchedSimulation(config, compiled_list, device=device, ram_unit=ram_unit, **kwargs)
