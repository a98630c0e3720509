"""Batched simulation engine: builds the device state from compiled traces
and steps it window by window.

Port of the JAX package's `batched/engine.py` for whole-resident traces
(`BatchedSimulation` slot sizing :686-1560, `step_until_time` :2504,
`metrics_summary` :3784, `build_batched_from_traces` :4564): no sliding pod
window, no mesh, no buffer donation, no superspan executor or streaming
feeder. The pod axis is 128-aligned as in the reference's default build,
so states compare leaf for leaf.

Entry points run on `torch.device("cuda")` unless the caller passes
`device="cpu"`; with no card and no explicit device they raise. On the
card the window step goes through the three CUDA kernels (ops/); on the
CPU through their plain PyTorch versions.

The window loop reads nothing back from the device: the engine keeps the
trace slab's window column on the host and mirrors the event cursor there,
which tells it, per window, how many event chunks to run and whether a
node removal is due (step.WindowPlan). The mirror is read from the device
once, when a state is installed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.pipeline import compile_profile
from kubernetriks_tpu_torch.batched.state import (
    DEFAULT_RAM_UNIT,
    EV_REMOVE_NODE,
    ClusterBatchState,
    TraceSlab,
    flatten,
    init_state,
    make_step_constants,
)
from kubernetriks_tpu_torch.batched.step import CUMSUM_MAX_K, DeviceConstants, WindowPlan, window_body
from kubernetriks_tpu_torch.batched.timerep import INF_WIN, from_f64_np
from kubernetriks_tpu_torch.batched.trace_compile import (
    CompiledClusterTrace,
    compile_cluster_trace,
    pad_and_batch,
)

POD_ALIGN = 128
BIG_RANK = 1 << 30


def resolve_device(device=None) -> torch.device:
    """`device` as given; None means the CUDA card, and raises without one
    (the port never carries on on the CPU unasked). A CUDA device comes
    back with its index, as tensors report theirs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: kubernetriks_tpu_torch runs on the card by "
                "default; pass device='cpu' to run the plain PyTorch path"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _name_ranks(names) -> np.ndarray:
    """Rank of each slot's name in the stable lexicographic sort of
    `names` (the scalar reference walks name-sorted snapshots)."""
    order = np.argsort(np.asarray(names, dtype=object), kind="stable")
    out = np.empty(len(names), np.int32)
    out[order] = np.arange(len(names), dtype=np.int32)
    return out


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
    ) -> None:
        self.device = resolve_device(device)
        self.config = config
        if scheduler_profile is None:
            scheduler_profile = config.scheduler_profile
        self.profile = compile_profile(scheduler_profile)
        self.conditional_move = bool(config.enable_unscheduled_pods_conditional_move)
        self.consts = make_step_constants(config)
        self.ram_unit = ram_unit
        interval = config.scheduling_cycle_interval
        compiled_traces = list(compiled_traces)
        C = len(compiled_traces)

        p_max = max((c.n_pods for c in compiled_traces), default=0)
        n_pods_aligned = -(-max(p_max, 1) // POD_ALIGN) * POD_ALIGN
        (
            ev_time,
            ev_kind,
            ev_slot,
            node_cap_cpu,
            node_cap_ram,
            pod_req_cpu,
            pod_req_ram,
            pod_duration,
            _,
        ) = pad_and_batch(compiled_traces, n_pods=n_pods_aligned)

        self.n_clusters = C
        self.n_nodes = node_cap_cpu.shape[1]
        self.n_pods = pod_req_cpu.shape[1]
        self.n_real_pods = p_max
        self.n_events = ev_time.shape[1]
        if max_events_per_window is None:
            max_events_per_window = min(self._max_events_in_any_window(ev_time), 32)
        self.max_events_per_window = max(1, max_events_per_window)
        self.max_pods_per_cycle = max(1, max_pods_per_cycle or self.n_pods)
        if self.max_pods_per_cycle > CUMSUM_MAX_K:
            raise ValueError(
                f"max_pods_per_cycle={self.max_pods_per_cycle} (the pod slot count "
                f"when not given) is above {CUMSUM_MAX_K}, the largest cycle "
                f"step.xla_cumsum16 is pinned for; pass max_pods_per_cycle <= "
                f"{CUMSUM_MAX_K} (ROADMAP Queue 3, the cumsum trap, lifts this)"
            )

        self.state = init_state(
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
        )
        ev_win, ev_off = from_f64_np(ev_time, interval)
        self.slab = TraceSlab.build(ev_win, ev_off, ev_kind, ev_slot, self.device)
        self._k = DeviceConstants.build(self.consts, self.device)

        # Host copy of the slab's window column, as two lookup tables:
        # _due_upto[c, w] = events of cluster c with window < w (clamped at
        # the last finite window), _rm_prefix[c, i] = node removals among
        # the first i slab events.
        finite = ev_win < INF_WIN
        self._wmax = int(ev_win[finite].max()) + 1 if finite.any() else 0
        bucket = np.clip(ev_win, -1, self._wmax - 1) + 1
        flat = (np.arange(C)[:, None] * (self._wmax + 1) + bucket)[finite]
        hist = np.bincount(flat, minlength=C * (self._wmax + 1)).reshape(C, self._wmax + 1)
        self._due_upto = np.cumsum(hist, axis=1)
        self._rm_prefix = np.concatenate(
            [np.zeros((C, 1), np.int64), np.cumsum(ev_kind == EV_REMOVE_NODE, axis=1)], axis=1
        )
        self._cursor = np.zeros(C, np.int64)

        # Name-rank tables: same-window reschedules queue in (removal time,
        # node name, pod name) order, like the reference's name-sorted walks.
        self.node_names = [c.node_names for c in compiled_traces]
        self.pod_names = [c.pod_names for c in compiled_traces]
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
        self.name_ranks = (
            torch.from_numpy(nnr).to(self.device),
            torch.from_numpy(pnr).to(self.device),
        )

        self.next_window_idx = 0
        self.windows_run = 0
        self.host_syncs = 0

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

    # --- state ------------------------------------------------------------

    def install_state(self, state: ClusterBatchState, next_window_idx: int) -> None:
        """Continue from `state` (e.g. one carried over from the JAX engine
        by convert.state_from_numpy) at window `next_window_idx`. Reads the
        event cursor back once to seed the host mirror. Pending autoscaler
        effects (finite node create/remove or pod removal times) need the
        autoscaler port and raise, as does a leaf that is not on this
        engine's device."""
        for path, leaf in flatten(state).items():
            if leaf.device != self.device:
                raise ValueError(
                    f"install_state: leaf {path} is on {leaf.device}, the engine "
                    f"runs on {self.device}"
                )
        pending = (
            (state.nodes.create_time.win < INF_WIN).any()
            | (state.nodes.remove_time.win < INF_WIN).any()
            | (state.pods.removal_time.win < INF_WIN).any()
        )
        self.host_syncs += 1
        if bool(pending):
            raise NotImplementedError(
                "state carries pending autoscaler effects; they need the "
                "autoscaler port (ROADMAP Queue 1 item 7)"
            )
        self.state = state
        self._cursor = state.event_cursor.cpu().numpy().astype(np.int64)
        self.next_window_idx = int(next_window_idx)

    def _count_sync(self) -> None:
        self.host_syncs += 1

    # --- stepping -----------------------------------------------------------

    @property
    def next_window(self) -> float:
        return self.next_window_idx * self.config.scheduling_cycle_interval

    def window_idxs(self, until_time: float) -> np.ndarray:
        interval = self.config.scheduling_cycle_interval
        first = self.next_window_idx
        count = int(math.floor(until_time / interval)) - first + 1
        return first + np.arange(max(count, 0), dtype=np.int32)

    def _plan(self, w: int) -> WindowPlan:
        """Host facts of window w from the slab tables and the cursor
        mirror; advances the mirror to where the window leaves it."""
        due = self._due_upto[:, min(max(w, 0), self._wmax)]
        target = np.maximum(self._cursor, due)
        E = self.max_events_per_window
        span = target - self._cursor
        n_chunks = int(((span + E - 1) // E).max()) if span.size else 0
        rows = np.arange(self.n_clusters)
        removal_due = bool(
            (self._rm_prefix[rows, target] > self._rm_prefix[rows, self._cursor]).any()
        )
        self._cursor = target
        return WindowPlan(n_chunks=n_chunks, removal_due=removal_due)

    def step_window(self) -> None:
        """Advance one scheduling window."""
        w = self.next_window_idx
        self.state = window_body(
            self.state,
            self.slab,
            w,
            self.consts,
            self._k,
            self.max_events_per_window,
            self.max_pods_per_cycle,
            self._plan(w),
            conditional_move=self.conditional_move,
            name_ranks=self.name_ranks,
            sync=self._count_sync,
        )
        self.next_window_idx = w + 1
        self.windows_run += 1

    def step_until_time(self, until_time: float) -> None:
        """Advance through every window whose cycle time is <= until_time."""
        for _ in self.window_idxs(until_time):
            self.step_window()

    # --- readout ------------------------------------------------------------

    def decisions_total(self) -> int:
        self.host_syncs += 1
        return int(self.state.metrics.scheduling_decisions.sum())

    def metrics_summary(self) -> Dict:
        """Cross-cluster reduction into the reference's printer shape."""
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
            },
            "timings": {
                "pod_duration": est(m.pod_duration),
                "pod_schedule_time": est(m.algo_latency),
                "pod_queue_time": est(m.queue_time),
            },
        }


def build_batched_from_traces(
    config,
    cluster_events,
    workload_events,
    n_clusters: int = 1,
    device=None,
    **kwargs,
) -> BatchedSimulation:
    """Replicate one (cluster trace, workload trace) pair across n_clusters
    — the homogeneous-batch benchmark shape. `device`: see resolve_device."""
    device = resolve_device(device)
    ram_unit = kwargs.pop("ram_unit", DEFAULT_RAM_UNIT)
    compiled = compile_cluster_trace(cluster_events, workload_events, config, ram_unit=ram_unit)
    return BatchedSimulation(
        config, [compiled] * n_clusters, device=device, ram_unit=ram_unit, **kwargs
    )
