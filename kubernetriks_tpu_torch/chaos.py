"""Chaos engine: counter-based fault draws and the host-side node crash chains.

Own copy of the JAX package's `chaos.py`: `FaultParams`, `has_node_faults`,
`make_fault_params`, the threefry2x32 counter PRNG with `object_uniforms` /
`pod_attempt_uniforms`, the crash chain compiler (`inject_node_faults`,
failure groups included), and the scalar oracle's `PodFaultOracle`, which
draws the same bits at each attempt's commit as the card's draw kernel.

Every draw is a pure function of (seed, stream, cluster, object, counter),
so the host (numpy) and the device (torch) compute the same bits. The
torch form computes in int64 masked to 32 bits: torch has no full uint32
arithmetic on CUDA, so every add is taken mod 2^32 and every shift and
rotation is taken on the masked value. `_to_unit` is `(bits >> 8) * 2^-24`
in float32, exact on every backend.

Node crashes are sampled on the host into concrete events before the run:
a crash is a RemoveNodeRequest(crashed=True, downtime_s=TTR), a recovery a
CreateNodeRequest(recovered=True) of the node's capacity on a fresh slot.
Pod failures (CrashLoopBackOff) are drawn on the device at each attempt's
commit (batched/step.py `commit_scattered_tail`, ops/chaos_kernel.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# Stream ids separating the fault channels in the counter space.
STREAM_NODE = 1
STREAM_GROUP = 2
STREAM_POD = 3


class FaultParams(NamedTuple):
    """The fault constants of a run; None in its place = fault injection
    off, and the step is then the one without faults."""

    seed: int
    fail_prob: float
    backoff_base: float
    backoff_cap: float
    restart_limit: int
    node_faults: bool  # the slab may carry EV_NODE_CRASH / EV_NODE_RECOVER

    @property
    def pod_faults(self) -> bool:
        return self.fail_prob > 0.0


def has_node_faults(cfg) -> bool:
    """Whether a FaultInjectionConfig configures any node-level fault
    channel."""
    return (
        cfg is not None
        and cfg.enabled
        and (
            (cfg.node is not None and cfg.node.mttf > 0)
            or any(g.mttf > 0 for g in (cfg.failure_groups or []))
        )
    )


def make_fault_params(config) -> Optional[FaultParams]:
    """FaultParams from a SimulationConfig; None when fault injection is
    disabled or configured to do nothing."""
    cfg = getattr(config, "fault_injection", None)
    if cfg is None or not cfg.enabled:
        return None
    node_faults = has_node_faults(cfg)
    pod = cfg.pod
    fail_prob = float(pod.fail_prob) if pod else 0.0
    if not node_faults and fail_prob <= 0:
        return None
    return FaultParams(
        seed=int(cfg.seed if cfg.seed is not None else config.seed),
        fail_prob=fail_prob,
        backoff_base=float(pod.backoff_base) if pod else 10.0,
        backoff_cap=float(pod.backoff_cap) if pod else 300.0,
        restart_limit=int(pod.restart_limit) if pod else 5,
        node_faults=node_faults,
    )


_KS_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_MASK32 = 0xFFFFFFFF


class _NumpyU32:
    """uint32 arithmetic on numpy arrays (wrapping natively)."""

    @staticmethod
    def u(x):
        return np.asarray(x).astype(np.uint32)

    def add(self, a, b):
        return self.u(self.u(a) + self.u(b))

    def rotl(self, x, r):
        return self.u((x << np.uint32(r)) | (x >> np.uint32(32 - r)))

    def xor(self, a, b):
        return self.u(self.u(a) ^ self.u(b))

    def to_unit(self, bits):
        return (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)


class _TorchU32:
    """uint32 arithmetic on torch int64 tensors holding values in
    [0, 2^32), every result masked back into that range; Python ints stay
    Python ints (no host-to-device copy)."""

    def __init__(self):
        import torch

        self.torch = torch

    def u(self, x):
        if isinstance(x, self.torch.Tensor):
            return x.to(self.torch.int64) & _MASK32
        return int(x) & _MASK32

    def add(self, a, b):
        return (self.u(a) + self.u(b)) & _MASK32

    def rotl(self, x, r):
        return ((x << r) & _MASK32) | (x >> (32 - r))

    def xor(self, a, b):
        return self.u(a) ^ self.u(b)

    def to_unit(self, bits):
        # A power-of-two scale: exact whatever way the device multiplies.
        return (bits >> 8).to(self.torch.float32) * (2.0**-24)


def _ops(xp):
    return _NumpyU32() if xp is np else _TorchU32()


def _threefry2x32(k0, k1, c0, c1, ops):
    """Threefry-2x32 (20 rounds) of the counter (c0, c1) under key
    (k0, k1); every add wraps mod 2^32. Returns the two 32-bit blocks."""
    ks0, ks1 = ops.u(k0), ops.u(k1)
    ks2 = ops.xor(ops.xor(ks0, ks1), _KS_PARITY)
    ks = (ks0, ks1, ks2)
    x0 = ops.add(c0, ks0)
    x1 = ops.add(c1, ks1)
    for chunk in range(5):
        rots = _ROT_A if chunk % 2 == 0 else _ROT_B
        for r in rots:
            x0 = ops.add(x0, x1)
            x1 = ops.rotl(x1, r)
            x1 = ops.xor(x1, x0)
        d = chunk + 1
        x0 = ops.add(x0, ks[d % 3])
        x1 = ops.add(ops.add(x1, ks[(d + 1) % 3]), d)
    return x0, x1


def object_uniforms(seed, stream, cluster, obj, counter, xp=np):
    """Two float32 uniforms in [0, 1) for (seed, stream, cluster, obj,
    counter): key = H(seed, stream | cluster, obj), then block (counter, 0).
    cluster/obj/counter broadcast. `xp` is numpy, or torch (tensors of any
    integer dtype holding values in [0, 2^32), or Python ints)."""
    ops = _ops(xp)
    h0, h1 = _threefry2x32(seed, stream, cluster, obj, ops)
    b0, b1 = _threefry2x32(h0, h1, counter, 0, ops)
    return ops.to_unit(b0), ops.to_unit(b1)


def pod_attempt_uniforms(seed, cluster, slot, attempt, xp=np):
    """(u_fail, u_frac) for one pod scheduling attempt; attempt = the pod's
    restart count when the attempt commits."""
    return object_uniforms(seed, STREAM_POD, cluster, slot, attempt, xp)


# --- node-fault compilation (host side) ----------------------------------------


def _sample_span(u: float, mean: float, distribution: str) -> float:
    if distribution == "fixed":
        return float(mean)
    if distribution != "exponential":
        raise ValueError(
            f"unknown fault distribution {distribution!r} (expected 'exponential' or 'fixed')"
        )
    # Exponential inverse CDF; u in [0, 1) so log(1-u) is finite.
    return float(-mean * np.log1p(-np.float64(u)))


def _sample_span_vec(u: np.ndarray, mean: float, distribution: str) -> np.ndarray:
    """_sample_span over a float32 uniform array, with the same float64
    arithmetic element by element."""
    if distribution == "fixed":
        return np.full(np.shape(u), float(mean), np.float64)
    if distribution != "exponential":
        raise ValueError(
            f"unknown fault distribution {distribution!r} (expected 'exponential' or 'fixed')"
        )
    return -float(mean) * np.log1p(-np.asarray(u, np.float64))


def fault_horizon(cfg, cluster_events, workload_events) -> float:
    """Sampling horizon: the config's value, else the latest finite trace
    timestamp."""
    if cfg.horizon is not None:
        return float(cfg.horizon)
    last = 0.0
    for events in (cluster_events, workload_events):
        for ts, _ in events:
            if np.isfinite(ts):
                last = max(last, float(ts))
    return last


@dataclass
class _NodeLifetime:
    uid: int  # appearance index among the trace's CreateNode events
    name: str
    node: object  # core.types.Node template (capacity source)
    create_ts: float
    remove_ts: float  # +inf when never removed by the trace


def _node_lifetimes(cluster_events) -> List[_NodeLifetime]:
    from kubernetriks_tpu_torch.core.events import CreateNodeRequest, RemoveNodeRequest

    lifetimes: List[_NodeLifetime] = []
    live: Dict[str, _NodeLifetime] = {}
    for ts, event in cluster_events:
        if isinstance(event, CreateNodeRequest):
            lt = _NodeLifetime(
                uid=len(lifetimes), name=event.node.metadata.name, node=event.node,
                create_ts=float(ts), remove_ts=np.inf,
            )
            lifetimes.append(lt)
            live[lt.name] = lt
        elif isinstance(event, RemoveNodeRequest):
            lt = live.pop(event.node_name, None)
            if lt is not None:
                lt.remove_ts = float(ts)
    return lifetimes


def _chain(seed, stream, cluster, uid, t0, end, horizon, mttf, mttr, distribution, interval):
    """Crash/recover pairs for one failure process alive on [t0, end):
    incarnation k draws (u_ttf, u_ttr); draws are clamped below at one
    scheduling interval; a pair is kept only when both times fall before
    the node's planned removal."""
    pairs: List[Tuple[float, float]] = []
    t = t0
    k = 0
    while True:
        u1, u2 = object_uniforms(seed, stream, np.uint32(cluster), np.uint32(uid), np.uint32(k))
        ttf = max(_sample_span(float(u1), mttf, distribution), interval)
        crash = t + ttf
        if crash >= min(horizon, end):
            break
        ttr = max(_sample_span(float(u2), mttr, distribution), interval)
        recover = crash + ttr
        if recover >= end:
            break
        pairs.append((crash, recover))
        t = recover
        k += 1
    return pairs


def _chains_batched(
    seed: int,
    stream: int,
    cluster: int,
    uids: Sequence[int],
    t0s: Sequence[float],
    ends: Sequence[float],
    horizon: float,
    mttf: float,
    mttr: float,
    distribution: str,
    interval: float,
) -> List[List[Tuple[float, float]]]:
    """_chain for many failure processes at once, bit for bit: one
    threefry call per incarnation index draws for every process, and each
    lane's float64 arithmetic is _chain's sequence."""
    U = len(uids)
    pairs: List[List[Tuple[float, float]]] = [[] for _ in range(U)]
    if U == 0:
        return pairs
    uid_arr = np.asarray(uids, np.uint32)
    t = np.asarray(t0s, np.float64).copy()
    end_arr = np.asarray(ends, np.float64)
    cutoff = np.minimum(np.float64(horizon), end_arr)
    active = np.ones(U, bool)
    k = 0
    while active.any():
        u1, u2 = object_uniforms(seed, stream, np.uint32(cluster), uid_arr, np.uint32(k))
        ttf = np.maximum(_sample_span_vec(u1, mttf, distribution), interval)
        crash = t + ttf
        active &= crash < cutoff
        ttr = np.maximum(_sample_span_vec(u2, mttr, distribution), interval)
        recover = crash + ttr
        active &= recover < end_arr
        for i in np.nonzero(active)[0]:
            pairs[i].append((float(crash[i]), float(recover[i])))
        t = np.where(active, recover, t)
        k += 1
    return pairs


def inject_node_faults(cluster_events, cfg, seed: int, cluster_idx: int, horizon: float, interval: float):
    """A new cluster-event list: the original events (order kept) plus the
    sampled crash/recover events appended in time order. Per-node chains
    first, then the failure groups in config order; a group pair is dropped
    for a member already down or within one interval of another of its
    transitions. Deterministic in (cfg, seed, cluster_idx, trace)."""
    from kubernetriks_tpu_torch.core.events import CreateNodeRequest, RemoveNodeRequest

    lifetimes = _node_lifetimes(cluster_events)
    by_name: Dict[str, List[_NodeLifetime]] = {}
    for lt in lifetimes:
        by_name.setdefault(lt.name, []).append(lt)

    fault_events: List[Tuple[float, object]] = []
    downtime: Dict[int, List[Tuple[float, float]]] = {}

    def clear_of_existing(lt: _NodeLifetime, crash: float, recover: float) -> bool:
        return all(
            recover + interval <= start or crash >= end + interval
            for start, end in downtime.get(lt.uid, [])
        )

    def emit_pair(lt: _NodeLifetime, crash: float, recover: float) -> None:
        downtime.setdefault(lt.uid, []).append((crash, recover))
        fault_events.append(
            (crash, RemoveNodeRequest(node_name=lt.name, crashed=True, downtime_s=float(recover - crash)))
        )
        fresh = lt.node.copy()
        fresh.status.allocatable = fresh.status.capacity.copy()
        fault_events.append((recover, CreateNodeRequest(node=fresh, recovered=True)))

    if cfg.node is not None and cfg.node.mttf > 0:
        chains = _chains_batched(
            seed, STREAM_NODE, cluster_idx,
            [lt.uid for lt in lifetimes], [lt.create_ts for lt in lifetimes],
            [lt.remove_ts for lt in lifetimes], horizon,
            cfg.node.mttf, cfg.node.mttr, cfg.node.distribution, interval,
        )
        for lt, chain in zip(lifetimes, chains):
            for crash, recover in chain:
                emit_pair(lt, crash, recover)

    for gi, group in enumerate(cfg.failure_groups or []):
        for crash, recover in _chains_batched(
            seed, STREAM_GROUP, cluster_idx, [gi], [0.0], [np.inf], horizon,
            group.mttf, group.mttr, group.distribution, interval,
        )[0]:
            for name in group.members:
                for lt in by_name.get(name, []):
                    if lt.create_ts <= crash and recover < lt.remove_ts and clear_of_existing(lt, crash, recover):
                        emit_pair(lt, crash, recover)

    fault_events.sort(key=lambda item: item[0])
    return list(cluster_events) + fault_events


# --- pod-fault oracle (scalar path) -----------------------------------------


def plain_pod_slot_map(workload_events) -> Dict[str, int]:
    """name -> global plain pod slot, replicating the batched trace
    compiler's numbering: CreatePodRequest events stably sorted by
    timestamp, ranked among plain pods (pod-group ring slots are renumbered
    past every plain pod by segment_pod_slots, so the plain rank IS the
    global slot in both the segmented and unsegmented layouts)."""
    from kubernetriks_tpu_torch.core.events import CreatePodRequest

    creates = [
        (float(ts), i, event.pod.metadata.name)
        for i, (ts, event) in enumerate(workload_events)
        if isinstance(event, CreatePodRequest)
    ]
    creates.sort(key=lambda item: (item[0], item[1]))
    return {name: slot for slot, (_, _, name) in enumerate(creates)}


class PodFaultOracle:
    """Scalar-path pod failure oracle: draws the SAME counter-PRNG values
    the batched commit draws on device, tracks per-pod restart counts, and
    answers the retry/perma/backoff questions the control-plane components
    ask. Pods without a plain trace slot (HPA ring replicas) and
    long-running services are exempt."""

    def __init__(self, cfg, seed: int, cluster_idx: int, workload_events) -> None:
        pod = cfg.pod
        self.fail_prob = np.float32(pod.fail_prob if pod else 0.0)
        self.backoff_base = float(pod.backoff_base) if pod else 10.0
        self.backoff_cap = float(pod.backoff_cap) if pod else 300.0
        self.restart_limit = int(pod.restart_limit) if pod else 5
        self.seed = int(seed)
        self.cluster_idx = int(cluster_idx)
        self.slot_map = plain_pod_slot_map(workload_events)
        self.restarts: Dict[str, int] = {}

    def attempt(
        self, pod_name: str, pod_duration: Optional[float]
    ) -> Optional[float]:
        """Draw for one scheduling attempt at commit: returns fail_after
        seconds (the attempt fails that long after its start) or None (the
        attempt runs to completion)."""
        if self.fail_prob <= 0 or pod_duration is None:
            return None
        slot = self.slot_map.get(pod_name)
        if slot is None:
            return None
        k = self.restarts.get(pod_name, 0)
        u_fail, u_frac = pod_attempt_uniforms(
            self.seed,
            np.uint32(self.cluster_idx),
            np.uint32(slot),
            np.uint32(k),
        )
        if not bool(np.float32(u_fail) < self.fail_prob):
            return None
        # f32 product mirrors the batched path's u_frac * duration_seconds.
        return float(np.float32(u_frac) * np.float32(pod_duration))

    def record_failure(self, pod_name: str) -> int:
        """Increment and return the pod's restart count (called once per
        failure, by the api server — the first component on the failure
        chain)."""
        k = self.restarts.get(pod_name, 0) + 1
        self.restarts[pod_name] = k
        return k

    def is_permanently_failed(self, pod_name: str) -> bool:
        return self.restarts.get(pod_name, 0) > self.restart_limit

    def backoff_after_failure(self, pod_name: str) -> float:
        """Backoff of the pod's LAST recorded failure: min(base * 2^k, cap)
        with k = the restart count before that failure (0-based). float32
        arithmetic so the value matches the batched path bit-for-bit."""
        k = max(self.restarts.get(pod_name, 1) - 1, 0)
        return float(
            np.minimum(
                np.float32(self.backoff_base) * np.exp2(np.float32(k)),
                np.float32(self.backoff_cap),
            )
        )
