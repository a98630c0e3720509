"""The device telemetry ring, host side: build, drain, merge (reference
`kubernetriks_tpu/telemetry/ring.py:77-158`).

The ring (state.TelemetryRing) lives in the state and is written on the
card by the window's record (step.telemetry_record, one glue kernel): one
(C, TELEMETRY_COLS) int32 row per executed window at cursor % R. This
module owns the host side:

- `init_ring` builds the empty ring the engine attaches at build;
- `snapshot` drains the rows written since the last drain (the engine
  counts them on the host) to an owned host copy. The engine calls it
  only where the host already blocks (the exit of step_until_time, a slide's
  or an executed window's read, readout), never inside a span of graph
  replays, so telemetry adds no host read there;
- `merge_snapshot` / `series` fold drained copies into one (windows, (Wn,
  C, K)) view, deduplicated by window index (overlapping snapshots of a
  wrapping ring see the same rows);
- `counter_events` renders the series as Chrome trace counter tracks on
  a sim-time process.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.state import TELEMETRY_COLS, TelemetryRing

# Column names, indexed by the TELEM_* constants of batched/state.py.
RING_COLUMNS = (
    "window",
    "decisions",
    "queued",
    "unschedulable",
    "hpa_pod_actions",
    "ca_node_actions",
    "fault_events",
    "alive_nodes",
    "hpa_reserve_used",
    "ca_reserve_used",
    "pod_headroom",
    "lane_active",
)
assert len(RING_COLUMNS) == TELEMETRY_COLS

# Point-in-time readings: their high-water mark is reported, not a sum
# over windows (the action deltas sum).
GAUGE_COLUMNS = frozenset(
    {
        "queued",
        "unschedulable",
        "alive_nodes",
        "hpa_reserve_used",
        "ca_reserve_used",
        "pod_headroom",
        "lane_active",
    }
)


def init_ring(n_clusters: int, capacity: int, device) -> TelemetryRing:
    """The empty ring on `device`: window column -1 marks unwritten rows
    (the drain skips them), cursor 0."""
    return TelemetryRing(
        buf=torch.full((n_clusters, capacity, TELEMETRY_COLS), -1, dtype=torch.int32, device=device),
        cursor=torch.zeros((n_clusters,), dtype=torch.int32, device=device),
    )


def snapshot(telem: TelemetryRing, lo: int, hi: int) -> Tuple[np.ndarray, int]:
    """Drain the ring's rows of windows recorded lo..hi-1 (counted as the
    cursor counts: slots lo % R ..), at most the last R, and the windows
    recorded (the cursor). A blocking read: callers sit where the host
    already blocks. The reference drains the whole ring each time; the
    engine knows how far it drained before. The rows come back as an
    owned host copy, laid out window by window (one or two slices of the
    ring, transposed where they lie before the copy), seen as (C, n, K):
    a window's rows, and a column over the clusters, are then a short
    stride apart for the merge and the observatory."""
    R = telem.buf.shape[1]
    lo = max(lo, hi - R)
    n = max(hi - lo, 0)
    a = lo % R
    parts = [telem.buf[:, a:a + n]] if a + n <= R else [telem.buf[:, a:], telem.buf[:, : a + n - R]]
    rows = torch.cat([p.transpose(0, 1) for p in parts], dim=0).cpu()  # (n, C, K), a new tensor
    cursor = int(telem.cursor.max()) if telem.cursor.numel() else 0
    return rows.numpy().transpose(1, 0, 2), cursor


def merge_snapshot(seen: dict, buf: np.ndarray) -> None:
    """Fold one drained buffer ((C, n, K)) into the window -> (C, K) rows
    map. Overlapping snapshots see the same rows, so the last write is
    exact; the map holds each distinct window once, a row of the drain's
    window-major copy."""
    rows = np.ascontiguousarray(buf.transpose(1, 0, 2))  # (n, C, K); no copy for snapshot's own
    wins = rows[:, 0, 0]  # the window column, the same in every cluster
    for i in np.nonzero(wins >= 0)[0].tolist():
        seen[int(wins[i])] = rows[i]


def series(seen: dict, n_clusters: int) -> Tuple[np.ndarray, np.ndarray]:
    """The records as (windows (Wn,), data (Wn, C, K)), by window."""
    if not seen:
        return np.zeros((0,), np.int32), np.zeros((0, n_clusters, TELEMETRY_COLS), np.int32)
    order = sorted(seen)
    return np.asarray(order, np.int32), np.stack([seen[w] for w in order], axis=0)


def counter_events(wins: np.ndarray, data: np.ndarray, interval: float, pid: int = 1) -> list:
    """Chrome trace counter tracks of the series on a sim-time process (ts
    = window * interval in sim-microseconds): each column past the window
    index, summed over the clusters."""
    ev = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": "ktpu-device-ring (sim time)"},
        }
    ]
    if len(wins) == 0:
        return ev
    totals = data.sum(axis=1)  # (Wn, K)
    for i, w in enumerate(wins.tolist()):
        ts = w * interval * 1e6
        for col in range(1, TELEMETRY_COLS):
            ev.append(
                {
                    "ph": "C",
                    "name": RING_COLUMNS[col],
                    "pid": pid,
                    "ts": ts,
                    "args": {RING_COLUMNS[col]: int(totals[i, col])},
                }
            )
    return ev
