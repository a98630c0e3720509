"""The window executor's glue kernels: wrappers, launch counts
(`LAUNCHES[name]`), and the plain PyTorch versions they run for CPU
tensors (in batched/step.py, op for op with the reference).

| wrapper               | CUDA source (ops/csrc/) | replaces (no TPU kernel: XLA glue in the reference) |
| window_work_due       | window_work_due.cu      | kubernetriks_tpu/batched/step.py:157 `_window_work_due` |
| next_window_span      | next_window.cu          | kubernetriks_tpu/batched/step.py:2239 `_next_interesting_window` |
| catch_up              | catch_up.cu             | kubernetriks_tpu/batched/step.py:2322 `_catch_up_bookkeeping` |
| conditional_wake_scan | conditional_wake.cu     | kubernetriks_tpu/batched/step.py:994 `_conditional_wake_exact` (the scans) |

None of them is a TPU kernel of the reference's: XLA fuses each there. In
eager PyTorch each would be a dozen to hundreds of small launches a window
(the razor's predicate ~12, the next window ~30, a 50-window catch-up ~500)
or, for the conditional move's scans, a host loop over the events and the
parked pods; each kernel is one launch (the reductions two: a pass per
cluster, then one block over the clusters; next_window_span's are the
wrappers next_window_rows and next_window_combine, each launch counted
under next_window_span). Integer and float32 work
only, with the reference's float32 operations unfused (--fmad=false).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetriks_tpu_torch.ops._launch import check as _check, launch as _launch, on_cuda as _on_cuda


def _f32_bits(x: float) -> int:
    return int(np.array(x, dtype=np.float32).view(np.int32))


def _step():
    from kubernetriks_tpu_torch.batched import step

    return step


def window_work_due(
    cursor: torch.Tensor,  # (C,) int32 event cursor
    packed: torch.Tensor,  # (C, E, 4) int32 trace slab
    node_create_win: torch.Tensor,  # (C, N) int32
    node_remove_win: torch.Tensor,  # (C, N) int32
    pod_removal_win: torch.Tensor,  # (C, P) int32
    phase: torch.Tensor,  # (C, P) int32
    finish_win: torch.Tensor,  # (C, P) int32
    finish_off: torch.Tensor,  # (C, P) float32
    W: torch.Tensor,  # (C,) int32
) -> torch.Tensor:
    """0-dim bool (step.window_work_due_plain)."""
    if not _on_cuda(cursor):
        return _step().window_work_due_plain(
            cursor, packed, node_create_win, node_remove_win, pod_removal_win, phase, finish_win, finish_off, W
        )
    C, E = packed.shape[:2]
    N = node_create_win.shape[1]
    P = phase.shape[1]
    i32 = torch.int32
    _check("window_work_due", {
        "cursor": (cursor, i32, (C,)), "packed": (packed, i32, (C, E, 4)),
        "node_create_win": (node_create_win, i32, (C, N)), "node_remove_win": (node_remove_win, i32, (C, N)),
        "pod_removal_win": (pod_removal_win, i32, (C, P)), "phase": (phase, i32, (C, P)),
        "finish_win": (finish_win, i32, (C, P)), "finish_off": (finish_off, torch.float32, (C, P)),
        "W": (W, i32, (C,)),
    }, cursor.device)
    out = torch.empty((), dtype=torch.bool, device=cursor.device)
    rows = torch.empty((C,), dtype=torch.uint8, device=cursor.device)
    _launch("window_work_due", "window_work_due", [
        cursor, packed, node_create_win, node_remove_win, pod_removal_win, phase, finish_win, finish_off, W,
        rows, out, C, N, P, E,
    ])
    return out


def next_window_span(
    cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win, queue_win,
    last_flush_win, W, limit, ca_next_win=None, ca_next_off=None, ca_snap_win=None, ca_snap_off=None,
    hpa_next_win=None, col_next_win=None, ca_count=None, *, flush_windows: int, interval: float,
) -> torch.Tensor:
    """(2,) int32 [W + 1, next] (step.next_window_span_plain): per-cluster
    (C, N) and (C, P) int32 rows, the (C,) cursor, last flush window and
    window, the (1,) limit; with the autoscalers the (C,) due-time pairs
    and snapshot delay, the collection latch (or None) and the (C, Gn) CA
    node counts. The kernel's two passes, next_window_rows then
    next_window_combine."""
    rows = next_window_rows(
        cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win, queue_win,
        last_flush_win, ca_next_win, ca_next_off, ca_snap_win, ca_snap_off, hpa_next_win, col_next_win, ca_count,
        interval=interval,
    )
    return next_window_combine(rows, W, limit, flush_windows=flush_windows, has_auto=ca_next_win is not None)


def next_window_rows(
    cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win, queue_win,
    last_flush_win, ca_next_win=None, ca_next_off=None, ca_snap_win=None, ca_snap_off=None, hpa_next_win=None,
    col_next_win=None, ca_count=None, *, interval: float,
) -> torch.Tensor:
    """next_window.cu's first pass (step.next_window_rows_plain): (C, 5)
    int32 words a cluster, next_window_span's operands but W and limit."""
    if not _on_cuda(cursor):
        return _step().next_window_rows_plain(
            cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win, queue_win,
            last_flush_win, ca_next_win, ca_next_off, ca_snap_win, ca_snap_off, hpa_next_win, col_next_win,
            ca_count, interval=interval,
        )
    C, E = packed.shape[:2]
    N = node_create_win.shape[1]
    P = phase.shape[1]
    i32, f32 = torch.int32, torch.float32
    ops = {
        "cursor": (cursor, i32, (C,)), "packed": (packed, i32, (C, E, 4)), "phase": (phase, i32, (C, P)),
        "finish_win": (finish_win, i32, (C, P)), "node_create_win": (node_create_win, i32, (C, N)),
        "node_remove_win": (node_remove_win, i32, (C, N)), "pod_removal_win": (pod_removal_win, i32, (C, P)),
        "queue_win": (queue_win, i32, (C, P)), "last_flush_win": (last_flush_win, i32, (C,)),
    }
    has_auto = ca_next_win is not None
    G = 0
    if has_auto:
        G = ca_count.shape[1]
        ops.update({
            "ca_next_win": (ca_next_win, i32, (C,)), "ca_next_off": (ca_next_off, f32, (C,)),
            "ca_snap_win": (ca_snap_win, i32, (C,)), "ca_snap_off": (ca_snap_off, f32, (C,)),
            "hpa_next_win": (hpa_next_win, i32, (C,)), "ca_count": (ca_count, i32, (C, G)),
        })
        if col_next_win is not None:
            ops["col_next_win"] = (col_next_win, i32, (C,))
    _check("next_window_span", ops, cursor.device)
    rows = torch.empty((C, 5), dtype=i32, device=cursor.device)
    _launch("next_window_span", "next_window", [
        cursor, packed, phase, finish_win, node_create_win, node_remove_win, pod_removal_win, queue_win,
        last_flush_win, None, None, ca_next_win, ca_next_off, ca_snap_win, ca_snap_off, hpa_next_win,
        col_next_win, ca_count, rows, None, C, N, P, E, G, 0, int(has_auto), _f32_bits(interval), 1,
    ])
    return rows


def next_window_combine(rows, W, limit, *, flush_windows: int, has_auto: bool) -> torch.Tensor:
    """next_window.cu's combine (step.next_window_combine_plain): (2,)
    int32 [W + 1, next] from the (C, 5) words of every cluster, the (C,)
    window and the (1,) limit. A mesh gathers every shard's words between
    the two passes (the executor's ("next",) piece)."""
    if not _on_cuda(rows):
        return _step().next_window_combine_plain(rows, W, limit, flush_windows=flush_windows, has_auto=has_auto)
    C = rows.shape[0]
    i32 = torch.int32
    _check("next_window_span", {
        "rows": (rows, i32, (C, 5)), "W": (W, i32, tuple(W.shape)), "limit": (limit, i32, (1,)),
    }, rows.device)
    span = torch.empty((2,), dtype=i32, device=rows.device)
    _launch("next_window_span", "next_window", [
        None, None, None, None, None, None, None, None, None, W, limit, None, None, None, None, None, None, None,
        rows, span, C, 0, 0, 0, 0, int(flush_windows), int(has_auto), 0, 2,
    ])
    return span


def catch_up(
    span, last_flush_win, time, hpa_next_win=None, hpa_next_off=None, ca_next_win=None, ca_next_off=None,
    hpa_int_win=None, hpa_int_off=None, ca_snap_win=None, ca_snap_off=None, ca_period_win=None,
    ca_period_off=None, *, interval: float, flush_interval: float,
):
    """The skipped windows' bookkeeping (step.catch_up_plain): the (2,)
    int32 span [from, to) on the device, the (C,) last flush window and
    time, and with the autoscalers the (C,) pairs of the HPA tick and CA
    cycle with their interval, snapshot delay and period. Returns
    (last_flush_win, time, hpa_next_win, hpa_next_off, ca_next_win,
    ca_next_off), new tensors, the last four None without the
    autoscalers. The kernel reads the span on the device: one thread a
    cluster loops over the skipped windows."""
    if not _on_cuda(span):
        return _step().catch_up_plain(
            span, last_flush_win, time, hpa_next_win, hpa_next_off, ca_next_win, ca_next_off, hpa_int_win,
            hpa_int_off, ca_snap_win, ca_snap_off, ca_period_win, ca_period_off,
            interval=interval, flush_interval=flush_interval,
        )
    C = last_flush_win.shape[0]
    i32, f32 = torch.int32, torch.float32
    has_auto = hpa_next_win is not None
    ops = {"span": (span, i32, (2,)), "last_flush_win": (last_flush_win, i32, (C,)), "time": (time, i32, (C,))}
    pairs = ("hpa_next", "ca_next", "hpa_int", "ca_snap", "ca_period")
    vals = (hpa_next_win, hpa_next_off, ca_next_win, ca_next_off, hpa_int_win, hpa_int_off, ca_snap_win,
            ca_snap_off, ca_period_win, ca_period_off)
    if has_auto:
        for i, name in enumerate(pairs):
            ops[f"{name}_win"] = (vals[2 * i], i32, (C,))
            ops[f"{name}_off"] = (vals[2 * i + 1], f32, (C,))
    _check("catch_up", ops, span.device)
    out_flush = torch.empty_like(last_flush_win)
    out_time = torch.empty_like(time)
    outs = [torch.empty_like(v) for v in vals[:4]] if has_auto else [None] * 4
    _launch("catch_up", "catch_up", [
        span, last_flush_win, time, *vals, out_flush, out_time, *outs, C, int(has_auto),
        _f32_bits(interval), _f32_bits(flush_interval),
    ])
    return (out_flush, out_time, *outs)


def conditional_wake_scan(o_valid, o_cpu, o_ram, s_valid, s_is_node, s_cpu, s_ram) -> torch.Tensor:
    """The conditional move's budget scans (step.wake_scan_plain): the
    parked pods in queue order, (C, P) bool / int32 / int32, and the wake
    events in effect-time order, (C, V) bool / bool / int32 / int32.
    Returns the (C, P) moves in parked order."""
    if not _on_cuda(o_valid):
        return _step().wake_scan_plain(o_valid, o_cpu, o_ram, s_valid, s_is_node, s_cpu, s_ram)
    C, P = o_valid.shape
    V = s_valid.shape[1]
    i32, b = torch.int32, torch.bool
    _check("conditional_wake_scan", {
        "o_valid": (o_valid, b, (C, P)), "o_cpu": (o_cpu, i32, (C, P)), "o_ram": (o_ram, i32, (C, P)),
        "s_valid": (s_valid, b, (C, V)), "s_is_node": (s_is_node, b, (C, V)),
        "s_cpu": (s_cpu, i32, (C, V)), "s_ram": (s_ram, i32, (C, V)),
    }, o_valid.device)
    moved = torch.empty((C, P), dtype=b, device=o_valid.device)
    if C * P:
        _launch("conditional_wake_scan", "conditional_wake", [
            o_valid, o_cpu, o_ram, s_valid, s_is_node, s_cpu, s_ram, moved, C, P, V,
        ])
    return moved
