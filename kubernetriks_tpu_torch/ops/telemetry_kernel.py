"""The flight recorder's per-window record: wrapper, launch count
(`LAUNCHES["telemetry_record"]`), and the plain PyTorch version it runs
for CPU tensors (batched/step.py `telemetry_record_plain`, op for op with
the reference).

| wrapper          | CUDA source (ops/csrc/) | replaces (no TPU kernel: XLA glue in the reference) |
| telemetry_record | telemetry_record.cu     | kubernetriks_tpu/batched/step.py:1784 `_telemetry_record` |

Not a TPU kernel of the reference's: XLA fuses the record there. In eager
PyTorch it is ~30 small launches a window (two phase counts over the pods,
the alive count, the reserve sums, ten counter deltas, the stack and the
scatter); the kernel is one. Integer only, so bit for bit with the plain
version. It writes the ring row, the cursor and the counter snapshot m0
in place: the ring is a fixed buffer of the window executor, which a
captured graph updates where it lies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kubernetriks_tpu_torch.ops._launch import check as _check, launch as _launch, on_cuda as _on_cuda


def telemetry_record(
    phase: torch.Tensor,  # (C, P) int32
    alive: torch.Tensor,  # (C, N) bool
    hpa_head: Optional[torch.Tensor],  # (C, Gp) int32, None without the autoscalers
    hpa_tail: Optional[torch.Tensor],  # (C, Gp) int32
    ca_cursor: Optional[torch.Tensor],  # (C, Gn) int32
    pod_base: torch.Tensor,  # (C,) int32
    W: torch.Tensor,  # (C,) int32
    counters: Sequence[torch.Tensor],  # the (C,) int32 counters of state.TELEM_COUNTERS
    m0: torch.Tensor,  # (len(TELEM_COUNTERS), C) int32, updated in place
    buf: torch.Tensor,  # (C, R, TELEMETRY_COLS) int32, updated in place
    cursor: torch.Tensor,  # (C,) int32, updated in place
    *,
    head_bound: int,
    window: Optional[torch.Tensor] = None,  # (C,) int32 the window column, None: W
    active: Optional[torch.Tensor] = None,  # (C,) bool the lane column, None: 1
) -> None:
    """Write the window's row into `buf` at cursor % R, bump `cursor` and
    set `m0` to `counters` (step.telemetry_record_plain), in place.
    `head_bound`: trace_pod_bound less the plain window width; `window`
    and `active`: a lane-asynchronous engine's global window and active
    lanes, which its record writes in columns 0 and 11."""
    if not _on_cuda(phase):
        from kubernetriks_tpu_torch.batched.step import telemetry_record_plain

        telemetry_record_plain(
            phase, alive, hpa_head, hpa_tail, ca_cursor, pod_base, W, counters, m0, buf, cursor,
            head_bound=head_bound, window=window, active=active,
        )
        return
    if len(counters) != 10:
        raise ValueError(f"telemetry_record: {len(counters)} counters, expected 10")
    C, P = phase.shape
    N = alive.shape[1]
    R = buf.shape[1]
    i32 = torch.int32
    ops = {
        "phase": (phase, i32, (C, P)), "alive": (alive, torch.bool, (C, N)), "pod_base": (pod_base, i32, (C,)),
        "W": (W, i32, (C,)), "m0": (m0, i32, (len(counters), C)), "buf": (buf, i32, (C, R, 12)),
        "cursor": (cursor, i32, (C,)),
    }
    ops.update({f"counters[{k}]": (t, i32, (C,)) for k, t in enumerate(counters)})
    if window is not None:
        ops["window"] = (window, i32, (C,))
    if active is not None:
        ops["active"] = (active, torch.bool, (C,))
    Gp = Gn = 0
    if hpa_head is not None:
        Gp, Gn = hpa_head.shape[1], ca_cursor.shape[1]
        ops.update({
            "hpa_head": (hpa_head, i32, (C, Gp)), "hpa_tail": (hpa_tail, i32, (C, Gp)),
            "ca_cursor": (ca_cursor, i32, (C, Gn)),
        })
    _check("telemetry_record", ops, phase.device)
    _launch("telemetry_record", "telemetry_record", [
        phase, alive, hpa_head, hpa_tail, ca_cursor, pod_base, W, window, active, *counters, m0, buf, cursor,
        C, P, N, Gp, Gn, R, int(head_bound),
    ])
