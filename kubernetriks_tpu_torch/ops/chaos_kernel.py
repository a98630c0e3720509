"""The chaos engine's commit-time draw: wrapper, plain PyTorch version and
launch count (`LAUNCHES["pod_attempt_draw"]`).

| wrapper          | CUDA source (ops/csrc/) | replaces                                            |
| pod_attempt_draw | pod_attempt_draw.cu     | no TPU kernel: XLA glue, kubernetriks_tpu/batched/step.py:1311-1360 |

For every pod slot whose attempt starts in this cycle (start_tmp < +inf),
the CrashLoopBackOff draw `chaos.pod_attempt_uniforms(seed, cluster,
global plain slot, restarts)` decides whether the attempt fails and at what
fraction of its duration. The global slot is the device slot plus the
cluster's `pod_base` (the sliding pod window), so the draw stays keyed on
the trace slot as the window slides; only plain trace pods with a finite
duration draw. For CPU tensors the plain version runs; CUDA tensors go to
the kernel or raise.

The seed comes in one of two forms. A Python int: one seed for every
cluster, each cluster's draws keyed on its own index (a plain build). A
(C,) uint32 tensor on the state's device: a scenario fleet's per-lane
seeds (reference step.py:1328-1336), each lane's draws keyed on cluster 0,
so a lane's fault stream is a function of its seed alone; the kernel
reads the vector from device memory, so a captured graph replays the
seeds written there last, not those of its capture.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetriks_tpu_torch import chaos
from kubernetriks_tpu_torch.batched.timerep import fma_f32
from kubernetriks_tpu_torch.ops._launch import check as _check, launch as _launch, on_cuda as _on_cuda


def _i32(x: int) -> int:
    """A 32-bit pattern as the signed int ctypes passes."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _f32_bits(x: float) -> int:
    return int(np.array(x, dtype=np.float32).view(np.int32))


def pod_attempt_draw_plain(start_tmp, restarts, dur_win, dur_off, will_fail, pod_base,
                           seed, plain_width: int, fail_prob: float, interval: float, row0: int = 0):
    """(will_fail_out, fail_rel), each (C, P): will_fail_out = the draw's
    verdict where the attempt starts, else will_fail; fail_rel = start_tmp
    + u_frac * duration seconds (one fused multiply-add, as XLA:CPU
    contracts it) where it fails, else 0. `seed`: an int (cluster key c)
    or a (C,) uint32 tensor (cluster key 0; module note). `row0`: the
    global cluster index of row 0 (a shard of a batch sharded over a
    mesh keys its draws on the global index)."""
    C, P = start_tmp.shape
    dev = start_tmp.device
    idx = torch.arange(P, dtype=torch.int64, device=dev)[None, :].expand(C, P)
    started = start_tmp < float("inf")
    in_plain = idx < plain_width
    gslot = idx + pod_base.to(torch.int64)[:, None]
    if isinstance(seed, torch.Tensor):
        # The uint32 bits, widened through an int32 view (exact on every
        # device), one seed a row; every lane keys cluster 0.
        seed = (seed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)[:, None]
        cid = torch.zeros((C, P), dtype=torch.int64, device=dev)
    else:
        cid = (torch.arange(C, dtype=torch.int64, device=dev) + int(row0))[:, None].expand(C, P)
    u_fail, u_frac = chaos.pod_attempt_uniforms(seed, cid, gslot, restarts.to(torch.int64), xp=torch)
    prob = float(np.float32(fail_prob))
    wf = started & in_plain & (dur_win >= 0) & (u_fail < prob)
    dur_s = dur_win.to(torch.float32) * torch.tensor(interval, dtype=torch.float32, device=dev) + dur_off
    fail_rel = torch.where(wf, fma_f32(u_frac, dur_s, start_tmp), torch.zeros_like(start_tmp))
    return torch.where(started, wf, will_fail), fail_rel


def pod_attempt_draw(
    start_tmp: torch.Tensor,  # (C, P) float32, +inf where no attempt starts
    restarts: torch.Tensor,  # (C, P) int32
    dur_win: torch.Tensor,  # (C, P) int32 duration pair (win < 0: a service)
    dur_off: torch.Tensor,  # (C, P) float32
    will_fail: torch.Tensor,  # (C, P) bool
    pod_base: torch.Tensor,  # (C,) int32 global slot of device slot 0
    seed,  # int, or (C,) uint32 per-lane seeds (module note)
    plain_width: int,
    fail_prob: float,
    interval: float,  # the scheduling interval, seconds
    row0: int = 0,  # global cluster index of row 0 (a mesh shard's first row)
):
    """(will_fail_out (C, P) bool, fail_rel (C, P) float32)."""
    if not _on_cuda(start_tmp):
        return pod_attempt_draw_plain(
            start_tmp, restarts, dur_win, dur_off, will_fail, pod_base, seed, plain_width, fail_prob, interval,
            row0,
        )
    C, P = start_tmp.shape
    i32, f32, b = torch.int32, torch.float32, torch.bool
    operands = {
        "start_tmp": (start_tmp, f32, (C, P)), "restarts": (restarts, i32, (C, P)),
        "dur_win": (dur_win, i32, (C, P)), "dur_off": (dur_off, f32, (C, P)),
        "will_fail": (will_fail, b, (C, P)), "pod_base": (pod_base, i32, (C,)),
    }
    seeds = None
    if isinstance(seed, torch.Tensor):
        seeds, seed = seed, 0
        operands["seeds"] = (seeds, torch.uint32, (C,))
    _check("pod_attempt_draw", operands, start_tmp.device)
    will_fail_out = torch.empty_like(will_fail)
    fail_rel = torch.empty_like(start_tmp)
    if C * P:
        _launch("pod_attempt_draw", "pod_attempt_draw", [
            start_tmp, restarts, dur_win, dur_off, will_fail, pod_base, seeds, will_fail_out, fail_rel,
            C, P, _i32(seed), int(plain_width), _f32_bits(fail_prob), _f32_bits(interval), int(row0),
        ])
    return will_fail_out, fail_rel
