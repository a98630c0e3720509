"""Launch plumbing shared by the port's kernel wrappers: the launch
counters, the operand checks, and the ctypes launch that raises on a
failed launch. A wrapper runs its plain PyTorch version for CPU tensors
only; a CUDA tensor goes to the kernel or raises, and any other device
raises."""

from __future__ import annotations

import weakref
from typing import Dict

import torch

# One count per kernel wrapper, bumped only where its kernel launches.
LAUNCHES: Dict[str, int] = {
    "fused_event_scatter": 0,
    "fused_free_resources": 0,
    "fused_select_cycle_commit": 0,
    "fused_ca_scale_down": 0,
    "fused_ca_scale_up": 0,
    "fused_schedule_cycle": 0,
    "fused_select_schedule_cycle": 0,
    "fused_commit_scatter": 0,
    "pod_attempt_draw": 0,
    "window_work_due": 0,
    "next_window_span": 0,
    "catch_up": 0,
    "conditional_wake_scan": 0,
    "telemetry_record": 0,
}

# Dynamic shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232448


# Capture backends whose CUDA graphs hold conditional bodies that launch
# counted kernels (graphs.CudaGraphs.when): such a body counts its runs on
# the card, and settle_launches() folds them into LAUNCHES.
_DEFERRED = weakref.WeakSet()


def register_deferred(backend) -> None:
    _DEFERRED.add(backend)


def launch_counts() -> Dict[str, int]:
    """LAUNCHES, with the launches of conditional graph bodies that ran on
    the card folded in first (one host read a backend holding such a
    body)."""
    for backend in list(_DEFERRED):
        backend.settle_launches()
    return dict(LAUNCHES)


def reset_launches() -> None:
    for backend in list(_DEFERRED):
        backend.settle_launches()
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(name: str, tensors, device) -> None:
    """Raise unless every (tensor, dtype, shape) operand lies on `device`
    with that dtype and shape and is contiguous."""
    for arg, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def launch(name: str, kernel: str, args) -> None:
    """Launch C entry point `kernel` (ops/_build.py) on the current stream
    with tensors passed as device pointers; raise if the launch failed,
    else count it under `name`."""
    from kubernetriks_tpu_torch.ops import _build

    fn = _build.kernel(kernel)
    stream = torch.cuda.current_stream().cuda_stream
    # None stands for a null pointer (an optional operand left out).
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    LAUNCHES[name] += 1


def on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA, else raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True
