"""Runtime sanitizer (`KTPU_SANITIZE=1`): the dynamic half of ktpu-lint.

Port of the JAX package's `sanitize.py`. The static passes
(kubernetriks_tpu_torch/lint/) prove the source obeys the framework's
invariants; the sanitizer enforces them on a live run:

- **Sync guard**: the engine's stepping loop (`step_until_time`,
  `step_windows`, `run_to_completion`) runs inside `guard(active,
  device)`. On the card the region runs under
  `torch.cuda.set_sync_debug_mode("error")`, so any operation that blocks
  the host on the device (`.item()`, `.cpu()`, `int(t)`, a blocking copy
  either way, `nonzero`, boolean-mask indexing, `unique`) raises unless
  it sits inside an `allow_transfer(active, reason)` scope. The allow
  scopes pair 1:1 with the lint pass's sync-ok waivers: the static
  budget and the runtime budget are one list. On both devices the
  sanitizer also keeps the reference's thread-local guard depth, and
  `to_host`, the port's one device-to-host path, asserts through
  `assert_sync_allowed` that it runs inside an allow scope whenever the
  guard is active: the CPU's net, where the debug mode has nothing to see.
- The mode is process-wide, and only the thread that entered the guard
  sets it (on entry to the outermost guard, off again on exit, and off
  inside an allow scope). Waiting on a CUDA event, as the stream feeder's
  thread does, is not a synchronizing operation to the mode; a
  non-blocking copy into pinned memory is not either, which is why
  `to_host(host, ready=event)` counts such a read where its value is
  first used.
- **Captured addresses** (the counterpart of the reference's
  `consume_donated`: the card has no donation, but a captured CUDA graph
  reads fixed addresses): `check_addresses(state, addresses)` raises,
  naming the leaf, where a state leaf's storage is no longer the storage
  the window executor captured (its `addresses` record, taken anew at
  every rebuild of its buffers).
- The `KTPU_DEBUG_FINITE` NaN/inf sweep folds in at every dispatch
  boundary (the engine's `_check_finite` runs under the sanitizer too).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch

from kubernetriks_tpu_torch.flags import flag_bool

_state = threading.local()


def _depths():
    if not hasattr(_state, "guard"):
        _state.guard = 0
        _state.allow = 0
        _state.cuda = 0  # guards entered on the card (the debug mode is set)
        _state.prev = 0  # the debug mode the outermost card guard found
    return _state


def sanitize_default() -> bool:
    """The build-time default for BatchedSimulation(sanitize_mode=None)."""
    return flag_bool("KTPU_SANITIZE")


def _on_card(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def _set_mode(mode) -> None:
    torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def _guard_cm(cuda: bool):
    st = _depths()
    st.guard += 1
    arm = cuda and st.cuda == 0 and st.allow == 0
    st.cuda += int(cuda)
    if arm:
        st.prev = torch.cuda.get_sync_debug_mode()
        _set_mode("error")
    try:
        yield
    finally:
        st.cuda -= int(cuda)
        st.guard -= 1
        if arm:
            _set_mode(st.prev)


@contextlib.contextmanager
def _allow_cm():
    st = _depths()
    st.allow += 1
    lift = st.allow == 1 and st.cuda > 0
    if lift:
        _set_mode(st.prev)
    try:
        yield
    finally:
        st.allow -= 1
        if lift:
            _set_mode("error")


def guard(active: bool, device=None):
    """Context manager for the stepping loop: no device-to-host read while
    active, but inside allow_transfer scopes. On the card (`device` CUDA,
    or None with a card present) the region runs under
    torch.cuda.set_sync_debug_mode("error"); on both devices to_host
    checks the thread-local depth (assert_sync_allowed)."""
    if not active:
        return contextlib.nullcontext()
    return _guard_cm(_on_card(device))


def allow_transfer(active: bool, reason: str):
    """A waived read's scope; `reason` mirrors the lint waiver's reason and
    is a required argument so the runtime budget stays greppable."""
    if not reason:
        raise ValueError("allow_transfer requires a reason")
    if not active:
        return contextlib.nullcontext()
    return _allow_cm()


def assert_sync_allowed(what: str) -> None:
    """Raise when a device-to-host read happens inside a sanitized region
    outside every allow_transfer scope. Called by to_host; two integer
    compares when no guard is active."""
    st = _depths()
    if st.guard > 0 and st.allow == 0:
        raise RuntimeError(
            f"KTPU_SANITIZE: unwaived device-to-host sync ({what}) inside the sanitized stepping loop; wrap a "
            "legitimate read in sanitize.allow_transfer(reason) and give its line a sync-ok lint waiver"
        )


def to_host(x: torch.Tensor, ready=None) -> np.ndarray:
    """The port's one device-to-host read (reference
    parallel/multihost.py:125, the read alone): a numpy copy of `x`. With
    `ready` (a CUDA event recorded after a non-blocking copy into the host
    tensor `x`) the read is the wait on it, where the value is first used.
    The copy never aliases `x`, on either device. Under KTPU_SANITIZE an
    unwaived call inside the guard raises."""
    assert_sync_allowed("to_host")
    if ready is not None:
        ready.synchronize()
    return x.detach().to("cpu", copy=True).numpy()


def state_addresses(state) -> Dict[str, int]:
    """Leaf path -> storage address of every non-empty leaf of a state
    tree: the record a capture reads from (WindowExecutor.addresses)."""
    from kubernetriks_tpu_torch.batched.state import flatten

    return {path: t.untyped_storage().data_ptr() for path, t in flatten(state).items() if t.numel()}


def check_addresses(state, addresses: Optional[Dict[str, int]]) -> int:
    """Raise, naming the leaf, where a leaf of `state` no longer lies in
    the storage the window executor captured (`addresses`, its record
    since its last rebuild), or the leaf set changed: a captured graph
    would go on reading and writing the old buffers. Returns the number
    of leaves checked (0: no record)."""
    if addresses is None:
        return 0
    now = state_addresses(state)
    for path in sorted(set(now) | set(addresses)):
        if now.get(path) != addresses.get(path):
            raise RuntimeError(
                f"KTPU_SANITIZE: state leaf {path} is not the buffer the window executor captured "
                f"({addresses.get(path)} -> {now.get(path)}); the state was rebound without rebuilding the "
                "executor (write into the leaves in place, or rebind and rebuild)"
            )
    return len(now)
