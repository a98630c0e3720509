"""Recompile sentinel: the runtime cross-check of the fleet's capture-once
guarantee (`KTPU_EXPLAIN_RECOMPILES`).

Port of the JAX package's `recompile.py`. There a recompile is an XLA
compilation, seen on jax's compile logger; here it is a CUDA graph
capture by the window executor (batched/graphs.py), which publishes each
one with its piece key, e.g. `("end", route, removal_due, hpa, ca)`, a
slide graph's `("slide", W, L, slot)`, or a conditional node's body,
`key + ("body",)`. The static half is the scenariotrace lint pass (a
scenario leaf never reaches a piece key or a capture argument); the
dynamic half is a count of `dispatch_stats["captures"]`. Both say THAT
something captured; the sentinel names WHICH piece did, so a plan that
reached an uncaptured piece, or a buffer rebuilt mid-run, is diagnosed
in one line.

Usage (the fleet wires this up):

    sent = RecompileSentinel().install()
    ...build (precompile_pieces)...
    sent.seal("build")                 # captures beyond here are events
    ...steady state...
    sent.check("query stream")         # raises/warns, naming piece keys
    sent.uninstall()

or windowed, immune to neighbouring engines capturing in between:

    with sent.expect_none("fleet wave 3"):
        ...one wave...

`KTPU_EXPLAIN_RECOMPILES` (tristate): unset -> armed only where code opts
in; 1 -> `ScenarioFleet` seals a raising sentinel right after its build
(which captures every piece) and guards every wave and pump round; 0 ->
forced off everywhere. Nesting is supported: every installed sentinel
sees every capture, and the hook costs one check of an empty list when
none is installed.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, Optional

from kubernetriks_tpu_torch.flags import flag_tristate


class RecompileError(RuntimeError):
    """A window piece was captured after the sentinel was sealed."""


class RecompileWarning(RuntimeWarning):
    pass


_LOCK = threading.Lock()
_SENTINELS: List["RecompileSentinel"] = []


def publish_capture(key) -> None:
    """The capture hook: the window executor calls it once a graph is
    captured (a piece, or a conditional node's body), with its key."""
    if not _SENTINELS:
        return
    with _LOCK:
        for sent in _SENTINELS:
            sent._events.append(tuple(key))


class RecompileSentinel:
    """Collects capture events and enforces a zero-capture contract past a
    seal point (or inside expect_none windows)."""

    def __init__(self, mode: str = "raise"):
        if mode not in ("raise", "warn"):
            raise ValueError(f"mode must be 'raise' or 'warn', got {mode!r}")
        self.mode = mode
        self._events: List[tuple] = []
        self._sealed_at: Optional[int] = None
        self._installed = False

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "RecompileSentinel":
        with _LOCK:
            if not self._installed:
                _SENTINELS.append(self)
                self._installed = True
        return self

    def uninstall(self) -> None:
        with _LOCK:
            if self._installed:
                _SENTINELS.remove(self)
                self._installed = False

    def __enter__(self) -> "RecompileSentinel":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- the contract ------------------------------------------------------

    @property
    def events(self) -> List[tuple]:
        """Piece keys of every capture observed since install()."""
        with _LOCK:
            return list(self._events)

    def seal(self, context: str = "warm-up") -> None:
        """Mark the end of warm-up: captures beyond this point are contract
        violations for check()."""
        with _LOCK:
            self._sealed_at = len(self._events)

    def post_seal_events(self) -> List[tuple]:
        with _LOCK:
            if self._sealed_at is None:
                return []
            return list(self._events[self._sealed_at :])

    def _report(self, keys: List[tuple], context: str) -> None:
        listing = ", ".join(sorted({repr(k) for k in keys}))
        msg = (
            f"KTPU_EXPLAIN_RECOMPILES: {len(keys)} CUDA graph capture(s) after the warm-up during "
            f"{context or 'the sealed region'}; piece keys: {listing}. A plan reached a piece the build did "
            "not capture, or the executor's buffers were rebuilt; the capture-once contract is broken."
        )
        if self.mode == "raise":
            raise RecompileError(msg)
        warnings.warn(msg, RecompileWarning, stacklevel=3)

    def check(self, context: str = "") -> None:
        """Raise (or warn) if anything was captured since seal()."""
        keys = self.post_seal_events()
        if keys:
            # Re-seal so a warn-mode caller is not re-warned forever.
            self.seal()
            self._report(keys, context)

    def expect_none(self, context: str):
        """Context manager: no capture may happen inside the block
        (independent of seal(), so neighbouring engines capturing between
        blocks don't contaminate the verdict)."""
        sentinel = self

        class _Window:
            def __enter__(self_w):
                with _LOCK:
                    self_w.start = len(sentinel._events)
                return sentinel

            def __exit__(self_w, exc_type, exc, tb):
                if exc_type is not None:
                    return False
                with _LOCK:
                    keys = list(sentinel._events[self_w.start :])
                if keys:
                    sentinel._report(keys, context)
                return False

        return _Window()


def sentinel_mode() -> Optional[bool]:
    """The KTPU_EXPLAIN_RECOMPILES tristate: None unset (code that opts in
    arms its own sentinels, the fleet does not), True -> armed raising,
    False -> forced off everywhere."""
    return flag_tristate("KTPU_EXPLAIN_RECOMPILES")


def maybe_sentinel() -> Optional[RecompileSentinel]:
    """An installed raising sentinel when the flag is explicitly on
    (ScenarioFleet's wiring), else None."""
    if sentinel_mode() is True:
        return RecompileSentinel("raise").install()
    return None
