"""The streaming feeder: a producer thread that stages the sliding pod
window's refill payload in bounded slabs, running ahead of the engine.

Port of the JAX package's `batched/stream.py` (`StreamFeeder`, :94-476,
and the lane-asynchronous fleet's `LaneTraceMux`, :478-594, at the end of
this module). A producer
thread assembles payload segments (the engine's callback over
trace_compile.stage_segment) and uploads them into a ring of at most K
slabs (state.RefillStage), ahead of the consumer, the engine's stepping
loop, which installs the next slab where the installed one no longer
covers the next slide. The pipeline holds at most K slabs of C x L
columns plus the segment being assembled, not the whole trace, so a
trace whose whole slide payload exceeds the device budget runs.

Slab schedule. The width L is fixed, so the producer needs no feedback:
successive slabs advance by the stride

    stride = (L - W) - W//2,

the least restage base after the installed slab at lo runs out (a slide's
shift is at most W/2), so the scheduled successor always covers the next
restage point. Where the ring ran empty and the consumer's base passed the
schedule, the producer starts at that base (a demand fast-forward). At the
least width, L = W + W/2, the stride is 0 and the producer runs on
demand: it builds exactly the slab the consumer's base asks for.

Spent slabs. A slab the base has passed (lo + L - W < base) or one whose
successor also covers the base is dropped at the next `get_stage`; a slab
the engine retires is dropped at once and its lo recorded, and
`get_stage` asserts that every slab it serves lies past that retired
high-water mark: a spent slab is never offered again. Moving the base
backwards (a growth, an installed state) needs a re-seek: the engine
closes the feeder and builds a new one at the new base and width. A
slab's content is a function of (lo, width) alone, so a re-seek cannot
diverge.

Stalls. The consumer's wait for a covering slab splits into
`stage_wait_feeder` (not published yet: assembly bound) and
`stage_wait_upload` (published, upload not settled: transfer bound), both
on the engine's tracer; a wait for a feeder's first slab is its cold
start, counted apart (the engine starts the feeder at the build and at
each re-seek, so the first slab is mostly ready by the first slide); the producer's own assembly and upload times are
counters here (the feeder thread never touches the engine's span ring).

Slabs in place. The slabs live in a SlabRing: `depth` (C, L) stages on the
engine's device, allocated once when the feeder is built, at most as many
as the trace still needs from the feeder's base, filled in turn (slab j
goes to slot j mod depth: the ring holds fewer than `depth` slabs when
slab j is built, and they are the latest ones, so slot j mod depth is no
longer in it). The slide reads the installed slot where it lies (the
window executor keeps one slide graph a slot), so the device holds the
ring's slots and nothing more. The consumer releases a slot when it stops
reading it (before it retires the slab): on the card an event recorded
on the compute stream after the last slide that read it, which the next
upload into that slot waits on; on the CPU the consumer's reads have
finished by then.

Uploads. On the card each segment is written into one of `depth` pinned
host buffers and copied with non_blocking on a copy stream into its slot,
with a CUDA event recorded after it; the producer's settle waits on that
event (the feeder thread's only wait on the card), and the engine's
install makes the compute stream wait on it, so the engine thread never
reads a device value for the feeder. A pinned buffer is refilled only
after its last upload's event. The window executor captures its graphs in
the thread-local mode, so the feeder thread's event waits and copies never
invalidate an open capture. On the CPU the same thread and schedule run,
and an upload is a plain copy into the slot.

Without a thread (`thread=False`: the engine's bounded slabs over the
device budget without streaming) the same schedule runs on the consumer's
thread: `get_stage` builds the slab at the consumer's base where none
covers it (a prefetch miss), and `prefetch`, called while the device runs
a span, builds the scheduled successor ahead (a hit at the next
`get_stage`).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.faults import FeederProducerError, InjectedFeederKill
from kubernetriks_tpu_torch.batched.state import (
    EV_CREATE_POD,
    EV_NONE,
    EV_REMOVE_POD,
    RefillStage,
    flatten,
    stage_arrays_np,
    stage_nbytes,
)
from kubernetriks_tpu_torch.telemetry import NULL_TRACER
from kubernetriks_tpu_torch.telemetry.tracer import (
    PH_STAGE_ASSEMBLE,
    PH_STAGE_PREFETCH,
    PH_STAGE_PUT,
    PH_STAGE_WAIT_FEEDER,
    PH_STAGE_WAIT_UPLOAD,
)


class _Slot:
    """One ring entry: a slab covering payload columns [lo, lo + L) and the
    event the producer sets once its upload has settled."""

    __slots__ = ("lo", "stage", "ready")

    def __init__(self, lo: int, stage, ready: threading.Event):
        self.lo = lo
        self.stage = stage
        self.ready = ready


def _settle_default(slab) -> None:
    """Wait until the slab's upload has landed (on the feeder thread): a
    SlabRing slab's event on the card; nothing for other slabs."""
    ready = getattr(slab, "ready", None)
    if ready is not None:
        ready.synchronize()


class StreamFeeder:
    """Bounded ring of staging slabs from a producer thread.

    - assemble(lo, width) -> host segment (the engine binds
      trace_compile.stage_segment over its payload source);
    - upload(segment) -> slab (SlabRing.upload);
    - base: the first pod base the consumer asks for (slab 0 starts there);
    - width, window: the stage width L and the pod window W;
    - trace_cols: the payload's columns (T + W, the right padding
      included): a slab reaching them is the last, and the producer exits;
    - depth: the ring's capacity K (the memory bound); K = 1 stages
      synchronously, off the engine's thread, and stays exact;
    - settle: waits for a slab's upload (None: none to wait for);
    - retired_lo: the retired high-water mark of a dead predecessor, which
      a supervisor restart carries over, so that never-re-offer spans it;
    - chaos: a faults.HostChaos (or anything with feeder_kill()); a hit
      raises InjectedFeederKill in the producer before the slab is built;
    - thread: False runs the schedule on the consumer's thread (module
      note): no producer thread, no settle.
    """

    # Helpers whose callers hold self._cond (the feederlock lint pass holds
    # every call of one to that).
    _UNDER_LOCK = ("_scheduled_lo", "_publish", "_build_here", "_producer_error")
    # The slab being built: written by the builder before it assembles
    # (the producer thread outside the lock, or the consumer under it) and
    # read under the lock only once the builder died, to name its slab.
    _LOCK_FREE = ("_building_lo",)

    def __init__(
        self,
        assemble: Callable[[int, int], dict],
        upload: Callable[[dict], object],
        *,
        base: int,
        width: int,
        window: int,
        trace_cols: int,
        depth: int = 3,
        settle: Optional[Callable[[object], None]] = _settle_default,
        retired_lo: int = -1,
        chaos=None,
        thread: bool = True,
    ) -> None:
        self._assemble = assemble
        self._upload = upload
        self._settle = settle if thread else None
        self._chaos = chaos
        self.width = int(width)
        self.window = int(window)
        self.depth = max(1, int(depth))
        self.trace_cols = int(trace_cols)
        self.stride = self.width - self.window - self.window // 2
        # Run-ahead needs a positive stride; at the least width the
        # producer builds on demand.
        self.ahead = self.stride > 0

        self._cond = threading.Condition()
        self._ring: deque = deque()  # _Slot entries, strictly increasing lo
        self._next_lo = int(base)
        self._demand_lo = int(base)
        self._last_lo = -1  # the highest slab lo published
        self._retired_lo = int(retired_lo)  # the highest lo retired
        self._served_lo = -1  # the last slab lo served
        self._building_lo = -1  # the slab the producer is building
        self._done = False  # the last slab is published
        self._stop = False
        self._error: Optional[BaseException] = None

        # Counters (read under the lock, or after close()).
        self.produced = 0
        self.spent_dropped = 0
        self.demand_fastforwards = 0
        self.ring_high_water = 0
        self._depth_sum = 0
        self._depth_samples = 0
        self.assemble_ns = 0
        self.upload_ns = 0
        self.settle_ns = 0
        self.stall_cold = 0
        self.stall_cold_ns = 0
        self.stall_not_ready = 0
        self.stall_not_ready_ns = 0
        self.stall_upload = 0
        self.stall_upload_ns = 0

        self._thread = None
        if thread:
            self._thread = threading.Thread(target=self._produce, name="ktpu-stream-feeder", daemon=True)
            self._thread.start()

    # --- building a slab (the feeder thread, or the consumer's) -----------------

    def _scheduled_lo(self) -> int:
        """The next slab's lo (call under the lock)."""
        if not self.ahead:
            # On demand: the slab the consumer's base asks for (a retired
            # slab's lo is never asked for again).
            return self._demand_lo
        lo = self._next_lo
        if not self._ring and self._demand_lo > lo:
            # The ring is empty and the consumer passed the schedule: a
            # scheduled slab would be dominated on arrival, so start at the
            # consumer's base.
            lo = self._demand_lo
            self.demand_fastforwards += 1
        return lo

    def _build(self, lo: int, tracer=NULL_TRACER):
        """Assemble and upload the slab at `lo` (outside the lock): its
        stage and the assembly and upload times. A death mid-build reports
        this slab."""
        self._building_lo = lo
        if self._chaos is not None and self._chaos.feeder_kill():
            raise InjectedFeederKill(f"host chaos: injected stream-feeder kill while building slab lo={lo}")
        t0 = time.perf_counter_ns()
        seg = self._assemble(lo, self.width)
        t1 = time.perf_counter_ns()
        stage = self._upload(seg)
        t2 = time.perf_counter_ns()
        tracer.end(PH_STAGE_ASSEMBLE, t0, dur=t1 - t0)
        tracer.end(PH_STAGE_PUT, t1, dur=t2 - t1)
        return stage, t1 - t0, t2 - t1

    def _publish(self, lo: int, built) -> _Slot:
        """Append a built slab to the ring (call under the lock)."""
        stage, assemble_ns, upload_ns = built
        slot = _Slot(lo, stage, threading.Event())
        self.assemble_ns += assemble_ns
        self.upload_ns += upload_ns
        self._ring.append(slot)
        self.produced += 1
        self._last_lo = lo
        self.ring_high_water = max(self.ring_high_water, len(self._ring))
        self._next_lo = lo + max(self.stride, 1)
        self._done = lo + self.width >= self.trace_cols
        self._cond.notify_all()
        return slot

    def _produce(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._stop and (
                        len(self._ring) >= self.depth
                        or (not self.ahead and (len(self._ring) > 0 or self._demand_lo <= self._last_lo))
                    ):
                        self._cond.wait()
                    if self._stop:
                        return
                    lo = self._scheduled_lo()
                # Outside the lock: assembly and upload overlap the
                # consumer's windows.
                built = self._build(lo)
                t2 = time.perf_counter_ns()
                with self._cond:
                    if self._stop:
                        return
                    slot = self._publish(lo, built)
                    done = self._done
                # Settle the upload before marking the slot ready: a
                # consumer that took it meanwhile waits on the event (the
                # upload-wait half of the stall split).
                if self._settle is not None:
                    self._settle(slot.stage)
                    settle_ns = time.perf_counter_ns() - t2
                    with self._cond:
                        self.settle_ns += settle_ns
                slot.ready.set()
                if done:
                    return
        except BaseException as exc:  # carried to the consumer
            with self._cond:
                self._error = exc
                # A consumer waiting on a published slab's settle wakes and
                # sees the error.
                for slot in self._ring:
                    slot.ready.set()
                self._cond.notify_all()

    def _build_here(self, lo: int, tracer) -> None:
        """Without a thread: build and publish the slab at `lo` on the
        consumer's thread (call under the lock), a death raised as the
        thread's would be."""
        try:
            built = self._build(lo, tracer)
        except Exception as exc:
            self._error = exc
            raise self._producer_error() from exc
        self._publish(lo, built).ready.set()

    def prefetch(self, tracer=NULL_TRACER) -> None:
        """Without a thread: build the scheduled successor of the served
        slab while the device runs a span (a no-op with a thread, where the
        producer runs ahead by itself, on demand, at the trace's end, or
        where the ring is full)."""
        with self._cond:
            if (
                self._thread is not None or self._error is not None or self._done or not self.ahead
                or not self._ring or len(self._ring) >= self.depth or self._next_lo <= self._last_lo
            ):
                return
            t0 = tracer.begin()
            try:
                self._build_here(self._next_lo, tracer)
            except FeederProducerError:
                return  # recorded: the next get_stage raises it, where the supervisor restarts
            tracer.end(PH_STAGE_PREFETCH, t0)

    # --- the consumer (engine thread) ------------------------------------------

    def _producer_error(self) -> FeederProducerError:
        """The producer's death with its slab (call under the lock)."""
        lo = self._building_lo
        span = f"slab lo={lo} span=[{lo}, {lo + self.width})" if lo >= 0 else "before the first slab"
        return FeederProducerError(
            f"stream feeder producer failed ({span}): {self._error!r}",
            slab_lo=lo if lo >= 0 else None,
            width=self.width,
        )

    def retired_watermark(self) -> int:
        """The highest retired slab lo (a supervisor restart's carry-over)."""
        with self._cond:
            return self._retired_lo

    def get_stage(self, base: int, tracer=NULL_TRACER):
        """(slab, lo, fresh) for the ring slab of largest lo that covers
        `base` (lo <= base and base - lo + W <= L; dominated predecessors
        are dropped as spent), blocking until the producer publishes it
        (without a thread: building it at `base`); `fresh` is True the
        first time a slab is served. Raises AssertionError where the ring
        would have to offer a spent or retired slab again, or where the
        base moved backwards without a re-seek, and FeederProducerError
        where the producer died."""
        waited = False
        with self._cond:
            # The next scheduled slab never needs to start below the
            # consumer's latest base.
            if base > self._demand_lo:
                self._demand_lo = base
                self._cond.notify_all()
            built_here = False
            while True:
                if self._error is not None:
                    raise self._producer_error() from self._error
                while (self._ring and self._ring[0].lo + self.width - self.window < base) or (
                    len(self._ring) >= 2 and self._ring[1].lo <= base
                ):
                    self._ring.popleft()
                    self.spent_dropped += 1
                    self._cond.notify_all()  # room in the ring
                if self._ring and self._ring[0].lo <= base:
                    slot = self._ring[0]
                    break
                if self._ring:  # head.lo > base: the base moved backwards
                    raise AssertionError(
                        f"stream ring would re-offer below its head: requested base {base} precedes slab "
                        f"lo={self._ring[0].lo}; spent slabs are never re-offered; re-seek the feeder "
                        "(close and rebuild) after moving the base backwards"
                    )
                if self._done:
                    raise AssertionError(
                        f"stream feeder exhausted the trace (trace_cols={self.trace_cols}) with base {base} "
                        "uncovered: the stride and coverage invariant is broken"
                    )
                if self._thread is None:
                    # The reference's prefetch miss: a slab at the base.
                    built_here = True
                    self._build_here(base, tracer)
                    continue
                if not waited:
                    waited = True
                    t_wait = time.perf_counter_ns()
                self._cond.wait()
            if self._thread is None:
                tracer.count("stage_prefetch_miss" if built_here else "stage_prefetch_hit")
            if waited:
                dur = time.perf_counter_ns() - t_wait
                if self._served_lo < 0:
                    # The feeder's first slab: its cold start.
                    self.stall_cold += 1
                    self.stall_cold_ns += dur
                else:
                    self.stall_not_ready += 1
                    self.stall_not_ready_ns += dur
                tracer.end(PH_STAGE_WAIT_FEEDER, t_wait, dur=dur)
            assert slot.lo > self._retired_lo, (
                f"stream ring re-offered a retired slab (lo={slot.lo} <= retired {self._retired_lo})"
            )
            fresh = slot.lo != self._served_lo
            self._served_lo = slot.lo
            self._depth_sum += len(self._ring)
            self._depth_samples += 1
        if not slot.ready.is_set():
            # Published, but its upload has not settled: the upload wait.
            t_wait = time.perf_counter_ns()
            slot.ready.wait()
            dur = time.perf_counter_ns() - t_wait
            with self._cond:
                self.stall_upload += 1
                self.stall_upload_ns += dur
                if self._error is not None:
                    raise self._producer_error() from self._error
            tracer.end(PH_STAGE_WAIT_UPLOAD, t_wait, dur=dur)
        return slot.stage, slot.lo, fresh

    def retire(self, lo: int) -> None:
        """Drop the slab at `lo` (the engine has moved past it) and record
        it as spent: get_stage asserts rather than serve it again."""
        with self._cond:
            if self._ring and self._ring[0].lo == lo:
                self._ring.popleft()
            if lo > self._retired_lo:
                self._retired_lo = lo
            self._cond.notify_all()

    def stop(self) -> None:
        """Ask the producer to exit, without waiting for it."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    def close(self, timeout: float = 30.0) -> bool:
        """Stop the producer and join it (idempotent; a re-seek is close
        and rebuild). False, with a warning, where the producer outlived
        the timeout: it is mid-build, and drops its slab at the stop check
        before publishing."""
        self.stop()
        if self._thread is None:
            return True
        self._thread.join(timeout)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "stream feeder producer did not exit within %.0fs of close() (mid-build on a %d-column "
                "segment); it drops the slab and exits at its next stop check",
                timeout, self.width,
            )
            return False
        return True

    def report(self) -> dict:
        """The feeder's section of the engine's telemetry_report: production
        counters, the ring's depth (mean and high-water mark against its
        capacity), the producer's times and the consumer's stall split (a
        first slab's wait is the cold start, apart from the waits on a
        producer that fell behind)."""
        with self._cond:
            depth_mean = self._depth_sum / self._depth_samples if self._depth_samples else 0.0
            return {
                "threaded": self._thread is not None,
                "slabs_produced": self.produced,
                "spent_dropped": self.spent_dropped,
                "demand_fastforwards": self.demand_fastforwards,
                "ring_capacity": self.depth,
                "ring_depth_high_water": self.ring_high_water,
                "ring_depth_mean": round(depth_mean, 3),
                "segment_cols": self.width,
                "stride_cols": self.stride,
                "trace_cols": self.trace_cols,
                "assemble_ms": round(self.assemble_ns / 1e6, 3),
                "upload_ms": round(self.upload_ns / 1e6, 3),
                "settle_ms": round(self.settle_ns / 1e6, 3),
                "stalls": {
                    "cold_start": {"count": self.stall_cold, "ms": round(self.stall_cold_ns / 1e6, 3)},
                    "feeder_not_ready": {"count": self.stall_not_ready, "ms": round(self.stall_not_ready_ns / 1e6, 3)},
                    "upload_wait": {"count": self.stall_upload, "ms": round(self.stall_upload_ns / 1e6, 3)},
                },
            }


# --- the slabs -----------------------------------------------------------------


class StagedSlab:
    """A slab as the producer publishes it: its stage (a slot of the ring
    that owns it), the event its upload recorded (None on the CPU) and its
    slot's index."""

    __slots__ = ("stage", "ready", "ring", "index")

    def __init__(self, stage: RefillStage, ready, ring: "SlabRing", index: int):
        self.stage = stage
        self.ready = ready
        self.ring = ring
        self.index = index

    def release(self, event) -> None:
        """The consumer stopped reading this slot; `event` (None on the
        CPU) completes after its last read: the ring refills the slot only
        then."""
        self.ring.released[self.index] = event


def empty_stage(C: int, L: int, has_rank: bool, device, pin: bool = False) -> RefillStage:
    """A (C, L) stage of zeros on `device` (a ring's slots) or, with `pin`,
    in pinned host memory (its upload buffers)."""

    def i32():
        return torch.zeros((C, L), dtype=torch.int32, device=device, pin_memory=pin)

    return RefillStage(
        req_cpu=i32(), req_ram=i32(), dur_win=i32(),
        dur_off=torch.zeros((C, L), dtype=torch.float32, device=device, pin_memory=pin),
        create_win=i32(), rank=i32() if has_rank else None,
    )


class SlabRing:
    """The slots a feeder fills (module note): `depth` (C, L) stages on
    `device`, allocated here, filled in turn, and read in place by the
    slide. On the card: as many pinned host buffers, copies with
    non_blocking on `stream` (the engine's copy stream; the slots are
    allocated on the compute stream and marked used on the copy stream, so
    the allocator reuses their memory only after both), `released[i]`: the
    event after the last slide that read slot i, which its next upload
    waits on; `uploaded[i]`: the event after the last upload from pinned
    buffer i. On the CPU an upload copies into the slot."""

    def __init__(self, C: int, L: int, has_rank: bool, depth: int, device, interval: float, stream=None) -> None:
        self.device = torch.device(device)
        self.stream = stream
        self.interval = interval
        self.depth = max(1, int(depth))
        self.width = int(L)
        self.slots: List[RefillStage] = [empty_stage(C, L, has_rank, self.device) for _ in range(self.depth)]
        self.released: List[Optional[torch.cuda.Event]] = [None] * self.depth
        self.host: List[RefillStage] = []
        self.uploaded: List[Optional[torch.cuda.Event]] = [None] * self.depth
        if self.device.type == "cuda":
            for slot in self.slots:
                for t in flatten(slot).values():
                    t.record_stream(stream)
            self.host = [empty_stage(C, L, has_rank, "cpu", pin=True) for _ in range(self.depth)]
        self._next = 0

    def upload(self, seg: dict) -> StagedSlab:
        """Write `seg` into the next slot (producer thread): on the card
        through the next pinned buffer, copied without blocking after the
        slot's release event."""
        i = self._next % self.depth
        self._next += 1
        arrays = stage_arrays_np(seg, self.interval)
        slot = self.slots[i]
        if self.device.type != "cuda":
            for name, t in flatten(slot).items():
                np.copyto(t.numpy(), arrays[name[1:]])
            return StagedSlab(slot, None, self, i)
        if self.uploaded[i] is not None:
            self.uploaded[i].synchronize()  # the pinned buffer's last upload
        host = self.host[i]
        for name, t in flatten(host).items():
            np.copyto(t.numpy(), arrays[name[1:]])
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            released = self.released[i]
            if released is not None:
                self.stream.wait_event(released)  # the slot's last slide
            for d, h in zip(flatten(slot).values(), flatten(host).values()):
                d.copy_(h, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.uploaded[i] = event
        return StagedSlab(slot, event, self, i)

    def nbytes(self) -> int:
        """Bytes of the ring's slots on its device."""
        return sum(stage_nbytes(s) for s in self.slots)

    def pinned_nbytes(self) -> int:
        """Bytes of its pinned host buffers (none on the CPU)."""
        return sum(stage_nbytes(s) for s in self.host)


class LaneTraceMux:
    """Per-lane workload ranges over the resident trace slab (reference
    `LaneTraceMux`, stream.py:478-594): each lane of a lane-asynchronous
    fleet may replay its own row range of its slab row, as pure data.

    `offer(lane, lo, hi)`: slab rows [lo, hi) of the lane are kept. Pod
    creates outside the range become EV_NONE in place (their window stays,
    so the row's time order holds), and a pod remove is masked where its
    slot's create was masked (never a remove without its create; a remove
    of a slot the slab never creates stays). Node and chaos events are
    never masked: the cluster's shape and fault streams belong to the
    scenario, not to the workload range.

    Never re-offer: an offer to a lane whose previous range still flies
    raises; the engine's lane_reset retires a lane's range (`retire`).

    Host only: it keeps a host copy of the packed (C, E, 4) slab and
    returns host row blocks; the engine writes them into the device slab
    (engine.set_lane_trace)."""

    def __init__(self, packed) -> None:
        base = np.array(packed, np.int32)
        if base.ndim != 3 or base.shape[-1] != 4:
            raise ValueError(f"LaneTraceMux wants a (C, E, 4) packed slab, got {base.shape}")
        self._base = base
        C = base.shape[0]
        self._flying = [False] * C  # an offer outstanding (not retired yet)
        self._installed = [None] * C  # the last (lo, hi) served a lane
        self.offers = 0

    @property
    def n_rows(self) -> int:
        return self._base.shape[1]

    def offer(self, lane: int, lo: int = 0, hi: Optional[int] = None):
        """The lane's masked (E, 4) host rows, or None where the lane
        already has exactly this range installed (the caller skips the
        device write). Raises on a re-offer to a lane whose previous range
        was never retired."""
        E = self._base.shape[1]
        hi = E if hi is None else int(hi)
        lo = int(lo)
        if not (0 <= lo <= hi <= E):
            raise ValueError(f"lane {lane}: trace row-range [{lo}, {hi}) outside [0, {E})")
        if self._flying[lane]:
            raise RuntimeError(
                f"lane {lane}: trace rows re-offered while its previous range is still flying; retire the lane "
                "(lane_reset) before re-seeding (never-re-offer invariant)"
            )
        self._flying[lane] = True
        self.offers += 1
        if self._installed[lane] == (lo, hi):
            return None
        self._installed[lane] = (lo, hi)
        rows = self._base[lane].copy()
        kind = rows[:, 2]
        slot = rows[:, 3]
        is_create = kind == EV_CREATE_POD
        is_remove = kind == EV_REMOVE_POD
        if not bool(is_create.any()):
            return rows
        in_range = np.zeros((E,), bool)
        in_range[lo:hi] = True
        n_slots = int(slot[is_create | is_remove].max()) + 1
        created = np.zeros((n_slots,), bool)
        created[slot[is_create]] = True
        kept = np.zeros((n_slots,), bool)
        kept[slot[is_create & in_range]] = True
        drop = (is_create & ~in_range) | (is_remove & created[slot] & ~kept[slot])
        rows[drop, 2] = EV_NONE
        return rows

    def retire(self, lanes) -> None:
        """The lanes' offered ranges are spent (a reset boundary): the
        next offer to them is legal again."""
        for lane in lanes:
            self._flying[int(lane)] = False

    def report(self) -> dict:
        return {
            "offers": self.offers,
            "installed": {lane: rng for lane, rng in enumerate(self._installed) if rng is not None},
        }
