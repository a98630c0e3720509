"""The port's streaming feeder (kubernetriks_tpu_torch/batched/stream.py
StreamFeeder) and its fault domain (batched/faults.py) on the CPU, against
the JAX package's.

- The JAX StreamFeeder is host-only: both feeders are driven with the same
  numpy callbacks through the same scripted gets and retires (each get
  after the producer has gone idle, so the schedule is not a race): the
  (lo, width) served, the slabs' content, freshness and the production
  counters are equal, in run-ahead mode, on demand (L = W + W/2), with a
  one-slab ring, across a jump of the base and to the trace's end.
- The reference's unit cases on the port's class: a spent or retired slab
  is never offered again, the ring is bounded and runs ahead, demand mode
  builds exactly what is asked, a producer's death reaches the consumer
  with its slab's context, a HostChaos kill does too, and the retired
  high-water mark survives a restart.
- HostChaos's feeder channel draws, parses KTPU_HOST_CHAOS (the fleet's
  dispatch and stall keys too) and reports as the reference's.
- The thread-less feeder: builds on demand, prefetches, carries a death
  to the next get; the engine's ring holds no more than the whole payload.
- The engine's supervisor: producer deaths mid-run restart the feeder
  (backoff, the retired mark kept) and the run equals the run without the
  feeder; past the cap of 5 restarts the error propagates (KTPU_HOST_CHAOS
  at the build arms it).

Tolerance: exact everywhere.
"""

import threading
import time

import numpy as np
import pytest

from chip_smoke import composed_sim

from kubernetriks_tpu.batched.faults import HostChaos as JaxHostChaos
from kubernetriks_tpu.batched.stream import StreamFeeder as JaxStreamFeeder

from kubernetriks_tpu_torch.batched.faults import FeederProducerError, HostChaos, InjectedFeederKill
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.batched.stream import StreamFeeder
from kubernetriks_tpu_torch.convert import state_to_numpy


def _callbacks(C=2, T=1000):
    """Numpy callbacks over a seeded whole payload: a segment of columns
    [lo, lo + width), padded past T."""
    rng = np.random.default_rng(11)
    full = rng.integers(0, 1 << 20, (C, T)).astype(np.int32)

    def assemble(lo, width):
        out = np.full((C, width), -1, np.int32)
        src = full[:, lo : lo + width]
        out[:, : src.shape[1]] = src
        return {"lo": lo, "width": width, "cols": out}

    def upload(seg):
        return ("slab", seg["lo"], seg["width"], seg["cols"].copy())

    return assemble, upload


def _idle(f, timeout=10.0):
    """Wait until the producer waits (or has finished): the feeder's state
    is then a function of the calls made, not of the thread's timing."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with f._cond:
            if (
                f._stop or f._done or f._error is not None or len(f._ring) >= f.depth
                or (not f.ahead and (len(f._ring) > 0 or f._demand_lo <= f._last_lo))
            ):
                return
        time.sleep(0.001)
    raise AssertionError("the producer never went idle")


# The report's counters but ring_depth_mean, which samples the ring's depth
# when a get returns: after a get that waited, the producer may or may not
# have published the next slab yet.
COUNTERS = ("slabs_produced", "spent_dropped", "demand_fastforwards", "ring_capacity", "ring_depth_high_water",
            "segment_cols", "stride_cols", "trace_cols")

# name: (feeder kwargs, script of ("get", base) / ("retire", lo of the last served))
SCRIPTS = {
    "ahead": (dict(width=256, window=64, depth=2, trace_cols=1064),
              [("get", 0), ("get", 64), ("retire",), ("get", 200), ("get", 300), ("retire",), ("get", 400),
               ("get", 520), ("retire",), ("get", 700), ("get", 900), ("get", 960)]),
    "ahead, deep": (dict(width=200, window=40, depth=3, trace_cols=1040),
                    [("get", 0), ("retire",), ("get", 150), ("retire",), ("get", 290), ("get", 330), ("retire",),
                     ("get", 430), ("retire",), ("get", 600), ("retire",), ("get", 900)]),
    "demand": (dict(width=96, window=64, depth=2, trace_cols=1064),
               [("get", 0), ("retire",), ("get", 40), ("retire",), ("get", 72), ("retire",), ("get", 100),
                ("retire",), ("get", 968)]),
    "one slab": (dict(width=160, window=64, depth=1, trace_cols=1064),
                 [("get", 0), ("retire",), ("get", 90), ("retire",), ("get", 200), ("retire",), ("get", 330)]),
    "jump": (dict(width=256, window=64, depth=2, trace_cols=1064),
             [("get", 0), ("retire",), ("get", 650), ("retire",), ("get", 850)]),
}


def _run_script(cls, kwargs, script):
    assemble, upload = _callbacks()
    f = cls(assemble, upload, base=0, settle=None, **kwargs)
    served, last = [], None
    try:
        for step in script:
            _idle(f)
            if step[0] == "get":
                stage, lo, fresh = f.get_stage(step[1])
                assert stage[1] == lo and stage[2] == f.width
                served.append((step[1], lo, stage[2], fresh, stage[3]))
                last = lo
            else:
                f.retire(last)
        _idle(f)
        rep = f.report()
    finally:
        f.close()
    return served, {k: rep[k] for k in COUNTERS}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_feeder_serves_the_reference_sequence(name):
    kwargs, script = SCRIPTS[name]
    port, port_rep = _run_script(StreamFeeder, kwargs, script)
    ref, ref_rep = _run_script(JaxStreamFeeder, kwargs, script)
    assert [s[:4] for s in port] == [s[:4] for s in ref]
    for a, b in zip(port, ref):
        assert np.array_equal(a[4], b[4])
    assert port_rep == ref_rep
    if name == "demand":
        assert port_rep["stride_cols"] == 0 and port_rep["ring_depth_high_water"] == 1
    if name == "jump":
        assert port_rep["demand_fastforwards"] >= 1
    assert len({lo for _, lo, *_ in port}) >= 3


def _fake_feeder(**kwargs):
    def assemble(lo, width):
        return {"lo": lo, "width": width}

    def upload(seg):
        return ("slab", seg["lo"], seg["width"])

    kwargs.setdefault("base", 0)
    kwargs.setdefault("window", 64)
    kwargs.setdefault("trace_cols", 10_000)
    return StreamFeeder(assemble, upload, settle=None, **kwargs)


def test_feeder_never_reoffers_spent_or_retired_slab():
    f = _fake_feeder(width=256, depth=2)  # stride 160: run-ahead
    stage, lo, fresh = f.get_stage(0)
    assert (lo, fresh) == (0, True) and stage == ("slab", 0, 256)
    _, _, fresh = f.get_stage(64)
    assert not fresh  # served again without moving: not fresh
    f.retire(0)
    # Slab 0 still covers base 100, but it is retired: the head is the
    # slab at 160, and a base below it is a seek error, not a re-offer.
    with pytest.raises(AssertionError, match="re-offer"):
        f.get_stage(100)
    f.close()


def test_feeder_ring_is_bounded_and_runs_ahead():
    f = _fake_feeder(width=256, depth=2)
    f.get_stage(0)
    _idle(f)
    assert f.ring_high_water == 2
    served = [f.get_stage(base)[1] for base in (200, 400, 600, 800)]
    assert served == sorted(served) and f.ring_high_water <= 2
    assert f.report()["slabs_produced"] >= len(set(served))
    f.close()


def test_feeder_demand_mode_builds_exactly_on_demand():
    f = _fake_feeder(width=96, depth=2)  # stride 0
    assert not f.ahead
    assert f.get_stage(0)[1] == 0
    f.retire(0)
    _, lo1, fresh = f.get_stage(40)
    assert (lo1, fresh) == (40, True)
    rep = f.report()
    assert rep["ring_depth_high_water"] == 1 and rep["slabs_produced"] == 2
    f.close()


def test_feeder_producer_error_carries_slab_context():
    def assemble(lo, width):
        if lo >= 96:
            raise RuntimeError("disk on fire at lo=%d" % lo)
        return {"lo": lo, "width": width}

    f = StreamFeeder(assemble, lambda seg: ("slab", seg["lo"]), base=0, width=96, window=64, trace_cols=10_000,
                     depth=2, settle=None)
    assert f.get_stage(0)[1] == 0
    f.retire(0)
    with pytest.raises(FeederProducerError) as info:
        f.get_stage(96)
    err = info.value
    assert isinstance(err, RuntimeError) and (err.slab_lo, err.width) == (96, 96)
    assert "stream feeder producer failed" in str(err) and "slab lo=96 span=[96, 192)" in str(err)
    assert "disk on fire" in str(err) and isinstance(err.__cause__, RuntimeError)
    f.close()
    # A death before any slab: no slab to name.
    g = StreamFeeder(lambda lo, w: 1 / 0, lambda seg: seg, base=0, width=96, window=64, trace_cols=1000, depth=2,
                     settle=None)
    with pytest.raises(FeederProducerError, match="stream feeder producer failed"):
        g.get_stage(0)
    g.close()


def test_feeder_chaos_kill_surfaces_with_slab_context():
    f = _fake_feeder(width=96, depth=2, chaos=HostChaos(seed=3, feeder_rate=1.0))
    with pytest.raises(FeederProducerError) as info:
        f.get_stage(0)
    err = info.value
    assert err.slab_lo == 0 and "injected stream-feeder kill" in str(err)
    assert isinstance(err.__cause__, InjectedFeederKill)
    f.close()


def test_feeder_retired_watermark_survives_restart():
    f = _fake_feeder(width=256, depth=2)
    _, lo0, _ = f.get_stage(0)
    f.retire(lo0)
    assert f.retired_watermark() == lo0
    f.close()
    again = _fake_feeder(width=256, depth=2, base=0, retired_lo=lo0)
    with pytest.raises(AssertionError, match="retired"):
        again.get_stage(0)
    again.close()
    onward = _fake_feeder(width=256, depth=2, base=160, retired_lo=lo0)
    _, lo, fresh = onward.get_stage(160)
    assert lo > lo0 and fresh
    onward.close()


def test_feeder_upload_wait_is_split_from_the_feeder_wait():
    """A published slab whose upload has not settled: the consumer's wait
    counts as an upload wait, not a feeder one."""
    gate = threading.Event()
    f = StreamFeeder(lambda lo, w: {"lo": lo}, lambda seg: ("slab", seg["lo"]), base=0, width=256, window=64,
                     trace_cols=10_000, depth=1, settle=lambda stage: gate.wait())
    deadline = time.monotonic() + 10
    while f.produced == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    threading.Timer(0.05, gate.set).start()
    f.get_stage(0)
    stalls = f.report()["stalls"]
    assert stalls["upload_wait"]["count"] == 1 and stalls["feeder_not_ready"]["count"] == 0
    f.close()


@pytest.mark.parametrize("spec", [None, "0", "1", "seed=3,feeder=0.3", "feeder=0.5,seed=11"])
def test_host_chaos_matches_the_reference(spec):
    """The feeder channel draws, counts and reports as the reference's; the
    fleet keys (dispatch, stall, stall_ms) parse equal to the reference's."""
    port, ref = HostChaos.from_flag(spec), JaxHostChaos.from_flag(spec)
    assert (port is None) == (ref is None)
    if port is None:
        return
    assert [port.feeder_kill() for _ in range(200)] == [ref.feeder_kill() for _ in range(200)]
    assert port.report() == ref.report()
    for bad in ("feeder", "nonsense=1"):
        with pytest.raises(ValueError):
            HostChaos.from_flag(bad)
    for fleet in ("dispatch=0.1", "feeder=0.2,stall=0.3", "stall_ms=2", "seed=5,dispatch=0.3,stall=0.2,stall_ms=1.5"):
        mine, want = HostChaos.from_flag(fleet), JaxHostChaos.from_flag(fleet)
        assert mine.report() == want.report()
        assert (mine.stall_ms, mine.dispatch_rate, mine.stall_rate) == (want.stall_ms, want.dispatch_rate, want.stall_rate)


class _CountingTracer:
    """The tracer calls the thread-less feeder makes, counted."""

    def __init__(self):
        self.counters, self.spans = {}, []

    def begin(self):
        return 0

    def end(self, phase, t0, dur=None):
        self.spans.append(phase)

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


def test_threadless_feeder_builds_on_demand_and_prefetches():
    """thread=False (the engine's bounded slabs over the budget without
    streaming): get_stage builds the slab at the base where none covers it
    (a miss), prefetch builds the scheduled successor (a hit at the next
    get), a jump of the base builds at the new base, and a death in a
    prefetch is raised, with its slab, by the next get_stage."""
    from kubernetriks_tpu_torch.telemetry.tracer import PH_STAGE_ASSEMBLE, PH_STAGE_PREFETCH, PH_STAGE_PUT

    tracer = _CountingTracer()
    f = _fake_feeder(width=256, depth=2, thread=False)  # stride 160
    assert f.report()["threaded"] is False and f.produced == 0
    assert f.get_stage(0, tracer)[1] == 0
    f.prefetch(tracer)
    f.prefetch(tracer)  # the ring is full: nothing more
    assert f.produced == 2 and f._last_lo == 160
    f.retire(0)
    assert f.get_stage(200, tracer)[1] == 160
    f.retire(160)
    assert f.get_stage(700, tracer)[1] == 700  # the prefetch was not made: a miss at the base
    assert tracer.counters == {"stage_prefetch_miss": 2, "stage_prefetch_hit": 1}
    assert tracer.spans.count(PH_STAGE_PREFETCH) == 1
    assert tracer.spans.count(PH_STAGE_ASSEMBLE) == tracer.spans.count(PH_STAGE_PUT) == 3
    f.close()
    doomed = _fake_feeder(width=256, depth=2, thread=False, chaos=_KillNth({2}))
    doomed.get_stage(0)
    doomed.prefetch()
    doomed.retire(0)
    with pytest.raises(FeederProducerError, match="injected stream-feeder kill") as info:
        doomed.get_stage(200)
    assert info.value.slab_lo == 160


def test_ring_holds_no_more_than_the_whole_payload():
    """The ring's slots are the staging's only device bytes: at the default
    width the composed toy's ring would hold its whole payload, so it is
    one slab of it; an explicit segment keeps its width with at most
    stream_depth slots, one on demand (stride 0)."""
    sim = composed_sim("cpu", 2, pod_window=8, stream=True)
    T = sim.consts.trace_pod_bound
    assert sim._feeder is not None and sim._stage_cols() == T + 8 and sim._stage_tags() == [0]
    sim.step_until_time(400.0)
    staging = sim.staging_bytes()
    assert staging["device_peak_bytes"] <= staging["whole_payload_bytes"] and sim.dispatch_stats["grows"] > 0
    assert sim.telemetry_report()["feeder"]["stalls"]["feeder_not_ready"]["count"] == 0
    sim.close()
    ahead = _streamed(stream_depth=3)
    assert ahead._stage_cols() == 24 and ahead._stage_tags() == [0, 1, 2]
    ahead.step_until_time(400.0)
    # Grown to W = 32: 48 = W + W/2 columns, on demand.
    assert (ahead.pod_window, ahead._stage_cols(), ahead._stage_tags()) == (32, 48, [0])
    ahead.close()


class _KillNth:
    """Chaos that kills exactly the Nth slab builds."""

    def __init__(self, kills):
        self.kills = set(kills)
        self.calls = 0

    def feeder_kill(self):
        self.calls += 1
        return self.calls in self.kills


def _streamed(**kwargs):
    return composed_sim("cpu", 2, pod_window=8, stream=True, stream_segment=24, **kwargs)


def test_supervisor_restarts_and_keeps_the_run(monkeypatch):
    """Two producer deaths mid-run (the first and third slab builds): the
    supervisor restarts the feeder twice, the run equals the run without
    the feeder, and the restarts reach dispatch_stats and the feeder's
    report; past the cap of 5 restarts (every build killed, as
    KTPU_HOST_CHAOS=feeder=1 arms at the build) the error propagates."""
    plain = composed_sim("cpu", 2, pod_window=8)
    plain.step_until_time(400.0)
    sim = _streamed()
    kills = _KillNth({1, 3})
    sim._feeder_chaos = kills
    sim.step_until_time(400.0)
    assert kills.calls >= 4 and sim.dispatch_stats["stage_refills"] >= 3
    assert sim.dispatch_stats["feeder_restarts"] == 2 == sim.telemetry_report()["feeder"]["restarts"]
    assert compare_states(state_to_numpy(plain.state), state_to_numpy(sim.state)) == []
    assert sim.host_syncs == plain.host_syncs
    sim.close()
    monkeypatch.setenv("KTPU_HOST_CHAOS", "seed=3,feeder=1.0")
    doomed = _streamed()
    assert isinstance(doomed._feeder_chaos, HostChaos) and doomed._feeder_chaos.feeder_rate == 1.0
    with pytest.raises(FeederProducerError, match="injected stream-feeder kill"):
        doomed.step_until_time(400.0)
    assert doomed.dispatch_stats["feeder_restarts"] == 6
    doomed.close()
