"""One traced stretch of the window under torch.profiler (CPU and CUDA
activities), reduced to what the per-layer readers and the result's
`device` and `breakdown` need. profile_main_path.py's arithmetic: busy is
the union of the device's activity intervals (kernels, copies, fills),
idle the rest of the traced wall time.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

# CUDA runtime calls in which the host waits for the device.
HOST_WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")
# The harness's record_function ranges (drivers name theirs "kbench.*").
ANNOTATION = "kbench."
# How far back from a gap the search for the host event covering it looks.
LOOKBACK = 4096


class Event(NamedTuple):
    name: str
    start_ns: int
    duration_ns: int
    on_device: bool
    thread: int
    annotation: bool


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, the merged intervals) of (start, end) pairs."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def reduce(events: List[Event], wall_s: float) -> Dict:
    """The trace's numbers: busy (the union of device activity), device
    activities by name, the stepping thread's time in host waits, and the
    longest idle gaps by the innermost host event of the stepping thread
    (the one that opened the harness's ranges) that covers each."""
    stepping = {e.thread for e in events if not e.on_device and e.name.startswith(ANNOTATION)}
    device: List[Tuple[int, int]] = []
    by_name: Dict[str, List[int]] = defaultdict(list)
    host_ops: List[Tuple[int, int, str]] = []
    waits_ns = 0
    for e in events:
        if e.annotation or e.name.startswith(ANNOTATION):
            continue  # ranges, which the trace also draws on the device's row
        if e.on_device:
            device.append((e.start_ns, e.start_ns + e.duration_ns))
            by_name[e.name].append(e.duration_ns)
        elif e.thread in stepping:
            host_ops.append((e.start_ns, e.start_ns + e.duration_ns, e.name))
            if e.name.startswith(HOST_WAITS):
                waits_ns += e.duration_ns
    if not device:
        raise SystemExit("kbench: the profiler saw no device activity")
    busy_ns, merged = _union(device)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)
    host_ops.sort()
    starts = [s for s, _, _ in host_ops]

    def doing(t0: int, t1: int) -> str:
        mid = (t0 + t1) // 2
        best = None
        hi = bisect.bisect_right(starts, mid)
        for s, e, name in host_ops[max(0, hi - LOOKBACK):hi]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "(host, outside any traced op)"

    idle_by: Dict[str, float] = defaultdict(float)
    for g, s, e in gaps[:200]:
        idle_by[doing(s, e)] += g / 1e9
    top_ops = sorted(((n, sum(d) / 1e9) for n, d in by_name.items()), key=lambda x: -x[1])[:10]
    return {
        "window_s": wall_s,
        "busy_s": busy_ns / 1e9,
        "device_events": len(device),
        "kernels": {n: (len(d), sum(d) / 1e9) for n, d in by_name.items()},
        "host_wait_s": waits_ns / 1e9,
        "breakdown": {
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": [[n, s] for n, s in sorted(idle_by.items(), key=lambda x: -x[1])[:10]],
        },
    }


def traced(torch, run: Callable[[], None]) -> Dict:
    """Run `run()` under the profiler and reduce its events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [Event(e.name(), e.start_ns(), e.duration_ns(), e.device_type() == cuda, e.start_thread_id(),
                    e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    return reduce(events, wall)
