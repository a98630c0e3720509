#!/usr/bin/env python3
"""Where the port's window time goes on the card.

    python3 profile_main_path.py [--path headline|autoscaler|replay|deep]
        [--windows 20] [--repeats 1] [--route sorted|megakernel|two_kernel]
        [--executor eager|graphs] [--k K] [--pod-window W] [--reclaim on|off]
        [--telemetry on|off] [--package-root DIR]

Builds the headline shape (`chip_smoke.headline_sim`), with `--path
autoscaler` the reference's composed scenario at full width
(`chip_smoke.composed_sim` with FULL_COMPOSED: HPA + cluster autoscaler),
with `--path replay` the full-width Alibaba trace replay
(`chip_smoke.replay_sim` on FULL_REPLAY: one cluster, the sorted cycle
route, the CA on), or with `--path deep` a deep queue past the reference's
shared-memory route gate (deep_sim: 128 clusters of 8 nodes, ~20 480 pods,
K pods per cycle, K = P by default). `--route` overrides the route the
engine chose at build (the tests do the same), so the routes can be timed
on one shape. `--executor` builds the engine with its window graphs
(`graphs`: every piece captured before the warm-up, precompile_pieces) or
without (`eager`: the same pieces launched op by op); left out, the
engine's default (graphs on the card; a checkout that predates the window
executor has only eager windows). `--pod-window W` builds the path with
a sliding pod window of W plain pod slots (the composed line's is 512,
the replay's 4 096): its windows then run through step_until_time, which
slides the window between spans, and a growth inside the timed windows
raises (a repeat could not restore the narrower state). `--reclaim`
builds the autoscaler paths with CA slot reclaim on or off; left out, the
engine's default (on for the card). `--telemetry` builds the path with
the flight recorder armed or not (the ring's record, one kernel a
window); left out, the engine's default (off). Steps to the warm-up time (t=190 s; 590 s on the autoscaler
path, inside its load burst; 43 200 s, mid-day, on the replay; 300 s on
the deep path, ~5 000 pods queued a cluster) and keeps a copy of that
state. Then it runs the same `--windows` windows from it (`install_state`
puts the copy back before each repeat):
  1. untraced, on the host clock, ending in a synchronize, `--repeats`
     times (the first is `host_ms_per_window`, all are listed); with the
     flight recorder armed, each repeat's decisions/s and cluster-windows/s
     go to standard error (telemetry.log_chunk_throughput's line);
  2. traced with torch.profiler (CPU + CUDA), again on the host clock,
     summing device kernel time per name; with the flight recorder armed,
     its spans also open NVTX ranges and record_function scopes named
     after their phase (the tracer's `annotate`), which show among the
     host rows.
The device's idle share is 1 - busy / wall, both from the traced windows;
the untraced wall time of the same windows is printed beside it, and the
difference is the profiler's own cost. Prints one JSON line: host ms per
window (untraced and traced), device busy ms per window, the idle share,
device kernel launches per window, the executor's counts
(`dispatch_stats`, the graph pool's bytes), the top host rows (self CPU
time a window) and the top device ops with their share of busy time. The full key_averages table goes to
profile_<path>_<route>_<executor>[_w<W>].txt in the output directory beside this script (the one
chip_smoke.py writes to). `--package-root` imports the package and
chip_smoke.py from DIR instead of this checkout, so one call on the card
can time two checkouts on the same windows. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _is_kernel(key: str, name: str) -> bool:
    """Whether a profiler row is `name`'s kernel (plain or a template
    instance, with or without its namespace)."""
    return any(f"::{name}{post}" in key or key.startswith(f"{name}{post}") for post in ("(", "<"))


def clone_tree(tree):
    """A copy of a state tree (NamedTuples of tensors), every leaf cloned:
    the engine updates its state in place. Kept here rather than taken from
    the package, since `--package-root` may time a checkout without
    `state.clone_state`."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*[clone_tree(x) for x in tree])
    return tree.clone()


def deep_sim(device, k_pods=None, n_clusters: int = 128, rate: float = 20.48, **engine_kwargs):
    """A deep queue at a batch the dense routes take: 128 clusters of 8
    headline nodes, Poisson pods at 20.48/s for 1000 s (~20 480 pod slots,
    past the reference's shared-memory gate at ~17 900; the headline's
    seed, requests and durations), k_pods pods per cycle (None: every
    slot). Each cluster runs 128 pods at a time, so ~18 pods a second
    queue up."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    config = SimulationConfig.from_yaml("sim_name: deep\nseed: 1\nscheduling_cycle_interval: 10.0")
    return build_batched_from_traces(
        config,
        UniformClusterTrace(8, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
        PoissonWorkloadTrace(
            rate_per_second=rate, horizon=1000.0, seed=3, cpu=4000, ram=8 * 1024**3,
            duration_range=(30.0, 120.0),
        ).convert_to_simulator_events(),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=k_pods, **engine_kwargs,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--path", choices=("headline", "autoscaler", "replay", "deep"), default="headline")
    ap.add_argument("--route", choices=("sorted", "megakernel", "two_kernel"), default=None)
    ap.add_argument("--executor", choices=("eager", "graphs"), default=None)
    ap.add_argument("--k", type=int, default=None, help="pods per cycle on the deep path (default: P)")
    ap.add_argument("--pod-window", type=int, default=0, help="sliding pod window (0: whole-resident)")
    ap.add_argument("--reclaim", choices=("on", "off"), default=None, help="CA slot reclaim (default: the engine's)")
    ap.add_argument("--telemetry", choices=("on", "off"), default=None,
                    help="the flight recorder (default: the engine's, off)")
    ap.add_argument("--package-root", default=str(HERE))
    args = ap.parse_args(argv)

    root = Path(args.package_root).resolve()
    if not (root / "kubernetriks_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"profile_main_path: no kubernetriks_tpu_torch under {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import FULL_COMPOSED, FULL_REPLAY, composed_sim, headline_sim, replay_sim, replay_trace

    if not torch.cuda.is_available():
        print("profile_main_path: needs a CUDA device", file=sys.stderr)
        return 2
    from kubernetriks_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    kw = {} if args.executor is None else {"graphs": args.executor == "graphs"}
    if args.pod_window:
        kw["pod_window"] = args.pod_window
    if args.reclaim:
        kw["reclaim"] = args.reclaim == "on"
    if args.telemetry:
        kw["telemetry"] = args.telemetry == "on"
    build, warm_up = {
        "headline": (lambda: headline_sim("cuda", **kw), 190.0),
        "autoscaler": (lambda: composed_sim("cuda", 256, **FULL_COMPOSED, **kw), 590.0),
        "replay": (lambda: replay_sim("cuda", replay_trace("replay_full", **FULL_REPLAY), **kw), 43200.0),
        "deep": (lambda: deep_sim("cuda", args.k, **kw), 300.0),
    }[args.path]
    sim = build()
    if args.route:
        sim.cycle_route = args.route
    executor = "graphs" if getattr(sim, "graphs", False) else "eager"
    precompile = getattr(sim, "precompile_pieces", None)
    captured = precompile() if precompile else 0
    sim.step_until_time(warm_up)
    torch.cuda.synchronize()
    state0, window0 = clone_tree(sim.state), sim.next_window_idx
    stats0 = dict(getattr(sim, "dispatch_stats", {}))

    n = args.windows
    sliding = getattr(sim, "pod_window", None) is not None
    interval = sim.config.scheduling_cycle_interval

    tracer = getattr(sim, "tracer", None)
    armed = bool(getattr(tracer, "enabled", False))
    annotations = set()
    if armed:
        from kubernetriks_tpu_torch.telemetry import PHASE_NAMES, log_chunk_throughput

        annotations = set(PHASE_NAMES)

        logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(message)s")
        log = logging.getLogger("profile_main_path")

    def decisions() -> int:
        return int(sim.state.metrics.scheduling_decisions.sum())

    def timed_windows(log_throughput: bool = False) -> float:
        grows = sim.dispatch_stats["grows"] if sliding else 0
        before = decisions() if log_throughput else 0
        t0 = time.perf_counter()
        if sliding:
            sim.step_until_time(sim.next_window + (n - 1) * interval)
        else:
            for _ in range(n):
                sim.step_window()
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) * 1e3 / n
        if log_throughput:
            log_chunk_throughput(log, n, sim.n_clusters, decisions() - before, elapsed * n / 1e3)
        if sliding and sim.dispatch_stats["grows"] != grows:
            raise SystemExit("profile_main_path: the pod window grew inside the timed windows; "
                             "take a wider --pod-window or fewer --windows")
        return elapsed

    host_ms = []
    for _ in range(max(1, args.repeats)):
        host_ms.append(timed_windows(log_throughput=armed))
        sim.install_state(state0, window0)
    torch.cuda.synchronize()
    stats = {k: v - stats0[k] for k, v in getattr(sim, "dispatch_stats", {}).items()}
    if armed:
        tracer.annotate = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = timed_windows()
    if armed:
        tracer.annotate = False
    events = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    # Device-side rows (kernels, memcpy, memset) have no host time; the
    # aten rows also report their kernels' time as "self" device time, so
    # summing both would count every kernel twice. The tracer's annotated
    # spans also leave a device-side row, named after the phase, which
    # spans the kernels it launched: not a kernel either.
    kernels = []
    for e in events:
        us = dev_us(e)
        if us > 0 and e.self_cpu_time_total == 0 and e.key not in annotations:
            kernels.append((e.key, us, e.count))
    # Host rows: what the host spends a window on (the planning's CPU ops,
    # the launches, the graph replays).
    host_rows = sorted(
        ((e.key, e.self_cpu_time_total, e.count) for e in events if e.self_cpu_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_us = sum(us for _, us, _ in kernels)
    launches = sum(c for _, _, c in kernels)
    kernels.sort(key=lambda k: -k[1])
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    window = f"_w{args.pod_window}" if args.pod_window else ""
    window += "_reclaim" if getattr(sim, "reclaim", False) else ""
    telemetry = getattr(sim.state, "telemetry", None) is not None
    window += "_telemetry" if telemetry else ""
    (out_dir / f"profile_{args.path}_{sim.cycle_route}_{executor}{window}.txt").write_text(
        events.table(sort_by="self_cuda_time_total", row_limit=60)
    )
    busy_ms = busy_us / 1e3 / n
    print(json.dumps({
        "card": card,
        "path": args.path,
        "windows": n,
        "cycle_route": sim.cycle_route,
        "executor": executor,
        "graphs_captured_up_front": captured,
        "dispatch_stats_timed": stats,
        "graph_pool_bytes": sim.graph_pool_bytes() if hasattr(sim, "graph_pool_bytes") else 0,
        "pod_window": getattr(sim, "pod_window", None),
        "reclaim": getattr(sim, "reclaim", False),
        "telemetry": telemetry,
        "shape": {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods,
                  "real_pods": sim.n_real_pods, "E": sim.max_events_per_window,
                  "K": sim.max_pods_per_cycle},
        "package": str(root),
        "host_ms_per_window": host_ms[0],
        "host_ms_per_window_repeats": host_ms,
        "traced_host_ms_per_window": traced_ms,
        "device_busy_ms_per_window": busy_ms if busy_us > 0 else None,
        "device_idle_share": (1.0 - busy_ms / traced_ms) if busy_us > 0 else None,
        "device_kernels_per_window": launches / n,
        "port_kernels_ms_per_window": {
            name: sum(us for k, us, _ in kernels if _is_kernel(k, name)) / 1e3 / n
            for name in (
                "event_scatter_kernel", "free_resources_kernel", "select_cycle_commit_kernel",
                "ca_scale_down_kernel", "ca_scale_up_kernel", "schedule_cycle_kernel",
                "select_schedule_cycle_kernel", "commit_fill_kernel", "commit_scatter_kernel",
                "telemetry_record_kernel",
            )
        },
        "top_host": [
            {"name": k[:80], "ms_per_window": us / 1e3 / n, "count_per_window": c / n}
            for k, us, c in host_rows[:12]
        ],
        "top": [
            {"name": k[:80], "ms_per_window": us / 1e3 / n, "count_per_window": c / n,
             "share_of_busy": us / busy_us}
            for k, us, c in kernels[:15]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
