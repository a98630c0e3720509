#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetriks_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from ops/csrc with nvcc, timed;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     inputs captured from the main path at its own shapes (1024 clusters x
     256 nodes, the run's pod and event widths, K = 64); device times of
     the kernel and, where one exists, of a single PyTorch library call as
     a yardstick (timed only; both from CUDA-graph replays between CUDA
     events), and the plain version's time on the CUDA clock;
  4. the main path — the headline bench shape: 1024 uniform clusters of 256
     nodes (64 000 mCPU, 128 GiB), Poisson pods at 2/s for 1000 s (seed 3,
     4000 mCPU, 8 GiB, 30-120 s), default profile, 64 pods per cycle;
     build, step to 190 s, then 200 s steps to 1200 s; decisions, rate,
     windows, host syncs per window and each kernel's launch count, with
     conservation checks on the final state;
  5. card against CPU: a 300 s trace with a node removal at C=8, N=16, run
     through the kernels on the card and through the plain path on the CPU,
     final states equal under compare_states.
It prints the kernels' JSON line, then the device JSON line last. Without a
CUDA device, or without the package beside it, it exits 2 and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50 * 1024**2  # H100 L2 cache
OUT_DIR = HERE / "chiprun_out"


def headline_sim(device, n_clusters: int = 1024, n_nodes: int = 256):
    """The reference's headline bench shape (`bench.py:92` `run_shape`):
    n_clusters uniform clusters of n_nodes nodes (64 000 mCPU, 128 GiB),
    Poisson pods at 2/s for 1000 s (seed 3, 4000 mCPU, 8 GiB, 30-120 s),
    default profile, 64 pods per cycle. profile_main_path.py uses it too."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    config = SimulationConfig.from_yaml("sim_name: bench\nseed: 1\nscheduling_cycle_interval: 10.0")
    return build_batched_from_traces(
        config,
        UniformClusterTrace(n_nodes, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
        PoissonWorkloadTrace(
            rate_per_second=2.0, horizon=1000.0, seed=3, cpu=4000, ram=8 * 1024**3,
            duration_range=(30.0, 120.0),
        ).convert_to_simulator_events(),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=64,
    )


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def graph_ms(fns, inner: int = 12, reps: int = 5) -> float:
    """Device time of one call: `inner` calls, cycling through `fns` (the
    same call on different input copies), captured in a CUDA graph and
    replayed `reps` times between CUDA events. Without the graph a short
    kernel's time would be the host's launch cost (the wrapper's checks and
    allocations take longer than the kernel runs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(inner):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Time of one call of `fn` on the CUDA clock, host launch cost
    included: for the plain versions, whose loops read counts back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_inputs(step_mod, names):
    """Wrap the step module's kernel wrappers so the last call's arguments
    are kept (the port never updates a tensor in place, so references
    suffice)."""
    captured = {}
    originals = {n: getattr(step_mod, n) for n in names}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            captured[name] = (args, kwargs)
            return fn(*args, **kwargs)

        return wrapped

    for n, fn in originals.items():
        setattr(step_mod, n, recorder(n, fn))

    def restore():
        for n, fn in originals.items():
            setattr(step_mod, n, fn)

    return captured, restore


def max_abs_err(outs_a, outs_b) -> float:
    err = 0.0
    for a, b in zip(outs_a, outs_b):
        if a.dtype == torch.bool:
            a, b = a.to(torch.int32), b.to(torch.int32)
        a = a.to(torch.float64)
        b = b.to(torch.float64)
        both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
        d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def outputs_agree(outs_k, outs_p, stats_idx) -> bool:
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if i == stats_idx:
            if not torch.allclose(a, b, rtol=1e-6, atol=0.0, equal_nan=False):
                return False
        elif not torch.equal(a, b):
            return False
    return True


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not (HERE / "kubernetriks_tpu_torch" / "ops" / "csrc").is_dir():
        fail("the kubernetriks_tpu_torch package is not beside this script", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)", 2)
    sys.path.insert(0, str(HERE))
    OUT_DIR.mkdir(exist_ok=True)

    # --- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    # --- 2. build -----------------------------------------------------------
    from kubernetriks_tpu_torch.ops import _build
    from kubernetriks_tpu_torch.ops import scheduler_kernel as sk

    build_s = _build.build_all()
    print(f"phase 2: kernels built in {build_s:.2f} s", flush=True)
    with open(OUT_DIR / "ptxas.txt", "w") as f:
        for name, log in _build.build_log.items():
            f.write(f"--- {name}\n{log}\n")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
    for name in _build.KERNELS:
        _build.kernel(name)

    # --- 3. kernels against their plain versions -----------------------------
    from kubernetriks_tpu_torch.batched import step as step_mod

    names = ["fused_event_scatter", "fused_free_resources", "fused_select_cycle_commit"]
    sim = headline_sim(dev)
    captured, restore = capture_inputs(step_mod, names)
    sim.step_until_time(190.0)
    restore()
    torch.cuda.synchronize()
    print(
        f"phase 3: shapes C={sim.n_clusters} N={sim.n_nodes} P={sim.n_pods} "
        f"E={sim.max_events_per_window} K={sim.max_pods_per_cycle}",
        flush=True,
    )
    report = {}

    def copies_of(args):
        """Enough copies of a call's inputs that cycling through them
        overruns the 50 MB L2 cache, as the main path's launches do (their
        inputs are a window's fresh tensors)."""
        size = nbytes([a for a in args if isinstance(a, torch.Tensor)])
        n = max(1, -(-2 * L2_BYTES // max(size, 1)))
        return [args] + [
            tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            for _ in range(n - 1)
        ]

    def check_kernel(name, kernel_fn, plain_fn, args, kwargs, stats_idx, library, need_bytes, ops):
        outs_k = kernel_fn(*args, **kwargs)
        torch.cuda.synchronize()
        outs_p = plain_fn(*args, **kwargs)
        torch.cuda.synchronize()
        err = max_abs_err(outs_k, outs_p)
        if not outputs_agree(outs_k, outs_p, stats_idx):
            fail(f"{name}: kernel disagrees with its plain version (max abs err {err})")
        sets = copies_of(args)
        ms = graph_ms([lambda a=a: kernel_fn(*a, **kwargs) for a in sets])
        plain_ms = cuda_ms(lambda: plain_fn(*args, **kwargs), reps=3, warmup=1)
        library_ms = graph_ms([library(a) for a in sets]) if library else None
        bytes_s = need_bytes / HBM_BYTES_PER_S
        ops_s = ops / FP32_OPS_PER_S
        report[name] = {
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms,
            "bytes": need_bytes,
            "ops": ops,
        }
        lib = f"{library_ms:.4f}" if library_ms is not None else "n/a"
        print(
            f"  {name}: agrees with its plain version (tolerance: outputs exact, stats rows "
            f"rtol 1e-6; max abs err {err}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {report[name]['bound_ms']:.4f} ms "
            f"({report[name]['bound_by']}: {need_bytes} B, {ops} ops)",
            flush=True,
        )

    # Bounds count what this run's data needs: every byte of each input
    # the function must read (a row it only consults where a mask is set
    # counts only there) and every output byte, once.

    # Event scatter. Yardstick: one scatter_reduce_ "amin" of the pod
    # create times (the largest of the five accumulators).
    args, kwargs = captured["fused_event_scatter"]
    ev_kind, ev_slot, ev_valid = args[0], args[1], args[4]
    C, N = args[5].shape
    P = args[7].shape[1]
    n_valid = int(ev_valid.sum())

    def event_library(a):
        cp = a[4] & (a[0] == sk.EV_CREATE_POD) & (a[1] >= 0) & (a[1] < P)
        acc = torch.cat([a[7], torch.full_like(a[7][:, :1], float("inf"))], dim=1)
        idx = torch.where(cp, a[1], P).long()
        return lambda: acc.clone().scatter_reduce_(1, idx, a[2], "amin")

    check_kernel(
        "fused_event_scatter", sk.fused_event_scatter, sk.event_scatter_plain, args, kwargs, -1,
        event_library,
        ev_valid.numel() + 16 * n_valid + 2 * C * (5 * N + 12 * P),
        n_valid,
    )
    # Free resources. Yardstick: one scatter_add_ of the cpu requests.
    args, kwargs = captured["fused_free_resources"]
    freed, finishes = args[0], args[4]
    C, N = args[6].shape
    n_freed = int(freed.sum())
    n_fin = int((freed & finishes).sum())

    def free_library(a):
        idx = torch.where(a[0] & (a[1] >= 0) & (a[1] < N), a[1], N).long()
        src = torch.where(a[0], a[2], 0)
        acpu = torch.cat([a[6], torch.zeros_like(a[6][:, :1])], dim=1)
        return lambda: acpu.clone().scatter_add_(1, idx, src)

    check_kernel(
        "fused_free_resources", sk.fused_free_resources, sk.free_resources_plain, args, kwargs, 2,
        free_library,
        freed.numel() + 13 * n_freed + 4 * n_fin + 16 * C * N + 20 * C,
        5 * n_fin + 2 * n_freed,
    )
    # Megakernel; no single library call computes it. Per pick: three key
    # compares per remaining eligible pod, ~16 operations per node (fit,
    # score, argmax).
    args, kwargs = captured["fused_select_cycle_commit"]
    eligible = args[3]
    C, N = args[1].shape
    P = eligible.shape[1]
    K = kwargs["k_pods"]
    elig = eligible.sum(dim=1).to(torch.int64)
    picks = torch.clamp(elig, max=K)
    n_picks = int(picks.sum())
    scanned = int((picks * elig - picks * (picks - 1) // 2).sum())
    check_kernel(
        "fused_select_cycle_commit", sk.fused_select_cycle_commit, sk.select_cycle_commit_plain,
        args, kwargs, 6, None,
        eligible.numel() + 12 * int(elig.sum()) + 24 * n_picks + 9 * C * N + 8 * C * P
        + 8 * C * N + 16 * C * P + 20 * C,
        3 * scanned + 16 * N * n_picks,
    )
    del sim, captured

    # --- 4. the main path ----------------------------------------------------
    sim = headline_sim(dev)
    sk.reset_launches()
    sim.step_until_time(190.0)
    before = sim.decisions_total()
    syncs0, windows0 = sim.host_syncs, sim.windows_run
    t0 = time.perf_counter()
    end = 390.0
    while end <= 1200.0:
        sim.step_until_time(end)
        end += 200.0
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    windows = sim.windows_run - windows0
    syncs_per_window = (sim.host_syncs - syncs0) / max(windows, 1)
    total = sim.decisions_total()
    decisions = total - before
    print(
        f"phase 4: decisions {total} (timed {decisions} in {elapsed:.3f} s = "
        f"{decisions / elapsed:.1f} decisions/s), windows {sim.windows_run} "
        f"(timed {windows}, {1e3 * elapsed / max(windows, 1):.3f} ms/window), "
        f"host syncs per window {syncs_per_window:.3f}, launches {launches}",
        flush=True,
    )
    if total <= 0:
        fail("the main path made no scheduling decision")
    for name in names:
        if launches[name] <= 0:
            fail(f"the main path never launched {name}")
    # Conservation: every node's used capacity is the sum of the requests
    # of the pods running on it; every cluster (same trace) ends identical.
    st = sim.state
    C, Nn = st.nodes.alloc_cpu.shape
    running = st.pods.phase == 3
    flat = (torch.arange(C, device=dev)[:, None] * Nn + st.pods.node.clamp(min=0)).reshape(-1)
    for req, cap, alloc in (
        (st.pods.req_cpu, st.nodes.cap_cpu, st.nodes.alloc_cpu),
        (st.pods.req_ram, st.nodes.cap_ram, st.nodes.alloc_ram),
    ):
        used = torch.bincount(
            flat, weights=torch.where(running, req, 0).reshape(-1).to(torch.float64), minlength=C * Nn
        ).reshape(C, Nn)
        if not torch.equal(used, (cap - alloc).to(torch.float64)):
            fail("allocatable does not equal capacity minus the running pods' requests")
        if bool((alloc < 0).any()):
            fail("negative allocatable")
    for leaf in (st.pods.phase, st.pods.node, st.pods.start_time.off, st.nodes.alloc_cpu):
        if not bool((leaf == leaf[:1]).all()):
            fail("clusters replaying the same trace diverged")
    for est in (st.metrics.queue_time, st.metrics.pod_duration):
        if not bool(torch.isfinite(est.total).all()):
            fail("non-finite estimator sums")
    print("phase 4: state checks passed", flush=True)
    main_path = {
        "decisions": total,
        "timed_decisions": decisions,
        "timed_seconds": elapsed,
        "decisions_per_s": decisions / elapsed,
        "windows": sim.windows_run,
        "timed_windows": windows,
        "host_syncs_per_window": syncs_per_window,
        "launches": launches,
    }
    del sim, st

    # --- 5. card against CPU ---------------------------------------------------
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.convert import state_to_numpy
    from kubernetriks_tpu_torch.core.events import RemoveNodeRequest
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    config = SimulationConfig.from_yaml(
        "sim_name: smoke\nseed: 1\nscheduling_cycle_interval: 10.0\n"
        "as_to_ps_network_delay: 0.05\nps_to_sched_network_delay: 0.01\n"
        "sched_to_as_network_delay: 0.02\nas_to_node_network_delay: 0.15\n"
    )
    cluster = UniformClusterTrace(16, cpu=16000, ram=32 * 1024**3).convert_to_simulator_events()
    cluster.append((120.0, RemoveNodeRequest(node_name="gen_node_3")))
    workload = PoissonWorkloadTrace(
        rate_per_second=2.0, horizon=300.0, seed=5, cpu=4000, ram=8 * 1024**3,
        duration_range=(30.0, 120.0),
    ).convert_to_simulator_events()
    finals = {}
    for where in ("cuda", "cpu"):
        s = build_batched_from_traces(
            config, list(cluster), list(workload), n_clusters=8, device=where, max_pods_per_cycle=64,
        )
        s.step_until_time(400.0)
        finals[where] = (state_to_numpy(s.state), s.metrics_summary()["counters"])
    bad = compare_states(finals["cuda"][0], finals["cpu"][0])
    if bad:
        fail(f"card and CPU states differ at {bad}")
    counters = finals["cuda"][1]
    if counters["scheduling_decisions"] <= 0 or counters["pods_succeeded"] <= 0:
        fail(f"phase 5 run made no progress: {counters}")
    print(f"phase 5: card == CPU under compare_states ({counters})", flush=True)

    kernels = []
    meta = {
        "fused_event_scatter": ("event_scatter.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:671"),
        "fused_free_resources": ("free_resources.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:513"),
        "fused_select_cycle_commit": ("select_cycle_commit.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:1139"),
    }
    for name in names:
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"kubernetriks_tpu_torch/ops/csrc/{meta[name][0]}",
            "replaces": meta[name][1],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump({"card": smi, "build_s": build_s, "kernels": kernels, "main_path": main_path}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
