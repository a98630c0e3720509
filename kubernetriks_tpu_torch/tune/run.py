"""The autotuner's command line: the real sweep over the knob registry on the
composed line, or the pinned fake grid, then the profile written and
loaded back build-identical.

    python -m kubernetriks_tpu_torch.tune [--device cpu] [--fake]
        [--budget N] [--clusters C] [--json PATH]

Prints one JSON record (`metric`, `tune`, `value` in ms a window, `unit`).
The counterpart of the reference bench's `--tune` / `--tune-fake` lines
(`bench.py:1727` `run_tune`, `:1856` `run_tune_fake`,
`_tune_roundtrip_check`), kept out of any bench module: a bench can wrap
`run_tune` / `run_tune_fake` in its own lines.

On the card (the default device) the geometry is the composed line at
full width through its sliding pod window: 256 clusters of 32 nodes with
the CA's 64 slots (N = 96), pods at 1.5/s for 1 000 s beside one HPA
group of at most 64, K = 64, pod_window=512; timed from the first slide
after 590 s to 1 190 s in 100 s spans. With `--device cpu` it is the
reference's smoke cut of the same line (4 clusters of 8 nodes, 0.375/s
for 500 s, K = 64, pod_window=64; 40 s spans from 290 s to 490 s), which
runs a whole sweep in seconds.

The profile lands at artifacts/tuned/<cuda|cpu>_<C>x<N>.json under the
working directory (or `--json PATH`); an existing profile for the same
device type and C there is the resume cache, so a budgeted run
(`--budget`, KTPU_TUNE_BUDGET) continues where the last one stopped.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Callable, Dict, Optional

# The composed line's HPA pod group (the reference bench's
# COMPOSED_GROUP_YAML): 8 initial pods of 8 000 mCPU / 16 GiB, a load model
# of three phases that scales the group up and down again.
COMPOSED_GROUP_YAML = """events:
- timestamp: 49.5
  event_type:
    !CreatePodGroup
      pod_group:
        name: grp
        initial_pod_count: 8
        max_pod_count: {max_pods}
        pod_template:
          metadata: {{name: grp}}
          spec:
            resources:
              requests: {{cpu: 8000, ram: 17179869184}}
              limits: {{cpu: 8000, ram: 17179869184}}
        target_resources_usage: {{cpu_utilization: 0.5}}
        resources_usage_model_config:
          cpu_config:
            model_name: pod_group
            config: |
              - duration: {d1}
                total_load: 4.0
              - duration: {d2}
                total_load: 24.0
              - duration: {d3}
                total_load: 2.0
"""

COMPOSED_CONFIG_YAML = """
sim_name: bench_composed
seed: 1
scheduling_cycle_interval: 10.0
horizontal_pod_autoscaler:
  enabled: true
cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: {n_nodes}
  node_groups:
  - node_template:
      metadata: {{name: ca_node}}
      status: {{capacity: {{cpu: 64000, ram: 137438953472}}}}
"""

# Per device: the composed line's shape, the shared build arguments, the
# cluster count and the span protocol (module note).
GEOMETRY = {
    "cuda": {
        "shape": dict(n_nodes=32, rate_per_second=1.5, horizon=1000.0, max_group_pods=64, burst=(300.0, 300.0, 400.0)),
        "build": dict(max_pods_per_cycle=64, max_ca_pods_per_cycle=64, max_pods_per_scale_down=8, pod_window=512),
        "n_clusters": 256,
        "protocol": dict(warm_until=590.0, t_end=1190.0, step=100.0),
    },
    "cpu": {
        "shape": dict(n_nodes=8, rate_per_second=0.375, horizon=500.0, max_group_pods=16, burst=(100.0, 150.0, 250.0)),
        "build": dict(max_pods_per_cycle=64, max_ca_pods_per_cycle=64, max_pods_per_scale_down=8, pod_window=64),
        "n_clusters": 4,
        "protocol": dict(warm_until=290.0, t_end=490.0, step=40.0),
    },
}

# The fake grid's pinned bonus table: a winner off the defaults on both
# devices (the two-kernel route and the razor).
FAKE_BONUSES = {"megakernel": {False: 5.0}, "window_razor": {True: 3.0}}


def composed_inputs(n_nodes: int, *, rate_per_second: float, horizon: float, max_group_pods: int, burst: tuple):
    """The composed line's (config, cluster events, workload events), the
    reference bench's `_composed_inputs` (`bench.py:198`): n_nodes uniform
    nodes of 64 000 mCPU / 128 GiB, Poisson plain pods (seed 3, 16 000 mCPU
    / 32 GiB, 30-120 s) beside one HPA pod group, and the CA allowed
    n_nodes nodes of the 64 000 mCPU template."""
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
    from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

    config = SimulationConfig.from_yaml(COMPOSED_CONFIG_YAML.format(n_nodes=n_nodes))
    cluster = UniformClusterTrace(n_nodes, cpu=64000, ram=128 * 1024**3)
    plain = PoissonWorkloadTrace(
        rate_per_second=rate_per_second, horizon=horizon, seed=3, cpu=16000, ram=32 * 1024**3,
        duration_range=(30.0, 120.0), name_prefix="plain",
    )
    group = GenericWorkloadTrace.from_yaml(
        COMPOSED_GROUP_YAML.format(max_pods=max_group_pods, d1=burst[0], d2=burst[1], d3=burst[2])
    ).convert_to_simulator_events()
    workload = sorted(plain.convert_to_simulator_events() + group, key=lambda e: e[0])
    return config, cluster.convert_to_simulator_events(), workload


def roundtrip_check(config, cluster_events, workload, *, device, n_clusters: int, statics, build_kwargs):
    """The written profile's round-trip gate: an engine built from the
    profile FILE must resolve exactly the statics an engine built from the
    hand-passed arguments resolves (`tuning_statics()`). Builds without
    stepping (the statics are a build-time affair); returns (n_nodes, the
    hand table, a check(profile path) callable) so the caller can write
    the profile once N is known."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces

    sim_hand = build_batched_from_traces(
        config, cluster_events, workload, n_clusters=n_clusters, device=device,
        tuned_profile=False, **statics, **build_kwargs,
    )
    hand = sim_hand.tuning_statics()
    n_nodes = sim_hand.n_nodes
    sim_hand.close()

    def check(profile_file: str) -> None:
        sim_prof = build_batched_from_traces(
            config, cluster_events, workload, n_clusters=n_clusters, device=device,
            tuned_profile=profile_file, **build_kwargs,
        )
        got = sim_prof.tuning_statics()
        sim_prof.close()
        if got != hand:
            raise AssertionError(
                f"tuned profile {profile_file} did not load back build-identical: the profile build resolved "
                f"{got}, the hand-passed statics {hand}"
            )

    return n_nodes, hand, check


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _resume(device_type: str, n_clusters: int, json_path: Optional[str], log: Callable[[str], None]):
    """The candidates of an existing profile for this device type and C
    (N is unknown before the first build, hence the glob), or None. An
    unreadable profile is disclosed and the sweep starts fresh."""
    from kubernetriks_tpu_torch.tune.profile import ARTIFACT_DIR, load_profile

    pattern = json_path or os.path.join(ARTIFACT_DIR, f"{device_type}_{n_clusters}x*.json")
    for path in sorted(glob.glob(pattern)):
        try:
            resume = load_profile(path).doc.get("candidates")
        except (ValueError, OSError) as exc:
            log(f"tune: ignoring unreadable profile {path}: {exc}")
            continue
        log(f"tune: resuming from {path} ({len(resume or [])} cached candidates)")
        return resume
    return None


def run_tune(
    device=None,
    *,
    budget: Optional[int] = None,
    n_clusters: Optional[int] = None,
    json_path: Optional[str] = None,
    log: Callable[[str], None] = _stderr,
) -> Dict[str, object]:
    """The REAL measurement-driven sweep (tune/) over the registry on the
    composed line at the device's geometry (module note): staged
    coordinate descent, bench-protocol measurements (>= 5 valid spans a
    candidate, a recompile sentinel sealed after each warm-up, whole-grid
    bit-identity), the observatory objective; the profile written
    (resumable) and checked to load back build-identical. Returns
    {"value": the chosen objective, "tune": the disclosure}."""
    from kubernetriks_tpu_torch.batched.engine import resolve_device
    from kubernetriks_tpu_torch.flags import flag_int
    from kubernetriks_tpu_torch.tune.measure import BenchMeasurementBackend
    from kubernetriks_tpu_torch.tune.profile import profile_path, save_profile
    from kubernetriks_tpu_torch.tune.search import profile_doc, staged_coordinate_descent

    device = resolve_device(device)
    geo = GEOMETRY[device.type]
    if budget is None:
        budget = flag_int("KTPU_TUNE_BUDGET")
    C = int(n_clusters or geo["n_clusters"])
    config, cluster_events, workload = composed_inputs(**geo["shape"])
    be = BenchMeasurementBackend(
        config, cluster_events, workload, n_clusters=C, device=device,
        build_kwargs=dict(geo["build"]), **geo["protocol"],
    )
    result = staged_coordinate_descent(
        be, budget=budget, resume_candidates=_resume(device.type, C, json_path, log), log=log,
    )
    n_nodes, _, check = roundtrip_check(
        config, cluster_events, workload, device=device, n_clusters=C, statics=result.chosen,
        build_kwargs=geo["build"],
    )
    path = json_path or profile_path(device.type, C, n_nodes)
    proto = geo["protocol"]
    doc = profile_doc(
        result, backend=device.type, n_clusters=C, n_nodes=n_nodes, budget=budget,
        protocol=(
            f"composed line, {C} clusters, {geo['build']}: warm to {proto['warm_until']} s and through the first "
            f"slide, every piece captured, >= 5 valid {proto['step']} s spans to {proto['t_end']} s, zero-decision "
            "spans dropped, recompile sentinel sealed a candidate, no growth in the timed spans, whole-grid "
            "final-state bit-identity against the first candidate; objective = observatory tuning_objective over "
            "the timed spans"
        ),
    )
    save_profile(doc, path)
    check(path)
    baseline_obj = result.baseline["objective"]
    return {
        "value": result.objective,
        "tune": {
            "backend": device.type,
            "profile": path,
            "geometry": {"n_clusters": C, "n_nodes": n_nodes},
            "chosen": result.chosen,
            "objective": result.objective,
            "baseline": result.baseline["statics"],
            "baseline_objective": baseline_obj,
            "ab_vs_default_frac": round(result.objective / baseline_obj, 4) if baseline_obj else None,
            "candidates": len(result.candidates),
            "measured": result.measured,
            "reused": result.reused,
            "complete": result.complete,
            "fingerprints": sorted({str(c.get("fingerprint")) for c in result.candidates}),
            # Allocated device bytes of each new measurement (the card's):
            # before its build, its peak, after its engine is dropped.
            "device_memory": be.memory,
            # Each new measurement's float32 metric leaves that are not bit
            # for bit the first candidate's, with their max relative change.
            "metric_drift": be.metric_drift,
            "roundtrip_build_identical": True,
            "measurement": "bench",
        },
    }


def run_tune_fake(device=None, *, n_clusters: Optional[int] = None, json_path: Optional[str] = None) -> Dict:
    """The fake-backend grid: the whole staged coordinate descent driven by
    the PINNED FakeMeasurementBackend (FAKE_BONUSES, so the winner is
    known), then the real persistence and build seam end to end: the
    profile written (its geometry from a real engine build of the
    composed line at the device's shape) and checked to load back
    build-identical. No timings: this line gates the plumbing."""
    from kubernetriks_tpu_torch.batched.engine import resolve_device
    from kubernetriks_tpu_torch.tune.measure import FakeMeasurementBackend
    from kubernetriks_tpu_torch.tune.profile import profile_path, save_profile
    from kubernetriks_tpu_torch.tune.search import profile_doc, staged_coordinate_descent

    device = resolve_device(device)
    geo = GEOMETRY[device.type]
    C = int(n_clusters or geo["n_clusters"])
    result = staged_coordinate_descent(FakeMeasurementBackend(FAKE_BONUSES, device_type=device.type))
    want = {name: max(table, key=table.get) for name, table in FAKE_BONUSES.items()}
    if any(result.chosen[k] != v for k, v in want.items()):
        raise AssertionError(f"fake tune grid: the pinned bonus table makes {want} the winner, got {result.chosen}")
    config, cluster_events, workload = composed_inputs(**geo["shape"])
    n_nodes, _, check = roundtrip_check(
        config, cluster_events, workload, device=device, n_clusters=C, statics=result.chosen,
        build_kwargs=geo["build"],
    )
    doc = profile_doc(
        result, backend=device.type, n_clusters=C, n_nodes=n_nodes,
        protocol="FakeMeasurementBackend pinned grid (plumbing gate)",
    )
    path = save_profile(doc, json_path or profile_path(device.type, C, n_nodes))
    check(path)
    return {
        "value": result.objective,
        "tune": {
            "backend": device.type,
            "profile": path,
            "geometry": {"n_clusters": C, "n_nodes": n_nodes},
            "chosen": result.chosen,
            "objective": result.objective,
            "baseline": result.baseline["statics"],
            "baseline_objective": result.baseline["objective"],
            "candidates": len(result.candidates),
            "measured": result.measured,
            "reused": result.reused,
            "complete": result.complete,
            "roundtrip_build_identical": True,
            "measurement": "fake",
        },
    }


def record(metric: str, out: Dict) -> Dict[str, object]:
    """The command line's JSON record: the unit is ms a window (the objective the
    sweep minimizes), the sweep's disclosure under `tune`."""
    return {"metric": metric, "tune": out["tune"], "value": round(out["value"], 4), "unit": "ms/window"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetriks_tpu_torch.tune",
        description="Sweep the port's performance statics on the composed line and write a tuned profile.",
    )
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--fake", action="store_true", help="the pinned fake grid: plumbing only, no timings")
    parser.add_argument("--budget", type=int, default=None, help="new measurements at most (KTPU_TUNE_BUDGET)")
    parser.add_argument("--clusters", type=int, default=None, help="cluster count (default: the device's geometry)")
    parser.add_argument("--json", default=None, help="profile path (default: artifacts/tuned/<device>_<C>x<N>.json)")
    args = parser.parse_args(argv)
    if args.fake:
        out = run_tune_fake(args.device, n_clusters=args.clusters, json_path=args.json)
        metric = "tuned statics objective (fake-backend grid + profile round trip, plumbing gate)"
    else:
        out = run_tune(args.device, budget=args.budget, n_clusters=args.clusters, json_path=args.json)
        metric = "tuned statics objective (measurement-driven sweep over the knob registry, composed line)"
    print(json.dumps(record(metric, out)), flush=True)
    return 0
