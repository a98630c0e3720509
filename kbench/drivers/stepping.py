"""The stepping driver: a study that advances every lane of one engine
through spans of scheduling windows and polls its progress after each.

Set-up (all of it in `setup_s`): the generator draws the inputs from the
seed, the program builds its engine on them (with per-lane scenarios
where the traffic gives them), captures every window piece
(`precompile_pieces`) and steps to the warm-up time, then one span more,
so that the window's first span finds everything built.

The window: spans of `span_windows` scheduling windows, each ended by one
host read of every lane's decisions counter after a synchronize (what a
polling study, an RL learner or a what-if client blocks on), until
`--seconds` have passed. A traced run (--trace 1) runs `trace_spans`
spans under torch.profiler instead.

Outputs: the pods the program holds resident and the counters of
`check_lanes` lanes drawn from the seed, read once the window has closed;
`check()` runs the plain reference over the same lanes to the same time
and compares (reference/compare.py).
"""

from __future__ import annotations

import concurrent.futures
import gc
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from kbench import trace_reader
from kbench.reference import compare, replay
from kbench.tracegen import common

# The share of the trace's horizon past which a window may not run: the
# Alibaba arrivals stop there, and a window past it would measure a
# thinning load.
HORIZON_GUARD = 0.8


def draw_scenario(spec: Dict, lanes: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Per-lane scenario vectors from the traffic's `scenario` block:
    {key: {"uniform": [lo, hi]} | {"integers": [lo, hi]} (inclusive) |
    {"choice": [...]}}."""
    out = {}
    for key, law in sorted(spec.items()):
        (kind, arg), = law.items()
        if kind == "uniform":
            out[key] = rng.uniform(arg[0], arg[1], size=lanes)
        elif kind == "integers":
            out[key] = rng.integers(arg[0], arg[1] + 1, size=lanes)
        elif kind == "choice":
            out[key] = rng.choice(np.asarray(arg), size=lanes)
        else:
            raise ValueError(f"unknown scenario law {kind!r} for {key!r}")
    return out


def check_lanes(rng: np.random.Generator, lanes: int, k: int) -> List[int]:
    """`k` lanes to check, one drawn uniformly from each of k equal blocks
    of the batch: a fault that leaves a contiguous part of the batch
    behind cannot hide between them."""
    k = min(k, lanes)
    edges = np.linspace(0, lanes, k + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]


def draw(spec: Dict, seed: int, out_dir: str):
    """What a run draws from its seed, in this order: the inputs (written
    under `out_dir`), the per-lane scenario (None where the traffic gives
    none) and the lanes to check. The control (reference/control.py)
    draws through here too, so it judges the lanes and inputs a run does."""
    config, tr = spec["config"], spec["traffic"]
    lanes = int(tr["lanes"])
    inputs = common.generator(config["generator"]).Inputs(config, seed, float(tr["trace_days"]), out_dir)
    rng = np.random.default_rng([seed, 1])
    scenario = draw_scenario(tr["scenario"], lanes, rng) if tr.get("scenario") else None
    return inputs, scenario, check_lanes(rng, lanes, int(tr["check_lanes"]))


def lane_scenario(scenario, lane: int):
    """One lane's scenario values, as the reference takes them."""
    return None if scenario is None else {k: v[lane].item() for k, v in scenario.items()}


class Run:
    def __init__(self, spec: Dict, args, process_start: float, device: str = "cuda") -> None:
        import torch

        self.torch = torch
        self.device = device
        self.args = args
        self.t_process = process_start
        self.spec = spec
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.sim = None
        self.attempted = 0
        self.failed = 0
        self.spans_s: List[float] = []
        self.trace = None
        self.tmp = tempfile.mkdtemp(prefix="kbench-")

    # --- set-up ---------------------------------------------------------

    def setup(self) -> None:
        tr = self.traffic
        seed = self.args.seed
        lanes = int(tr["lanes"])
        t0 = time.perf_counter()
        self.inputs, self.scenario, self.check_lanes = draw(self.spec, seed, os.path.join(self.tmp, "inputs"))
        kwargs = dict(self.config.get("engine", {}))
        kwargs.update(tr.get("engine", {}))
        if self.scenario is not None:
            kwargs["scenario"] = self.scenario
        self.sim = sim = self.inputs.program_simulation(lanes, self.device, kwargs)
        self.sync()
        self.trace_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.device == "cuda":
            sim.precompile_pieces()
        self.sync()
        self.capture_s = time.perf_counter() - t0
        self.span_s = float(tr["span_windows"]) * float(self.config["simulation"]["scheduling_cycle_interval"])
        self.t = float(tr["warm_until"])
        sim.step_until_time(self.t)
        self._span()  # the readout's own path, warmed
        self.sync()
        # Set-up leaves millions of objects (the trace's rows, names,
        # events): frozen out of the collector, so that no full collection
        # walks them inside the window.
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_process
        print(f"kbench: set-up {self.setup_s:.2f} s (inputs and build {self.trace_build_s:.2f} s, captures "
              f"{self.capture_s:.2f} s); C={sim.n_clusters} N={sim.n_nodes} P={sim.n_pods} route {sim.cycle_route}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    # --- the window -----------------------------------------------------

    def _decisions(self):
        return self.sim.state.metrics.scheduling_decisions.cpu()

    def _span(self) -> float:
        """One span and its readout; returns its wall seconds."""
        t_next = self.t + self.span_s
        if t_next > HORIZON_GUARD * self.inputs.horizon:
            raise SystemExit(
                f"kbench: the window reached {t_next:.0f} s, past {HORIZON_GUARD:.0%} of the trace's "
                f"{self.inputs.horizon:.0f} s horizon: the cell needs a longer trace")
        t0 = time.perf_counter()
        with self.torch.profiler.record_function("kbench.span"):
            self.sim.step_until_time(t_next)
        with self.torch.profiler.record_function("kbench.readout"):
            self.sync()
            self.last_decisions = self._decisions()
        self.t = t_next
        return time.perf_counter() - t0

    def _counters(self) -> Dict:
        sim = self.sim
        return {"decisions": int(self._decisions().sum()), "windows": sim.windows_run, "host_syncs": sim.host_syncs,
                "dispatch": dict(sim.dispatch_stats), "feeder": (sim.telemetry_report().get("feeder") or None),
                "t": self.t}

    def window(self, traced: bool) -> None:
        self.before = self._counters()
        if traced:
            self.trace = trace_reader.traced(self.torch, lambda: self._spans(int(self.traffic["trace_spans"]), None))
            self.window_s = self.trace["window_s"]
        else:
            t0 = time.perf_counter()
            self._spans(None, self.args.seconds)
            self.sync()
            self.window_s = time.perf_counter() - t0
        self.after = self._counters()

    def _spans(self, count, seconds) -> None:
        t0 = time.perf_counter()
        while (count is not None and self.attempted < count) or (
                seconds is not None and time.perf_counter() - t0 < seconds):
            self.attempted += 1
            self.spans_s.append(self._span())

    # --- what the window produced, and the check ------------------------

    def outputs(self) -> Dict:
        """The checked lanes' resident pods and counters at the window's
        end, copied to the host; the program's state is freed after."""
        sim = self.sim
        dec = self.last_decisions
        m = sim.state.metrics
        up, down = m.scaled_up_nodes.cpu(), m.scaled_down_nodes.cpu()
        ca = self.config["simulation"].get("cluster_autoscaler", {})
        groups = sorted(g["node_template"]["metadata"]["name"] for g in ca.get("node_groups", [])) \
            if ca.get("enabled") else []
        out = {"t": self.t, "lanes": {}}
        for lane in self.check_lanes:
            metrics = sim.cluster_metrics(lane)
            counters = {"scheduling_decisions": int(dec[lane]),
                        **{k: metrics[k] for k in ("pods_succeeded", "terminated_pods", "pods_removed")},
                        "nodes": sim.node_count_at(self.t, lane)}
            if groups:
                counters.update(scaled_up_nodes=int(up[lane]), scaled_down_nodes=int(down[lane]))
                counters.update({f"ca_nodes.{g}": int(n) for g, n in zip(groups, sim.ca_node_counts(lane))})
            out["lanes"][lane] = {"pods": sim.pod_view(lane), "counters": counters}
        return out

    def check(self, outcome: Dict, precision: str = "float32") -> List[Dict]:
        """The reference over each checked lane to the window's end, one
        worker process a lane; the pods and counters that differ, summed
        over the lanes (limit 0 each)."""
        T = outcome["t"]
        bounds = {**self.config.get("engine", {}), **self.traffic.get("engine", {})}
        half = 0.5 * float(self.config["simulation"]["scheduling_cycle_interval"])
        lanes = list(outcome["lanes"])
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(max_workers=len(lanes), mp_context=ctx) as pool:
            futures = [
                pool.submit(replay.readout, self.inputs, lane_scenario(self.scenario, lane), bounds, precision, T, half,
                            list(outcome["lanes"][lane]["pods"]))
                for lane in lanes
            ]
            refs = [f.result() for f in futures]
        print(f"kbench: the reference ran {len(lanes)} lane(s) to {T:.0f} s in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        total = {"pods_compared": 0, "pods_differing": 0, "counters_differing": 0}
        for lane, ref in zip(lanes, refs):
            got = outcome["lanes"][lane]
            pods = compare.pods(got["pods"], ref["pods"])
            want = replay.expected(ref)
            for ex in pods["examples"]:
                print(f"kbench: lane {lane} at {T} s: {ex}", file=sys.stderr, flush=True)
            if want != {k: got["counters"].get(k) for k in want}:
                print(f"kbench: lane {lane} at {T} s: counters {got['counters']}, reference {want}",
                      file=sys.stderr, flush=True)
            total["pods_compared"] += pods["compared"]
            total["pods_differing"] += pods["state"] + pods["node"] + pods["start"]
            total["counters_differing"] += compare.counters(got["counters"], want)
        self.check_detail = total
        limits = self.traffic["limits"]
        return [{"name": k, "value": total[k], "limit": limits[k]} for k in ("pods_differing", "counters_differing")]

    def close(self) -> None:
        """Stop the program's feeder and drop its state."""
        if self.sim is not None:
            self.sim.close()
            self.sim = None

    def cleanup(self) -> None:
        """Remove the generated inputs."""
        shutil.rmtree(self.tmp, ignore_errors=True)
