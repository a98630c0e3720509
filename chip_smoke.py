#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetriks_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the eight CUDA kernels of the TPU kernels, the chaos engine's
     commit-time draw (pod_attempt_draw.cu), the window executor's four
     glue kernels (window_work_due.cu, next_window.cu, catch_up.cu,
     conditional_wake.cu), the flight recorder's record
     (telemetry_record.cu) and the graph_if helper (the window executor's
     conditional node) from ops/csrc with nvcc (one process each, all at
     once), timed;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     inputs captured (cloned) from its path, run without graphs, at that
     path's shapes — the three
     scheduling kernels from the headline path at t = 190 s (1024 clusters
     x 256 nodes, K = 64), the two cluster-autoscaler kernels from the
     autoscaler path at the first window where each acts (256 clusters x
     96 node slots x 1664 pod slots); device times of the kernel and, where
     one exists, of a single PyTorch library call as a yardstick (timed
     only; both from CUDA-graph replays between CUDA events, cycling over
     enough input copies to overrun the L2 cache), and the plain version's
     time on the CUDA clock;
  4. the headline path — the headline bench shape: 1024 uniform clusters of
     256 nodes (64 000 mCPU, 128 GiB), Poisson pods at 2/s for 1000 s (seed
     3, 4000 mCPU, 8 GiB, 30-120 s), default profile, 64 pods per cycle;
     build, capture every window piece's CUDA graph (precompile_pieces),
     step to 190 s, then 200 s steps to 1200 s on the graph executor;
     decisions, rate, windows, host syncs per window, captures, replays,
     the graph pool's bytes and each kernel's launch count, with
     conservation checks on the final state; the timed span fails on an
     eager window, a capture or a host read;
  5. card against CPU: a 300 s trace with a node removal at C=8, N=16, run
     through the kernels on the card and through the plain path on the CPU,
     final states equal under compare_states;
  6. the autoscaler path — the reference's composed scenario (`bench.py:260`
     `run_composed` defaults, whole-resident, CA slot reclaim on: the
     card's default, which the run checks): 256
     clusters of 32 nodes (64 000 mCPU, 128 GiB) plus 64 CA slots, Poisson
     pods at 1.5/s for 1000 s (16 000 mCPU, 32 GiB), one HPA group (8 to 64
     pods, cpu target 0.5, load 4/24/2 over 300/300/400 s), the CA at a
     10 s scan; timed as phase 4; the HPA and CA counters, the
     autoscaler bounds, every cluster equal; device busy ms a window from
     a second run of the timed windows under torch.profiler;
 6w. the same line through the reference's sliding pod window
     (`bench.py:266` pod_window=512: P = 512 + the HPA ring), timed as
     phase 4 on the graph executor with one host read a span (a slide or
     a growth) and none inside it; slides, growths, final window, device P,
     reads a span, host and device busy ms a window, replays a window and
     decisions/s beside phase 6's; its counters and metric leaves equal
     phase 6's (compare_states), every slot the window holds is in the
     phase of its global slot in phase 6 and every slot it slid past is
     terminal there; it streams (the card's default: the feeder thread
     stages the slide's payload), and the same timed span without the
     feeder (stream=False) ends in the same state with the same host
     reads, host ms a window beside;
 6r. phase 6w's line again with slot reclaim off, timed the same way: its
     counters (but the slots reclaimed) and metric leaves equal phase
     6w's; slots reclaimed, host and device busy ms a window of both;
  7. card against CPU on the autoscaler path, slot reclaim on both sides
     and again off on both: the composed scenario at 4 nodes and C=8 to
     t=400 s (CA scale-ups and a removal), final states equal under
     compare_states; again through an 8-slot pod window (it slides and
     grows), reclaim on;
  8. the two-kernel route (KTPU_MEGAKERNEL=0: selection + cycle, then the
     commit scatter) on the headline shape, timed as phase 4;
  9. the trace-replay path at the full width of the reference's Alibaba
     replay bench (`scripts/bench_alibaba.py`): one cluster of 1 313
     synthetic machines (seed 3, 10 % of them failing) plus 400 CA slots, ~107 k
     pods over one simulated day, the CA on (at most 200 nodes of a 64 000
     mCPU / 88 GiB template), the six network delays, K = 256; built and
     run through the port's CLI functions (build_batched_simulation ->
     precompile_pieces -> run_to_completion -> metrics_summary) on the
     sorted cycle route and the graph executor (no eager window, at most
     run_to_completion's one host read per 64 windows); device busy ms a
     window over 100 traced windows from 43 200 s of a second run;
 9w. the same replay through a sliding pod window of 4 096 slots (the
     reference README's) to completion: its counters and window count
     equal phase 9's, every pod terminal, one host read a span (and
     run_to_completion's own); growths, final window, wall seconds, ms and
     busy ms a window beside phase 9's; run twice, streamed (the card's
     default) and with stream=False (the whole-trace payload on the card):
     equal states and host reads, host ms a window of each, busy ms and
     kernels a window of the streamed run;
 10. card against CPU on the replay and the two-kernel route: the replay
     at the reference's own test size (100 machines, 700 tasks, 4 000 s,
     seed 7) to completion; the headline shape at C=128 to t=60 s on the
     two-kernel route, the megakernel route and the CPU; final states equal
     under compare_states;
 11. the graph executor against eager windows (graphs=False) on the card:
     the headline at C=128 to 300 s on both dense routes (the two-kernel
     route forced after the build), the autoscaler path to 1200 s and the
     full-width replay to 2000 s, and through sliding pod windows that
     slide and grow: the autoscaler path through 128 slots to 1200 s and
     phase 10's replay through 64 to 4 550 s, and the endurance churn at
     C=4 through 24 waves (slot reclaim's piece in every window); every
     leaf equal bit for bit, every kernel launched as often, as many host
     reads, host ms a window of both, captures, replays and the graph
     pool's bytes;
 12. the endurance churn — the reference's endurance line (`bench.py:540-
     760` `run_endurance`: 8 nodes of 16 000 mCPU / 32 GiB, Poisson pods
     at 0.25/s, churn waves of 24 000 mCPU pods 160 s apart that fit only
     the CA's 32 000 mCPU template, a 2-slot CA reserve, pod_window=128,
     K = 32; its fault block on and ca_slot_multiplier 2, as the
     reference's long runs take them; telemetry and the watchdog armed, as
     its endurance line has them; the streaming feeder on, the card's
     default)
     at 256 clusters (each with its own crash chains, build timed) through
     96 waves (15 390 s) on the graph executor with slot reclaim: finishes
     with the bounds clean, crashes and restarts seen, at least 3x the
     reserve in
     allocations and slots reclaimed on every cluster, one host read a
     span, no reserve verdict of the watchdog and a lossless ring (the
     reference's gate, `bench.py:625-626, 745-760`); a second run (at 16
     clusters) read once a wave shows the dynamic scale-down order away
     from the static table; busy ms a window over waves 40-50; without
     reclaim the churn raises (16 clusters); at C=4 card == CPU, reclaim
     on both sides, through 76 waves, past wave 74's pair (ca_node_99,
     ca_node_100: the scale-down walks it out of slot order, which the CPU
     run must show).
 13. scheduler profiles: under best_fit and balanced_packing, the headline
     shape on the graph executor timed as phase 4 (megakernel) and as
     phase 8 (two-kernel route), and the full replay timed to 10 800 s
     as phase 9 (sorted route); card == CPU
     for best_fit, balanced_packing and a custom profile
     (BalancedResourceAllocation at weight 2.0) at C=128 on the megakernel
     route and at C=8 on the sorted and two-kernel routes;
 14. the chaos engine: the composed line through pod_window=512 with the
     reference bench's fault block (node crash chains, CrashLoopBackOff)
     on the graph executor, timed as phase 6w (one host read a span),
     faults shown, device busy and kernels a window beside phase 6w's;
     card == CPU at C=8 to t=400 s with faults and with faults plus
     best_fit; graph == eager bit for bit under faults through
     pod_window=512 (slides and a growth) to t=1 200 s.
 15. fast-forward: the sparse headline (the headline's 1024 x 256 at
     0.02 pods/s a cluster, the reference's sparse rate, to 70 000 s),
     where fast-forward turns on by itself, with telemetry on; timed from
     190 s to 70 000 s on the graph executor (one host read an executed
     window, none other; the ring holds the executed windows, lossless),
     and again with telemetry off (equal reads and dispatch counts): wall time, decisions/s, windows executed and skipped, host
     reads, kernels and busy ms an executed window (torch.profiler, 5 000
     -> 7 000 s of a second run); the same line stepping every window on
     the card ends in an equal state; card == CPU at C = 4 on this line (to 35 000 s)
     and on the composed line at 0.02 pods/s to 2 000 s (slot reclaim on
     both sides, both fast-forwarded), with the same windows executed.
 16. the conditional move on graphs: phase 6w's line with
     enable_unscheduled_pods_conditional_move, timed as phase 6w (no
     eager window, one host read a span), host ms, busy ms and kernels a
     window beside 6w's; card == CPU at C = 4 to t = 400 s.
 17. the flight recorder: phase 6w's line timed as phase 6w with
     telemetry on (the watchdog riding it) and off: states equal but the
     ring, host reads and dispatch_stats equal, no read inside a span, the
     record launched once a window, the ring lossless; kernels, host ms
     and busy ms a window on against off; at phase 7w's depth the card's
     ring equals the CPU's bit for bit and its gauges the CPU's (counts
     exact, utilizations at rtol 1e-5), the gauge CSV written.
 18. the streaming feeder over the device budget: the replay's synthetic
     day replicated to 1 024 clusters with the CA on, through
     pod_window=4096, built through the CLI's native path (the C++ feeder,
     compile_from_arrays; the phase fails if the feeder does not build),
     its whole-trace payload (~2.73 GB) over the 2 GiB budget, run to
     20 000 s on the graph executor with the feeder's slabs (one host read
     a span, at least two slabs installed, every kernel of the path
     launched); every cluster's state equals a one-cluster streamed run to
     the same time on the same route; slabs installed and produced, the
     stall split, the staging's device bytes against the whole payload's
     (its peak must stay below the whole payload at the width reached,
     read after the run and again after the traced continuation, which
     grows the window and re-seeks the feeder), host and busy ms a
     window, the build seconds.
 19. checkpoints on the card (save_checkpoint / load_checkpoint): phase
     6w's line with telemetry and the watchdog armed (reclaim, streaming)
     saved at 590 s, restored into a fresh card engine and stepped to
     1 190 s: state == the uninterrupted run under compare_states, equal
     counters, the ring re-drained lossless; phase 9w's streamed replay
     saved mid-stream (43 540 s, a completion chunk boundary), restored
     and run to completion: every leaf == phase 9w's final state; a C = 4
     composed run with faults saved on the card and restored on the CPU:
     the two continuations equal; save and restore seconds and bytes.
 20. the scenario fleet (batched/fleet.py, wave-aligned): the reference's
     --sweep line (`bench.py:981`: 64 scenarios of `bench.py:862` over
     16 lanes, 8 nodes, horizon 400 s, query horizon 450 s, K = 64; the
     sorted route) and the same pattern at 1 024 scenarios over 256 lanes
     (4 waves, the megakernel route, pod faults on, each scenario its own
     fault_seed): no capture after wave 1, the planted duplicates of
     scenario 0 bit-identical to it, three probe queries equal standalone
     card engines built from `bench.py:889` `_scenario_config` (one of
     them, in 20b, a lane whose seed changed since wave 1); scenarios/s
     against the three standalone engines extrapolated to all scenarios
     (`bench.py:1108-1140`), host and busy ms a window of a fleet wave;
     card == CPU at 8 scenarios over 4 lanes with node and pod faults.
 21. the lane-asynchronous fleet (batched/fleet.py pump / run_async,
     the engine's lane clocks; telemetry on): (a) the reference's
     open-loop line (`bench.py:1192` `run_open_loop` defaults: 32 queries
     over 4 lanes, 64 nodes, pods at 3/s to 400 s, query horizons cycling
     (1, 1/16, 1/8, 1/16) of 450 s, pump spans of 4): the stream through a
     wave-aligned and a lane-asynchronous fleet, every result equal; 5
     timed rounds each (queries/s), occupancy, a pump's host ms a window,
     the latency histograms against the queries polled (counts, p99
     within a bucket of the exact), the first 5
     queries on a CPU fleet == the card's; device busy and kernels a
     window of a traced pump stream (its first 8 queries) and of 8
     windows in each freeze variant; (b) 1 024 queries over 256 lanes (the megakernel route, pod
     faults, each its own seed, the same horizon mix) through both
     fleets, every result equal, scenarios/s of each and occupancy.
 22. the reference's host-chaos line (`bench.py:1452` `run_host_chaos`
     defaults: 24 queries over 4 lanes, 8 nodes, dispatch faults and
     stalls at 0.05, 1 ms, seed 7, 4 rounds): the quiet A/B (results and
     dispatch_stats), then armed: every round finishes, availability >=
     90 %, every lane faults, a lane quarantined and re-admitted, one
     outcome a query id, the latency histograms against the results
     polled. No fleet of phases 20-22 captures after its build.
 23. the RL scheduler loop (kubernetriks_tpu_torch/rl/, float32, TF32
     off): (a) the reference's RL bench shape (`scripts/bench_rl.py:105-135`:
     8 192 clusters x 8 nodes, 16 windows x K = 8, 4 epochs), one warm and
     one timed PPO iteration of the MLP head and of the attention head at
     update_microbatch=1024: wall, decisions/s, the rollout / GAE / update
     split, peak device memory, kernels and device busy ms a rollout
     window; the rollout launches the event scatter, free and commit
     scatter kernels; (b) card against CPU at C = 4 (`tests/test_rl.py`'s
     make_sim, both heads; its autoscaled sim with the CA and reclaim at
     the card's default, the CA kernels): greedy and sampled rollouts on
     the same noise, actions, valid flags and final states equal (near-tie
     flips reported), one update within rtol 1e-4, the card's run with the
     plain versions refused; (c) the learning proof
     (`tests/test_rl_learning.py:47-118`): the MLP trained on 32 clusters,
     greedy on held-out seeds against eval_kube and best-fit, the
     reference's thresholds as the gate.
The card runs of phases 5, 7, 10, 15 and 16 replay graphs too (fails
otherwise); the window-cost razor is on there (the card's default) and
off on the CPU, so they hold razor on against razor off. Phase 4 also
traces 50 windows of a second run for device busy and kernels a window.
Phase 3 also holds the three cycle-route kernels against their plain
versions: the two-kernel route's on inputs of the headline shape built with
KTPU_MEGAKERNEL=0, the candidate cycle on inputs of the full-width replay;
and the three redesigned cycle kernels above K = 256: the megakernel and
the two-kernel route's selection with K = P = 2 048 on a seeded deep queue
over the headline's captured rows, the candidate cycle with K = 1 024 rows
over the replay's captured node rows.
The event scatter, the free kernel and both CA kernels are held and timed
at the replay's shape too (C = 1, N = 1 713, P = 107 136), on their busiest
calls in its first 600 s; the kernels' JSON line carries these as extra
entries labelled "(replay)", with the replay's launch counts. The three cycle
kernels are held and timed under best_fit and balanced_packing too (their
general instantiation) on the same captured inputs: entries labelled with
the profile, with the launches of phase 13's timed run of that route
under it. Every kernel of the fault path is held and timed on it (phase
14's line to 590 s): the event scatter on its chunk with the most
crashes, the free kernel on its call freeing the most failing or removed
attempts, the megakernel on its deepest queue, the CA kernels on their
calls with the most candidates on their branch, and the commit-time draw
against its plain version, bit for bit (its call with the most attempts
starting): entries labelled "(composed, faults)", with phase 14's
launches. The replay's CA calls
attempt nothing, so both CA kernels are also held and timed at the replay's
width on seeded walks that work (the tests' generators: a scale-down where
about half the candidates attempt, with rollbacks; a scale-up packing 64
valid cache rows), in chip_smoke.json's checks only. The event scatter,
the free kernel and the megakernel are held and timed at the composed
line's windowed width too (phase 6w's, on its last calls to 590 s), and
the event scatter, the free kernel and the candidate cycle at the windowed
replay's (phase 9w's, on its busiest calls in its first 600 s): entries
labelled "(composed, pod_window=512)" and "(replay, pod_window=4096)",
with the launches of phases 6w and 9w. Both CA kernels are held and timed
on the endurance churn too (phase 12's settings: faults on, slot
multiplier 2), on their first calls that act after slots have
been reused (for the scale-down, a removal on a walk whose live candidates
the dynamic name order puts in another order than the static table: wave
74's pair, ca_node_99 and ca_node_100; for the scale-up, a cursor below
the allocations made): entries labelled "(churn, reclaim)", with the
launches of phase 12. The window glue kernels are held and timed, bit
for bit, on eager runs of phase 15's line to 1 500 s (the razor's
predicate on its first call that finds no work, the next window on its
first call, the catch-up on its longest skip) and of phase 16's line to
590 s (the conditional move's scans on their call with the most
event-by-parked-pod steps), with the launches of phases 15 and 16. The
flight recorder's record is held bit for bit and timed on phase 17's
line at 590 s (C = 256, N = 96, P = 648, R = 1024), with phase 17's
launches. The commit draw with a scenario fleet's per-lane seed vector is
held bit for bit and timed on phase 20b's line (256 lanes, each its own
seed) on its call with the most attempts starting, with phase 20b's
launches: the entry "pod_attempt_draw (seed vector)". The record with the
lane columns (a lane-asynchronous engine's global window and active lanes)
is held bit for bit and timed on phase 21b's line (256 lanes, eagerly, its
last record of the second pump round, lanes active and parked), with
phase 21b's launches: the entry "telemetry_record (lane columns)". A timed
kernel cycles through at most 512 copies of its inputs.
It prints the kernels' JSON line, then the device JSON line last. Without a
CUDA device, or without the package beside it, it exits 2 and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50 * 1024**2  # H100 L2 cache
MAX_COPIES = 512  # input copies a timed kernel cycles through, at most
OUT_DIR = HERE / "chiprun_out"


def headline_sim(device, n_clusters: int = 1024, n_nodes: int = 256, rate: float = 2.0, horizon: float = 1000.0,
                 **engine_kwargs):
    """The reference's headline bench shape (`bench.py:92` `run_shape`):
    n_clusters uniform clusters of n_nodes nodes (64 000 mCPU, 128 GiB),
    Poisson pods at `rate`/s for `horizon` s (2/s for 1000 s; seed 3, 4000
    mCPU, 8 GiB, 30-120 s), default profile, 64 pods per cycle.
    profile_main_path.py uses it too. engine_kwargs go to the engine (e.g.
    graphs=False)."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    config = SimulationConfig.from_yaml("sim_name: bench\nseed: 1\nscheduling_cycle_interval: 10.0")
    return build_batched_from_traces(
        config,
        UniformClusterTrace(n_nodes, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
        PoissonWorkloadTrace(
            rate_per_second=rate, horizon=horizon, seed=3, cpu=4000, ram=8 * 1024**3,
            duration_range=(30.0, 120.0),
        ).convert_to_simulator_events(),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=64, **engine_kwargs,
    )


# The sparse headline (phase 15): the headline's shape at the reference's
# sparse rate (tests/test_fast_forward.py:18, 0.02 pods/s a cluster) over
# 70 000 s, where fast-forward turns on by itself: the reference's density
# rule counts the 256 node creations too, 0.33 trace events a window over
# 20 000 s, 0.237 over 70 000 s (under 0.25).
SPARSE = dict(rate=0.02, horizon=70000.0)
# Phase 15's card-against-CPU run of this line at C = 4 stops here (a depth
# cut from 70 000 s, PERF.md §4).
SPARSE_CHECK_UNTIL = 35000.0


def sparse_sim(device, n_clusters: int = 1024, **engine_kwargs):
    """The sparse headline: headline_sim at SPARSE's rate and horizon."""
    return headline_sim(device, n_clusters, **SPARSE, **engine_kwargs)


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

# The reference's composed line at its own width (`bench.py:260`
# `run_composed` defaults); composed_sim's defaults are a toy cut of it.
FULL_COMPOSED = dict(n_nodes=32, rate=1.5, horizon=1000.0, max_group_pods=64, burst=(300.0, 300.0, 400.0), k=64)
# The sliding pod windows: the composed line's (`bench.py:266`) and the
# replay's (the reference README streams the Alibaba replay through 4 096).
COMPOSED_POD_WINDOW = 512
REPLAY_POD_WINDOW = 4096
# Phase 13 times the replay under each profile to an eighth of the day (a
# depth cut from the whole day, then half and a quarter of it; PERF.md §4).
PROFILE_REPLAY_UNTIL = 10800.0
WINDOWED_COMPOSED = f"pod_window={COMPOSED_POD_WINDOW}"
WINDOWED_REPLAY = f"pod_window={REPLAY_POD_WINDOW}"
# The non-default scheduler profiles the cycle kernels are held and timed
# under (phase 3) and whose paths phase 13 runs; the custom one is the
# tests' (tests/test_torch_profiles.py).
KERNEL_PROFILES = ("best_fit", "balanced_packing")
CUSTOM_PROFILE = {"filters": ["Fit"], "score": [{"name": "BalancedResourceAllocation", "weight": 2.0}]}
FAULTS_LABEL = "composed, faults"


def profile_node_ops(profile) -> int:
    """Operations a node of a cycle kernel's decision pass takes for one
    candidate under `profile`: fit and argmax (8), each LeastAllocated or
    MostAllocated score (8), each BalancedResourceAllocation score (5), a
    weight's multiply and each sum's add (1 each). The default: 16."""
    ops = 8
    for i, (name, weight) in enumerate(profile.scores):
        ops += 5 if name == "BalancedResourceAllocation" else 8
        ops += (weight != 1.0) + (i > 0)
    return ops


def composed_config_yaml(n_nodes: int) -> str:
    """The composed scenario's config (`bench.py:198` `_composed_inputs`):
    HPA on, the CA with one 64 000 mCPU / 128 GiB node group, at most
    n_nodes CA nodes, a 10 s scan."""
    return f"""
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


def composed_workload_yaml(max_group_pods: int, burst) -> str:
    return COMPOSED_GROUP_YAML.format(max_pods=max_group_pods, d1=burst[0], d2=burst[1], d3=burst[2])


# The reference bench's fault block (`bench.py:157-166` FAULTS_YAML), which
# its composed line takes with faults on and its endurance line always.
FAULTS_YAML = """
fault_injection:
  enabled: true
  node:
    mttf: 900.0
    mttr: 120.0
  pod:
    fail_prob: 0.05
    restart_limit: 3
"""


def composed_sim(device, n_clusters, n_nodes=4, rate=0.2, horizon=300.0, max_group_pods=16,
                 burst=(90.0, 90.0, 120.0), k=8, faults=False, conditional_move=False, **engine_kwargs):
    """The reference's composed scenario (`bench.py:198` `_composed_inputs`)
    on the port: n_nodes uniform nodes, Poisson plain pods (seed 3, 16 000
    mCPU / 32 GiB, 30-120 s) beside one HPA pod group, the CA allowed
    n_nodes nodes of the 64 000 mCPU template; max_ca_pods_per_cycle 64,
    max_pods_per_scale_down 8. FULL_COMPOSED gives the reference's width;
    `faults` adds FAULTS_YAML (each cluster then has its own crash chains),
    `conditional_move` the config's enable_unscheduled_pods_conditional_move."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
    from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

    cluster = UniformClusterTrace(n_nodes, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events()
    plain = PoissonWorkloadTrace(
        rate_per_second=rate, horizon=horizon, seed=3, cpu=16000, ram=32 * 1024**3,
        duration_range=(30.0, 120.0), name_prefix="plain",
    ).convert_to_simulator_events()
    group = GenericWorkloadTrace.from_yaml(
        composed_workload_yaml(max_group_pods, burst)
    ).convert_to_simulator_events()
    config_yaml = composed_config_yaml(n_nodes) + (FAULTS_YAML if faults else "")
    if conditional_move:
        config_yaml += "enable_unscheduled_pods_conditional_move: true\n"
    return build_batched_from_traces(
        SimulationConfig.from_yaml(config_yaml), cluster,
        sorted(plain + group, key=lambda e: e[0]),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=k,
        max_ca_pods_per_cycle=64, max_pods_per_scale_down=8, **engine_kwargs,
    )


# The reference's endurance line (`bench.py:547-600`, `run_endurance`):
# churn waves of pods that fit only the CA's template, through a 2-slot CA
# reserve a slot multiplier (max_node_count 2), which only slot reclaim can
# carry to the end; its fault block is FAULTS_YAML.
ENDURANCE_CONFIG_YAML = """
sim_name: bench_endurance
seed: 1
scheduling_cycle_interval: 10.0
cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: 2
  node_groups:
  - node_template:
      metadata: {name: ca_node}
      status: {capacity: {cpu: 32000, ram: 68719476736}}
"""


def endurance_churn_yaml(n_waves: int, spacing: float, t0: float = 30.0) -> str:
    """The reference's `_endurance_churn_events` as a generic workload:
    each wave's 24 000 mCPU pod fits only the CA template (the base nodes
    have 16 000), runs min(60, spacing / 2) s and retires before the next
    wave; every third wave sends two pods 7 s apart, the second running
    14 s longer, so two CA nodes coexist."""
    events, pod = [], 0
    for k in range(n_waves):
        t = t0 + k * spacing
        for j in range(2 if k % 3 == 2 else 1):
            events.append(
                f"""
- timestamp: {round(t + 7.0 * j, 1)}
  event_type:
    !CreatePod
      pod:
        metadata:
          name: churn_{pod:04d}
        spec:
          resources:
            requests: {{cpu: 24000, ram: 25769803776}}
            limits: {{cpu: 24000, ram: 25769803776}}
          running_duration: {round(min(60.0, spacing / 2) + 14.0 * j, 1)}
"""
            )
            pod += 1
    return "events:" + "".join(events)


def endurance_sim(device, n_clusters: int = 4, n_waves: int = 24, n_nodes: int = 8, spacing: float = 160.0,
                  rate: float = 0.25, pod_window=128, faults=False, **engine_kwargs):
    """The reference's endurance line (`run_endurance` defaults: 4 clusters
    of 8 nodes of 16 000 mCPU / 32 GiB, 24 waves 160 s apart from t = 30 s,
    Poisson plain pods at 0.25/s to 60 s before the horizon, seed 3, 2 000
    mCPU / 4 GiB, 20-60 s, K = 32, pod_window=128, ca_slot_multiplier 1),
    with its fault block where `faults` (the reference runs it with faults
    on, and with ca_slot_multiplier 2 on its long runs, `bench.py:610,
    688`), without telemetry (the engine's defaults: on the card the
    streaming feeder stages the pod window). engine_kwargs go to the
    engine (e.g. reclaim=, graphs=, ca_slot_multiplier=)."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
    from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

    horizon = 30.0 + n_waves * spacing
    plain = PoissonWorkloadTrace(
        rate_per_second=rate, horizon=horizon - 60.0, seed=3, cpu=2000, ram=4 * 1024**3,
        duration_range=(20.0, 60.0), name_prefix="plain",
    ).convert_to_simulator_events()
    churn = GenericWorkloadTrace.from_yaml(endurance_churn_yaml(n_waves, spacing)).convert_to_simulator_events()
    engine_kwargs.setdefault("ca_slot_multiplier", 1)
    return build_batched_from_traces(
        SimulationConfig.from_yaml(ENDURANCE_CONFIG_YAML + (FAULTS_YAML if faults else "")),
        UniformClusterTrace(n_nodes, cpu=16000, ram=32 * 1024**3).convert_to_simulator_events(),
        sorted(plain + churn, key=lambda e: e[0]),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=32, pod_window=pod_window, **engine_kwargs,
    )


# The reference's six network delays: the Alibaba replay bench's
# (`scripts/bench_alibaba.py:40-45`) and its tests' (`test_util.py:10`).
REPLAY_DELAYS = {
    "bench": (0.050, 0.089, 0.023, 0.152, 0.67, 0.50),
    "test": (0.050, 0.010, 0.020, 0.150, 0.30, 0.40),
}

REPLAY_CA_YAML = """cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: 200
  node_groups:
  - node_template:
      metadata:
        name: replay_ca_node
      status:
        capacity:
          cpu: 64000
          ram: 94489280512
"""


def replay_config_yaml(paths, delays: str, ca: bool) -> str:
    """The Alibaba replay's config as YAML: the trace files, a 10 s cycle,
    the six delays and, with `ca`, the bench's cluster autoscaler."""
    names = ("as_to_ps", "ps_to_sched", "sched_to_as", "as_to_node", "as_to_ca", "as_to_hpa")
    machines, tasks, instances = paths
    text = "sim_name: alibaba_replay\nseed: 1\nscheduling_cycle_interval: 10.0\n"
    text += "".join(f"{n}_network_delay: {d}\n" for n, d in zip(names, REPLAY_DELAYS[delays]))
    text += (
        "trace_config:\n  alibaba_cluster_trace_v2017:\n"
        f"    machine_events_trace_path: {machines}\n"
        f"    batch_task_trace_path: {tasks}\n"
        f"    batch_instance_trace_path: {instances}\n"
    )
    return text + (REPLAY_CA_YAML if ca else "")


def replay_config(paths, delays: str, ca: bool):
    """replay_config_yaml's config, parsed."""
    from kubernetriks_tpu_torch.config import SimulationConfig

    return SimulationConfig.from_yaml(replay_config_yaml(paths, delays, ca))


def replay_trace(name: str, **kwargs):
    """Synthesize the Alibaba CSVs under the output directory (the
    reference's synthesizer, byte for byte); returns their paths."""
    from kubernetriks_tpu_torch.trace.synthetic_alibaba import write_synthetic_trace_dir

    return write_synthetic_trace_dir(str(OUT_DIR / name), **kwargs)


# The bench's replay (`scripts/bench_alibaba.py:33-35`): 1 313 machines,
# ~53 k tasks over one day, 10 % of the machines failing, seed 3.
FULL_REPLAY = dict(error_fraction=0.1, seed=3, horizon=86400.0)


def replay_sim(device, paths, delays="bench", ca=True, n_clusters: int = 1, **engine_kwargs):
    """The replay through the port's CLI functions (the native feeder and
    compile_from_arrays): one cluster unless asked, K = 256."""
    from kubernetriks_tpu_torch.cli import build_batched_simulation

    return build_batched_simulation(replay_config(paths, delays, ca), n_clusters, device=device, **engine_kwargs)


def with_megakernel_flag(value: str, build):
    """build() with KTPU_MEGAKERNEL set to `value` (read at engine build)."""
    old = os.environ.get("KTPU_MEGAKERNEL")
    os.environ["KTPU_MEGAKERNEL"] = value
    try:
        return build()
    finally:
        if old is None:
            del os.environ["KTPU_MEGAKERNEL"]
        else:
            os.environ["KTPU_MEGAKERNEL"] = old


def graph_report(sim, stats: dict) -> dict:
    """The window executor's counts over a run (`stats`: the change in
    sim.dispatch_stats) and the graphs' memory pool."""
    return {**stats, "graphs": sim.graphs, "graph_pool_bytes": sim.graph_pool_bytes()}


def check_graph_run(label, sim, stats: dict, syncs: int, windows: int, max_syncs: int = 0):
    """Fail unless a run went through the graph executor alone: graphs on,
    no eager window, no capture inside it (precompile_pieces took them
    all), and at most `max_syncs` host reads."""
    if not sim.graphs:
        fail(f"{label}: the engine runs without graphs")
    if stats["eager_windows"] or stats["graph_windows"] != windows:
        fail(f"{label}: {stats['eager_windows']} eager window(s), {stats['graph_windows']} of {windows} on graphs")
    if stats["captures"]:
        fail(f"{label}: {stats['captures']} capture(s) inside the timed run")
    if syncs > max_syncs:
        fail(f"{label}: the window loop read the device back {syncs} times in {windows} windows")


def ran_on_graphs(label, sim):
    """Fail unless every window of a card run replayed graphs."""
    stats = sim.dispatch_stats
    if not sim.graphs or stats["eager_windows"] or stats["graph_windows"] != sim.windows_run:
        fail(f"{label}: the card run did not go through the graph executor alone ({stats})")


def check_sliding_run(label, sim, stats: dict, syncs: int, windows: int, max_completion_reads: int = 0):
    """Fail unless a run through the sliding pod window went through the
    graph executor alone and read the device once a span: host reads ==
    slides + growths (+ at most `max_completion_reads`, run_to_completion's
    own), at least one slide, no eager window, and no capture but the ones
    a growth takes again."""
    if not sim.graphs:
        fail(f"{label}: the engine runs without graphs")
    if stats["eager_windows"] or stats["graph_windows"] != windows:
        fail(f"{label}: {stats['eager_windows']} eager window(s), {stats['graph_windows']} of {windows} on graphs")
    spans = stats["slides"] + stats["grows"]
    if stats["slides"] <= 0:
        fail(f"{label}: the window never slid")
    if not spans <= syncs <= spans + max_completion_reads:
        fail(f"{label}: {syncs} host reads for {stats['slides']} slides and {stats['grows']} growths")
    if stats["captures"] and not stats["grows"]:
        fail(f"{label}: {stats['captures']} capture(s) inside the timed run without a growth")


def sliding_report(sim, stats: dict, syncs: int, windows: int) -> dict:
    """The window's counts over a run: slides, growths, host reads (a span
    each, plus run_to_completion's own where it ran), the final width and
    the device pod axis."""
    spans = stats["slides"] + stats["grows"]
    return {
        "pod_window": sim.pod_window, "P": sim.n_pods, "pod_base": sim._pod_base,
        "slides": stats["slides"], "grows": stats["grows"], "host_reads": syncs,
        "host_reads_per_span": syncs / max(spans, 1), "replays_per_window": stats["replays"] / max(windows, 1),
    }


def metric_leaves(state) -> dict:
    """The state's `.metrics.` leaves as numpy (compare_states' form): the
    per-cluster counters and estimator accumulators, whatever the pod
    axis's layout."""
    from kubernetriks_tpu_torch.convert import state_to_numpy

    return {k: v for k, v in state_to_numpy(state).items() if k.startswith(".metrics.")}


def device_busy(run, label: str) -> dict:
    """Device busy ms and kernels a window of `run()` (which returns the
    windows it ran) under torch.profiler (CPU + CUDA): the device events'
    time and count (kernels, copies, fills), read from the raw trace,
    beside the traced host ms a window (the profiler's own cost included).
    Fails if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    # The raw events: key_averages() would build a Python object for every
    # CPU op and kernel first, seconds a traced run of an eager path.
    busy_ns, kernels = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ns += e.duration_ns()
            kernels += 1
    if busy_ns <= 0:
        fail(f"{label}: the profiler saw no device time")
    return {"windows": n, "busy_ms_per_window": busy_ns / 1e6 / n, "kernels_per_window": kernels / n,
            "traced_host_ms_per_window": 1e3 * traced / n}


def profiled_busy(build, warm_until: float, until: float, label: str) -> dict:
    """Device busy ms a window of a freshly built engine's windows from
    `warm_until` to `until` on the graph executor, traced with
    torch.profiler (CPU + CUDA): the device rows' kernel time over the
    windows, beside the traced host ms a window (the profiler's own cost
    included). Fails if the trace holds no device time. Returns the
    numbers and the engine."""
    sim = build()
    sim.precompile_pieces()
    sim.step_until_time(warm_until)
    torch.cuda.synchronize()
    w0, x0 = sim.windows_run, sim.dispatch_stats["executed_windows"]

    def run():
        sim.step_until_time(until)
        return max(sim.windows_run - w0, 1)

    out = device_busy(run, label)
    n = out["windows"]
    executed = sim.dispatch_stats["executed_windows"] - x0
    if sim.fast_forward and executed > 0:
        # Fast-forward: per executed window as well.
        out.update({
            "executed_windows": executed, "busy_ms_per_executed_window": out["busy_ms_per_window"] * n / executed,
            "kernels_per_executed_window": out["kernels_per_window"] * n / executed,
            "traced_host_ms_per_executed_window": out["traced_host_ms_per_window"] * n / executed,
        })
    print(f"{label}: device busy {out['busy_ms_per_window']:.4f} ms a window over {n} traced windows "
          f"({out['kernels_per_window']:.1f} kernels a window, traced host {out['traced_host_ms_per_window']:.3f} ms)"
          + (f"; per executed window ({executed}): busy {out['busy_ms_per_executed_window']:.4f} ms, "
             f"{out['kernels_per_executed_window']:.1f} kernels" if "executed_windows" in out else ""),
          flush=True)
    return out, sim


def graph_eager_pair(label, sk, build, until: float, route=None, sliding: bool = False, must_grow: bool = True) -> dict:
    """Build twice (`build(graphs)`), optionally force the cycle route,
    step both to `until`: once replaying the window graphs (captured up
    front), once eagerly (graphs=False). Fails unless every leaf of the two
    final states is equal bit for bit, each kernel launched as often, and
    the graph run had no eager window and no host read (`sliding`: one a
    span, and with `must_grow` at least one growth). Returns each run's
    host ms a window (from window 0, ending in a synchronize) and counts."""
    from kubernetriks_tpu_torch.batched.state import flatten

    runs = {}
    for graphs in (True, False):
        sim = build(graphs)
        if route:
            sim.cycle_route = route
        captured = sim.precompile_pieces()
        sk.reset_launches()
        syncs0 = sim.host_syncs
        t0 = time.perf_counter()
        sim.step_until_time(until)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stats = dict(sim.dispatch_stats)
        stats["captures"] -= captured
        runs[graphs] = {
            "state": flatten(sim.state),
            "launches": sk.launch_counts(),
            "host_ms_per_window": 1e3 * elapsed / max(sim.windows_run, 1),
            "windows": sim.windows_run,
            "syncs": sim.host_syncs - syncs0,
            "stats": stats,
            "precompiled_graphs": captured,
            "graph_pool_bytes": sim.graph_pool_bytes(),
            "route": sim.cycle_route,
            "skipped_body_launches": sim._executor.skipped_body_launches(),
        }
        if graphs and sliding:
            check_sliding_run(label, sim, stats, runs[graphs]["syncs"], sim.windows_run)
            if must_grow and not stats["grows"]:
                fail(f"{label}: the window never grew")
            runs[graphs]["sliding"] = sliding_report(sim, stats, runs[graphs]["syncs"], sim.windows_run)
        elif graphs:
            check_graph_run(label, sim, stats, runs[graphs]["syncs"], sim.windows_run)
        del sim
    g, e = runs[True], runs[False]
    bad = [p for p in g["state"] if not torch.equal(g["state"][p], e["state"][p])]
    if bad:
        fail(f"{label}: graph and eager runs differ at {bad}")
    # The eager run on the card runs the razor's gated tails whatever their
    # predicate holds; the graphs skip them where it is false.
    skipped = g["skipped_body_launches"]
    if {n: k + skipped.get(n, 0) for n, k in g["launches"].items()} != e["launches"]:
        fail(f"{label}: launches differ: graphs {g['launches']} (+ {skipped} skipped in conditional nodes), "
             f"eager {e['launches']}")
    if g["syncs"] != e["syncs"]:
        fail(f"{label}: host reads differ: graphs {g['syncs']}, eager {e['syncs']}")
    out = {
        "route": g["route"],
        "windows": g["windows"],
        "graph_host_ms_per_window": g["host_ms_per_window"],
        "eager_host_ms_per_window": e["host_ms_per_window"],
        "graphs_captured": g["precompiled_graphs"],
        "replays": g["stats"]["replays"],
        "graph_pool_bytes": g["graph_pool_bytes"],
        "launches": g["launches"],
        "skipped_body_launches": skipped,
        "sliding": g.get("sliding"),
    }
    print(
        f"{label}: graph run == eager run bit for bit over {g['windows']} windows (route {g['route']}), "
        f"launches equal (+ {skipped} the graphs' conditional nodes skipped), host ms a window "
        f"{g['host_ms_per_window']:.3f} (graphs) against "
        f"{e['host_ms_per_window']:.3f} (eager), {out['graphs_captured']} graphs, {out['replays']} replays, "
        f"pool {out['graph_pool_bytes']} B" + (f", window {out['sliding']}" if sliding else ""),
        flush=True,
    )
    return out


def timed_path(sim, sk, names, label):
    """Capture every window piece (precompile_pieces), step the headline
    span (to 190 s, then 200 s steps to 1200 s) with the launch counts set
    to 0 just before; returns the run's numbers and fails if a kernel in
    `names` never launched, or if the timed span ran an eager window, a
    capture or a host read (through the sliding pod window: a read other
    than one a span, or a capture without a growth)."""
    t0 = time.perf_counter()
    captured = sim.precompile_pieces()
    capture_s = time.perf_counter() - t0
    sk.reset_launches()
    sim.step_until_time(190.0)
    before = sim.decisions_total()
    syncs0, windows0 = sim.host_syncs, sim.windows_run
    stats0 = dict(sim.dispatch_stats)
    t0 = time.perf_counter()
    end = 390.0
    while end <= 1200.0:
        sim.step_until_time(end)
        end += 200.0
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sk.launch_counts()
    windows = sim.windows_run - windows0
    syncs = sim.host_syncs - syncs0
    graph = graph_report(sim, {k: sim.dispatch_stats[k] - stats0[k] for k in stats0})
    total = sim.decisions_total()
    decisions = total - before
    out = {
        "decisions": total,
        "timed_decisions": decisions,
        "timed_seconds": elapsed,
        "decisions_per_s": decisions / elapsed,
        "windows": sim.windows_run,
        "timed_windows": windows,
        "ms_per_window": 1e3 * elapsed / max(windows, 1),
        "host_syncs_per_window": syncs / max(windows, 1),
        "launches": launches,
        "cycle_route": sim.cycle_route,
        "precompiled_graphs": captured,
        "precompile_s": capture_s,
        "graph": graph,
    }
    print(
        f"{label}: route {sim.cycle_route}, decisions {total} (timed {decisions} in {elapsed:.3f} s = "
        f"{decisions / elapsed:.1f} decisions/s), windows {sim.windows_run} (timed {windows}, "
        f"{out['ms_per_window']:.3f} ms/window), host syncs per window "
        f"{out['host_syncs_per_window']:.3f}, {captured} graphs captured up front in {capture_s:.2f} s, "
        f"timed span: {graph}, launches {launches}",
        flush=True,
    )
    if total <= 0:
        fail(f"{label}: no scheduling decision")
    if sim.pod_window is None:
        check_graph_run(label, sim, graph, syncs, windows)
    else:
        check_sliding_run(label, sim, graph, syncs, windows)
        out["window"] = sliding_report(sim, graph, syncs, windows)
        print(f"{label}: window {out['window']}", flush=True)
    for name in names:
        if launches[name] <= 0:
            fail(f"{label}: never launched {name}")
    return out


def timed_replay(sim, sk, names, label, until=None) -> dict:
    """Capture every window piece, run the replay to completion on the
    graph executor with the launch counts set to 0 just before, and check
    the run: graphs alone (run_to_completion reads the device once per
    chunk of 64 windows past the last event; the window loop itself
    never does), every pod terminal, some decision, every kernel in
    `names` launched. `until`: step to that time instead (no read; the
    pods are not all terminal then). Returns the run's numbers."""
    t0 = time.perf_counter()
    captured = sim.precompile_pieces()
    capture_s = time.perf_counter() - t0
    sk.reset_launches()
    syncs0, stats0 = sim.host_syncs, dict(sim.dispatch_stats)
    t0 = time.perf_counter()
    if until is None:
        sim.run_to_completion(max_time=86400.0 * 20.0)
    else:
        sim.step_until_time(until)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sk.launch_counts()
    graph = graph_report(sim, {k: sim.dispatch_stats[k] - stats0[k] for k in stats0})
    check_graph_run(label, sim, graph, sim.host_syncs - syncs0, sim.windows_run,
                    max_syncs=-(-sim.windows_run // 64) if until is None else 0)
    summary = sim.metrics_summary()  # raises if an autoscaler bound was crossed
    counters = summary["counters"]
    decisions = counters["scheduling_decisions"]
    windows = sim.windows_run
    phase = sim.state.pods.phase[:, : sim.n_real_pods]
    if until is None and not bool(((phase == 4) | (phase == 5) | (phase == 6)).all()):
        fail(f"{label}: the replay ended with a pod that is not terminal")
    if decisions <= 0:
        fail(f"{label}: the replay made no scheduling decision")
    for name in names:
        if launches[name] <= 0:
            fail(f"{label}: the replay never launched {name}")
    return {
        "cycle_route": sim.cycle_route,
        "shape": {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "real_pods": sim.n_real_pods,
                  "events": sim.n_events, "E": sim.max_events_per_window, "K": sim.max_pods_per_cycle},
        "windows": windows,
        "wall_s": elapsed,
        "ms_per_window": 1e3 * elapsed / max(windows, 1),
        "decisions_per_s": decisions / elapsed,
        "events_per_s": (sim.n_clusters * sim.n_events + decisions) / elapsed,
        "host_syncs": sim.host_syncs,
        "precompiled_graphs": captured,
        "precompile_s": capture_s,
        "graph": graph,
        "counters": counters,
        "timings": summary["timings"],
        "launches": launches,
    }


# --- phase 23: the RL scheduler loop (kubernetriks_tpu_torch/rl/) -------------------
# The reference's RL bench (scripts/bench_rl.py:105-135): one PPO iteration
# over 8 192 clusters of 8 nodes, 16 windows x K = 8, 4 epochs; the
# attention head's update in chunks of 1 024 clusters.
RL_BENCH_CLUSTERS = 8192
RL_BENCH_WINDOWS = 16
RL_ATTENTION_MICROBATCH = 1024
# Card against CPU at tests/test_rl.py's size: C = 4, 8 windows.
RL_CHECK_WINDOWS = 8
# The learning proof: tests/test_rl_learning.py:47-118's settings.
RL_PROOF_ITERATIONS = 16
RL_PROOF_CLUSTERS = 32
RL_PROOF_TRAIN_SEED = 11_000
RL_PROOF_HELDOUT_SEED = 91_000
# The kernels the rollout runs on the card; the CA's on an autoscaled sim.
RL_PATH_KERNELS = ("fused_event_scatter", "fused_free_resources", "fused_commit_scatter")
RL_CA_KERNELS = ("fused_ca_scale_down", "fused_ca_scale_up")
# The loss is invariant to a shift of all of a row's logits, so the logit
# bias's gradient is zero in exact arithmetic: Adam's first step on it is
# float32 noise scaled to the learning rate, on either side.
RL_SHIFT_INVARIANT = ("logit.bias", "logit_b")
RL_AUTOSCALED_YAML = """sim_name: rl_autoscaled
seed: 1
scheduling_cycle_interval: 10.0
as_to_ps_network_delay: 0.050
ps_to_sched_network_delay: 0.010
sched_to_as_network_delay: 0.020
as_to_node_network_delay: 0.150
as_to_ca_network_delay: 0.30
as_to_hpa_network_delay: 0.40
cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: 6
  node_groups:
  - node_template:
      metadata:
        name: ca_node
      status:
        capacity:
          cpu: 16000
          ram: 34359738368
"""


def rl_bench_sim(device, n_clusters: int, **engine_kwargs):
    """scripts/bench_rl.py:34 `build` (tests/test_rl.py `make_sim` at C =
    4): uniform nodes of 16 000 mCPU and 32 GiB, 8 a cluster, Poisson pods
    at 0.5/s to 200 s (seed 7, 4 000 mCPU, 8 GiB, 20-60 s), K = 8."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    return build_batched_from_traces(
        SimulationConfig.from_yaml("sim_name: rl_bench\nseed: 1\nscheduling_cycle_interval: 10.0"),
        UniformClusterTrace(8, cpu=16000, ram=32 * 1024**3).convert_to_simulator_events(),
        PoissonWorkloadTrace(rate_per_second=0.5, horizon=200.0, seed=7, cpu=4000, ram=8 * 1024**3,
                             duration_range=(20.0, 60.0)).convert_to_simulator_events(),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=8, **engine_kwargs,
    )


def rl_autoscaled_sim(device, n_clusters: int = 4, **engine_kwargs):
    """tests/test_rl.py `make_autoscaled_sim`: two nodes of 8 000 mCPU and
    16 GiB, the CA (up to 6 nodes of 16 000 mCPU, 32 GiB), Poisson pods at
    0.5/s to 200 s (seed 7, 6 000 mCPU, 12 GiB, 20-60 s), K = 8."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

    return build_batched_from_traces(
        SimulationConfig.from_yaml(RL_AUTOSCALED_YAML),
        UniformClusterTrace(2, cpu=8000, ram=16 * 1024**3).convert_to_simulator_events(),
        PoissonWorkloadTrace(rate_per_second=0.5, horizon=200.0, seed=7, cpu=6000, ram=12 * 1024**3,
                             duration_range=(20.0, 60.0)).convert_to_simulator_events(),
        n_clusters=n_clusters, device=device, max_pods_per_cycle=8, **engine_kwargs,
    )


@contextlib.contextmanager
def plain_versions_refused():
    """Inside the block the plain versions of the RL path's kernels (the
    event scatter, the free pass, the commit scatter, both CA passes)
    raise, in every module that calls them: a card run inside it proves
    that the wrappers launched the kernels."""
    from kubernetriks_tpu_torch.batched import step as step_mod
    from kubernetriks_tpu_torch.ops import autoscale_kernel, scheduler_kernel

    targets = [(scheduler_kernel, "event_scatter_plain"), (scheduler_kernel, "free_resources_plain"),
               (scheduler_kernel, "commit_scatter_plain"), (step_mod, "commit_scatter_plain"),
               (autoscale_kernel, "ca_scale_down_plain"), (autoscale_kernel, "ca_scale_up_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def refuse(name):
        def plain(*args, **kwargs):
            raise AssertionError(f"the plain {name} ran on the card's RL path")
        return plain

    for mod, name, _ in saved:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def rl_params_close(a: dict, b: dict, start: dict, lr: float, rtol: float, atol: float):
    """(worst |a - b| off the shift-invariant logit bias, problems): a ==
    b within rtol / atol there; on the logit bias each side within one
    Adam step (lr) of `start`."""
    problems, worst = [], 0.0
    for name in b:
        x, y = a[name].detach().cpu(), b[name].detach().cpu()
        if name in RL_SHIFT_INVARIANT:
            if max(float((x - start[name].cpu()).abs().max()), float((y - start[name].cpu()).abs().max())) > lr:
                problems.append(f"{name} moved more than one Adam step")
            continue
        worst = max(worst, float((x - y).abs().max()))
        if not torch.allclose(x, y, rtol=rtol, atol=atol):
            problems.append(f"{name} differs by {float((x - y).abs().max()):.3g}")
    return worst, problems


def rl_card_vs_cpu(dev, sk, build, head: str, label: str, windows: int = RL_CHECK_WINDOWS, seed: int = 5) -> dict:
    """One head on a small sim (`build(device, **kwargs)`), card against
    CPU (phase 23b; tests/test_torch_cuda.py): trainers with one seed (the
    same weights, drawn on the CPU), a greedy rollout and a sampled one
    with the same noise ((W, K, C, N) drawn on the CPU from a seeded
    generator, copied to the card), the card's run with the plain versions
    refused and its launches counted. Actions compared; every cluster whose
    actions all agree must have equal valid flags and an equal final state
    (compare_states); a cluster with a flip is reported with its margin on
    the CPU's scores at the first flip, and fails unless that is a near tie
    (under 1e-5 relative). Then one ppo_update from each side's sampled
    batch: params within rtol 1e-4 (atol 1e-6) where no cluster flipped.
    Returns the report; its "problems" list is empty on success."""
    from kubernetriks_tpu_torch.convert import state_to_numpy
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.rl.env import MASK_LOGIT, draw_gumbel, final_state_value
    from kubernetriks_tpu_torch.rl.ppo import PPOConfig, PPOTrainer, compute_gae, ppo_update

    config = PPOConfig(epochs_per_iteration=1, learning_rate=1e-3)
    card_sim = build(dev)
    cpu_sim = build(torch.device("cpu"), reclaim=card_sim.reclaim)
    card = PPOTrainer(card_sim, windows, config, seed=seed, policy_kind=head)
    cpu = PPOTrainer(cpu_sim, windows, config, seed=seed, policy_kind=head)
    K, C, N = cpu_sim.max_pods_per_cycle, cpu_sim.n_clusters, cpu_sim.n_nodes
    gumbel = draw_gumbel(torch.Generator().manual_seed(seed + 1), (windows, K, C, N))
    report = {"head": head, "C": C, "N": N, "windows": windows, "reclaim": card_sim.reclaim, "problems": []}
    batches = {}
    for mode in ("greedy", "sampled"):
        noise = None if mode == "greedy" else gumbel
        sk.reset_launches()
        t0 = time.perf_counter()
        with plain_versions_refused():
            card_final, card_flat = card.collect(greedy=noise is None, gumbel=noise)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = sk.launch_counts()
        cpu_final, cpu_flat = cpu.collect(greedy=noise is None, gumbel=noise)
        t2 = time.perf_counter()
        batches[mode] = (card_final, card_flat, cpu_final, cpu_flat)
        a_card, a_cpu = card_flat.action.cpu(), cpu_flat.action
        flipped = (a_card != a_cpu).any(dim=0)
        flips = []
        for c in torch.nonzero(flipped).flatten().tolist():
            t = int(torch.nonzero(a_card[:, c] != a_cpu[:, c])[0])
            obs = cpu_flat.obs[t, c][None]
            logits, _ = cpu.policy_apply(cpu.params, obs)
            fit = obs[..., 1] > 0
            score = torch.where(fit, logits, MASK_LOGIT)
            score = torch.where(fit.any(), score, torch.zeros_like(score))[0]
            if noise is not None:
                score = score + noise[t // K, t % K, c]
            hi, lo = float(score[a_cpu[t, c]]), float(score[a_card[t, c]])
            near = hi - lo <= 1e-5 * max(1.0, abs(hi))
            flips.append({"cluster": c, "decision": t, "margin": hi - lo, "near_tie": near})
            if not near:
                report["problems"].append(f"{label} {mode}: cluster {c} decision {t}: card and CPU chose nodes "
                                          f"{int(a_card[t, c])} and {int(a_cpu[t, c])}, margin {hi - lo:.3g}")
        keep = np.flatnonzero(~flipped.numpy())
        if not torch.equal(card_flat.valid.cpu()[:, keep], cpu_flat.valid[:, keep]):
            report["problems"].append(f"{label} {mode}: valid flags differ")
        a_np, b_np = state_to_numpy(card_final), state_to_numpy(cpu_final)
        bad = compare_states({k: v[keep] for k, v in a_np.items()}, {k: v[keep] for k, v in b_np.items()})
        if bad:
            report["problems"].append(f"{label} {mode}: card and CPU final states differ at {bad[:5]}")
        for name in RL_PATH_KERNELS + (RL_CA_KERNELS if card_sim.autoscale_statics is not None else ()):
            if launches[name] <= 0:
                report["problems"].append(f"{label} {mode}: the card's rollout never launched {name}")
        report[mode] = {"flips": flips, "clusters_compared": len(keep), "decisions": int(cpu_flat.valid.sum()),
                        "card_s": t1 - t0, "cpu_s": t2 - t1,
                        "launches": {n: launches[n] for n in RL_PATH_KERNELS + RL_CA_KERNELS}}
    # One update from each side's sampled batch.
    news = []
    for trainer, (final, flat) in ((card, batches["sampled"][:2]), (cpu, batches["sampled"][2:])):
        boot = final_state_value(final, trainer.policy_apply, trainer.params)
        adv, ret = compute_gae(flat.reward, flat.value, flat.valid, config.gamma, config.gae_lambda, boot)
        new, _, loss, _ = ppo_update(trainer.params, trainer.opt_state, trainer.policy_apply, flat, adv, ret, config)
        if not math.isfinite(float(loss)):
            report["problems"].append(f"{label}: the update's loss is not finite on {final.time.device}")
        news.append(new)
    if report["sampled"]["flips"]:
        report["update"] = "not compared: the sampled batches differ"
    else:
        worst, problems = rl_params_close(news[0], news[1], cpu.params, config.learning_rate, 1e-4, 1e-6)
        report["update"] = {"max_abs_diff": worst}
        report["problems"] += [f"{label} update: {p}" for p in problems]
    return report


def rl_iteration_split(trainer, sk) -> dict:
    """One PPO iteration of `trainer` (PPOTrainer.train_iteration's steps)
    timed on the host clock to a synchronize at each boundary: rollout,
    GAE (with the bootstrap value), update (the epochs); the rollout's
    kernel launches, counted from 0."""
    from kubernetriks_tpu_torch.rl.env import final_state_value
    from kubernetriks_tpu_torch.rl.ppo import compute_gae, ppo_update

    cfg = trainer.config
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    final, flat = trainer.collect()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = sk.launch_counts()
    boot = final_state_value(final, trainer.policy_apply, trainer.params)
    adv, ret = compute_gae(flat.reward, flat.value, flat.valid, cfg.gamma, cfg.gae_lambda, boot)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(cfg.epochs_per_iteration):
        trainer.params, trainer.opt_state, loss, aux = ppo_update(
            trainer.params, trainer.opt_state, trainer.policy_apply, flat, adv, ret, cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {
        "rollout_s": t1 - t0, "gae_s": t2 - t1, "update_s": t3 - t2, "wall_s": t3 - t0,
        "decisions": int(flat.valid.sum()), "loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
        "transition_bytes": sum(x.numel() * x.element_size() for x in flat), "launches": launches,
    }


def rl_phase(dev, sk, card: str) -> dict:
    """Phase 23, the RL scheduler loop (kubernetriks_tpu_torch/rl/) on the
    card, float32 with TF32 off.

    23a, the reference's RL bench shape (scripts/bench_rl.py:105-135):
    8 192 clusters x 8 nodes, 16 windows x K = 8, 4 epochs; one warm
    iteration, then one timed (rl_iteration_split) for the MLP head
    (hidden 64) and for the attention head at update_microbatch=1024:
    wall, decisions/s, the rollout / GAE / update split, the peak device
    memory of the timed iteration, kernels and device busy ms a rollout
    window (a traced rollout) beside its host ms; the rollout must launch
    the event scatter, free and commit scatter kernels.
    23b, card against CPU at C = 4 (rl_card_vs_cpu) for both heads on
    tests/test_rl.py's make_sim shape, and for the MLP on its autoscaled
    sim with the CA and reclaim at the card's default (the CA kernels).
    23c, the learning proof (rl_proof)."""
    from kubernetriks_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 23: TF32 matmuls are on; the policy runs float32 as the reference does")
    out = {"card": card}

    # --- 23a
    t0 = time.perf_counter()
    stamps = {}
    sim = rl_bench_sim(dev, RL_BENCH_CLUSTERS)
    out["bench_build_s"] = time.perf_counter() - t0
    for head, micro in (("mlp", 0), ("attention", RL_ATTENTION_MICROBATCH)):
        label = f"phase 23a {head}"
        trainer = PPOTrainer(sim, RL_BENCH_WINDOWS, PPOConfig(epochs_per_iteration=4, update_microbatch=micro),
                             policy_kind=head)
        t1 = time.perf_counter()
        trainer.train_iteration()  # warm: cuBLAS handles, the allocator's pools
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        run = rl_iteration_split(trainer, sk)
        run["warm_iteration_s"] = warm_s
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        run["decisions_per_s"] = run["decisions"] / run["wall_s"]
        run["host_ms_per_window"] = 1e3 * run["rollout_s"] / RL_BENCH_WINDOWS
        run["busy"] = device_busy(lambda: (trainer.collect(), RL_BENCH_WINDOWS)[1], f"{label} rollout")
        for name in RL_PATH_KERNELS:
            if run["launches"][name] <= 0:
                fail(f"{label}: the rollout never launched {name}")
        if not math.isfinite(run["loss"]) or run["decisions"] <= 0:
            fail(f"{label}: loss {run['loss']}, {run['decisions']} decisions")
        out[head] = run
        print(f"{label} ({card}): C={RL_BENCH_CLUSTERS} N=8 W={RL_BENCH_WINDOWS} K=8, update_microbatch={micro}: "
              f"{run['wall_s']:.3f} s an iteration = {run['decisions_per_s']:.0f} decisions/s ({run['decisions']} "
              f"decisions); rollout {run['rollout_s']:.3f} s, GAE {run['gae_s']:.3f} s, update {run['update_s']:.3f} "
              f"s; a rollout window: host {run['host_ms_per_window']:.3f} ms, device busy "
              f"{run['busy']['busy_ms_per_window']:.3f} ms, {run['busy']['kernels_per_window']:.1f} kernels; peak "
              f"device memory {run['peak_bytes'] / 2**30:.2f} GiB, transitions {run['transition_bytes'] / 2**30:.3f} "
              f"GiB; launches {{{', '.join(f'{n}: {run['launches'][n]}' for n in RL_PATH_KERNELS)}}}; loss "
              f"{run['loss']:.4f}; the warm iteration {warm_s:.3f} s", flush=True)
        del trainer
    del sim
    stamps["23a"] = time.perf_counter() - t0

    # --- 23b
    checks = {}
    for head, build, label in (("mlp", rl_bench_sim, "make_sim"), ("attention", rl_bench_sim, "make_sim"),
                               ("mlp", rl_autoscaled_sim, "autoscaled")):
        name = f"phase 23b {head} {label}"
        t1 = time.perf_counter()
        rep = rl_card_vs_cpu(dev, sk, lambda d, **kw: build(d, 4, **kw), head, name)
        rep["seconds"] = time.perf_counter() - t1
        if rep["problems"]:
            fail(f"{name}: " + "; ".join(rep["problems"]))
        checks[f"{head} {label}"] = rep
        flips = [f for mode in ("greedy", "sampled") for f in rep[mode]["flips"]]
        print(f"{name}: card == CPU at C={rep['C']} N={rep['N']} W={rep['windows']} (reclaim {rep['reclaim']}), greedy "
              f"and sampled (same noise): actions, valid flags and final states equal on "
              f"{rep['sampled']['clusters_compared']}/{rep['C']} clusters, near-tie flips {flips}; one update "
              f"{rep['update']}; launches {rep['sampled']['launches']}", flush=True)
    out["card_vs_cpu"] = checks
    stamps["23b"] = time.perf_counter() - t0 - stamps["23a"]

    # --- 23c
    out["proof"] = rl_proof(dev)
    stamps["23c"] = out["proof"]["seconds"]
    out["seconds"] = stamps
    print(f"phase 23: {stamps} s", flush=True)
    return out



def rl_proof(dev) -> dict:
    """Phase 23c, the learning proof (tests/test_rl_learning.py:47-118's
    settings and thresholds): the MLP trained RL_PROOF_ITERATIONS
    iterations on 32 clusters of the bimodal scenario (rl/evaluate.py),
    then greedy on held-out seeds against eval_kube, best-fit and its own
    untrained weights. The untrained weights are the reference's own for
    its seed 0 (rl/reference_init.py: the gates compare the trained policy
    with them); the rollout noise is the trainer's generator's. Fails on a
    missed gate, with the four summaries printed."""
    from kubernetriks_tpu_torch.convert import policy_params_from_flax
    from kubernetriks_tpu_torch.rl import evaluate
    from kubernetriks_tpu_torch.rl.ppo import PPOConfig, PPOTrainer, adam_init
    from kubernetriks_tpu_torch.rl.reference_init import reference_mlp_init

    t0 = time.perf_counter()
    windows = np.arange(evaluate.PROOF_WINDOWS, dtype=np.int32)
    large = evaluate.PROOF_LARGE["cpu"]
    trainer = PPOTrainer(
        evaluate.make_proof_sim(RL_PROOF_TRAIN_SEED, RL_PROOF_CLUSTERS, device=dev), evaluate.PROOF_WINDOWS,
        PPOConfig(learning_rate=3e-4, gamma=0.995, gae_lambda=0.97, epochs_per_iteration=4,
                  reward_size_weighted=True, shaping_coef=0.2),
        seed=0,
    )
    trainer.params = policy_params_from_flax(reference_mlp_init(0), dev)
    trainer.opt_state = adam_init(trainer.params)
    heldout = evaluate.make_proof_sim(RL_PROOF_HELDOUT_SEED, RL_PROOF_CLUSTERS, device=dev)

    def greedy(apply, params):
        return evaluate.eval_policy(heldout, apply, params, windows, greedy=True, large_cpu=large)

    proof = {
        "kube": evaluate.eval_kube(evaluate.make_proof_sim(RL_PROOF_HELDOUT_SEED, RL_PROOF_CLUSTERS, device=dev),
                                   windows, large_cpu=large),
        "bestfit": greedy(evaluate.bestfit_policy_apply, None),
        "untrained": greedy(trainer.policy_apply, trainer.params),
    }
    history = trainer.train(RL_PROOF_ITERATIONS)
    if not all(math.isfinite(it["policy_loss"]) for it in history):
        fail(f"phase 23c: a policy loss is not finite: {[it['policy_loss'] for it in history]}")
    proof["trained"] = trained = greedy(trainer.policy_apply, trainer.params)
    kube, bestfit, untrained = proof["kube"], proof["bestfit"], proof["untrained"]
    gates = {
        "large_placed >= kube + 0.30": trained["large_placed_frac"] >= kube["large_placed_frac"] + 0.30,
        "unschedulable_left < kube": trained["unschedulable_left_per_cluster"] < kube["unschedulable_left_per_cluster"],
        "placements > kube": trained["placements_per_cluster"] > kube["placements_per_cluster"],
        "queue < kube": trained["mean_queue_time_s"] < kube["mean_queue_time_s"],
        "large_placed >= bestfit - 0.05": trained["large_placed_frac"] >= bestfit["large_placed_frac"] - 0.05,
        "queue <= bestfit + 0.5": trained["mean_queue_time_s"] <= bestfit["mean_queue_time_s"] + 0.5,
        "parks <= 0.7 untrained": trained["park_decisions_per_cluster"] <= 0.7 * untrained["park_decisions_per_cluster"],
        "queue < untrained": trained["mean_queue_time_s"] < untrained["mean_queue_time_s"],
    }
    proof.update(iterations=RL_PROOF_ITERATIONS, mean_reward=[it["mean_reward"] for it in history], gates=gates,
                 seconds=time.perf_counter() - t0)
    for name in ("kube", "bestfit", "untrained", "trained"):
        print(f"phase 23c {name}: " + json.dumps(proof[name]), flush=True)
    print(f"phase 23c: {RL_PROOF_ITERATIONS} iterations on {RL_PROOF_CLUSTERS} clusters in {proof['seconds']:.1f} s "
          f"(with the evaluations), mean reward {proof['mean_reward'][0]:.4f} -> {proof['mean_reward'][-1]:.4f}; "
          f"gates {gates}", flush=True)
    missed = [g for g, ok in gates.items() if not ok]
    if missed:
        fail(f"phase 23c: the learning proof missed {missed}")
    return proof


T0 = time.perf_counter()


def stamp(phase: str) -> None:
    """The script's elapsed seconds as a phase starts."""
    print(f"-- {phase} at {time.perf_counter() - T0:.1f} s", flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def graph_ms(fns, inner: int = 12, reps: int = 5) -> float:
    """Device time of one call: at least `inner` calls, cycling through
    `fns` (the same call on different input copies, each one at least
    once), captured in a CUDA graph and replayed `reps` times between CUDA
    events. Without the graph a short kernel's time would be the host's
    launch cost (the wrapper's checks and allocations take longer than the
    kernel runs). The calls are warmed on the stream they are captured on:
    the free kernel's scratch is per stream and must exist before a
    capture."""
    inner = max(inner, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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


def kept(args):
    """A call's arguments, each tensor cloned: the engine updates its state
    and the window's accumulators in place, so a reference would not keep
    what the call saw."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def capture_inputs(step_mod, names):
    """Wrap the step module's kernel wrappers so the last call's arguments
    are kept (cloned). The engine must run without graphs (graphs=False):
    a replay calls no wrapper."""
    captured = {}
    originals = {n: getattr(step_mod, n) for n in names}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            captured[name] = (kept(args), kwargs)
            return fn(*args, **kwargs)

        return wrapped

    for n, fn in originals.items():
        setattr(step_mod, n, recorder(n, fn))

    def restore():
        for n, fn in originals.items():
            setattr(step_mod, n, fn)

    return captured, restore


def capture_first(mod, name, acts):
    """Wrap `mod.name` so the arguments of the first call whose outputs
    satisfy `acts(args, outs)` are kept, cloned (reading the outputs
    synchronizes, so this runs only in a capture pass, on an engine built
    with graphs=False). Returns (captured, restore)."""
    captured = {}
    real = getattr(mod, name)

    def wrapped(*args, **kwargs):
        args = kept(args)
        outs = real(*args, **kwargs)
        if name not in captured and acts(args, outs):
            captured[name] = (args, kwargs)
        return outs

    setattr(mod, name, wrapped)
    return captured, lambda: setattr(mod, name, real)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


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


def deep_queue(args, kwargs, seed: int = 11):
    """The megakernel's captured operands with K = P and a deep queue: 60 %
    of the pod slots eligible, queue keys (win 0-2, offsets among 0.0,
    -0.0, 0.5 and 2.25, a unique seq) and requests (1, 4 or 8 times the
    largest captured one, or 17 times its cpu, which fits no headline
    node) drawn from `seed`, the positional tables built as the engine
    builds them. Node and pod rows as captured."""
    from kubernetriks_tpu_torch.batched.step import xla_cumsum16

    alive, acpu, aram, eligible = args[:4]
    base_cpu, base_ram = int(args[7].max()), int(args[8].max())
    waited, phase, node, _, start_t, park_t = args[9:]
    C, P = eligible.shape
    dev = eligible.device
    g = torch.Generator().manual_seed(seed)
    elig = torch.rand((C, P), generator=g) < 0.6
    qwin = torch.randint(0, 3, (C, P), generator=g, dtype=torch.int32)
    qoff = torch.tensor([0.0, -0.0, 0.5, 2.25])[torch.randint(0, 4, (C, P), generator=g)]
    qseq = torch.argsort(torch.rand((C, P), generator=g), dim=1).to(torch.int32)
    pick = torch.randint(0, 4, (C, P), generator=g)
    req_cpu = (torch.tensor([1, 4, 8, 17], dtype=torch.int32) * base_cpu)[pick]
    req_ram = (torch.tensor([1, 4, 8, 1], dtype=torch.int32) * base_ram)[pick]
    dur = park_t[:, :1].expand(C, P).contiguous()  # the first table entry is one pod's time
    cd_post = xla_cumsum16(dur)
    bind = (start_t[:, :1] - park_t[:, :1]).contiguous()
    ops = [t.to(dev) for t in (elig, qwin, qoff, qseq, req_cpu, req_ram)]
    return (
        alive, acpu, aram, *ops, waited, phase, node,
        (cd_post - dur).contiguous(), (cd_post + bind).contiguous(), cd_post.contiguous(),
    ), {"k_pods": P}


def long_cycle(args, K: int, n_valid: int = 1000, seed: int = 12):
    """The candidate cycle's captured node rows with K candidate rows, the
    first n_valid valid, their requests drawn from `seed` among the
    captured valid rows' requests."""
    alive, acpu, aram, valid, req_cpu, req_ram = args
    C = valid.shape[0]
    dev = valid.device
    g = torch.Generator().manual_seed(seed)
    pool = torch.nonzero(valid.reshape(-1)).reshape(-1).cpu()
    pick = pool[torch.randint(0, len(pool), (C * K,), generator=g)].to(dev)
    rows = (torch.arange(K, device=dev) < n_valid).expand(C, K).contiguous()
    return (
        alive, acpu, aram, rows,
        req_cpu.reshape(-1)[pick].reshape(C, K).contiguous(),
        req_ram.reshape(-1)[pick].reshape(C, K).contiguous(),
    )


def chain_floors(sk, dev, n: int = 1024) -> dict:
    """Microseconds per candidate of the cycle kernels' dependent chains at
    their least work, from one cluster of 32 always-fitting nodes (one
    block of the fewest threads the kernel runs): the candidate cycle over
    n valid rows (the decision pass the megakernel runs too), and the
    two-kernel route's selection kernel over n eligible pods with K = n
    (its share of the queue ordering and its decision pass, per pick)."""
    g = torch.Generator().manual_seed(13)
    N = 32
    alive = torch.ones((1, N), dtype=torch.bool)
    cap = torch.full((1, N), 1 << 30, dtype=torch.int32)
    req = torch.randint(1, 100, (1, n), generator=g, dtype=torch.int32)
    ones = torch.ones((1, n), dtype=torch.bool)
    cyc = [x.to(dev) for x in (alive, cap, cap.clone(), ones, req, req.clone())]
    seq = torch.argsort(torch.rand((1, n), generator=g), dim=1).to(torch.int32)
    zeros = torch.zeros((1, n), dtype=torch.int32)
    sel = [x.to(dev) for x in (alive, cap, cap.clone(), ones, zeros, zeros.float(), seq, req, req.clone())]
    return {
        "fused_schedule_cycle": 1e3 * graph_ms([lambda: sk.fused_schedule_cycle(*cyc)]) / n,
        "fused_select_schedule_cycle": 1e3 * graph_ms(
            [lambda: sk.fused_select_schedule_cycle(*sel, k_pods=n)]) / n,
    }


def composed_window_phase(dev, sk, must_launch, whole, n_clusters: int = 256) -> dict:
    """Phase 6w: the composed line at full width through its sliding pod
    window (COMPOSED_POD_WINDOW), timed as phase 6 (timed_path: one read a
    span, no other), then held against the whole-resident run of phase 6
    (`whole`: its summary, metric leaves, final phase rows and numbers):
    the same counters and estimators (compare_states on the metric
    leaves), every slot the window holds in the phase of its global slot,
    every slot it slid past terminal. Device busy from a second run of the
    same windows, which must end in the same state, and then the slide
    piece's own cost (slide_piece_cost). `must_launch`: the kernels the
    path must launch. Returns the numbers and the run's metric leaves."""
    from kubernetriks_tpu_torch.batched.state import compare_states, flatten

    def build():
        return composed_sim(dev, n_clusters, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW)

    sim = build()
    if not sim._stream_on():
        fail("phase 6w: the card engine does not stream by default")
    out = timed_path(sim, sk, must_launch, "phase 6w")
    summary = sim.metrics_summary()  # raises if an autoscaler bound was crossed
    if summary["counters"] != whole["summary"]["counters"]:
        fail(f"phase 6w: counters differ from phase 6: {summary['counters']} vs {whole['summary']['counters']}")
    bad = compare_states(whole["metrics"], metric_leaves(sim.state))
    if bad:
        fail(f"phase 6w: metric leaves differ from phase 6 at {bad}")
    # Every slot the window holds has the phase of its global slot in the
    # whole-resident run ([plain slots | ring], 128-aligned), and every
    # slot the window slid past is terminal there.
    W, T, base = sim.pod_window, sim.consts.trace_pod_bound, sim._pod_base
    R = sim.n_pods - W
    ph, whole_phase = sim.state.pods.phase, whole["phase"]
    plain = max(0, min(W, T - base))
    if not (torch.equal(ph[:, :plain], whole_phase[:, base : base + plain])
            and torch.equal(ph[:, W:], whole_phase[:, T : T + R])
            and bool((ph[:, plain:W] == 0).all())):
        fail("phase 6w: a slot's phase differs from its global slot's in phase 6")
    gone = whole_phase[:, :base]
    if not bool(((gone == 4) | (gone == 5) | (gone == 6)).all()):
        fail("phase 6w: the window slid past a slot that is not terminal")
    out["counters"] = summary["counters"]
    out["timings"] = summary["timings"]
    out["shape"] = {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "W": W, "T": T,
                    "hpa_seg": list(sim.hpa_seg), "K": sim.max_pods_per_cycle}
    out["reclaim"] = sim.reclaim
    metrics = metric_leaves(sim.state)
    final = flatten(sim.state)
    sim.close()
    del sim, ph
    out["busy"], again = profiled_busy(build, 190.0, 1190.0, "phase 6w")
    if [p for p, leaf in flatten(again.state).items() if not torch.equal(leaf, final[p])]:
        fail("phase 6w: a second run of the same windows ended in another state")
    out["slide_piece"] = slide_piece_cost(again)
    again.close()
    del again
    # The same timed span without the streaming feeder (the card's default
    # streams): the same state and host reads, host ms a window beside.
    off_sim = composed_sim(dev, n_clusters, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, stream=False)
    off = timed_path(off_sim, sk, must_launch, "phase 6w (stream off)")
    if [p for p, leaf in flatten(off_sim.state).items() if not torch.equal(leaf, final[p])]:
        fail("phase 6w: the run without the feeder ended in another state")
    if off["window"]["host_reads"] != out["window"]["host_reads"]:
        fail(f"phase 6w: {off['window']['host_reads']} host reads without the feeder, {out['window']['host_reads']} with")
    del off_sim
    out["stream_off"] = {k: off[k] for k in ("ms_per_window", "decisions_per_s", "window", "graph")}
    print(f"phase 6w: host {out['ms_per_window']:.4f} ms a window streamed ({out['graph']['stage_refills']} slab(s) "
          f"installed), {off['ms_per_window']:.4f} without the feeder; state and host reads equal", flush=True)
    ref = whole["path"]
    print(
        f"phase 6w: pod_window={COMPOSED_POD_WINDOW} (final W {out['window']['pod_window']}, device P "
        f"{out['shape']['P']}): {out['window']['slides']} slides, {out['window']['grows']} growths, "
        f"{out['window']['host_reads_per_span']:.3f} host reads a span, host {out['ms_per_window']:.3f} ms a window "
        f"(phase 6 {ref['ms_per_window']:.3f}), device busy {out['busy']['busy_ms_per_window']:.4f} ms a window "
        f"(phase 6 {ref['busy']['busy_ms_per_window']:.4f}), {out['window']['replays_per_window']:.3f} replays a "
        f"window, {out['decisions_per_s']:.1f} decisions/s over t = 190 -> 1200 s (phase 6 "
        f"{ref['decisions_per_s']:.1f}); counters, metric leaves and every slot's phase equal phase 6's; "
        f"the slide piece alone: {out['slide_piece']}",
        flush=True,
    )
    return out, metrics


def composed_reclaim_pair(dev, sk, must_launch, on: dict, on_metrics: dict) -> dict:
    """Phase 6r: phase 6w's line again with slot reclaim off (reclaim=False;
    phase 6w ran the card's default, on), timed as phase 6w: the same
    counters but the slots reclaimed, and the same metric leaves
    (compare_states). Prints both runs' slots reclaimed, host and device
    busy ms a window."""
    from kubernetriks_tpu_torch.batched.state import compare_states

    def build():
        return composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, reclaim=False)

    sim = build()
    if sim.reclaim or not on["reclaim"]:
        fail(f"phase 6r: reclaim {on['reclaim']} in phase 6w, {sim.reclaim} here")
    out = timed_path(sim, sk, must_launch, "phase 6r")
    counters = sim.metrics_summary()["counters"]
    want = dict(on["counters"])
    reclaimed = want.pop("ca_slots_reclaimed")
    if counters != want:
        fail(f"phase 6r: counters differ from phase 6w's: {counters} vs {want}")
    bad = compare_states(on_metrics, metric_leaves(sim.state))
    if bad:
        fail(f"phase 6r: metric leaves differ from phase 6w's at {bad}")
    del sim
    out["busy"], _ = profiled_busy(build, 190.0, 1190.0, "phase 6r")
    out["counters"] = counters
    print(
        f"phase 6r: the composed line through pod_window={COMPOSED_POD_WINDOW} with reclaim on (phase 6w): "
        f"{reclaimed} slots reclaimed, host {on['ms_per_window']:.4f} ms a window, device busy "
        f"{on['busy']['busy_ms_per_window']:.4f} ms a window ({on['busy']['kernels_per_window']:.1f} kernels); "
        f"off: host {out['ms_per_window']:.4f} ms a window, device busy {out['busy']['busy_ms_per_window']:.4f} ms "
        f"a window ({out['busy']['kernels_per_window']:.1f} kernels); counters and metric leaves equal",
        flush=True,
    )
    return out


def profiles_phase(dev, sk, names, two_names, replay_paths, replay_names, ref: dict) -> dict:
    """Phase 13: scheduler profiles, each of KERNEL_PROFILES on the three
    cycle routes' timed paths: the headline shape on the graph executor
    timed as phase 4 (the megakernel route) and as phase 8 (the two-kernel
    route; timed_path: no eager window, capture or host read in the timed
    span), and the full replay timed to completion as phase 9 (the sorted
    route), beside phase 9's numbers (`ref`); the kernels' line takes the
    profiled rows' launches from these runs. Then card == CPU under
    compare_states for the named profiles and the custom one: the headline
    at C = 128 to t = 60 s on the megakernel route, and at C = 8 to
    t = 200 s on the sorted and the two-kernel routes (forced after the
    build)."""
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.convert import state_to_numpy

    out = {"timed": {}, "two_kernel": {}, "replay": {}, "card_cpu": {}}
    for prof in KERNEL_PROFILES:
        sim = headline_sim(dev, scheduler_profile=prof)
        out["timed"][prof] = timed_path(sim, sk, names, f"phase 13 {prof}")
        if sim.profile.name != prof:
            fail(f"phase 13: the engine runs profile {sim.profile.name}, not {prof}")
        del sim
        sim = with_megakernel_flag("0", lambda: headline_sim(dev, scheduler_profile=prof))
        out["two_kernel"][prof] = timed_path(
            sim, sk, ["fused_event_scatter", "fused_free_resources"] + two_names, f"phase 13 {prof} two-kernel"
        )
        if sim.cycle_route != "two_kernel" or out["two_kernel"][prof]["launches"]["fused_select_cycle_commit"]:
            fail(f"phase 13: {prof} did not run on the two-kernel route alone")
        del sim
        sim = replay_sim(dev, replay_paths, scheduler_profile=prof)
        if sim.cycle_route != "sorted":
            fail(f"phase 13: the replay under {prof} built the {sim.cycle_route} route, not the sorted one")
        run = out["replay"][prof] = timed_replay(sim, sk, replay_names, f"phase 13 {prof} replay",
                                                 until=PROFILE_REPLAY_UNTIL)
        print(
            f"phase 13 {prof} replay: {run['windows']} windows in {run['wall_s']:.3f} s = "
            f"{run['ms_per_window']:.3f} ms a window (phase 9 {ref['ms_per_window']:.3f}), "
            f"{run['decisions_per_s']:.1f} decisions/s, pods_succeeded {run['counters']['pods_succeeded']} "
            f"(phase 9 {ref['counters']['pods_succeeded']}), run: {run['graph']}, launches {run['launches']}",
            flush=True,
        )
        del sim
    for prof in KERNEL_PROFILES + ("custom",):
        spec = CUSTOM_PROFILE if prof == "custom" else prof
        for C, route, until in ((128, "megakernel", 60.0), (8, "sorted", 200.0), (8, "two_kernel", 200.0)):
            finals = {}
            for where in ("cuda", "cpu"):
                s = headline_sim(where, n_clusters=C, scheduler_profile=spec)
                s.cycle_route = route
                s.step_until_time(until)
                if where == "cuda":
                    ran_on_graphs(f"phase 13 {prof} {route}", s)
                finals[where] = state_to_numpy(s.state)
                del s
            bad = compare_states(finals["cuda"], finals["cpu"])
            if bad:
                fail(f"phase 13: {prof} on the {route} route at C={C}: card and CPU differ at {bad}")
            decisions = int(finals["cuda"][".metrics.scheduling_decisions"].sum())
            out["card_cpu"][f"{prof} {route} C={C}"] = decisions
            print(f"phase 13: {prof} on the {route} route at C={C} to t={until:.0f} s: card == CPU under "
                  f"compare_states ({decisions} decisions)", flush=True)
    return out


def faults_phase(dev, sk, names, ref: dict) -> dict:
    """Phase 14: the chaos engine. The composed line with FAULTS_YAML on
    the graph executor (each of the 256 clusters with its own crash
    chains). Failed attempts wait in the queue for their backoff, so the
    live pods outgrow COMPOSED_POD_WINDOW: a first run through it to
    1 200 s gives the width the window grows to, and the timed engine is
    built at that width, so no growth (whose captures would land in the
    span) happens inside it. Timed as phase 6w (timed_path: one host read
    a span, no eager window) beside phase 6w's numbers (`ref`), faults
    shown; device busy and kernels a window from a traced second run;
    card == CPU under compare_states at C = 8 to t = 400 s with faults,
    and with faults and best_fit (slot reclaim on both sides); the graph
    run equal to the eager run bit for bit under faults through
    COMPOSED_POD_WINDOW to t = 1 200 s, across its slides and growth."""
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.convert import state_to_numpy

    def build_at(width, graphs=True):
        return composed_sim(dev, 256, **FULL_COMPOSED, pod_window=width, faults=True, graphs=graphs)

    t0 = time.perf_counter()
    probe = build_at(COMPOSED_POD_WINDOW)
    build_s = time.perf_counter() - t0
    probe.step_until_time(1200.0)
    width, grows = probe.pod_window, probe.dispatch_stats["grows"]
    del probe

    def build():
        return build_at(width)

    sim = build()
    out = timed_path(sim, sk, names + ["pod_attempt_draw"], "phase 14")
    out["build_s"] = build_s
    out["grown_from"] = {"pod_window": COMPOSED_POD_WINDOW, "to": width, "grows": grows}
    counters = sim.metrics_summary()["counters"]
    out["counters"] = counters
    if counters["pod_interruptions"] + counters["pods_failed"] <= 0 or counters["node_crashes"] <= 0:
        fail(f"phase 14: the fault run showed no fault: {counters}")
    del sim
    out["busy"], _ = profiled_busy(build, 190.0, 1190.0, "phase 14")
    print(
        f"phase 14: composed with faults through {WINDOWED_COMPOSED} (grown to {width} in {grows} growth(s) by "
        f"1 200 s; timed at {width}), built in {build_s:.2f} s: host "
        f"{out['ms_per_window']:.3f} ms a window (phase 6w {ref['ms_per_window']:.3f}), device busy "
        f"{out['busy']['busy_ms_per_window']:.4f} ms a window (phase 6w {ref['busy']['busy_ms_per_window']:.4f}), "
        f"{out['busy']['kernels_per_window']:.1f} kernels a window (phase 6w "
        f"{ref['busy']['kernels_per_window']:.1f}), {out['decisions_per_s']:.1f} decisions/s; counters {counters}",
        flush=True,
    )
    out["card_cpu"] = {}
    for label, kwargs in (("faults", {}), ("faults + best_fit", {"scheduler_profile": "best_fit"})):
        finals = {}
        for where in ("cuda", "cpu"):
            s = composed_sim(where, 8, faults=True, reclaim=True, **kwargs)
            s.step_until_time(400.0)
            if where == "cuda":
                ran_on_graphs(f"phase 14 {label}", s)
            finals[where] = (state_to_numpy(s.state), s.metrics_summary()["counters"])
            del s
        bad = compare_states(finals["cuda"][0], finals["cpu"][0])
        if bad:
            fail(f"phase 14: {label}: card and CPU differ at {bad}")
        c = finals["cuda"][1]
        if c["pod_interruptions"] + c["pods_failed"] <= 0:
            fail(f"phase 14: {label}: the C=8 run showed no fault: {c}")
        out["card_cpu"][label] = c
        print(f"phase 14: {label} at C=8 to t=400 s: card == CPU under compare_states ({c})", flush=True)
    out["graph_vs_eager"] = graph_eager_pair(
        "phase 14 graph == eager under faults", sk, lambda g: build_at(COMPOSED_POD_WINDOW, g), 1200.0,
        sliding=True)
    return out


def check_skipping_run(label, sim, stats: dict, syncs: int, windows: int) -> None:
    """Fail unless a fast-forwarded run went through the graph executor
    alone: every executed window on graphs, none eager, no capture inside
    it, executed + skipped == the windows stepped, some skipped, and one
    host read an executed window (plus one a span through a pod window)."""
    if not sim.graphs:
        fail(f"{label}: the engine runs without graphs")
    if stats["eager_windows"] or stats["graph_windows"] != stats["executed_windows"]:
        fail(f"{label}: {stats['eager_windows']} eager window(s), {stats['graph_windows']} on graphs, "
             f"{stats['executed_windows']} executed")
    if stats["executed_windows"] + stats["skipped_windows"] != windows or stats["skipped_windows"] <= 0:
        fail(f"{label}: {stats['executed_windows']} executed and {stats['skipped_windows']} skipped of {windows}")
    if stats["captures"]:
        fail(f"{label}: {stats['captures']} capture(s) inside the timed run")
    if syncs != stats["executed_windows"] + stats["slides"] + stats["grows"]:
        fail(f"{label}: {syncs} host reads for {stats['executed_windows']} executed windows")


def sparse_phase(dev, sk, names) -> dict:
    """Phase 15: the sparse headline (sparse_sim: the headline's 1024
    clusters x 256 nodes at 0.02 pods/s a cluster to 70 000 s), where
    fast-forward turns on by itself: built, every piece captured, stepped
    to 190 s, then timed from 190 s to 70 000 s on the graph executor in
    1 000 s steps with the launch counts set to 0 just before (one host
    read an executed window, no other); the same line stepping every
    window (fast_forward=False) on the card ends in an equal state; device
    busy and kernels an executed window from a traced second run (5 000
    -> 7 000 s); card == CPU at C = 4 on this line (to 35 000 s) and on an autoscaled
    sparse variant (the composed line at 0.02 pods/s to 2 000 s), slot
    reclaim on both sides, both fast-forwarded."""
    from kubernetriks_tpu_torch.batched.state import compare_states, strip_telemetry
    from kubernetriks_tpu_torch.convert import state_to_numpy

    horizon = SPARSE["horizon"]

    def timed_span(sim):
        """190 s -> the horizon in 1 000 s steps, ending in a synchronize."""
        t0 = time.perf_counter()
        end = 1190.0
        while end < horizon:
            sim.step_until_time(end)
            end += 1000.0
        sim.step_until_time(horizon)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    sim = sparse_sim(dev, telemetry=True)
    build_s = time.perf_counter() - t0
    if not sim.fast_forward or not sim.window_razor:
        fail(f"phase 15: fast_forward {sim.fast_forward}, razor {sim.window_razor} on the sparse headline")
    t0 = time.perf_counter()
    captured = sim.precompile_pieces()
    capture_s = time.perf_counter() - t0
    sk.reset_launches()
    sim.step_until_time(190.0)
    before = sim.decisions_total()
    syncs0, stats0, w0 = sim.host_syncs, dict(sim.dispatch_stats), sim.windows_run
    drains0 = dict(sim._ring_drain_stats)
    elapsed = timed_span(sim)
    drains = {k: sim._ring_drain_stats[k] - drains0[k] for k in drains0}
    launches = sk.launch_counts()
    stats = {k: sim.dispatch_stats[k] - stats0[k] for k in stats0}
    syncs, windows = sim.host_syncs - syncs0, sim.windows_run - w0
    check_skipping_run("phase 15", sim, stats, syncs, windows)
    for name in names:
        if launches[name] <= 0:
            fail(f"phase 15: never launched {name}")
    decisions = sim.decisions_total() - before
    # The ring holds the executed windows, and no other (the drains rode
    # the executed windows' reads).
    check_ring("phase 15", sim, executed=sim.dispatch_stats["executed_windows"])
    final = state_to_numpy(strip_telemetry(sim.state))
    executed = stats["executed_windows"]
    out = {
        "shape": {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "K": sim.max_pods_per_cycle,
                  "horizon_s": horizon, "events": sim.n_events},
        "build_s": build_s, "precompiled_graphs": captured, "precompile_s": capture_s,
        "timed_windows": windows, "executed_windows": executed, "skipped_windows": stats["skipped_windows"],
        "wall_s": elapsed, "decisions": decisions, "decisions_per_s": decisions / elapsed,
        "ms_per_window": 1e3 * elapsed / windows, "ms_per_executed_window": 1e3 * elapsed / max(executed, 1),
        "host_reads_per_executed_window": syncs / max(executed, 1),
        "graph": graph_report(sim, stats), "launches": launches,
        # The ring's drains inside the timed span: their count and wall ms
        # (the blocking read, then the host's series and watchdog work).
        "ring_drains": {
            "drains": drains["drains"], "windows": drains["windows"],
            "read_ms": drains["read_ns"] / 1e6, "host_ms": drains["host_ns"] / 1e6,
            "ms_per_drain": (drains["read_ns"] + drains["host_ns"]) / 1e6 / max(drains["drains"], 1),
        },
    }
    armed = (sim.host_syncs, dict(sim.dispatch_stats))
    del sim
    # The same span with telemetry off, in this call: equal reads and
    # dispatch counts, and the recorder's cost an executed window.
    off = sparse_sim(dev)
    off.precompile_pieces()
    off.step_until_time(190.0)
    off.decisions_total()
    x0 = off.dispatch_stats["executed_windows"]
    off_s = timed_span(off)
    off.decisions_total()
    if (off.host_syncs, dict(off.dispatch_stats)) != armed:
        fail(f"phase 15: telemetry off read or dispatched otherwise: {(off.host_syncs, off.dispatch_stats)} vs {armed}")
    out["telemetry_off_wall_s"] = off_s
    out["telemetry_off_ms_per_executed_window"] = 1e3 * off_s / max(off.dispatch_stats["executed_windows"] - x0, 1)
    del off
    out["busy"], _ = profiled_busy(lambda: sparse_sim(dev), 5000.0, 7000.0, "phase 15")
    # Every window stepped, on the card.
    plain = sparse_sim(dev, fast_forward=False)
    plain.precompile_pieces()
    plain.step_until_time(190.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.step_until_time(horizon)
    torch.cuda.synchronize()
    out["every_window_wall_s"] = time.perf_counter() - t0
    bad = compare_states(state_to_numpy(plain.state), final)
    if bad:
        fail(f"phase 15: fast-forward and every window differ at {bad}")
    del plain, final
    # Card against CPU at C = 4, on this line and the autoscaled variant.
    runs = {
        "sparse headline C=4": (lambda where: sparse_sim(where, 4), SPARSE_CHECK_UNTIL),
        "composed at 0.02/s, reclaim, C=4": (
            lambda where: composed_sim(where, 4, **{**FULL_COMPOSED, "rate": 0.02, "horizon": 2000.0},
                                       reclaim=True, fast_forward=True), 2000.0),
    }
    for label, (build, until) in runs.items():
        finals = {}
        for where in ("cuda", "cpu"):
            s15 = build(where)
            if not s15.fast_forward or (label.startswith("composed") and not s15.reclaim):
                fail(f"phase 15: {label} on {where} built with fast_forward {s15.fast_forward}, reclaim {s15.reclaim}")
            s15.step_until_time(until)
            if where == "cuda":
                st = s15.dispatch_stats
                if not s15.graphs or st["eager_windows"] or st["graph_windows"] != st["executed_windows"]:
                    fail(f"phase 15: {label}: the card run did not go through the graph executor alone ({st})")
            finals[where] = (state_to_numpy(s15.state), s15.metrics_summary()["counters"], s15.next_window_idx,
                             dict(s15.dispatch_stats))
        bad = compare_states(finals["cuda"][0], finals["cpu"][0])
        if bad or finals["cuda"][2] != finals["cpu"][2]:
            fail(f"phase 15: {label}: card and CPU differ at {bad}")
        ex = [finals[w][3]["executed_windows"] for w in ("cuda", "cpu")]
        if ex[0] != ex[1]:
            fail(f"phase 15: {label}: {ex[0]} windows executed on the card, {ex[1]} on the CPU")
        out[label] = {"counters": finals["cuda"][1], "executed_windows": ex[0],
                      "skipped_windows": finals["cuda"][3]["skipped_windows"]}
        print(f"phase 15: {label} to t={until:.0f} s: card == CPU under compare_states, {ex[0]} windows executed "
              f"and {finals['cuda'][3]['skipped_windows']} skipped on both ({finals['cuda'][1]})", flush=True)
    print(
        f"phase 15: sparse headline {out['shape']} (built in {build_s:.2f} s), fast-forward on by its default: "
        f"t = 190 -> {horizon:.0f} s, {windows} windows ({executed} executed, {stats['skipped_windows']} skipped) "
        f"in {elapsed:.3f} s = {out['ms_per_executed_window']:.3f} ms an executed window with telemetry on "
        f"({out['telemetry_off_ms_per_executed_window']:.3f} off, the same reads and dispatches; "
        f"{out['ring_drains']['drains']} ring drains of {out['ring_drains']['windows']} windows, read "
        f"{out['ring_drains']['read_ms']:.3f} ms + host {out['ring_drains']['host_ms']:.3f} ms in all), "
        f"{out['decisions_per_s']:.1f} decisions/s, {out['host_reads_per_executed_window']:.3f} host reads an "
        f"executed window, {out['busy']['kernels_per_executed_window']:.1f} kernels and "
        f"{out['busy']['busy_ms_per_executed_window']:.4f} ms busy an executed window; every window "
        f"(fast_forward=False) {out['every_window_wall_s']:.3f} s, equal state; launches {launches}",
        flush=True,
    )
    return out


def conditional_move_phase(dev, sk, names, ref: dict) -> dict:
    """Phase 16: phase 6w's composed line (through pod_window=512) with
    enable_unscheduled_pods_conditional_move, timed as phase 6w on the
    graph executor (timed_path: no eager window, one host read a span,
    none inside it), beside phase 6w's host ms, busy ms and kernels a
    window (`ref`); card == CPU at C = 4 to t = 400 s, reclaim on both."""
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.convert import state_to_numpy

    def build():
        return composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, conditional_move=True)

    sim = build()
    if not sim.conditional_move or sim.fast_forward:
        fail(f"phase 16: conditional move {sim.conditional_move}, fast_forward {sim.fast_forward}")
    out = timed_path(sim, sk, names, "phase 16")
    out["counters"] = sim.metrics_summary()["counters"]
    del sim
    out["busy"], _ = profiled_busy(build, 190.0, 1190.0, "phase 16")
    finals = {}
    for where in ("cuda", "cpu"):
        s16 = composed_sim(where, 4, conditional_move=True, reclaim=True)
        s16.step_until_time(400.0)
        if where == "cuda":
            ran_on_graphs("phase 16", s16)
            if s16.host_syncs:
                fail(f"phase 16: {s16.host_syncs} host reads on the card at C=4")
        finals[where] = (state_to_numpy(s16.state), s16.metrics_summary()["counters"])
    bad = compare_states(finals["cuda"][0], finals["cpu"][0])
    if bad:
        fail(f"phase 16: card and CPU differ at {bad}")
    out["card_cpu_counters"] = finals["cuda"][1]
    print(
        f"phase 16: the composed line through {WINDOWED_COMPOSED} with the conditional move, on graphs: "
        f"{out['ms_per_window']:.3f} ms a window (phase 6w {ref['ms_per_window']:.3f}), device busy "
        f"{out['busy']['busy_ms_per_window']:.4f} ms (6w {ref['busy']['busy_ms_per_window']:.4f}), "
        f"{out['busy']['kernels_per_window']:.1f} kernels a window (6w {ref['busy']['kernels_per_window']:.1f}), "
        f"{out['decisions_per_s']:.1f} decisions/s; card == CPU at C=4 to 400 s ({finals['cuda'][1]})",
        flush=True,
    )
    return out


def check_ring(label, sim, executed=None) -> tuple:
    """Fail unless the drained telemetry ring is lossless: one record a
    window run (`executed`: the executed windows' count under fast-forward,
    their indices increasing), the decision deltas summing to the
    decisions counter. Returns the series."""
    wins, data = sim.telemetry_window_series()
    if executed is None:
        if not np.array_equal(wins, np.arange(sim.windows_run)):
            fail(f"{label}: the ring holds {len(wins)} windows, not the {sim.windows_run} run")
    elif len(wins) != executed or not bool((np.diff(wins) > 0).all()) or (len(wins) and wins[-1] >= sim.next_window_idx):
        fail(f"{label}: the ring holds {len(wins)} windows, not the {executed} executed")
    decisions = int(sim.state.metrics.scheduling_decisions.sum())
    if int(data[:, :, 1].sum()) != decisions:
        fail(f"{label}: the ring's decisions sum to {int(data[:, :, 1].sum())}, the counter holds {decisions}")
    return wins, data


def watchdog_gate(label, sim, caught) -> list:
    """The reference's endurance gate on the watchdog (`bench.py:745-760`):
    fail on a reserve verdict, caught as a warning or still fired, or if
    the watchdog never judged a drain. `caught` must hold the warnings of a
    block that ended in drain_telemetry(), so that the last windows are
    judged inside it. Returns the verdicts caught."""
    verdicts = [str(w.message) for w in caught if "saturation watchdog" in str(w.message)]
    reserve = [v for v in verdicts if "reserve" in v] + [k for k in sim.observatory.fired if "reserve" in k]
    if reserve:
        fail(f"{label}: the watchdog gave reserve verdicts under reclaim: {reserve}")
    if sim.observatory.samples <= 0:
        fail(f"{label}: the watchdog judged no drain")
    return verdicts


def telemetry_phase(dev, sk, names, ref: dict) -> dict:
    """Phase 17: the flight recorder on phase 6w's line (the composed line
    through pod_window=512, slot reclaim on), timed as phase 6w on the
    graph executor once with telemetry on (and the watchdog, which rides
    it) and once off: the states equal but the ring (strip_telemetry),
    host reads and dispatch_stats equal, one host read a span and none
    inside it on both (timed_path), the record launched once a window on
    and never off, the ring lossless; kernels, host ms and busy ms a
    window on against off (traced second runs); then at phase 7w's depth
    (C = 8, 4 nodes, through an 8-slot pod window, reclaim on, to 400 s)
    the card's ring and gauge series equal the CPU's (the ring bit for
    bit, the gauges' counts exact and utilizations at rtol 1e-5, float32
    sums in another order), and the gauge CSV is written."""
    from kubernetriks_tpu_torch.batched.state import compare_states, strip_telemetry
    from kubernetriks_tpu_torch.convert import state_to_numpy

    def build(on, **kwargs):
        return composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, telemetry=on, **kwargs)

    out, finals = {}, {}
    for on in (True, False):
        label = f"phase 17 telemetry {'on' if on else 'off'}"
        sim = build(on)
        if (sim.state.telemetry is not None) != on or sim._watchdog != on or not sim.reclaim:
            fail(f"{label}: built with ring {sim.state.telemetry is not None}, watchdog {sim._watchdog}, "
                 f"reclaim {sim.reclaim}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = timed_path(sim, sk, names + (["telemetry_record"] if on else []), label)
            if on:
                sim.drain_telemetry()
        records = run["launches"]["telemetry_record"]
        if records != (sim.windows_run if on else 0):
            fail(f"{label}: the record launched {records} times in {sim.windows_run} windows")
        if on:
            run["verdicts"] = watchdog_gate(label, sim, caught)
            check_ring(label, sim)
            run["report"] = {k: v for k, v in sim.telemetry_report().items()
                             if k in ("ring", "ring_drains", "per_window", "sync_budget")}
        # The feeder's production count depends on its thread's timing.
        stats = {k: v for k, v in sim.dispatch_stats.items() if k != "feeder_slabs_produced"}
        finals[on] = (state_to_numpy(strip_telemetry(sim.state)), sim.host_syncs, stats)
        sim.close()
        out["on" if on else "off"] = run
        del sim
        run["busy"], _ = profiled_busy(lambda: build(on), 190.0, 1190.0, label)
    bad = compare_states(finals[True][0], finals[False][0])
    if bad:
        fail(f"phase 17: telemetry on and off differ at {bad}")
    if finals[True][1:] != finals[False][1:]:
        fail(f"phase 17: host reads or dispatch_stats differ on {finals[True][1:]} and off {finals[False][1:]}")
    # Card against CPU at phase 7w's depth: the ring and the gauges.
    series = {}
    for where in ("cuda", "cpu"):
        s17 = composed_sim(where, 8, pod_window=8, reclaim=True, telemetry=True)
        s17.collect_gauges = True
        s17.step_until_time(400.0)
        if where == "cuda":
            ran_on_graphs("phase 17", s17)
            csv_path = OUT_DIR / "phase17_gauges.csv"
            s17.write_gauge_csv(str(csv_path), cluster=3)
            rows = csv_path.read_text().splitlines()
            if len(rows) != s17.windows_run + 1 or not rows[0].startswith("timestamp,current_nodes"):
                fail(f"phase 17: the gauge CSV has {len(rows)} lines for {s17.windows_run} windows")
        series[where] = (check_ring(f"phase 17 {where}", s17), s17.gauge_series(), state_to_numpy(s17.state))
    (wc, dc), (tc, gc), sc = series["cuda"]
    (wh, dh), (th, gh), sh = series["cpu"]
    if not (np.array_equal(wc, wh) and np.array_equal(dc, dh)):
        fail("phase 17: the card's ring differs from the CPU's")
    if compare_states(sh, sc):
        fail(f"phase 17: card and CPU states differ at {compare_states(sh, sc)}")
    if not (np.array_equal(tc, th) and np.array_equal(gc[..., :3], gh[..., :3])
            and np.allclose(gc[..., 3:], gh[..., 3:], rtol=1e-5, atol=0.0)):
        fail("phase 17: the card's gauges differ from the CPU's")
    out["card_cpu"] = {"windows": int(len(wc)), "ring_totals": dc.sum(axis=(0, 1)).tolist()}
    on, off = out["on"], out["off"]
    print(
        f"phase 17: telemetry on against off on {WINDOWED_COMPOSED} (phase 6w {ref['ms_per_window']:.3f} ms): host "
        f"{on['ms_per_window']:.3f} / {off['ms_per_window']:.3f} ms a window, device busy "
        f"{on['busy']['busy_ms_per_window']:.4f} / {off['busy']['busy_ms_per_window']:.4f} ms, "
        f"{on['busy']['kernels_per_window']:.1f} / {off['busy']['kernels_per_window']:.1f} kernels a window; "
        f"states equal but the ring, host reads and dispatch_stats equal; ring lossless "
        f"({on['report']['ring']['windows_kept']} windows), watchdog verdicts {on['verdicts']}; at C=8 through "
        f"pod_window=8 to 400 s the card's ring == the CPU's ({len(wc)} windows) and its gauges (CSV written)",
        flush=True,
    )
    return out


def churn_phase(dev, sk, must_launch) -> dict:
    """Phase 12: the reference's endurance churn (endurance_sim) at
    ENDURANCE_CLUSTERS clusters through ENDURANCE_WAVES waves, as the
    reference runs it: its fault block on (each cluster with its own crash
    chains) and ca_slot_multiplier 2 (ENDURANCE_KWARGS), on the graph
    executor with the card's default, slot reclaim on: timed from window 0
    with the launch counts set to 0 just before, one host read a span (the
    pod window's) and none inside it. It must finish with the autoscaler
    bounds clean, every cluster's allocations at least 3x its static
    reserve (the reference's gate, `bench.py:619`) and slots reclaimed on
    every cluster. A second run, read once a wave mid-wave, must show the
    dynamic scale-down order (ca_name_order) away from the static table at
    least once; a third, traced, gives device busy ms a window over waves
    40-50; without reclaim the same churn must raise; and at the reference
    bench's own size (4 clusters, 24 waves), and through REORDER_WAVES
    waves, the card's final state must equal the CPU's, reclaim on both
    sides, the longer CPU run removing a node on a reordered walk."""
    from kubernetriks_tpu_torch.batched.autoscale import ca_name_order
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.convert import state_to_numpy

    horizon = 30.0 + ENDURANCE_WAVES * 160.0

    def build(**kwargs):
        kwargs.setdefault("telemetry", True)
        kwargs.setdefault("watchdog", kwargs["telemetry"])
        return endurance_sim(dev, ENDURANCE_CLUSTERS, ENDURANCE_WAVES, **ENDURANCE_KWARGS, **kwargs)

    t0 = time.perf_counter()
    sim = build()
    build_s = time.perf_counter() - t0
    if not sim.reclaim or not sim.graphs or not sim._watchdog:
        fail(f"phase 12: the card engine built with reclaim {sim.reclaim}, graphs {sim.graphs}, "
             f"watchdog {sim._watchdog}")
    t0 = time.perf_counter()
    captured = sim.precompile_pieces()
    capture_s = time.perf_counter() - t0
    sk.reset_launches()
    syncs0, stats0 = sim.host_syncs, dict(sim.dispatch_stats)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        sim.step_until_time(horizon)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        sim.drain_telemetry()
    # The reference's endurance gate (`bench.py:625-626, 745-760`): no
    # reserve verdict under reclaim, and the ring lossless over the run.
    verdicts = watchdog_gate("phase 12", sim, caught)
    check_ring("phase 12", sim)
    launches = sk.launch_counts()
    stats = {k: sim.dispatch_stats[k] - stats0[k] for k in stats0}
    syncs, windows = sim.host_syncs - syncs0, sim.windows_run
    check_sliding_run("phase 12", sim, stats, syncs, windows)
    summary = sim.metrics_summary()  # raises if an autoscaler bound was crossed
    st = sim.autoscale_statics
    reserve = st.ng_slot_count.sum(dim=1).cpu()
    total = sim.state.auto.ca_total.sum(dim=1).cpu()
    reclaimed = torch.from_numpy(sim.ca_slots_reclaimed())
    if not bool((total >= 3 * reserve).all()):
        fail(f"phase 12: allocations {total.min().item()} under 3x the reserve {reserve.max().item()}")
    if not bool((reclaimed > 0).all()):
        fail("phase 12: a cluster reclaimed no slot")
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"phase 12: never launched {name}")
    counters = summary["counters"]
    if counters["node_crashes"] <= 0 or counters["pod_restarts"] <= 0:
        fail(f"phase 12: the churn with faults showed no crash or restart: {counters}")
    out = {
        "shape": {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "K": sim.max_pods_per_cycle,
                  "reserve": int(reserve[0]), "waves": ENDURANCE_WAVES, "horizon_s": horizon},
        "build_s": build_s,
        "windows": windows, "wall_s": elapsed, "ms_per_window": 1e3 * elapsed / max(windows, 1),
        "decisions_per_s": counters["scheduling_decisions"] / elapsed,
        "precompiled_graphs": captured, "precompile_s": capture_s,
        "window": sliding_report(sim, stats, syncs, windows), "graph": graph_report(sim, stats),
        "allocations_per_cluster": int(total[0]), "reclaimed_per_cluster": int(reclaimed[0]),
        "counters": counters, "launches": launches, "watchdog_verdicts": verdicts,
        "watchdog_samples": sim.observatory.samples,
        "ring": {k: v for k, v in sim.telemetry_report()["ring"].items() if k != "columns"},
        "ring_drains": sim.telemetry_report()["ring_drains"],
        "observatory": sim.telemetry_report()["resources"]["occupancy"],
    }
    del sim
    # The dynamic name order, read once a wave (a separate run, at
    # CHURN_CHECK_CLUSTERS clusters: the reads would stall the timed one).
    sim = endurance_sim(dev, CHURN_CHECK_CLUSTERS, ENDURANCE_WAVES, **ENDURANCE_KWARGS)
    sim.precompile_pieces()
    st = sim.autoscale_statics
    apart = []
    for k in range(ENDURANCE_WAVES):
        sim.step_until_time(30.0 + k * 160.0 + 50.0)
        sd_order, _ = ca_name_order(sim.state.auto, st, sim._k)
        if not torch.equal(sd_order, st.ca_sd_order):
            apart.append(k)
    if not apart:
        fail("phase 12: the dynamic scale-down order never left the static table")
    out["waves_with_dynamic_order"] = apart
    del sim
    out["busy"], _ = profiled_busy(build, 30.0 + 40 * 160.0, 30.0 + 50 * 160.0, "phase 12")
    # Without reclaim the same churn runs the 2-slot reserve dry (shown at
    # CHURN_CHECK_CLUSTERS clusters).
    off = endurance_sim(dev, CHURN_CHECK_CLUSTERS, ENDURANCE_WAVES, **ENDURANCE_KWARGS, reclaim=False, telemetry=False)
    off.step_until_time(30.0 + 6 * 160.0)
    try:
        off.metrics_summary()
        fail("phase 12: the churn without reclaim did not raise")
    except RuntimeError as e:
        if "CA slot reserve exhausted" not in str(e):
            raise
        out["without_reclaim"] = str(e).split(";")[0]
    del off
    # Card against CPU at the reference bench's own size, reclaim on both;
    # again through REORDER_WAVES waves, past the pair whose names straddle
    # 99 / 100, where the CPU run must remove a node on a reordered walk.
    for n_waves in (REORDER_WAVES,):
        finals = {}
        for where in ("cuda", "cpu"):
            s = endurance_sim(where, 4, n_waves, reclaim=True, **ENDURANCE_KWARGS)
            reordered, restore = count_reordered_removals(s)
            try:
                s.step_until_time(30.0 + n_waves * 160.0)
            finally:
                restore()
            if where == "cuda":
                ran_on_graphs("phase 12", s)
            finals[where] = (state_to_numpy(s.state), s.metrics_summary()["counters"], reordered[0])
        bad = compare_states(finals["cuda"][0], finals["cpu"][0])
        if bad:
            fail(f"phase 12: churn at C=4, {n_waves} waves: card and CPU states differ at {bad}")
        out[f"card_cpu_counters_{n_waves}_waves"] = finals["cuda"][1]
    out["cpu_reordered_removals"] = finals["cpu"][2]
    if not finals["cpu"][2]:
        fail(f"phase 12: the CPU churn through {REORDER_WAVES} waves removed no node on a reordered walk")
    print(
        f"phase 12: endurance churn with faults, {ENDURANCE_CLUSTERS} clusters x {out['shape']['N']} node slots "
        f"(built in {build_s:.2f} s), "
        f"{ENDURANCE_WAVES} waves to {horizon:.0f} s through a {out['shape']['reserve']}-slot CA reserve: "
        f"{windows} windows in {elapsed:.3f} s = {out['ms_per_window']:.4f} ms a window, device busy "
        f"{out['busy']['busy_ms_per_window']:.4f} ms a window, {out['decisions_per_s']:.1f} decisions/s, "
        f"{out['allocations_per_cluster']} allocations and {out['reclaimed_per_cluster']} slots reclaimed a "
        f"cluster, bounds clean, telemetry and the watchdog armed: no reserve verdict in "
        f"{out['watchdog_samples']} drains judged (verdicts {verdicts}), "
        f"ring lossless ({out['ring']['windows_kept']} windows), window {out['window']}, dynamic name order off "
        f"the static table in waves "
        f"{apart} (at {CHURN_CHECK_CLUSTERS} clusters); without reclaim ({CHURN_CHECK_CLUSTERS} clusters): "
        f"{out['without_reclaim']}; at C=4 card == CPU through {REORDER_WAVES} waves "
        f"({out[f'card_cpu_counters_{REORDER_WAVES}_waves']}) "
        f"({out['cpu_reordered_removals']} scale-down calls removing on a reordered walk on the CPU); "
        f"launches {launches}",
        flush=True,
    )
    return out


# The churn phase's scale (ENDUR_r01.json's wave count, 15 390 simulated s)
# and the reference's settings of its long endurance runs (`bench.py:610,
# 688`): faults on, a slot multiplier of 2.
ENDURANCE_CLUSTERS = 256
ENDURANCE_WAVES = 96
# The churn phase's side runs (the dynamic order read once a wave, the raise
# without reclaim) at this many clusters (a depth cut from 256, PERF.md §4).
CHURN_CHECK_CLUSTERS = 16
ENDURANCE_KWARGS = {"faults": True, "ca_slot_multiplier": 2}
# Wave 74's pair is allocated as ca_node_99 and ca_node_100: the first two
# coexisting CA nodes whose names leave allocation order.
REORDER_WAVES = 76


def count_reordered_removals(sim):
    """Count, in a list of one, the scale-down calls of `sim` (uncaptured:
    a replayed graph bypasses the wrapper) that remove a node while they
    walk the live candidates in another order than the static table.
    Returns (count, restore)."""
    from kubernetriks_tpu_torch.batched import autoscale as autoscale_mod

    count = [0]
    real = autoscale_mod.fused_ca_scale_down
    st = sim.autoscale_statics

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        if not args[2].is_cuda:
            count[0] += int((scale_down_walk_reordered(args, st) & out.any(dim=1)).sum())
        return out

    autoscale_mod.fused_ca_scale_down = wrapped
    return count, lambda: setattr(autoscale_mod, "fused_ca_scale_down", real)
CHURN_LABELS = {n: f"{n} (churn, reclaim)" for n in ("fused_ca_scale_down", "fused_ca_scale_up")}


def live_walk(slot_perm, alive):
    """The live candidates' node slots in the walk order `slot_perm` ((C,
    S), -1 padded) gives them, first in each row, -1 after them."""
    live = (slot_perm >= 0) & torch.gather(alive, 1, slot_perm.clamp(min=0).long())
    first = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    return torch.where(torch.gather(live, 1, first), torch.gather(slot_perm, 1, first), -1)


def scale_down_walk_reordered(args, st):
    """(C,) bool: where the scale-down call `args` (fused_ca_scale_down's
    positional arguments) walks its live candidates in another order than
    the static name table `st.ca_sd_order` would."""
    static = torch.gather(st.ca_slots, 1, st.ca_sd_order).to(args[9].dtype)
    return (live_walk(args[9], args[2]) != live_walk(static, args[2])).any(dim=1)


def churn_ca_inputs(dev):
    """The two CA kernels' arguments on the endurance churn as phase 12
    runs it (ENDURANCE_CLUSTERS clusters, ENDURANCE_KWARGS: faults on,
    slot multiplier 2; graphs off) once slots have been reused: the first scale-down that
    removes a node while it walks the live candidates in another order
    than the static table would (two coexisting CA nodes whose names
    straddle a digit boundary, "ca_node_100" < "ca_node_99": wave 74's
    pair), and the first scale-up that opens a node with the cursor below
    the allocations made (slots returned). Cloned, as capture_first keeps
    them. Returns ({name: (args, kwargs)}, the engine's shapes)."""
    from kubernetriks_tpu_torch.batched import autoscale as autoscale_mod

    sim = endurance_sim(dev, ENDURANCE_CLUSTERS, ENDURANCE_WAVES, graphs=False, **ENDURANCE_KWARGS)
    st, auto = sim.autoscale_statics, sim.state.auto  # the engine's fixed buffers
    reserve = st.ng_slot_count.sum(dim=1)

    def reused():
        return bool((auto.ca_total.sum(dim=1) > reserve).any())

    cap_up, restore_up = capture_first(
        autoscale_mod, "fused_ca_scale_up",
        lambda a, o: bool(a[8].any()) and bool(o[0].any()) and reused() and bool((a[2] < auto.ca_total).any()),
    )
    cap_down, restore_down = capture_first(
        autoscale_mod, "fused_ca_scale_down",
        lambda a, o: bool(o.any()) and reused() and bool(scale_down_walk_reordered(a, st).any()),
    )
    try:
        for k in range(ENDURANCE_WAVES):
            sim.step_until_time(30.0 + (k + 1) * 160.0)
            if "fused_ca_scale_up" in cap_up and "fused_ca_scale_down" in cap_down:
                break
    finally:
        restore_up()
        restore_down()
    torch.cuda.synchronize()
    if "fused_ca_scale_up" not in cap_up or "fused_ca_scale_down" not in cap_down:
        fail(f"the churn never scaled up and down on reused slots (captured {list(cap_up) + list(cap_down)})")
    shape = {"C": sim.n_clusters, "N": sim.n_nodes, "S": st.ca_slots.shape[1], "t": sim.next_window}
    return {**cap_up, **cap_down}, shape


def slide_piece_cost(sim, reps: int = 20) -> dict:
    """The slide piece's graph replayed `reps` times on its own, after the
    run (each replay slides the window further, or not at all): host
    microseconds a launch (cudaGraphLaunch, asynchronous) and device
    microseconds a replay (CUDA events around the replays). What fusing
    the slide into the end graph could save is bounded by the first."""
    graph = sim._executor.graphs[sim._executor.slide_key()][0]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        graph.replay()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return {"host_us_per_launch": 1e6 * host / reps, "device_us_per_replay": 1e3 * start.elapsed_time(end) / reps}


def replay_window_phase(dev, sk, paths, whole: dict, must_launch, stream: bool = True, streamed=None) -> dict:
    """Phase 9w: the replay of phase 9 through its sliding pod window
    (REPLAY_POD_WINDOW) to completion on the graph executor (one read a
    span, and run_to_completion's own), its counters and window count equal
    to phase 9's (`whole`), every pod terminal; device busy from 100
    traced windows of a second run from 43 200 s. `stream`: the streaming
    feeder on (the card's default) or off (the whole-trace payload on the
    device); `streamed`: the streamed run's numbers, which the run without
    the feeder must equal, state and host reads."""
    from kubernetriks_tpu_torch.batched.state import flatten

    label = "phase 9w" + ("" if stream else " (stream off)")
    stamp(label)

    def build():
        return replay_sim(dev, paths, pod_window=REPLAY_POD_WINDOW, stream=stream)

    t0 = time.perf_counter()
    sim = build()
    build_s = time.perf_counter() - t0
    if sim._stream_on() != stream or (sim._slide_payload is None) != stream:
        fail(f"{label}: the engine streams {sim._stream_on()}, its whole payload {sim._slide_payload is not None}")
    captured = sim.precompile_pieces()
    sk.reset_launches()
    syncs0, stats0 = sim.host_syncs, dict(sim.dispatch_stats)
    t0 = time.perf_counter()
    sim.run_to_completion(max_time=86400.0 * 20.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sk.launch_counts()
    stats = {k: sim.dispatch_stats[k] - stats0[k] for k in stats0}
    syncs = sim.host_syncs - syncs0
    check_sliding_run(label, sim, stats, syncs, sim.windows_run,
                      max_completion_reads=-(-sim.windows_run // 64))
    if stream and stats["stage_refills"] <= 0:
        fail(f"{label}: the feeder installed no slab")
    summary = sim.metrics_summary()
    if summary["counters"] != whole["counters"]:
        fail(f"{label}: counters differ from phase 9: {summary['counters']} vs {whole['counters']}")
    if sim.windows_run != whole["windows"]:
        fail(f"{label}: {sim.windows_run} windows, phase 9 {whole['windows']}")
    W, base = sim.pod_window, sim._pod_base
    ph = sim.state.pods.phase[:, : max(0, min(W, sim.n_real_pods - base))]
    if not bool(((ph == 4) | (ph == 5) | (ph == 6)).all()):
        fail(f"{label}: the replay ended with a pod that is not terminal")
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"{label}: never launched {name}")
    final = {p: leaf.clone() for p, leaf in flatten(sim.state).items()}
    out = {
        "stream": stream,
        "shape": {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "W": W, "T": sim.consts.trace_pod_bound},
        "build_s": build_s,
        "windows": sim.windows_run,
        "wall_s": elapsed,
        "ms_per_window": 1e3 * elapsed / max(sim.windows_run, 1),
        "decisions_per_s": summary["counters"]["scheduling_decisions"] / elapsed,
        "precompiled_graphs": captured,
        "graph": graph_report(sim, stats),
        "window": sliding_report(sim, stats, syncs, sim.windows_run),
        "host_syncs": syncs,
        "staging": sim.staging_bytes(),
        "feeder": sim.telemetry_report().get("feeder") or sim._last_feeder_report,
        "counters": summary["counters"],
        "timings": summary["timings"],
        "launches": launches,
    }
    sim.close()
    del sim, ph
    if streamed is not None:
        bad = [p for p, leaf in final.items() if not torch.equal(leaf, streamed["final"][p])]
        if bad:
            fail(f"{label}: the state differs from the streamed run's at {bad}")
        if syncs != streamed["host_syncs"]:
            fail(f"{label}: {syncs} host reads, the streamed run {streamed['host_syncs']}")
    else:
        out["final"] = final
        # Traced once, streamed: the run without the feeder runs the same
        # kernels (a depth cut, PERF.md section 4).
        out["busy"], again = profiled_busy(build, 43200.0, 44200.0, label)
        again.close()
        del again
    busy = out["busy"] if streamed is None else streamed["busy"]
    print(
        f"{label}: replay through pod_window={REPLAY_POD_WINDOW} to completion: {out['windows']} windows in "
        f"{elapsed:.3f} s = {out['ms_per_window']:.3f} ms a window (phase 9 {whole['wall_s']:.3f} s = "
        f"{whole['ms_per_window']:.3f}), device busy {busy['busy_ms_per_window']:.4f} ms a window "
        f"({busy['kernels_per_window']:.1f} kernels{'' if streamed is None else '; the streamed run'}) from 43 200 s "
        f"(phase 9 "
        f"{whole['busy']['busy_ms_per_window']:.4f}), {syncs} host reads, window {out['window']}, slabs installed "
        f"{stats['stage_refills']}, staging {out['staging']}, feeder {out['feeder']}, counters equal phase 9's"
        + ("" if streamed is None else "; state and host reads equal the streamed run's")
        + f", launches {launches}",
        flush=True,
    )
    return out


# Phase 18: the synthetic day replicated over this many clusters with the CA
# on, through REPLAY_POD_WINDOW, to this simulated time (two slab installs
# at least); its whole-trace payload is over the 2 GiB device budget.
STREAMED_CLUSTERS = 1024
STREAMED_UNTIL = 20000.0


def streamed_replay_phase(dev, sk, paths, must_launch) -> dict:
    """Phase 18: over the budget, streamed. The replay's synthetic day at
    STREAMED_CLUSTERS clusters through REPLAY_POD_WINDOW, built through the
    CLI's native path (the C++ feeder, compile_from_arrays), whose
    whole-trace slide payload exceeds SLIDE_PAYLOAD_BUDGET_BYTES, run to
    STREAMED_UNTIL on the graph executor with the streaming feeder (one
    host read a span, at least two slabs installed; the launch counts set
    to 0 just before, every kernel of the path launched); device busy from
    100 traced windows after it; then every cluster's state equals a
    one-cluster streamed run to the same time on the same cycle route
    (no faults: the clusters are identical)."""
    from kubernetriks_tpu_torch.batched import engine as engine_mod
    from kubernetriks_tpu_torch.convert import state_to_numpy
    from kubernetriks_tpu_torch.trace import feeder

    if not feeder.native_available():
        fail(f"phase 18: the native trace feeder did not build: {feeder.native_build_error()}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sim = replay_sim(dev, paths, pod_window=REPLAY_POD_WINDOW, n_clusters=STREAMED_CLUSTERS)
    build_s = time.perf_counter() - t0
    W = sim.pod_window
    whole_bytes = sim._whole_payload_bytes(W)
    if whole_bytes <= engine_mod.SLIDE_PAYLOAD_BUDGET_BYTES:
        fail(f"phase 18: the whole payload ({whole_bytes} B) fits the budget")
    if not sim._stream_on() or sim._slide_payload is not None:
        fail("phase 18: the engine does not stream")
    t0 = time.perf_counter()
    captured = sim.precompile_pieces()
    capture_s = time.perf_counter() - t0
    sk.reset_launches()
    syncs0, stats0, windows0 = sim.host_syncs, dict(sim.dispatch_stats), sim.windows_run
    t0 = time.perf_counter()
    sim.step_until_time(STREAMED_UNTIL)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sk.launch_counts()
    stats = {k: sim.dispatch_stats[k] - stats0[k] for k in stats0}
    syncs, windows = sim.host_syncs - syncs0, sim.windows_run - windows0
    check_sliding_run("phase 18", sim, stats, syncs, windows)
    for name in must_launch:
        if launches[name] <= 0:
            fail(f"phase 18: never launched {name}")
    if stats["stage_refills"] < 2:
        fail(f"phase 18: {stats['stage_refills']} slab(s) installed")
    report = sim.telemetry_report()
    staging = sim.staging_bytes()
    peak = torch.cuda.max_memory_allocated()
    if staging["device_peak_bytes"] >= staging["whole_payload_bytes"]:
        fail(f"phase 18: the staging's device peak {staging} is not below the whole payload")
    decisions = sim.decisions_total()
    big = state_to_numpy(sim.state)
    out = {
        "shape": {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "W": sim.pod_window,
                  "T": sim.consts.trace_pod_bound, "L": sim._stage_cols(), "K": sim.max_pods_per_cycle,
                  "route": sim.cycle_route},
        "build_s": build_s,
        "precompile_s": capture_s,
        "precompiled_graphs": captured,
        "windows": windows,
        "wall_s": elapsed,
        "ms_per_window": 1e3 * elapsed / max(windows, 1),
        "decisions": decisions,
        "decisions_per_s": decisions / elapsed,
        "host_syncs": syncs,
        "window": sliding_report(sim, stats, syncs, windows),
        "stage_refills": stats["stage_refills"],
        "feeder_slabs_produced": report["dispatch_stats"]["feeder_slabs_produced"],
        "feeder": report.get("feeder") or sim._last_feeder_report,
        "staging": staging,
        "device_peak_allocated_bytes": peak,
        "spans": {k: v for k, v in report.get("spans", {}).items() if k.startswith("stage")},
        "launches": launches,
    }
    route = sim.cycle_route
    # Device busy over 100 more windows of the same run.
    def more():
        w0 = sim.windows_run
        sim.step_until_time(STREAMED_UNTIL + 1000.0)
        return max(sim.windows_run - w0, 1)

    out["busy"] = device_busy(more, "phase 18")
    # The staging after the continuation, a growth's re-seek included: its
    # peak over the whole run must stay below the whole payload at the
    # width reached.
    after = sim.staging_bytes()
    out["after"] = {
        "W": sim.pod_window, "L": sim._stage_cols(), "grows": sim.dispatch_stats["grows"],
        "staging": after, "device_peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "feeder": sim.telemetry_report().get("feeder"),
    }
    if after["device_peak_bytes"] >= after["whole_payload_bytes"]:
        fail(f"phase 18: after the continuation, the staging's device peak {after} is not below the whole payload")
    sim.close()
    del sim
    stamp("phase 18: the one-cluster run")
    # Every cluster against one cluster on the same route.
    one = replay_sim(dev, paths, pod_window=REPLAY_POD_WINDOW)
    one.cycle_route = route
    one.step_until_time(STREAMED_UNTIL)
    small = state_to_numpy(one.state)
    one.close()
    del one
    if set(big) != set(small):
        fail("phase 18: the leaf sets of the 1 024-cluster and the one-cluster states differ")
    bad = []
    for key, a in big.items():
        b = small[key]
        if a.shape[1:] != b.shape[1:]:
            bad.append(key)
        elif ".metrics." in key and a.dtype == np.float32:
            if not np.allclose(a, b, rtol=1e-6, atol=0.0):
                bad.append(key)
        elif not bool((a == b).all()):
            bad.append(key)
    if bad:
        fail(f"phase 18: clusters differ from the one-cluster run at {bad}")
    del big, small
    print(
        f"phase 18: {STREAMED_CLUSTERS} clusters of the synthetic day through pod_window={REPLAY_POD_WINDOW} "
        f"(stage {out['shape']['L']} columns, route {route}), built in {build_s:.1f} s (native feeder, "
        f"compile_from_arrays), {captured} graphs in {capture_s:.1f} s; to {STREAMED_UNTIL:.0f} s: {windows} windows in "
        f"{elapsed:.3f} s = {out['ms_per_window']:.3f} ms a window, device busy "
        f"{out['busy']['busy_ms_per_window']:.4f} ms a window ({out['busy']['kernels_per_window']:.1f} kernels), "
        f"{decisions} decisions, {syncs} host reads ({stats['slides']} slides, {stats['grows']} growths), slabs "
        f"installed {stats['stage_refills']}, produced {out['feeder_slabs_produced']}, feeder {out['feeder']}, "
        f"staging spans {out['spans']}; device staging peak {staging['device_peak_bytes']} B against the whole "
        f"payload's {whole_bytes} B (all device allocations' peak {peak} B); after the continuation to "
        f"{STREAMED_UNTIL + 1000.0:.0f} s {out['after']}; every cluster equals the one-cluster run; launches {launches}",
        flush=True,
    )
    return out


# The reference's --sweep line (`bench.py:981` `run_sweep` defaults; its
# inputs `bench.py:945` `_sweep_setup`): the composed scenario at 8 nodes,
# Poisson pods at 0.375/s for 400 s beside one HPA group of at most 16
# pods (bursts of 100 / 150 / 250 s), a query horizon of 450 s, K = 64.
SWEEP = dict(n_nodes=8, rate=0.375, horizon=400.0, max_group_pods=16, burst=(100.0, 150.0, 250.0))
SWEEP_QUERY_HORIZON = 450.0
SWEEP_K = 64
# Pod faults alone (the reference bench's CrashLoopBackOff block): with
# no crash chain, which a build compiles into the trace, a lane's faults
# are a function of the query's fault_seed, whatever wave it runs in.
POD_FAULTS_YAML = """
fault_injection:
  enabled: true
  pod:
    fail_prob: 0.05
    restart_limit: 3
"""


# The reference's open-loop line (`bench.py:1192` `run_open_loop`
# defaults): the sweep's inputs at 64 nodes, pods at 3/s to 400 s, HPA
# groups of at most 32 pods, 32 queries over 4 lanes, K = 256, pump spans
# of 4 windows, query horizons cycling OPEN_LOOP_HORIZON_MIX (`bench.py:
# 1189`) of 450 s, 5 timed rounds. Its host-chaos line (`bench.py:1452`
# `run_host_chaos` defaults): 8 nodes, pods at 0.375/s to 300 s, 24
# queries over 4 lanes, query horizon 350 s on the same mix, K = 64,
# dispatch faults and stalls at 0.05 (1 ms), seed 7, 4 rounds.
OPEN_LOOP_HORIZON_MIX = (1.0, 0.0625, 0.125, 0.0625)
OPEN_LOOP = dict(n_nodes=64, rate=3.0, horizon=400.0, max_group_pods=32, burst=(100.0, 150.0, 250.0))
OPEN_LOOP_QUERIES, OPEN_LOOP_LANES, OPEN_LOOP_K, OPEN_LOOP_SPAN, OPEN_LOOP_ROUNDS = 32, 4, 256, 4, 5
HOST_CHAOS = dict(n_nodes=8, rate=0.375, horizon=300.0, max_group_pods=16, burst=(100.0, 150.0, 250.0))
HOST_CHAOS_QUERY_HORIZON = 350.0
HOST_CHAOS_RUN = dict(queries=24, lanes=4, seed=7, dispatch=0.05, stall=0.05, stall_ms=1.0, rounds=4)


def sweep_inputs(faults_yaml: str = "", **shape):
    """(config yaml, cluster events, workload events) of the sweep line
    (`shape`: SWEEP's keys overridden, as the reference's other fleet
    lines call `_sweep_setup`)."""
    from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
    from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

    s = {**SWEEP, **shape}
    cluster = UniformClusterTrace(s["n_nodes"], cpu=64000, ram=128 * 1024**3).convert_to_simulator_events()
    plain = PoissonWorkloadTrace(
        rate_per_second=s["rate"], horizon=s["horizon"], seed=3, cpu=16000, ram=32 * 1024**3,
        duration_range=(30.0, 120.0), name_prefix="plain",
    ).convert_to_simulator_events()
    group = GenericWorkloadTrace.from_yaml(
        composed_workload_yaml(s["max_group_pods"], s["burst"])
    ).convert_to_simulator_events()
    return composed_config_yaml(s["n_nodes"]) + faults_yaml, cluster, sorted(plain + group, key=lambda e: e[0])


def sweep_scenarios(n: int, seeds: bool = False):
    """`bench.py:862` `_sweep_scenarios`: n scenarios over the HPA scan
    interval and tolerance and the CA scan interval and threshold, with
    scenario 0 copied to two positions in another lane and another wave
    (the cross-talk probes); `seeds`: each scenario its own fault_seed
    (1000 + i; the copies keep scenario 0's). Returns (scenarios, probe
    positions)."""
    from kubernetriks_tpu_torch.batched.fleet import Scenario

    out = [
        Scenario(
            hpa_scan_interval=(30.0, 60.0, 90.0, 120.0)[i % 4],
            hpa_tolerance=0.05 + 0.05 * (i % 5),
            ca_scan_interval=10.0 + 5.0 * ((i // 2) % 4),
            ca_threshold=0.3 + 0.1 * ((i // 3) % 4),
            fault_seed=1000 + i if seeds else None,
        )
        for i in range(n)
    ]
    probes = []
    for pos in (min(n // 2 + 1, n - 1), n - 1):
        if pos > 0:
            out[pos] = out[0]
            probes.append(pos)
    return out, sorted(set(probes))


def scenario_config(config_yaml: str, scen):
    """`bench.py:889` `_scenario_config`: a standalone config carrying one
    scenario's overrides as plain config scalars (and its fault seed)."""
    from kubernetriks_tpu_torch.config import (
        KubeClusterAutoscalerConfig,
        KubeHorizontalPodAutoscalerConfig,
        SimulationConfig,
    )

    config = SimulationConfig.from_yaml(config_yaml)
    if scen.hpa_scan_interval is not None:
        config.horizontal_pod_autoscaler.scan_interval = scen.hpa_scan_interval
    if scen.hpa_tolerance is not None:
        config.horizontal_pod_autoscaler.kube_horizontal_pod_autoscaler_config = KubeHorizontalPodAutoscalerConfig(
            target_threshold_tolerance=scen.hpa_tolerance)
    if scen.ca_scan_interval is not None:
        config.cluster_autoscaler.scan_interval = scen.ca_scan_interval
    if scen.ca_threshold is not None:
        config.cluster_autoscaler.kube_cluster_autoscaler = KubeClusterAutoscalerConfig(
            scale_down_utilization_threshold=scen.ca_threshold)
    if scen.ca_max_node_count is not None:
        config.cluster_autoscaler.max_node_count = scen.ca_max_node_count
    if scen.as_to_ca_network_delay is not None:
        config.as_to_ca_network_delay = scen.as_to_ca_network_delay
    if scen.hpa_enabled is not None:
        config.horizontal_pod_autoscaler.enabled = scen.hpa_enabled
    if scen.fault_seed is not None:
        config.fault_injection.seed = scen.fault_seed
    return config


def checkpoint_phase(dev, sk, card: str, must_launch, replay_paths, replay_final: dict, replay_windows: int) -> dict:
    """Phase 19: checkpoints on the card. (a) phase 6w's composed line
    (256 clusters, pod_window=512, reclaim on, streaming on, telemetry and
    the watchdog armed) saved at 590 s, restored into a fresh card engine
    and stepped to 1 190 s: its state equals the uninterrupted run's under
    compare_states, its counters too, and its ring, re-drained after the
    restore, holds every window of the run (lossless, bit for bit the
    uninterrupted run's). (b) phase 9w's streamed replay saved mid-stream
    (43 540 s, the first completion chunk boundary past 43 200 s, so the
    continuation's completion reads land where phase 9w's did), restored
    and run to completion: its state equals phase 9w's final state leaf for
    leaf. (c) a C = 4 composed run with faults saved on the card at 300 s,
    restored on the CPU: both continuations to 600 s are equal. Save and
    restore seconds and checkpoint bytes of each, printed beside `card`
    (nvidia-smi's name and power limit)."""
    import shutil
    import tempfile

    from kubernetriks_tpu_torch.batched.state import compare_states, flatten
    from kubernetriks_tpu_torch.convert import state_to_numpy

    tmp = tempfile.mkdtemp(prefix="ktt_ckpt_")
    out = {}

    def save(sim, name):
        path = os.path.join(tmp, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp) if f.startswith(name))
        return path, save_s, nbytes

    def restore(sim, path):
        t0 = time.perf_counter()
        sim.load_checkpoint(path)
        if sim.device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    try:
        # (a) the composed line.
        label = "phase 19a"

        def build():
            return composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, telemetry=True)

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight = build()
            if not (straight.reclaim and straight._stream_on() and straight._watchdog):
                fail(f"{label}: built with reclaim {straight.reclaim}, stream {straight._stream_on()}, "
                     f"watchdog {straight._watchdog}")
            straight.step_until_time(590.0)
            straight.step_until_time(1190.0)
            first = build()
            first.step_until_time(590.0)
            path, save_s, nbytes = save(first, "composed")
            first.close()
            del first
            resumed = build()
            sk.reset_launches()
            restore_s = restore(resumed, path)
            resumed.step_until_time(1190.0)
            torch.cuda.synchronize()
            launches = sk.launch_counts()
            ran_on_graphs(label, resumed)
            a, b = state_to_numpy(straight.state), state_to_numpy(resumed.state)
            bad = compare_states(a, b)
            if bad:
                fail(f"{label}: the restored run differs from the uninterrupted one at {bad}")
            counters = resumed.metrics_summary()["counters"]
            if counters != straight.metrics_summary()["counters"]:
                fail(f"{label}: counters differ: {counters} vs {straight.metrics_summary()['counters']}")
            wins_a, data_a = straight.telemetry_window_series()
            wins_b, data_b = resumed.telemetry_window_series()
            if list(wins_b) != list(range(resumed.next_window_idx)) or list(wins_a) != list(wins_b) or not np.array_equal(
                    data_a, data_b):
                fail(f"{label}: the re-drained ring is not the uninterrupted run's whole series "
                     f"({len(wins_b)} windows, {resumed.next_window_idx} run)")
            for name in must_launch:
                if launches[name] <= 0:
                    fail(f"{label}: the continuation never launched {name}")
        out["composed"] = {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes, "windows": resumed.next_window_idx,
                           "warnings": len(caught), "counters": counters}
        print(f"{label} ({card}): composed line (C=256, pod_window=512, reclaim, stream, telemetry and watchdog) saved at "
              f"590 s in {save_s:.3f} s ({nbytes} B), restored in {restore_s:.3f} s, to 1 190 s: state == the "
              f"uninterrupted run under compare_states, counters equal, the ring re-drained lossless "
              f"({len(wins_b)} windows)", flush=True)
        straight.close()
        resumed.close()
        del straight, resumed, a, b

        # (b) the streamed replay, mid-stream.
        label = "phase 19b"
        save_at = 43540.0
        first = replay_sim(dev, replay_paths, pod_window=REPLAY_POD_WINDOW)
        if not first._stream_on():
            fail(f"{label}: the replay does not stream")
        first.step_until_time(save_at)
        if first._feeder is None or first.dispatch_stats["stage_refills"] <= 0:
            fail(f"{label}: no slab installed by {save_at} s")
        path, save_s, nbytes = save(first, "replay")
        base = first._pod_base
        first.close()
        del first
        resumed = replay_sim(dev, replay_paths, pod_window=REPLAY_POD_WINDOW)
        restore_s = restore(resumed, path)
        if resumed._pod_base != base:
            fail(f"{label}: restored at pod base {resumed._pod_base}, saved at {base}")
        t0 = time.perf_counter()
        resumed.run_to_completion(max_time=86400.0 * 20.0)
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t0
        final = flatten(resumed.state)
        bad = [p for p, leaf in replay_final.items() if p not in final or not torch.equal(leaf, final[p])]
        if bad or resumed.next_window_idx != replay_windows:
            fail(f"{label}: the restored replay differs from phase 9w's at {bad} (windows "
                 f"{resumed.next_window_idx} vs {replay_windows})")
        out["replay"] = {"save_at": save_at, "save_s": save_s, "restore_s": restore_s, "bytes": nbytes,
                         "rest_s": rest_s, "stage_refills": resumed.dispatch_stats["stage_refills"],
                         "pod_window": resumed.pod_window}
        print(f"{label} ({card}): replay through pod_window={REPLAY_POD_WINDOW} streamed, saved at {save_at:.0f} s in "
              f"{save_s:.3f} s ({nbytes} B), restored in {restore_s:.3f} s (pod base {base}), run to completion "
              f"in {rest_s:.2f} s ({resumed.dispatch_stats['stage_refills']} slabs installed after it): every "
              f"leaf == phase 9w's final state", flush=True)
        resumed.close()
        del resumed, final

        # (c) card -> CPU.
        label = "phase 19c"
        on_card = composed_sim(dev, 4, faults=True, reclaim=True)
        on_card.step_until_time(300.0)
        path, save_s, nbytes = save(on_card, "card_to_cpu")
        on_card.step_until_time(600.0)
        cpu = composed_sim("cpu", 4, faults=True, reclaim=True)
        restore_s = restore(cpu, path)
        cpu.step_until_time(600.0)
        bad = compare_states(state_to_numpy(on_card.state), state_to_numpy(cpu.state))
        counters = cpu.metrics_summary()["counters"]
        if bad or counters != on_card.metrics_summary()["counters"]:
            fail(f"{label}: the CPU continuation differs from the card's at {bad}")
        if counters["node_crashes"] <= 0 or counters["pod_restarts"] <= 0:
            fail(f"{label}: no fault by 600 s: {counters}")
        out["card_to_cpu"] = {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes, "counters": counters}
        print(f"{label} ({card}): C=4 composed with faults saved on the card at 300 s ({nbytes} B, {save_s:.3f} s), "
              f"restored on the CPU ({restore_s:.3f} s): the continuations to 600 s are equal ({counters})",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def fleet_phase(dev, sk, card: str, sorted_names, dense_names) -> dict:
    """Phase 20: the scenario fleet on the card (wave-aligned). (a) the
    reference's --sweep line: 64 scenarios over 16 lanes (4 waves), the
    sorted route; (b) the same pattern widened to 1 024 scenarios over 256
    lanes (4 waves), the megakernel route, pod faults on and each scenario
    its own fault_seed. In both: no capture after wave 1 (the pieces are
    captured at the fleet's build), the planted duplicates of scenario 0
    bit-identical to it (counters and every state row), three probe
    queries equal standalone card engines built from `scenario_config`
    (counters, HPA replicas, CA nodes, every state row); in (b) one probe
    is a lane whose fault seed changed since wave 1. Scenarios/s of the
    fleet (build included, as the reference times it) against the three
    standalone engines' mean extrapolated to all scenarios
    (`bench.py:1108-1140`); host and device busy ms a window of a fleet
    wave (a traced repeat of wave 1, whose results must repeat). (c) card
    against CPU: 8 scenarios over 4 lanes (2 waves) with the bench's whole
    fault block (crash chains keyed per lane on each lane's build seed):
    FleetResults and final states equal. Every number is printed beside
    `card` (nvidia-smi's name and power limit)."""
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.batched.fleet import Scenario, ScenarioFleet
    from kubernetriks_tpu_torch.batched.state import compare_states
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.convert import state_to_numpy

    def rows(state_np, lane):
        return {k: v[lane : lane + 1] for k, v in state_np.items()}

    def same(a, b):
        return (a.counters, a.hpa_replicas, a.ca_nodes) == (b.counters, b.hpa_replicas, b.ca_nodes)

    def sweep_line(label, n, lanes, faults_yaml, probes_at, must_launch, route):
        config_yaml, cluster, workload = sweep_inputs(faults_yaml)
        config = SimulationConfig.from_yaml(config_yaml)
        scens, dups = sweep_scenarios(n, seeds=bool(faults_yaml))
        keep = set(dups) | set(probes_at) | {0}
        t0 = time.perf_counter()
        fleet = ScenarioFleet(config, cluster, workload, n_lanes=lanes, horizon=SWEEP_QUERY_HORIZON, device=dev,
                              max_pods_per_cycle=SWEEP_K)
        build_s = time.perf_counter() - t0
        eng = fleet.engine
        if eng.cycle_route != route or not eng.graphs:
            fail(f"{label}: the fleet's engine runs the {eng.cycle_route} route (graphs {eng.graphs}), not {route}")
        sk.reset_launches()
        qids = [fleet.submit(s) for s in scens]
        kept, wave_s, captures = {}, [], []
        windows0 = eng.windows_run
        while fleet.pending:
            first_q = qids[fleet.waves_run * lanes]
            t1 = time.perf_counter()
            fleet._run_one_wave()
            torch.cuda.synchronize()
            wave_s.append(time.perf_counter() - t1)
            captures.append(eng.dispatch_stats["captures"])
            wanted = [q for q in keep if first_q <= q < first_q + lanes]
            if wanted:
                st = state_to_numpy(eng.state)
                for q in wanted:
                    kept[q] = rows(st, fleet.results[q].lane)
        fleet_s = time.perf_counter() - t0
        launches = sk.launch_counts()
        windows = eng.windows_run - windows0
        results = [fleet.results[q] for q in qids]
        for name in must_launch:
            if launches[name] <= 0:
                fail(f"{label}: the fleet never launched {name}")
        if captures[0] != captures[-1] or eng.dispatch_stats["eager_windows"]:
            fail(f"{label}: captures {captures} after each wave (after the build: {captures[0]}), eager windows "
                 f"{eng.dispatch_stats['eager_windows']}")
        for pos in dups:
            if not same(results[pos], results[0]) or compare_states(kept[0], kept[pos]):
                fail(f"{label}: lane cross-talk: scenario {pos} (lane {results[pos].lane}, wave {results[pos].wave}) "
                     f"duplicates scenario 0 (lane {results[0].lane}) but differs")
        if sum(r.counters["scheduling_decisions"] for r in results) <= 0 or not any(
                r.counters["scaled_up_nodes"] > 0 for r in results):
            fail(f"{label}: no decision, or the CA idle across every scenario")
        # The probes against standalone card engines, which are also the
        # per-engine baseline (build, run, read).
        base_s, solo_out = [], []
        for pos in probes_at:
            scen = scens[pos]
            t1 = time.perf_counter()
            solo = build_batched_from_traces(scenario_config(config_yaml, scen), cluster, workload, n_clusters=1,
                                             device=dev, max_pods_per_cycle=SWEEP_K)
            solo.step_until_time(results[pos].horizon)
            solo.decisions_total()
            base_s.append(time.perf_counter() - t1)
            r = results[pos]
            got = {n_: int(getattr(solo.state.metrics, n_)[0]) for n_ in r.counters}
            if got != r.counters or solo.hpa_replicas(0) != r.hpa_replicas or [
                    int(v) for v in solo.ca_node_counts(0)] != r.ca_nodes:
                fail(f"{label}: query {pos} (lane {r.lane}, wave {r.wave}) differs from its standalone engine: "
                     f"{r.counters} vs {got}")
            bad = compare_states(kept[pos], state_to_numpy(solo.state))
            if bad:
                fail(f"{label}: query {pos}'s state row differs from its standalone engine's at {bad}")
            solo_out.append({"query": pos, "lane": r.lane, "wave": r.wave, "seed": scen.fault_seed})
            solo.close()
        baseline_s = float(np.mean(base_s)) * n
        # A traced repeat of wave 1: host and busy ms a window.
        first = [Scenario(**s.overrides()) for s in scens[:lanes]]
        again = {}

        def rerun():
            again["r"] = fleet.sweep(first)
            return eng.windows_run - w1

        w1 = eng.windows_run
        busy = device_busy(rerun, label)
        if not all(same(a, b) for a, b in zip(again["r"], results[:lanes])):
            fail(f"{label}: a repeat of wave 1 differs from it")
        per_wave = windows / max(len(wave_s), 1)
        out = {
            "scenarios": n, "lanes": lanes, "waves": len(wave_s), "route": eng.cycle_route, "build_s": build_s,
            "fleet_s": fleet_s, "scenarios_per_s": n / fleet_s, "baseline_engine_s": base_s,
            "baseline_s": baseline_s, "baseline_scenarios_per_s": n / baseline_s, "speedup": baseline_s / fleet_s,
            "wave_s": wave_s, "windows_per_wave": per_wave,
            "host_ms_per_window": 1e3 * float(np.mean(wave_s[1:] or wave_s)) / per_wave,
            "busy": busy, "captures_after_wave1": captures[0], "captures_end": captures[-1],
            "launches": launches, "probes": solo_out, "duplicates": dups,
            "decisions": sum(r.counters["scheduling_decisions"] for r in results),
        }
        print(f"{label} ({card}): {n} scenarios over {lanes} lanes ({len(wave_s)} waves, {eng.cycle_route} route), fleet "
              f"{fleet_s:.3f} s with its build ({build_s:.3f} s) = {out['scenarios_per_s']:.1f} scenarios/s; "
              f"3-engine baseline {np.mean(base_s):.3f} s an engine, extrapolated {baseline_s:.1f} s = "
              f"{out['baseline_scenarios_per_s']:.2f} scenarios/s ({out['speedup']:.1f}x); host "
              f"{out['host_ms_per_window']:.4f} ms a window of a wave, device busy {busy['busy_ms_per_window']:.4f} ms, "
              f"{busy['kernels_per_window']:.1f} kernels a window; captures {captures}; duplicates {dups} == scenario "
              f"0; probes {solo_out} == standalone engines; launches {launches}", flush=True)
        fleet.close()
        return out

    out = {
        "sweep": sweep_line("phase 20a", 64, 16, "", [0, 17, 40], sorted_names, "sorted"),
        "wide": sweep_line("phase 20b", 1024, 256, POD_FAULTS_YAML, [0, 261, 1000],
                           dense_names + ["pod_attempt_draw"], "megakernel"),
    }
    wide = out["wide"]
    if wide["probes"][1]["wave"] == 0 or wide["launches"]["pod_attempt_draw"] <= 0:
        fail("phase 20b: the seed-change probe is not in a later wave, or no commit draw ran")

    # (c) card against CPU, node faults keyed per lane on its build seed.
    label = "phase 20c"
    config_yaml, cluster, workload = sweep_inputs(FAULTS_YAML)
    scens = [Scenario(fault_seed=700 + i, hpa_scan_interval=(30.0, 60.0)[i % 2], ca_threshold=0.3 + 0.1 * (i % 4))
             for i in range(8)]
    finals, res = {}, {}
    for where in (dev, "cpu"):
        fleet = ScenarioFleet(SimulationConfig.from_yaml(config_yaml), cluster, workload, n_lanes=4,
                              horizon=SWEEP_QUERY_HORIZON, device=where, max_pods_per_cycle=SWEEP_K, reclaim=True,
                              ca_slot_multiplier=4,
                              build_scenarios=[Scenario(fault_seed=500 + lane) for lane in range(4)])
        res[str(where)] = fleet.sweep(scens)
        finals[str(where)] = state_to_numpy(fleet.engine.state)
        fleet.close()
    on_card, on_cpu = res[str(dev)], res["cpu"]
    bad = compare_states(finals[str(dev)], finals["cpu"])
    if bad or not all(same(a, b) for a, b in zip(on_card, on_cpu)):
        fail(f"{label}: the card fleet differs from the CPU fleet (state at {bad})")
    crashes = sum(r.counters["node_crashes"] for r in on_card)
    if crashes <= 0:
        fail(f"{label}: no node crash in 8 scenarios")
    out["card_vs_cpu"] = {"scenarios": 8, "lanes": 4, "node_crashes": crashes,
                          "pod_restarts": sum(r.counters["pod_restarts"] for r in on_card)}
    print(f"{label} ({card}): 8 scenarios over 4 lanes (2 waves) with node and pod faults: card == CPU, FleetResults and "
          f"final states ({out['card_vs_cpu']})", flush=True)
    return out


def lane_async_phase(dev, sk, card: str, sorted_names, dense_names) -> dict:
    """Phases 21-22: the lane-asynchronous fleet on the card (batched/
    fleet.py pump / run_async; telemetry on in every fleet, as the
    reference's lines run them, so the ring's record writes its lane
    columns).

    21a, the reference's open-loop line (OPEN_LOOP): the stream through a
    wave-aligned and a lane-asynchronous fleet, every query's result equal
    between them; then OPEN_LOOP_ROUNDS timed repeats on the resident
    fleets (queries/s, the medians), the occupancy, host ms a window of a
    pump, the latency histograms' counts against the queries polled, and a
    5-query sub-stream on a CPU fleet equal to the card's; device busy ms
    and kernels a window of a traced pump stream (its first 8 queries)
    and of 8 windows in each freeze variant. 21b, full width: 1 024 queries over 256 lanes (the
    megakernel route, pod faults, each query its own fault_seed, horizons
    cycling the mix) through both fleets, every result equal, scenarios/s
    of each and the occupancy. 22, the reference's host-chaos line
    (HOST_CHAOS): a plain lane-asynchronous fleet and one with the
    quarantine configured but the injector disarmed run the same stream,
    equal in results and dispatch_stats; then HostChaos armed for 4
    rounds: every round finishes, availability >= 90 %, every lane
    faults, a lane is quarantined and re-admitted, every query id streams
    one outcome, every failure is one LaneFaultError, and the histograms
    count the polled results. No fleet captures after its build."""
    from kubernetriks_tpu_torch.batched.faults import HostChaos, LaneFaultError
    from kubernetriks_tpu_torch.batched.fleet import ScenarioFleet
    from kubernetriks_tpu_torch.config import SimulationConfig

    def same(a, b):
        return a.ok and b.ok and (a.counters, a.hpa_replicas, a.ca_nodes) == (b.counters, b.hpa_replicas, b.ca_nodes)

    def mix(n, query_horizon):
        return [query_horizon * OPEN_LOOP_HORIZON_MIX[i % len(OPEN_LOOP_HORIZON_MIX)] for i in range(n)]

    def submit(fleet, scens, horizons):
        return [fleet.submit(s, h) for s, h in zip(scens, horizons)]

    def build(config, inputs, lanes, horizon, k, where=dev, **kw):
        return ScenarioFleet(config, *inputs, n_lanes=lanes, horizon=horizon, device=where, max_pods_per_cycle=k,
                             telemetry=True, **kw)

    def equal_results(label, ref, got, what):
        for i, (a, b) in enumerate(zip(ref, got)):
            if not same(a, b):
                fail(f"{label}: query {i} differs {what}: {getattr(a, 'counters', a)} vs {getattr(b, 'counters', b)}")

    def no_capture(label, fleet, at_build):
        stats = fleet.engine.dispatch_stats
        if stats["captures"] != at_build or stats["eager_windows"]:
            fail(f"{label}: {stats['captures']} captures ({at_build} at the build), {stats['eager_windows']} eager "
                 "windows")

    out = {}
    # --- 21a ---
    label = "phase 21a"
    config_yaml, *inputs = sweep_inputs(**OPEN_LOOP)
    config = SimulationConfig.from_yaml(config_yaml)
    scens, _ = sweep_scenarios(OPEN_LOOP_QUERIES)
    horizons = mix(OPEN_LOOP_QUERIES, SWEEP_QUERY_HORIZON)
    t0 = time.perf_counter()
    wave = build(config, inputs, OPEN_LOOP_LANES, SWEEP_QUERY_HORIZON, OPEN_LOOP_K)
    t1 = time.perf_counter()
    asy = build(config, inputs, OPEN_LOOP_LANES, SWEEP_QUERY_HORIZON, OPEN_LOOP_K, lane_async=True,
                span_windows=OPEN_LOOP_SPAN)
    builds = (t1 - t0, time.perf_counter() - t1)
    caps = {id(f): f.engine.dispatch_stats["captures"] for f in (wave, asy)}
    wq = submit(wave, scens, horizons)
    wave.run()
    sk.reset_launches()
    aq = submit(asy, scens, horizons)
    asy.run_async()
    launches = sk.launch_counts()
    for name in sorted_names + ["telemetry_record"]:
        if launches[name] <= 0:
            fail(f"{label}: the lane-asynchronous fleet never launched {name}")
    first = [asy.results[q] for q in aq]
    equal_results(label, [wave.results[q] for q in wq], first, "between the wave and the lane-asynchronous fleets")
    asy.poll()
    asy.reset_query_stats()
    wave_s, asy_s, asy_windows, polled = [], [], [], 0
    for _ in range(OPEN_LOOP_ROUNDS):
        submit(wave, scens, horizons)
        t0 = time.perf_counter()
        wave.run()
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
        qs = submit(asy, scens, horizons)
        w0 = asy.engine.windows_run
        t0 = time.perf_counter()
        asy.run_async()
        torch.cuda.synchronize()
        asy_s.append(time.perf_counter() - t0)
        asy_windows.append(asy.engine.windows_run - w0)
        polled += len(asy.poll())
        equal_results(label, first, [asy.results[q] for q in qs], "from the first run")
    occupancy = asy.lane_occupancy()
    obs = asy.engine.observatory
    if asy.latency_hist.count != polled or obs.query_stats()["count"] != polled:
        fail(f"{label}: the latency histograms hold {asy.latency_hist.count} (fleet) and "
             f"{obs.query_stats()['count']} (observatory) queries, {polled} were polled")
    # The histogram's p99 within one bucket of the exact p99 of the kept
    # latencies (the reference's check, `bench.py:1353-1367`).
    exact = float(np.percentile(np.asarray(asy.latency_exact_window), 99, method="higher"))
    if abs(asy.latency_hist.percentile(99.0) - exact) > asy.latency_hist.bucket_width(exact) + 1e-12:
        fail(f"{label}: the histogram's p99 {asy.latency_hist.percentile(99.0)} s is more than a bucket from the "
             f"exact {exact} s")
    for f in (wave, asy):
        no_capture(label, f, caps[id(f)])
    # The first five queries on a CPU fleet equal the card's.
    cpu = build(config, inputs, OPEN_LOOP_LANES, SWEEP_QUERY_HORIZON, OPEN_LOOP_K, where="cpu", lane_async=True,
                span_windows=OPEN_LOOP_SPAN)
    cq = submit(cpu, scens[:5], horizons[:5])
    cpu.run_async()
    equal_results(label, first[:5], [cpu.results[q] for q in cq], "between the card and the CPU")
    cpu.close()
    # A traced pump stream (the first 8 queries: two blocks of the mix),
    # then 8 windows in each freeze variant: every lane re-seeded fresh
    # with a full horizon (the pieces without the freeze), then one lane
    # idle (the freezing pieces).
    asy.reset_query_stats()

    def pumped():
        w0 = asy.engine.windows_run
        submit(asy, scens[:8], horizons[:8])
        asy.run_async()
        asy.poll()
        return asy.engine.windows_run - w0

    busy = device_busy(pumped, label)
    eng = asy.engine
    lanes = list(range(OPEN_LOOP_LANES))
    full = eng.horizon_windows(SWEEP_QUERY_HORIZON)
    variants = {}
    for freeze in (False, True):
        eng.lane_reset(lanes)
        eng.set_lane_plan(lanes, eng.next_window_idx, [full] * (len(lanes) - 1) + [0 if freeze else full])

        def run():
            eng.step_windows(8)
            return 8

        variants["freeze" if freeze else "no_freeze"] = device_busy(run, f"{label} freeze={freeze}")
    eng.lane_reset(lanes)
    eng.set_lane_plan(lanes, eng.next_window_idx, [0] * len(lanes))
    no_capture(label, asy, caps[id(asy)])
    med_w, med_a = float(np.median(wave_s)), float(np.median(asy_s))
    out["open_loop"] = {
        "queries": OPEN_LOOP_QUERIES, "lanes": OPEN_LOOP_LANES, "span_windows": OPEN_LOOP_SPAN,
        "route": eng.cycle_route, "build_s": {"wave": builds[0], "lane_async": builds[1]},
        "wave_s": wave_s, "lane_async_s": asy_s, "wave_queries_per_s": OPEN_LOOP_QUERIES / med_w,
        "lane_async_queries_per_s": OPEN_LOOP_QUERIES / med_a, "speedup": med_w / med_a,
        "occupancy": occupancy, "lane_async_windows": asy_windows,
        "host_ms_per_window": 1e3 * med_a / float(np.median(asy_windows)),
        "busy": busy, "variants": variants, "latency": asy.query_latency_percentiles(),
        "captures": caps[id(asy)], "launches": launches, "pump_rounds": asy.pump_rounds,
    }
    o = out["open_loop"]
    print(f"{label} ({card}): {OPEN_LOOP_QUERIES} queries over {OPEN_LOOP_LANES} lanes, horizons cycling "
          f"{OPEN_LOOP_HORIZON_MIX} of {SWEEP_QUERY_HORIZON:.0f} s ({eng.cycle_route} route): wave "
          f"{o['wave_queries_per_s']:.1f} queries/s, lane-asynchronous {o['lane_async_queries_per_s']:.1f} queries/s "
          f"({o['speedup']:.2f}x; medians of {OPEN_LOOP_ROUNDS}); occupancy mean {occupancy['mean']:.4f} min "
          f"{occupancy['min']:.4f}; a pump's host {o['host_ms_per_window']:.4f} ms a window, device busy "
          f"{busy['busy_ms_per_window']:.4f} ms, {busy['kernels_per_window']:.1f} kernels a window; kernels a window "
          f"without the freeze {variants['no_freeze']['kernels_per_window']:.1f} (busy "
          f"{variants['no_freeze']['busy_ms_per_window']:.4f} ms), with it {variants['freeze']['kernels_per_window']:.1f}"
          f" (busy {variants['freeze']['busy_ms_per_window']:.4f} ms); every result == the wave fleet's, the first 5 "
          f"== the CPU's; captures {caps[id(asy)]} at the build and after; latency {o['latency']}", flush=True)
    wave.close()
    asy.close()

    # --- 21b ---
    stamp("phase 21b")
    label = "phase 21b"
    config_yaml, *inputs = sweep_inputs(POD_FAULTS_YAML)
    config = SimulationConfig.from_yaml(config_yaml)
    n, lanes_n = 1024, 256
    scens, _ = sweep_scenarios(n, seeds=True)
    horizons = mix(n, SWEEP_QUERY_HORIZON)
    fleets, res, secs, builds = {}, {}, {}, {}
    for kind in ("wave", "lane_async"):
        t0 = time.perf_counter()
        f = fleets[kind] = build(config, inputs, lanes_n, SWEEP_QUERY_HORIZON, SWEEP_K,
                                 **({"lane_async": True, "span_windows": OPEN_LOOP_SPAN} if kind == "lane_async" else {}))
        builds[kind] = time.perf_counter() - t0
        if f.engine.cycle_route != "megakernel" or not f.engine.graphs:
            fail(f"{label}: the {kind} fleet runs the {f.engine.cycle_route} route (graphs {f.engine.graphs})")
        at_build = f.engine.dispatch_stats["captures"]
        sk.reset_launches()
        qids = submit(f, scens, horizons)
        t0 = time.perf_counter()
        f.run() if kind == "wave" else f.run_async()
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
        if kind == "lane_async":
            launches = sk.launch_counts()
        res[kind] = [f.results[q] for q in qids]
        no_capture(label, f, at_build)
    equal_results(label, res["wave"], res["lane_async"], "between the wave and the lane-asynchronous fleets")
    for name in dense_names + ["pod_attempt_draw", "telemetry_record"]:
        if launches[name] <= 0:
            fail(f"{label}: the lane-asynchronous fleet never launched {name}")
    if sum(r.counters["pod_restarts"] for r in res["lane_async"]) <= 0:
        fail(f"{label}: no pod fault across {n} queries")
    asy = fleets["lane_async"]
    occupancy = asy.lane_occupancy()
    out["wide"] = {
        "queries": n, "lanes": lanes_n, "build_s": builds, "run_s": secs,
        "scenarios_per_s": {k: n / v for k, v in secs.items()}, "speedup": secs["wave"] / secs["lane_async"],
        "occupancy": occupancy, "pump_rounds": asy.pump_rounds, "windows": asy.engine.windows_run,
        "wave_windows": fleets["wave"].engine.windows_run, "launches": launches,
        "captures": asy.engine.dispatch_stats["captures"],
    }
    o = out["wide"]
    print(f"{label} ({card}): {n} queries over {lanes_n} lanes (megakernel route, pod faults, each its own seed, "
          f"horizons cycling the mix): wave {o['scenarios_per_s']['wave']:.1f} scenarios/s "
          f"({o['wave_windows']} windows), lane-asynchronous {o['scenarios_per_s']['lane_async']:.1f} scenarios/s "
          f"({o['windows']} windows, {o['pump_rounds']} pump rounds; {o['speedup']:.2f}x), builds {builds}; occupancy "
          f"mean {occupancy['mean']:.4f} min {occupancy['min']:.4f}; every result equal; no capture after either "
          f"build; launches {launches}", flush=True)
    for f in fleets.values():
        f.close()
    del fleets, res

    # --- 22 ---
    stamp("phase 22")
    label = "phase 22"
    hc = HOST_CHAOS_RUN
    config_yaml, *inputs = sweep_inputs(**HOST_CHAOS)
    config = SimulationConfig.from_yaml(config_yaml)
    scens, _ = sweep_scenarios(hc["queries"])
    horizons = mix(hc["queries"], HOST_CHAOS_QUERY_HORIZON)
    plain = build(config, inputs, hc["lanes"], HOST_CHAOS_QUERY_HORIZON, SWEEP_K, lane_async=True)
    fl = build(config, inputs, hc["lanes"], HOST_CHAOS_QUERY_HORIZON, SWEEP_K, lane_async=True, quarantine_faults=1,
               quarantine_window=64, quarantine_backoff=2)
    at_build = fl.engine.dispatch_stats["captures"]
    qp = submit(plain, scens, horizons)
    plain.run_async()
    qf = submit(fl, scens, horizons)
    fl.run_async()
    equal_results(label, [plain.results[q] for q in qp], [fl.results[q] for q in qf],
                  "between the plain fleet and the disarmed one")
    if plain.engine.dispatch_stats != fl.engine.dispatch_stats or fl.fault_report()["chaos"] is not None:
        fail(f"{label}: the disarmed fleet's dispatch_stats {fl.engine.dispatch_stats} differ from the plain fleet's "
             f"{plain.engine.dispatch_stats}, or it holds an injector")
    plain.close()
    fl.poll()
    fl.reset_query_stats()
    fl.arm_host_chaos(HostChaos(seed=hc["seed"], dispatch_rate=hc["dispatch"], stall_rate=hc["stall"],
                                stall_ms=hc["stall_ms"]))
    qids, outcomes, ok_polled = [], {}, 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the quarantine verdicts warn by design
        for _ in range(hc["rounds"]):
            qids += submit(fl, scens, horizons)
            fl.run_async()
            for o in fl.poll():
                outcomes[o.query] = outcomes.get(o.query, 0) + 1
                ok_polled += int(o.ok)
    chaos_s = time.perf_counter() - t0
    res = [fl.results[q] for q in qids]
    fails = [r for r in res if not r.ok]
    availability = 1.0 - len(fails) / len(res)
    victims = sorted({r.lane for r in fails if r.lane >= 0})
    report = fl.fault_report()
    missing = [q for q in qids if outcomes.get(q, 0) != 1]
    if missing or not all(isinstance(r, LaneFaultError) for r in fails):
        fail(f"{label}: qids {missing[:5]} did not stream exactly one outcome, or a failure is not a LaneFaultError")
    if availability < 0.90 or victims != list(range(hc["lanes"])):
        fail(f"{label}: availability {availability:.4f} (>= 0.90 wanted), faulted lanes {victims}")
    if report["quarantine_events"] < 1 or report["readmissions"] < 1:
        fail(f"{label}: {report['quarantine_events']} quarantines, {report['readmissions']} re-admissions")
    for i, r in enumerate(res):
        if r.ok and not same(r, fl.results[qf[i % len(scens)]]):
            fail(f"{label}: query {i} differs from its quiet run after a neighbour's fault")
    obs = fl.engine.observatory
    if fl.latency_hist.count != ok_polled or obs.query_stats()["count"] != ok_polled:
        fail(f"{label}: the latency histograms hold {fl.latency_hist.count} (fleet) and {obs.query_stats()['count']} "
             f"(observatory) queries, {ok_polled} results were polled")
    no_capture(label, fl, at_build)
    out["host_chaos"] = {
        "queries": len(qids), "failed": len(fails), "availability": availability, "faulted_lanes": victims,
        "report": report, "chaos_s": chaos_s, "captures": at_build,
    }
    print(f"{label} ({card}): quiet A/B equal (results and dispatch_stats); armed (seed {hc['seed']}, dispatch "
          f"{hc['dispatch']}, stall {hc['stall']} x {hc['stall_ms']} ms) over {hc['rounds']} rounds of "
          f"{hc['queries']} queries in {chaos_s:.3f} s: availability {availability:.4f} ({len(fails)} LaneFaultErrors, "
          f"lanes {victims}), {report['quarantine_events']} quarantines, {report['readmissions']} re-admissions, "
          f"injector {report['chaos']['events']}; every qid streamed one outcome; no capture after the build",
          flush=True)
    fl.close()
    return out


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
    stamp("phase 2")
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
    stamp("phase 3")
    from kubernetriks_tpu_torch.batched import step as step_mod

    names = ["fused_event_scatter", "fused_free_resources", "fused_select_cycle_commit"]
    sim = headline_sim(dev, graphs=False)
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
        inputs are a window's fresh tensors), at most MAX_COPIES: inputs
        under 200 KB stay partly in the L2 (their kernels are launch-sized;
        tens of thousands of copies made phase 3's replay block take over
        three minutes)."""
        size = nbytes([a for a in args if isinstance(a, torch.Tensor) and a.numel()])
        n = min(MAX_COPIES, max(1, -(-2 * L2_BYTES // max(size, 1))))
        return [args] + [
            tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            for _ in range(n - 1)
        ]

    def check_kernel(name, kernel_fn, plain_fn, args, kwargs, stats_idx, library, need_bytes, ops, label=None,
                     timed=None):
        # `terms`, a cycle kernel's launch arguments for its profile, is
        # the wrapper's alone: the plain version reads `profile`.
        # `timed`: (kernel, plain, input sets) to time in place of the
        # compared functions and copies_of(args) (an in-place kernel).
        plain_kwargs = {k: v for k, v in kwargs.items() if k != "terms"}
        outs_k = as_tuple(kernel_fn(*args, **kwargs))
        torch.cuda.synchronize()
        outs_p = as_tuple(plain_fn(*args, **plain_kwargs))
        torch.cuda.synchronize()
        err = max_abs_err(outs_k, outs_p)
        if not outputs_agree(outs_k, outs_p, stats_idx):
            fail(f"{name}: kernel disagrees with its plain version (max abs err {err})")
        time_k, time_p, sets = timed or (kernel_fn, plain_fn, copies_of(args))
        ms = graph_ms([lambda a=a: time_k(*a, **kwargs) for a in sets])
        plain_ms = cuda_ms(lambda: time_p(*sets[0], **plain_kwargs), reps=3, warmup=1)
        library_ms = graph_ms([library(a) for a in sets]) if library else None
        bytes_s = need_bytes / HBM_BYTES_PER_S
        ops_s = ops / FP32_OPS_PER_S
        label = label or name
        report[label] = {
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
            f"  {label}: agrees with its plain version (tolerance: outputs exact, stats rows "
            f"rtol 1e-6; max abs err {err}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {report[label]['bound_ms']:.4f} ms "
            f"({report[label]['bound_by']}: {need_bytes} B, {ops} ops)",
            flush=True,
        )

    # Bounds count what this run's data needs: every byte of each input
    # the function must read (a row it only consults where a mask is set
    # counts only there) and every output byte, once.

    # Event scatter. Yardstick: one scatter_reduce_ "amin" of the pod
    # create times (the largest of the five accumulators).
    def check_event_scatter(args, kwargs, label=None):
        ev_valid = args[4]
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
            n_valid, label=label,
        )

    # Free resources. Yardstick: one scatter_add_ of the cpu requests.
    def check_free_resources(args, kwargs, label=None):
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
            5 * n_fin + 2 * n_freed, label=label,
        )

    # The commit-time draw. Reads the start offsets and will_fail flags of
    # every slot (5 B), the pod bases, and for the slots that draw (an
    # attempt starting on a plain slot of finite duration) the restarts
    # and the duration window (8 B) and, where the attempt fails, the
    # duration offset (4 B); writes 5 B a slot. Operations: ~170 integer
    # operations a drawing slot (two threefry blocks of 20 rounds),
    # counted at the float32 rate (the card's table has no integer rate).
    # No PyTorch call computes threefry.
    from kubernetriks_tpu_torch.ops import chaos_kernel as ck

    def check_attempt_draw(args, kwargs, label):
        start, restarts, dur_win = args[0], args[1], args[2]
        C, P = start.shape
        plain = torch.arange(P, device=start.device)[None, :] < args[7]
        draws = (start < float("inf")) & plain & (dur_win >= 0)
        n_draw = int(draws.sum())
        wf, _ = ck.pod_attempt_draw(*args, **kwargs)
        n_fail = int((wf & draws).sum())
        seeds = 4 * C if isinstance(args[6], torch.Tensor) else 0  # a scenario fleet's seed vector
        check_kernel(
            "pod_attempt_draw", ck.pod_attempt_draw, ck.pod_attempt_draw_plain, args, kwargs, -1, None,
            5 * C * P + 4 * C + seeds + 8 * n_draw + 4 * n_fail + 5 * C * P, 170 * n_draw, label=label,
        )

    check_event_scatter(*captured["fused_event_scatter"])
    check_free_resources(*captured["fused_free_resources"])
    # The two selecting kernels' least work. Bytes: the eligible mask, the
    # eligible pods' keys and requests (12 B each), each pick's requests
    # again (8 B), the node rows read (9 B a node) and written (8 B).
    # Operations: ordering the first `picks` of `depth` keys needs at least
    # log2(depth! / (depth - picks)!) compares of ~3 operations (the count
    # of distinct outcomes), and each pick ~16 operations per node (fit,
    # score, argmax). The megakernel's commit adds 16 B a pick, the pod
    # rows (read 8 B, written 16 B a slot) and the stats rows; the
    # selection kernel writes 11 B a candidate row instead. No single
    # library call computes either.
    def selection_need(args, K, commit=False, node_ops=16):
        eligible = args[3]
        C, N = args[1].shape
        P = eligible.shape[1]
        depth = eligible.sum(dim=1).to(torch.float64)
        picks = torch.clamp(depth, max=K)
        n_picks = int(picks.sum())
        compares = float(
            ((torch.lgamma(depth + 1) - torch.lgamma(depth - picks + 1)) / math.log(2)).sum()
        )
        need = eligible.numel() + 12 * int(depth.sum()) + 8 * n_picks + 17 * C * N
        need += 16 * n_picks + 24 * C * P + 20 * C if commit else 11 * C * K
        return need, int(3 * compares) + node_ops * N * n_picks

    from kubernetriks_tpu_torch.batched.pipeline import compile_profile

    def check_profiled(name, kernel_fn, plain_fn, args, kwargs, stats_idx, need_of, label_of):
        """The cycle kernel `name` under each of KERNEL_PROFILES (its
        general instantiation) on the same captured inputs, against its
        plain version; need_of(args, node_ops) gives the bound's bytes and
        operations."""
        for prof_name in KERNEL_PROFILES:
            prof = compile_profile(prof_name)
            terms = sk.profile_terms(prof, dev)  # built before graph_ms captures the launches
            check_kernel(
                name, kernel_fn, plain_fn, args, {**kwargs, "profile": prof, "terms": terms}, stats_idx, None,
                *need_of(args, profile_node_ops(prof)), label=label_of(prof_name),
            )

    args, kwargs = captured["fused_select_cycle_commit"]
    check_kernel(
        "fused_select_cycle_commit", sk.fused_select_cycle_commit, sk.select_cycle_commit_plain,
        args, kwargs, 6, None, *selection_need(args, kwargs["k_pods"], commit=True),
    )
    check_profiled(
        "fused_select_cycle_commit", sk.fused_select_cycle_commit, sk.select_cycle_commit_plain, args, kwargs, 6,
        lambda a, ops: selection_need(a, kwargs["k_pods"], commit=True, node_ops=ops),
        lambda p: f"fused_select_cycle_commit ({p})",
    )
    # K = P: the cycle size the engine takes when none is given, on a deep
    # queue, so the kernel orders it in several batches. The two-kernel
    # route's selection is held on the same queue below.
    deep_args, deep_kwargs = deep_queue(args, kwargs)
    check_kernel(
        "fused_select_cycle_commit", sk.fused_select_cycle_commit, sk.select_cycle_commit_plain,
        deep_args, deep_kwargs, 6, None, *selection_need(deep_args, deep_kwargs["k_pods"], commit=True),
        label=f"fused_select_cycle_commit (K=P={deep_kwargs['k_pods']}, deep queue)",
    )
    del sim, captured

    stamp("phase 3: the two-kernel route")
    # The two-kernel route's kernels, on inputs of the headline shape built
    # with KTPU_MEGAKERNEL=0 (the same window, t = 190 s).
    two_names = ["fused_select_schedule_cycle", "fused_commit_scatter"]
    sim = with_megakernel_flag("0", lambda: headline_sim(dev, graphs=False))
    if sim.cycle_route != "two_kernel":
        fail(f"KTPU_MEGAKERNEL=0 built the {sim.cycle_route} route at the headline shape")
    captured, restore = capture_inputs(step_mod, two_names)
    sim.step_until_time(190.0)
    restore()
    torch.cuda.synchronize()
    print(f"phase 3: two-kernel route shapes C={sim.n_clusters} N={sim.n_nodes} P={sim.n_pods}", flush=True)
    args, kwargs = captured["fused_select_schedule_cycle"]
    check_kernel(
        "fused_select_schedule_cycle", sk.fused_select_schedule_cycle, sk.select_schedule_cycle_plain,
        args, kwargs, -1, None, *selection_need(args, kwargs["k_pods"]),
    )
    check_profiled(
        "fused_select_schedule_cycle", sk.fused_select_schedule_cycle, sk.select_schedule_cycle_plain,
        args, kwargs, -1, lambda a, ops: selection_need(a, kwargs["k_pods"], node_ops=ops),
        lambda p: f"fused_select_schedule_cycle ({p})",
    )
    # The megakernel's deep queue (K = P, several batches).
    check_kernel(
        "fused_select_schedule_cycle", sk.fused_select_schedule_cycle, sk.select_schedule_cycle_plain,
        deep_args[:9], deep_kwargs, -1, None, *selection_need(deep_args, deep_kwargs["k_pods"]),
        label=f"fused_select_schedule_cycle (K=P={deep_kwargs['k_pods']}, deep queue)",
    )
    del deep_args
    # Commit scatter: reads the two pod rows it copies through and the
    # touched candidate rows (18 B each), the two flags of the rest; writes
    # four pod rows. Yardstick: one scatter_ of the phase row.
    args, kwargs = captured["fused_commit_scatter"]
    C, K = args[0].shape
    P = args[6].shape[1]
    n_touched = int((args[1] | args[2]).sum())

    def commit_library(a):
        idx = torch.where(a[1] | a[2], a[0], P).long()
        wide = torch.cat([a[6], a[6][:, :1]], dim=1)
        vals = torch.where(a[1], sk.PHASE_RUNNING, sk.PHASE_UNSCHEDULABLE).to(torch.int32)
        return lambda: wide.clone().scatter_(1, idx, vals)

    check_kernel(
        "fused_commit_scatter", sk.fused_commit_scatter, sk.commit_scatter_plain, args, kwargs, -1,
        commit_library, 8 * C * P + 2 * C * K + 16 * n_touched + 16 * C * P, 0,
    )
    del sim, captured

    stamp("phase 3: the CA kernels")
    # The CA kernels, on inputs of the autoscaler path at full width: the
    # first window where the scale-up packs a cache pod and the first where
    # the scale-down removes a node (both launch, masked, on every window
    # where a CA cycle is due).
    from kubernetriks_tpu_torch.batched import autoscale as autoscale_mod
    from kubernetriks_tpu_torch.ops import autoscale_kernel as ak

    sim = composed_sim(dev, 256, **FULL_COMPOSED, graphs=False)
    cap_up, restore_up = capture_first(
        autoscale_mod, "fused_ca_scale_up", lambda a, o: bool(a[8].any()) and bool(o[0].any())
    )
    cap_down, restore_down = capture_first(
        autoscale_mod, "fused_ca_scale_down", lambda a, o: bool(o.any())
    )
    sim.step_until_time(1200.0)
    restore_up()
    restore_down()
    torch.cuda.synchronize()
    if "fused_ca_scale_up" not in cap_up or "fused_ca_scale_down" not in cap_down:
        fail(f"the autoscaler path never scaled up or down (captured {list(cap_up) + list(cap_down)})")
    print(
        f"phase 3: autoscaler shapes C={sim.n_clusters} N={sim.n_nodes} P={sim.n_pods} "
        f"S={sim.autoscale_statics.ca_slots.shape[1]} K_up={sim.max_ca_pods_per_cycle} "
        f"K_sd={sim.max_pods_per_scale_down}",
        flush=True,
    )
    # Scale-down. What the function must read: the branch flag of every
    # cluster; for clusters on the branch, the threshold and the candidate
    # rows (9 B); at the slots of the candidates alive, in range and with
    # at most K pods, not-pending (1 B), and where that is set (statically
    # eligible) the capacities and allocatables (16 B); for clusters with a
    # statically eligible candidate, four node rows (alive: 1 B;
    # allocatables, rank: 4 B) and those candidates' pod entries (9 B
    # each); it writes S flags. Operations: ~5 per node per pod entry (fit
    # tests and the argmin).
    def check_ca_scale_down(args, kwargs, label=None):
        br = args[0][:, 0]
        C, N = args[2].shape
        S = args[9].shape[1]
        K = kwargs["k_sd"]
        slot, cnt = args[9], args[11]
        pre = br[:, None] & args[10] & (slot >= 0) & (slot < N) & (cnt <= K)
        elig = pre & torch.gather(args[3], 1, slot.clamp(0, N - 1).long())
        n_br = int(br.sum())
        entries = int((cnt.clamp(0, K) * elig).sum())
        need = (
            C + n_br * (4 + 9 * S) + int(pre.sum()) + 16 * int(elig.sum())
            + 13 * N * int(elig.any(dim=1).sum()) + 9 * entries + C * S
        )
        check_kernel(
            "fused_ca_scale_down", ak.fused_ca_scale_down, ak.ca_scale_down_plain, args, kwargs, -1,
            None, need, 5 * N * entries, label=label,
        )

    # Scale-up. Reads the quota, and for clusters with a valid candidate
    # the seven group rows (28 B each) and the valid candidates (9 B); the
    # validity flags of the rest; writes S flags, Gn counts and one count.
    # Operations: 3 compares per slot per valid candidate.
    def check_ca_scale_up(args, kwargs, label=None):
        cvalid = args[8]
        C, G = args[1].shape
        Kc = cvalid.shape[1]
        S = kwargs["n_slots"]
        n_valid = int(cvalid.sum())
        n_active = int(cvalid.any(dim=1).sum())
        check_kernel(
            "fused_ca_scale_up", ak.fused_ca_scale_up, ak.ca_scale_up_plain, args, kwargs, -1,
            None, 4 * C + n_active * 28 * G + C * Kc + 8 * n_valid + C * (S + 4 * G + 4),
            3 * S * n_valid, label=label,
        )

    check_ca_scale_down(*cap_down["fused_ca_scale_down"])
    check_ca_scale_up(*cap_up["fused_ca_scale_up"])
    del sim, cap_up, cap_down

    stamp("phase 3: the churn's CA kernels")
    # The CA kernels on the endurance churn once slots have been reused:
    # the dynamic name key and slot order, a cursor pulled back.
    churn_caps, churn_shape = churn_ca_inputs(dev)
    print(f"phase 3: endurance churn with slot reclaim: {churn_shape}", flush=True)
    check_ca_scale_down(*churn_caps["fused_ca_scale_down"], label=CHURN_LABELS["fused_ca_scale_down"])
    check_ca_scale_up(*churn_caps["fused_ca_scale_up"], label=CHURN_LABELS["fused_ca_scale_up"])
    del churn_caps

    stamp("phase 3: the composed line's window")
    # The composed line through its pod window (pod_window=512: P = 648,
    # the window and the HPA ring): the pod-side kernels on the last calls
    # to t = 590 s, inside the load burst. The CA kernels' operands are
    # node rows and per-candidate pod entries, whose widths the window
    # does not change.
    sim = composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, graphs=False)
    captured, restore = capture_inputs(step_mod, names)
    sim.step_until_time(590.0)
    restore()
    torch.cuda.synchronize()
    print(f"phase 3: composed through pod_window={COMPOSED_POD_WINDOW}: C={sim.n_clusters} N={sim.n_nodes} "
          f"P={sim.n_pods} K={sim.max_pods_per_cycle}", flush=True)
    check_event_scatter(*captured["fused_event_scatter"], label=f"fused_event_scatter (composed, {WINDOWED_COMPOSED})")
    check_free_resources(*captured["fused_free_resources"], label=f"fused_free_resources (composed, {WINDOWED_COMPOSED})")
    args, kwargs = captured["fused_select_cycle_commit"]
    check_kernel(
        "fused_select_cycle_commit", sk.fused_select_cycle_commit, sk.select_cycle_commit_plain,
        args, kwargs, 6, None, *selection_need(args, kwargs["k_pods"], commit=True),
        label=f"fused_select_cycle_commit (composed, {WINDOWED_COMPOSED})",
    )
    del sim, captured

    stamp("phase 3: the replay")
    replay_block_t0 = time.perf_counter()
    # The replay's kernels, on inputs of the full-width replay in its first
    # 600 s, each from its busiest call: the candidate cycle's window with
    # the most candidates, the event chunk with the most valid events, the
    # window that frees the most pods, and the CA kernels' windows with the
    # most candidates on their branch (both launch, masked, on every window
    # where a CA cycle is due).
    t0 = time.perf_counter()
    replay_paths = replay_trace("replay_full", **FULL_REPLAY)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = replay_sim(dev, replay_paths, graphs=False)
    build_replay_s = time.perf_counter() - t0
    sizes = {
        (step_mod, "fused_schedule_cycle"): lambda a: int(a[3].sum()),
        (step_mod, "fused_event_scatter"): lambda a: int(a[4].sum()),
        (step_mod, "fused_free_resources"): lambda a: int(a[0].sum()),
        (autoscale_mod, "fused_ca_scale_down"): lambda a: int((a[0] & a[10]).sum()),
        (autoscale_mod, "fused_ca_scale_up"): lambda a: int(a[8].sum()),
    }

    def record_busiest(sim, until, sizes=sizes):
        """Each kernel's busiest call (by `sizes`) in sim's windows to
        `until` (graphs off), cloned: (busiest, sizes seen)."""
        busiest, most = {}, {name: -1 for _, name in sizes}

        def recording(name, real, size):
            def wrapped(*args, **kwargs):
                outs = real(*args, **kwargs)
                n = size(args)
                if n > most[name]:
                    most[name] = n
                    busiest[name] = (kept(args), kwargs)
                return outs

            return wrapped

        reals = {key: getattr(*key) for key in sizes}
        for (mod, name), size in sizes.items():
            setattr(mod, name, recording(name, reals[(mod, name)], size))
        try:
            sim.step_until_time(until)
        finally:
            for (mod, name), real in reals.items():
                setattr(mod, name, real)
        torch.cuda.synchronize()
        if len(busiest) != len(sizes):
            fail(f"the replay's first {until} s never called {sorted(set(most) - set(busiest))}")
        return busiest, most

    busiest, most = record_busiest(sim, 600.0)
    print(
        f"phase 3: replay shapes C={sim.n_clusters} N={sim.n_nodes} P={sim.n_pods} "
        f"K={sim.max_pods_per_cycle} E={sim.max_events_per_window} route {sim.cycle_route}; trace "
        f"written in {synth_s:.2f} s, engine built in {build_replay_s:.2f} s; busiest calls {most}",
        flush=True,
    )
    check_event_scatter(*busiest["fused_event_scatter"], label="fused_event_scatter (replay)")
    check_free_resources(*busiest["fused_free_resources"], label="fused_free_resources (replay)")
    check_ca_scale_down(*busiest["fused_ca_scale_down"], label="fused_ca_scale_down (replay)")
    check_ca_scale_up(*busiest["fused_ca_scale_up"], label="fused_ca_scale_up (replay)")
    # Those calls attempt nothing (no candidate eligible, no valid cache
    # row), so the CA kernels are also held and timed at the replay's
    # width on walks that work: seeded inputs from ca_inputs.py (the tests
    # use the same generators), a scale-down where about half the
    # candidates attempt, with rollbacks, and a scale-up packing 64 valid
    # rows. Kept in the checks only: the replay's count of such calls is
    # not known.
    from ca_inputs import ca_down_inputs, ca_up_inputs

    args, kwargs = busiest["fused_ca_scale_down"]
    args, K = ca_down_inputs(
        11, C=1, N=args[2].shape[1], S=args[9].shape[1], K=kwargs["k_sd"], edge="attempting"
    )
    check_ca_scale_down(
        tuple(torch.from_numpy(a).to(dev) for a in args), {"k_sd": K},
        label="fused_ca_scale_down (replay width, attempting)",
    )
    args, kwargs = busiest["fused_ca_scale_up"]
    args, S = ca_up_inputs(
        11, C=1, G=args[1].shape[1], K=args[8].shape[1], S=kwargs["n_slots"], edge="all_valid"
    )
    check_ca_scale_up(
        tuple(torch.from_numpy(a).to(dev) for a in args), {"n_slots": S},
        label="fused_ca_scale_up (replay width, packing)",
    )
    # Reads the node rows (9N B), every valid flag, the requests of the
    # rows up to the last valid one (8 B each); writes the node rows and
    # 6 B per candidate row. ~16 operations per node per row. No library
    # call computes it.
    def cycle_need(args, node_ops=16):
        C, N = args[1].shape
        K = args[3].shape[1]
        live = torch.where(args[3], torch.arange(1, K + 1, device=dev), 0).amax(dim=1)
        n_live = int(live.sum())
        return 9 * C * N + C * K + 8 * n_live + 8 * C * N + 6 * C * K, node_ops * N * n_live

    args, kwargs = busiest["fused_schedule_cycle"]
    check_kernel(
        "fused_schedule_cycle", sk.fused_schedule_cycle, sk.schedule_cycle_plain, args, kwargs, -1,
        None, *cycle_need(args),
    )
    check_profiled(
        "fused_schedule_cycle", sk.fused_schedule_cycle, sk.schedule_cycle_plain, args, kwargs, -1,
        cycle_need, lambda p: f"fused_schedule_cycle ({p})",
    )
    # K = 1 024 rows, 1 000 of them valid, on the replay's node rows: two
    # tiles of the kernel's candidate buffer.
    args = long_cycle(args, 1024)
    check_kernel(
        "fused_schedule_cycle", sk.fused_schedule_cycle, sk.schedule_cycle_plain, args, kwargs, -1,
        None, *cycle_need(args), label="fused_schedule_cycle (K=1024, 1000 valid rows)",
    )
    del sim, busiest
    stamp("phase 3: the replay's window")
    # The replay through its pod window (pod_window=4096: P = 4 096, 8 192
    # after a growth): the pod-side kernels on their busiest calls in the
    # first 600 s, at the window's width.
    sim = replay_sim(dev, replay_paths, pod_window=REPLAY_POD_WINDOW, graphs=False)
    busiest, most = record_busiest(sim, 600.0)
    print(f"phase 3: replay through pod_window={REPLAY_POD_WINDOW}: P={sim.n_pods}; busiest calls {most}", flush=True)
    check_event_scatter(*busiest["fused_event_scatter"], label=f"fused_event_scatter (replay, {WINDOWED_REPLAY})")
    check_free_resources(*busiest["fused_free_resources"], label=f"fused_free_resources (replay, {WINDOWED_REPLAY})")
    args, kwargs = busiest["fused_schedule_cycle"]
    check_kernel(
        "fused_schedule_cycle", sk.fused_schedule_cycle, sk.schedule_cycle_plain, args, kwargs, -1,
        None, *cycle_need(args), label=f"fused_schedule_cycle (replay, {WINDOWED_REPLAY})",
    )
    del sim, busiest
    replay_block_s = time.perf_counter() - replay_block_t0
    print(f"phase 3: the replay block took {replay_block_s:.1f} s (PR 11's, without the copy cap: 168-219 s)",
          flush=True)
    stamp("phase 3: the fault path")
    # The fault path: the composed line through its pod window with the
    # reference bench's fault block, to t = 590 s; every kernel it runs on
    # its busiest call: the event scatter on its chunk with the most node
    # removals (the line's only node removals in the slab are crashes;
    # recoveries reach the kernel as creations), the free kernel on its
    # call that frees the most pods which are not real finishes (failing
    # attempts, with removed ones), the megakernel on its deepest queue,
    # the CA kernels on their calls with the most candidates on their
    # branch, and the commit-time draw on its call with the most attempts
    # starting.
    t0 = time.perf_counter()
    sim = composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, faults=True, graphs=False)
    build_faults_s = time.perf_counter() - t0
    busiest, most = record_busiest(sim, 590.0, {
        (step_mod, "fused_event_scatter"): lambda a: int((a[4] & (a[0] == sk.EV_REMOVE_NODE)).sum()),
        (step_mod, "fused_free_resources"): lambda a: int((a[0] & ~a[4]).sum()),
        (step_mod, "fused_select_cycle_commit"): lambda a: int(a[3].sum()),
        (autoscale_mod, "fused_ca_scale_down"): sizes[(autoscale_mod, "fused_ca_scale_down")],
        (autoscale_mod, "fused_ca_scale_up"): sizes[(autoscale_mod, "fused_ca_scale_up")],
        (step_mod, "pod_attempt_draw"): lambda a: int((a[0] < float("inf")).sum()),
    })
    counters = sim.metrics_summary()["counters"]
    print(f"phase 3: composed with faults through {WINDOWED_COMPOSED}: C={sim.n_clusters} N={sim.n_nodes} "
          f"P={sim.n_pods} K={sim.max_pods_per_cycle} S={sim.autoscale_statics.ca_slots.shape[1]}, built "
          f"(per-cluster crash chains) in {build_faults_s:.2f} s; busiest calls {most}; to 590 s: {counters}",
          flush=True)
    if counters["pod_restarts"] <= 0 or most["fused_free_resources"] <= 0:
        fail("phase 3: the fault path freed no failing attempt by 590 s")
    if most["fused_event_scatter"] <= 0:
        fail("phase 3: no event chunk of the fault path to 590 s held a crash")
    check_event_scatter(*busiest["fused_event_scatter"], label=f"fused_event_scatter ({FAULTS_LABEL})")
    check_free_resources(*busiest["fused_free_resources"], label=f"fused_free_resources ({FAULTS_LABEL})")
    args, kwargs = busiest["fused_select_cycle_commit"]
    check_kernel(
        "fused_select_cycle_commit", sk.fused_select_cycle_commit, sk.select_cycle_commit_plain,
        args, kwargs, 6, None, *selection_need(args, kwargs["k_pods"], commit=True),
        label=f"fused_select_cycle_commit ({FAULTS_LABEL})",
    )
    check_ca_scale_down(*busiest["fused_ca_scale_down"], label=f"fused_ca_scale_down ({FAULTS_LABEL})")
    check_ca_scale_up(*busiest["fused_ca_scale_up"], label=f"fused_ca_scale_up ({FAULTS_LABEL})")
    check_attempt_draw(*busiest["pod_attempt_draw"], label=f"pod_attempt_draw ({FAULTS_LABEL})")
    del sim, busiest
    # The commit draw with a scenario fleet's per-lane seed vector, at phase
    # 20b's shape (the sweep line at 256 lanes with pod faults, each lane
    # its own seed), on its call with the most attempts starting.
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.batched.fleet import scenario_vectors
    from kubernetriks_tpu_torch.config import SimulationConfig

    sweep_yaml, sweep_cluster, sweep_workload = sweep_inputs(POD_FAULTS_YAML)
    sweep_config = SimulationConfig.from_yaml(sweep_yaml)
    sim = build_batched_from_traces(
        sweep_config, sweep_cluster, sweep_workload, n_clusters=256, device=dev, graphs=False,
        max_pods_per_cycle=SWEEP_K,
        scenario=dict(scenario_vectors(sweep_config, 256, sweep_scenarios(256, seeds=True)[0])),
    )
    busiest, most = record_busiest(sim, SWEEP_QUERY_HORIZON, {
        (step_mod, "pod_attempt_draw"): lambda a: int((a[0] < float("inf")).sum()),
    })
    if not isinstance(busiest["pod_attempt_draw"][0][6], torch.Tensor):
        fail("phase 3: the scenario build's commit draw took no seed vector")
    print(f"phase 3: the sweep line at 256 lanes with pod faults, each lane its own seed: C={sim.n_clusters} "
          f"P={sim.n_pods}, busiest draw {most}", flush=True)
    check_attempt_draw(*busiest["pod_attempt_draw"], label="pod_attempt_draw (seed vector)")
    del sim, busiest

    stamp("phase 3: the window glue")
    # The window executor's glue kernels (ops/window_kernel.py; no TPU
    # kernels) on the lines of the phases that run them, eagerly
    # (graphs=False): the razor's predicate on its first call that finds no
    # work (the skip, where it must read every row), fast-forward's next
    # window on its first call and its catch-up on its longest skip, all
    # on the sparse headline (phase 15's line, fast-forward on by its
    # default) to 1 500 s; the conditional move's scans on phase 16's line
    # to 590 s, on the call with the most event-by-parked-pod work.
    from kubernetriks_tpu_torch.ops import window_kernel as wk

    sim = sparse_sim(dev, graphs=False)
    if not (sim.fast_forward and sim.window_razor):
        fail(f"phase 3: the sparse headline built with fast_forward {sim.fast_forward}, razor {sim.window_razor}")
    busiest, most = record_busiest(sim, 1500.0, {
        (wk, "window_work_due"): lambda a: int(not bool(step_mod.window_work_due_plain(*a))),
        (wk, "next_window_span"): lambda a: 1,
        (wk, "catch_up"): lambda a: int(a[0][1] - a[0][0]),
    })
    print(f"phase 3: sparse headline C={sim.n_clusters} N={sim.n_nodes} P={sim.n_pods}: to 1 500 s "
          f"{sim.dispatch_stats['executed_windows']} windows executed, {sim.dispatch_stats['skipped_windows']} "
          f"skipped; longest skip {most['catch_up']}, a predicate without work found: {bool(most['window_work_due'])}",
          flush=True)
    if most["window_work_due"] <= 0 or most["catch_up"] <= 0:
        fail("phase 3: the sparse headline to 1 500 s gated no window without work, or skipped none")
    C, N, P, E = sim.n_clusters, sim.n_nodes, sim.n_pods, sim.n_events
    del sim
    args, kwargs = busiest["window_work_due"]
    check_kernel("window_work_due", wk.window_work_due, step_mod.window_work_due_plain, args, kwargs, -1, None,
                 12 * C + 8 * C * N + 16 * C * P + 1, C * (2 * N + 5 * P))
    args, kwargs = busiest["next_window_span"]
    check_kernel("next_window_span", wk.next_window_span, step_mod.next_window_span_plain, args, kwargs, -1, None,
                 16 * C + 4 + 8 * C * N + 16 * C * P + 8, C * (2 * N + 6 * P))

    def catch_up_outs(fn):
        return lambda *a, **k: tuple(x for x in fn(*a, **k) if x is not None)

    args, kwargs = busiest["catch_up"]
    n_skip = int(args[0][1] - args[0][0])
    check_kernel("catch_up", catch_up_outs(wk.catch_up), catch_up_outs(step_mod.catch_up_plain), args, kwargs, -1,
                 None, 8 + 16 * C, 3 * C * n_skip)
    sim = composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, conditional_move=True, graphs=False)
    busiest, most = record_busiest(sim, 590.0, {
        (wk, "conditional_wake_scan"): lambda a: int((a[0].sum(dim=1) * a[3].sum(dim=1)).sum()),
    })
    args, kwargs = busiest["conditional_wake_scan"]
    Cw, Pw = args[0].shape
    V = args[3].shape[1]
    print(f"phase 3: the conditional move on the composed line through {WINDOWED_COMPOSED}: C={Cw} P={Pw} "
          f"events V={V}; busiest scan {most['conditional_wake_scan']} event-by-parked-pod steps", flush=True)
    if most["conditional_wake_scan"] <= 0:
        fail("phase 3: the conditional move's line to 590 s never scanned a parked pod against an event")
    check_kernel("conditional_wake_scan", wk.conditional_wake_scan, step_mod.wake_scan_plain, args, kwargs, -1,
                 None, 10 * Cw * Pw + 10 * Cw * V, 6 * most["conditional_wake_scan"])
    del sim, busiest

    stamp("phase 3: the telemetry record")
    # The flight recorder's record (ops/telemetry_kernel.py; glue, no TPU
    # kernel) on phase 17's line, the composed line through pod_window=512
    # with telemetry on, eagerly to 590 s: its last call (C = 256, N = 96,
    # P = 648, the ring's R = 1024), compared bit for bit (the row, the
    # cursor and the counter snapshot it writes in place). Timed in place
    # on input copies that share the ring (one row a cluster written). No
    # PyTorch call computes it.
    from kubernetriks_tpu_torch.ops import telemetry_kernel as tk

    sim = composed_sim(dev, 256, **FULL_COMPOSED, pod_window=COMPOSED_POD_WINDOW, graphs=False, telemetry=True)
    last = {}
    real_record = tk.telemetry_record

    def recording(*args, **kwargs):
        head, counters, tail = args[:7], args[7], args[8:]
        last["call"] = (kept(head) + ([c.clone() for c in counters],) + kept(tail), kwargs)
        return real_record(*args, **kwargs)

    tk.telemetry_record = recording
    try:
        sim.step_until_time(590.0)
    finally:
        tk.telemetry_record = real_record
    torch.cuda.synchronize()
    if "call" not in last:
        fail("phase 3: the composed line with telemetry on never called the record")
    args, kwargs = last["call"]
    phase_r, alive_r, head_r = args[0], args[1], args[2]
    C, P = phase_r.shape
    N, R = alive_r.shape[1], args[9].shape[1]
    Gp, Gn = (0, 0) if head_r is None else (head_r.shape[1], args[4].shape[1])
    print(f"phase 3: the record on {WINDOWED_COMPOSED} at 590 s: C={C} N={N} P={P} R={R} Gp={Gp} Gn={Gn}",
          flush=True)
    del sim

    def record_outs(fn):
        def run(*a, **k):
            m0, buf, cursor = (x.clone() for x in a[8:])
            fn(*a[:8], m0, buf, cursor, **k)
            return m0, buf, cursor

        return run

    def check_record(args, kwargs, label):
        # Bytes: the phase and alive rows, the reserve leaves, the pod
        # bases, the window, the counters; m0 and the cursor read and
        # written, a row written; with lane clocks the global window and
        # the active lanes too.
        C, P = args[0].shape
        N, Gp = args[1].shape[1], 0 if args[2] is None else args[2].shape[1]
        Gn = 0 if args[2] is None else args[4].shape[1]
        lanes = 4 * C + C if kwargs.get("active") is not None else 0
        size = nbytes([a for a in args[:7] if isinstance(a, torch.Tensor)]) + nbytes(args[7]) + nbytes(args[8:])
        n_sets = min(MAX_COPIES, max(1, -(-2 * L2_BYTES // max(size, 1))))
        sets = [args] + [
            tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args[:7])
            + ([c.clone() for c in args[7]], args[8].clone(), args[9], args[10].clone())
            for _ in range(n_sets - 1)
        ]
        check_kernel(
            "telemetry_record", record_outs(tk.telemetry_record), record_outs(step_mod.telemetry_record_plain),
            args, kwargs, -1, None,
            4 * C * P + C * N + 8 * C * Gp + 4 * C * Gn + 8 * C + 40 * C + 80 * C + 48 * C + 8 * C + lanes,
            C * (2 * P + N), label=label, timed=(tk.telemetry_record, step_mod.telemetry_record_plain, sets),
        )

    check_record(args, kwargs, "telemetry_record")
    del args
    # The record with the lane columns (the global window, the active
    # lanes), bit for bit, on phase 21b's line: a lane-asynchronous fleet
    # of 256 lanes over the sweep line with pod faults, its horizons
    # cycling the open-loop mix, eagerly: its last record in the second
    # pump round, where the lanes of the shortest queries are parked
    # (inactive) beside the others.
    from kubernetriks_tpu_torch.batched.fleet import ScenarioFleet

    fleet = ScenarioFleet(sweep_config, sweep_cluster, sweep_workload, n_lanes=256, horizon=SWEEP_QUERY_HORIZON,
                          device=dev, graphs=False, max_pods_per_cycle=SWEEP_K, telemetry=True, lane_async=True,
                          span_windows=OPEN_LOOP_SPAN)
    for i, scen in enumerate(sweep_scenarios(256, seeds=True)[0]):
        fleet.submit(scen, SWEEP_QUERY_HORIZON * OPEN_LOOP_HORIZON_MIX[i % len(OPEN_LOOP_HORIZON_MIX)])
    last = {}

    def recording_lanes(*args, **kwargs):
        head, counters, tail = args[:7], args[7], args[8:]
        last["call"] = (kept(head) + ([c.clone() for c in counters],) + kept(tail),
                        {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()})
        return real_record(*args, **kwargs)

    tk.telemetry_record = recording_lanes
    try:
        fleet.pump()
        fleet.pump()
    finally:
        tk.telemetry_record = real_record
    torch.cuda.synchronize()
    args, kwargs = last["call"]
    active = kwargs.get("active")
    if active is None or not (bool(active.any()) and not bool(active.all())):
        fail(f"phase 3: the lane-asynchronous fleet's record saw no mix of active and parked lanes ({active})")
    print(f"phase 3: the record with lane columns on a lane-asynchronous fleet of 256 lanes at global window "
          f"{int(kwargs['window'][0])}: {int(active.sum())} lanes active, {int((~active).sum())} parked", flush=True)
    check_record(args, kwargs, "telemetry_record (lane columns)")
    fleet.close()
    del fleet, args
    floors = chain_floors(sk, dev)
    print(
        "phase 3: chain floor per candidate (one cluster, 32 nodes, 1 024 candidates): "
        + ", ".join(f"{k} {v:.4f} us" for k, v in floors.items()),
        flush=True,
    )

    # --- 4. the main path ----------------------------------------------------
    stamp("phase 4")
    sim = headline_sim(dev)
    main_path = timed_path(sim, sk, names, "phase 4")
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
    del sim, st
    main_path["busy"], _ = profiled_busy(lambda: headline_sim(dev), 190.0, 690.0, "phase 4")

    # --- 5. card against CPU ---------------------------------------------------
    stamp("phase 5")
    from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
    from kubernetriks_tpu_torch.batched.state import compare_states, flatten
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
        if where == "cuda":
            ran_on_graphs("phase 5", s)
        finals[where] = (state_to_numpy(s.state), s.metrics_summary()["counters"])
    bad = compare_states(finals["cuda"][0], finals["cpu"][0])
    if bad:
        fail(f"card and CPU states differ at {bad}")
    counters = finals["cuda"][1]
    if counters["scheduling_decisions"] <= 0 or counters["pods_succeeded"] <= 0:
        fail(f"phase 5 run made no progress: {counters}")
    print(f"phase 5: card == CPU under compare_states ({counters})", flush=True)

    # --- 6. the autoscaler path -----------------------------------------------
    stamp("phase 6")
    ca_names = ["fused_ca_scale_down", "fused_ca_scale_up"]
    sim = composed_sim(dev, 256, **FULL_COMPOSED)
    if not sim.reclaim:
        fail(f"phase 6: the card engine built without slot reclaim ({sim.reclaim_unsupported})")
    autoscaler_path = timed_path(sim, sk, names + ca_names, "phase 6")
    auto_launches = autoscaler_path["launches"]
    auto_counters = sim.metrics_summary()["counters"]  # raises if an autoscaler bound was crossed
    print(f"phase 6: counters {auto_counters}", flush=True)
    for key in ("total_scaled_up_pods", "total_scaled_down_pods", "total_scaled_up_nodes", "total_scaled_down_nodes"):
        if auto_counters[key] <= 0:
            fail(f"the autoscaler path made no {key}")
    st = sim.state
    for path, leaf in flatten(st.metrics).items():
        if not bool((leaf == leaf[:1]).all()) and leaf.dtype == torch.int32:
            fail(f"clusters replaying the same trace diverged at {path}")
    for leaf in (st.pods.phase, st.pods.node, st.nodes.alive, st.auto.ca_count, st.auto.hpa_tail):
        if not bool((leaf == leaf[:1]).all()):
            fail("clusters replaying the same trace diverged")
    print("phase 6: autoscaler bounds and state checks passed", flush=True)
    autoscaler_path["counters"] = auto_counters
    autoscaler_path["shape"] = {"C": sim.n_clusters, "N": sim.n_nodes, "P": sim.n_pods, "hpa_seg": list(sim.hpa_seg)}
    whole_summary = sim.metrics_summary()
    whole_metrics = metric_leaves(st)
    whole_phase = st.pods.phase.clone()
    del sim, st
    autoscaler_path["busy"], _ = profiled_busy(
        lambda: composed_sim(dev, 256, **FULL_COMPOSED), 190.0, 1190.0, "phase 6")

    windowed_composed, windowed_metrics = composed_window_phase(
        dev, sk, names + ca_names,
        {"summary": whole_summary, "metrics": whole_metrics, "phase": whole_phase, "path": autoscaler_path},
    )
    del whole_phase
    composed_reclaim_off = composed_reclaim_pair(dev, sk, names + ca_names, windowed_composed, windowed_metrics)

    # --- 7. card against CPU on the autoscaler path -----------------------------
    stamp("phase 7")
    for reclaim in (True, False):
        finals = {}
        sk.reset_launches()
        for where in ("cuda", "cpu"):
            s7 = composed_sim(where, 8, reclaim=reclaim)
            s7.step_until_time(400.0)
            if where == "cuda":
                ran_on_graphs("phase 7", s7)
            finals[where] = (state_to_numpy(s7.state), s7.metrics_summary()["counters"])
        counts = sk.launch_counts()
        if counts["fused_ca_scale_down"] <= 0 or counts["fused_ca_scale_up"] <= 0:
            fail(f"phase 7 card run (reclaim {reclaim}) did not launch both CA kernels")
        bad = compare_states(finals["cuda"][0], finals["cpu"][0])
        if bad:
            fail(f"autoscaler path, reclaim {reclaim}: card and CPU states differ at {bad}")
        counters = finals["cuda"][1]
        if counters["total_scaled_down_nodes"] <= 0 or counters["total_scaled_up_nodes"] <= 0:
            fail(f"phase 7 run (reclaim {reclaim}) made no CA scale-up and removal: {counters}")
        print(f"phase 7: card == CPU under compare_states on the autoscaler path, reclaim {reclaim} "
              f"({counters})", flush=True)
    # The same through an 8-slot pod window: it slides and grows.
    finals = {}
    for where in ("cuda", "cpu"):
        s7 = composed_sim(where, 8, pod_window=8, reclaim=True)
        s7.step_until_time(400.0)
        if where == "cuda":
            ran_on_graphs("phase 7w", s7)
        finals[where] = (state_to_numpy(s7.state), dict(s7.dispatch_stats), s7.pod_window)
    bad = compare_states(finals["cuda"][0], finals["cpu"][0])
    if bad:
        fail(f"phase 7w: card and CPU states differ at {bad}")
    stats = finals["cuda"][1]
    if not stats["slides"] or not stats["grows"] or (stats["slides"], stats["grows"]) != (
            finals["cpu"][1]["slides"], finals["cpu"][1]["grows"]):
        fail(f"phase 7w: slides and growths {stats} on the card, {finals['cpu'][1]} on the CPU")
    print(f"phase 7w: card == CPU under compare_states through pod_window=8 ({stats['slides']} slides, "
          f"{stats['grows']} growths, final W {finals['cuda'][2]})", flush=True)

    # --- 8. the two-kernel route on the headline shape -------------------------
    stamp("phase 8")
    sim = with_megakernel_flag("0", lambda: headline_sim(dev))
    two_kernel_path = timed_path(
        sim, sk, ["fused_event_scatter", "fused_free_resources"] + two_names, "phase 8"
    )
    if sim.cycle_route != "two_kernel" or two_kernel_path["launches"]["fused_select_cycle_commit"]:
        fail("phase 8 did not run on the two-kernel route alone")
    del sim

    # --- 9. the trace-replay path at full width ---------------------------------
    stamp("phase 9")
    replay_names = [
        "fused_event_scatter", "fused_free_resources", "fused_schedule_cycle",
        "fused_ca_scale_down", "fused_ca_scale_up",
    ]
    t0 = time.perf_counter()
    sim = replay_sim(dev, replay_paths)
    build_s9 = time.perf_counter() - t0
    if sim.cycle_route != "sorted":
        fail(f"the replay built the {sim.cycle_route} route, not the sorted one")
    replay_path = {"build_s": build_s9, **timed_replay(sim, sk, replay_names, "phase 9")}
    replay_launches = replay_path["launches"]
    counters = replay_path["counters"]
    print(
        f"phase 9: replay route {sim.cycle_route}, N={sim.n_nodes} P={sim.n_pods} "
        f"({sim.n_real_pods} pods, {sim.n_events} events), built in {build_s9:.2f} s, windows "
        f"{replay_path['windows']}, wall {replay_path['wall_s']:.3f} s = {replay_path['ms_per_window']:.3f} "
        f"ms/window, {replay_path['decisions_per_s']:.1f} decisions/s, {replay_path['events_per_s']:.1f} "
        f"events/s, pods_succeeded {counters['pods_succeeded']}, scaled-up nodes "
        f"{counters['total_scaled_up_nodes']}, host syncs {sim.host_syncs}, {replay_path['precompiled_graphs']} "
        f"graphs captured up front in {replay_path['precompile_s']:.2f} s, run: {replay_path['graph']}, "
        f"launches {replay_launches}",
        flush=True,
    )
    del sim
    replay_path["busy"], _ = profiled_busy(lambda: replay_sim(dev, replay_paths), 43200.0, 44200.0, "phase 9")

    windowed_replay = replay_window_phase(dev, sk, replay_paths, replay_path, replay_names)
    windowed_replay_unstreamed = replay_window_phase(
        dev, sk, replay_paths, replay_path, replay_names, stream=False, streamed=windowed_replay)
    replay_final = windowed_replay.pop("final")

    # --- 10. card against CPU: the replay and the two-kernel route ----------------
    stamp("phase 10")
    small_paths = replay_trace("replay_small", n_machines=100, n_tasks=700, horizon=4000.0, seed=7)
    finals = {}
    sk.reset_launches()
    for where in ("cuda", "cpu"):
        s10 = replay_sim(where, small_paths, delays="test", ca=False)
        s10.run_to_completion()
        if where == "cuda":
            ran_on_graphs("phase 10", s10)
        finals[where] = (state_to_numpy(s10.state), s10.metrics_summary()["counters"], s10.next_window_idx)
    if sk.launch_counts()["fused_schedule_cycle"] <= 0:
        fail("phase 10 card replay did not launch fused_schedule_cycle")
    bad = compare_states(finals["cuda"][0], finals["cpu"][0])
    if bad or finals["cuda"][2] != finals["cpu"][2]:
        fail(f"replay: card and CPU differ at {bad} (windows {finals['cuda'][2]} vs {finals['cpu'][2]})")
    counters = finals["cuda"][1]
    if counters["pods_succeeded"] <= 500:
        fail(f"phase 10 replay made too little progress: {counters}")
    print(f"phase 10: replay card == CPU under compare_states ({counters})", flush=True)
    finals = {}
    runs = (("cuda", "0"), ("cuda", "1"), ("cpu", "0"))
    for where, flag in runs:
        s10 = with_megakernel_flag(flag, lambda: headline_sim(where, n_clusters=128))
        s10.step_until_time(60.0)
        if where == "cuda":
            ran_on_graphs("phase 10", s10)
        finals[(where, s10.cycle_route)] = state_to_numpy(s10.state)
    want = {("cuda", "two_kernel"), ("cuda", "megakernel"), ("cpu", "two_kernel")}
    if set(finals) != want:
        fail(f"phase 10 routes were {sorted(finals)}")
    ref = finals[("cuda", "two_kernel")]
    for key in (("cuda", "megakernel"), ("cpu", "two_kernel")):
        bad = compare_states(ref, finals[key])
        if bad:
            fail(f"two-kernel route on the card differs from {key} at {bad}")
    print(
        "phase 10: headline at C=128 to t=60 s: two-kernel route on the card == megakernel route on "
        f"the card == two-kernel route on the CPU ({int(ref['.metrics.scheduling_decisions'].sum())} decisions)",
        flush=True,
    )

    # --- 11. the graph executor against eager windows on the card ----------------
    stamp("phase 11")
    graph_vs_eager = {
        "headline C=128 megakernel": graph_eager_pair(
            "phase 11 headline megakernel", sk, lambda g: headline_sim(dev, n_clusters=128, graphs=g),
            300.0, "megakernel"),
        "headline C=128 two_kernel": graph_eager_pair(
            "phase 11 headline two-kernel", sk, lambda g: headline_sim(dev, n_clusters=128, graphs=g),
            300.0, "two_kernel"),
        "autoscaler": graph_eager_pair(
            "phase 11 autoscaler", sk, lambda g: composed_sim(dev, 256, **FULL_COMPOSED, graphs=g), 1200.0),
        "replay to 2000 s": graph_eager_pair(
            "phase 11 replay", sk, lambda g: replay_sim(dev, replay_paths, graphs=g), 2000.0),
        "autoscaler through pod_window=128": graph_eager_pair(
            "phase 11 autoscaler pod_window=128", sk,
            lambda g: composed_sim(dev, 256, **FULL_COMPOSED, pod_window=128, graphs=g), 1200.0, sliding=True),
        "small replay through pod_window=64": graph_eager_pair(
            "phase 11 small replay pod_window=64", sk,
            lambda g: replay_sim(dev, small_paths, delays="test", ca=False, pod_window=64, graphs=g), 4550.0,
            sliding=True),
        "endurance churn C=4, 24 waves": graph_eager_pair(
            "phase 11 endurance churn", sk, lambda g: endurance_sim(dev, 4, 24, graphs=g), 30.0 + 24 * 160.0,
            sliding=True, must_grow=False),
    }

    # --- 12. the endurance churn through slot reclaim ------------------------------
    stamp("phase 12")
    churn_path = churn_phase(dev, sk, names + ca_names)

    # --- 13. scheduler profiles ------------------------------------------------------
    stamp("phase 13")
    profiles_path = profiles_phase(dev, sk, names, two_names, replay_paths, replay_names, replay_path)

    # --- 14. the chaos engine ----------------------------------------------------------
    stamp("phase 14")
    faults_path = faults_phase(dev, sk, names + ca_names, windowed_composed)

    # --- 15. the sparse headline: fast-forward -----------------------------------------
    stamp("phase 15")
    ff_names = ["window_work_due", "next_window_span", "catch_up"]
    sparse_path = sparse_phase(dev, sk, names + ff_names)

    # --- 16. the conditional move on graphs ------------------------------------------------
    stamp("phase 16")
    cm_path = conditional_move_phase(dev, sk, names + ca_names + ["conditional_wake_scan"], windowed_composed)

    # --- 17. the flight recorder --------------------------------------------------------------
    stamp("phase 17")
    telemetry_path = telemetry_phase(dev, sk, names + ca_names, windowed_composed)

    # --- 18. over the budget, streamed -----------------------------------------------------------
    stamp("phase 18")
    streamed_path = streamed_replay_phase(dev, sk, replay_paths, replay_names[:2] + ["fused_select_cycle_commit"]
                                          + replay_names[3:])

    # --- 19. checkpoints on the card ------------------------------------------------------------------
    stamp("phase 19")
    checkpoint_path = checkpoint_phase(dev, sk, smi, names + ca_names, replay_paths, replay_final,
                                       windowed_replay["windows"])
    del replay_final

    # --- 20. the scenario fleet ------------------------------------------------------------------------
    stamp("phase 20")
    fleet_path = fleet_phase(
        dev, sk, smi, ["fused_event_scatter", "fused_free_resources", "fused_schedule_cycle"] + ca_names, names + ca_names)

    # --- 21-22. the lane-asynchronous fleet ----------------------------------------------------------
    stamp("phase 21")
    lane_path = lane_async_phase(
        dev, sk, smi, ["fused_event_scatter", "fused_free_resources", "fused_schedule_cycle"] + ca_names,
        names + ca_names)

    # --- 23. the RL scheduler loop ----------------------------------------------------------------------------
    stamp("phase 23")
    rl_path = rl_phase(dev, sk, smi)

    kernels = []
    meta = {
        "fused_event_scatter": ("event_scatter.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:671"),
        "fused_free_resources": ("free_resources.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:513"),
        "fused_select_cycle_commit": ("select_cycle_commit.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:1139"),
        "fused_ca_scale_down": ("ca_scale_down.cu", "kubernetriks_tpu/ops/autoscale_kernel.py:177"),
        "fused_ca_scale_up": ("ca_scale_up.cu", "kubernetriks_tpu/ops/autoscale_kernel.py:402"),
        "fused_select_schedule_cycle": ("select_schedule_cycle.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:336"),
        "fused_commit_scatter": ("commit_scatter.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:828"),
        "fused_schedule_cycle": ("schedule_cycle.cu", "kubernetriks_tpu/ops/scheduler_kernel.py:903"),
        "pod_attempt_draw": (
            "pod_attempt_draw.cu", "kubernetriks_tpu/batched/step.py:1311 (XLA in the reference, no TPU kernel)"),
        "window_work_due": (
            "window_work_due.cu", "kubernetriks_tpu/batched/step.py:157 (XLA in the reference, no TPU kernel)"),
        "next_window_span": (
            "next_window.cu", "kubernetriks_tpu/batched/step.py:2239 (XLA in the reference, no TPU kernel)"),
        "catch_up": ("catch_up.cu", "kubernetriks_tpu/batched/step.py:2322 (XLA in the reference, no TPU kernel)"),
        "conditional_wake_scan": (
            "conditional_wake.cu", "kubernetriks_tpu/batched/step.py:994 (XLA in the reference, no TPU kernel)"),
        "telemetry_record": (
            "telemetry_record.cu", "kubernetriks_tpu/batched/step.py:1784 (XLA in the reference, no TPU kernel)"),
    }
    # Each kernel's launches come from its own path's run: the scheduling
    # kernels from the headline path (phase 4), the CA kernels from the
    # autoscaler path (phase 6), the two-kernel route's from phase 8, the
    # candidate cycle from the replay (phase 9).
    path_launches = {
        **{n: main_path["launches"][n] for n in names},
        **{n: auto_launches[n] for n in ca_names},
        **{n: two_kernel_path["launches"][n] for n in two_names},
        "fused_schedule_cycle": replay_launches["fused_schedule_cycle"],
    }
    # The replay-shape entries of the kernels that also run at other
    # shapes, with the replay's launches (phase 9).
    replay_labels = {
        f"{n} (replay)": n
        for n in ("fused_event_scatter", "fused_free_resources", "fused_ca_scale_down", "fused_ca_scale_up")
    }
    path_launches.update({label: replay_launches[n] for label, n in replay_labels.items()})
    # The windowed entries, with the launches of the run through the window
    # (phases 6w and 9w).
    for n in names:
        label = f"{n} (composed, {WINDOWED_COMPOSED})"
        replay_labels[label] = n
        path_launches[label] = windowed_composed["launches"][n]
    for n in ("fused_event_scatter", "fused_free_resources", "fused_schedule_cycle"):
        label = f"{n} (replay, {WINDOWED_REPLAY})"
        replay_labels[label] = n
        path_launches[label] = windowed_replay["launches"][n]
    # The CA kernels on the churn's reused slots, with the launches of the
    # churn's run (phase 12).
    for n, label in CHURN_LABELS.items():
        replay_labels[label] = n
        path_launches[label] = churn_path["launches"][n]
    # The cycle kernels under each profile, with the launches of that
    # profile's timed runs (phase 13: the headline on the megakernel and
    # the two-kernel routes, the replay on the sorted route).
    for prof in KERNEL_PROFILES:
        for n, launches in (
            ("fused_select_cycle_commit", profiles_path["timed"][prof]["launches"]),
            ("fused_select_schedule_cycle", profiles_path["two_kernel"][prof]["launches"]),
            ("fused_schedule_cycle", profiles_path["replay"][prof]["launches"]),
        ):
            label = f"{n} ({prof})"
            replay_labels[label] = n
            path_launches[label] = launches[n]
    # The fault path's entries, with the launches of phase 14's timed run.
    for n in ("fused_event_scatter", "fused_free_resources", "fused_select_cycle_commit",
              "fused_ca_scale_down", "fused_ca_scale_up", "pod_attempt_draw"):
        label = f"{n} ({FAULTS_LABEL})"
        replay_labels[label] = n
        path_launches[label] = faults_path["launches"][n]
    # The window glue: the razor's predicate, fast-forward's next window and
    # catch-up from the sparse headline's run (phase 15), the conditional
    # move's scans from its line's (phase 16).
    glue_names = ff_names + ["conditional_wake_scan", "telemetry_record"]
    path_launches.update({n: sparse_path["launches"][n] for n in ff_names})
    path_launches["conditional_wake_scan"] = cm_path["launches"]["conditional_wake_scan"]
    # The record from phase 17's telemetry-on run.
    path_launches["telemetry_record"] = telemetry_path["on"]["launches"]["telemetry_record"]
    # The commit draw with the fleet's seed vector, with phase 20b's launches.
    replay_labels["pod_attempt_draw (seed vector)"] = "pod_attempt_draw"
    path_launches["pod_attempt_draw (seed vector)"] = fleet_path["wide"]["launches"]["pod_attempt_draw"]
    # The record with lane columns, with phase 21b's launches.
    replay_labels["telemetry_record (lane columns)"] = "telemetry_record"
    path_launches["telemetry_record (lane columns)"] = lane_path["wide"]["launches"]["telemetry_record"]
    for label in names + ca_names + two_names + ["fused_schedule_cycle"] + list(replay_labels) + glue_names:
        name = replay_labels.get(label, label)
        r = report[label]
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": f"kubernetriks_tpu_torch/ops/csrc/{meta[name][0]}",
            "replaces": meta[name][1],
            "launches": path_launches[label],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump({
            "card": smi, "build_s": build_s, "kernels": kernels, "chain_floor_us": floors,
            "checks": report, "main_path": main_path,
            "autoscaler_path": autoscaler_path, "two_kernel_path": two_kernel_path,
            "replay_path": replay_path, "graph_vs_eager": graph_vs_eager,
            "windowed_composed": windowed_composed, "windowed_replay": windowed_replay,
            "composed_reclaim_off": composed_reclaim_off, "churn": churn_path,
            "profiles": profiles_path, "faults": faults_path, "sparse": sparse_path, "conditional_move": cm_path,
            "telemetry": telemetry_path, "windowed_replay_unstreamed": windowed_replay_unstreamed,
            "streamed_replay": streamed_path,
            "checkpoint": checkpoint_path, "fleet": fleet_path, "lane_async": lane_path, "rl": rl_path,
            "replay_block_s": replay_block_s,
        }, f, indent=1, default=float)
    stamp("the report")
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
