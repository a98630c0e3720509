"""Policy evaluation: the learning-proof harness for the RL scheduler.

Port of the JAX package's `rl/evaluate.py`. It compares, on the same
trace and the same window cadence, the learned policy run greedily, the
KubeScheduler batched path (Fit + LeastAllocatedResources, the
reference's default) and the best-fit packing heuristic, by placement
metrics read from the same metric arrays: both the policy and the kube
path go through prepare_cycle / commit_cycle and decision_metrics.

The proof scenario is a contended bimodal mix (make_proof_sim): a
high-rate small-pod process and a low-rate large-pod process on clusters
sized so that spreading the small pods (what LeastAllocated does)
fragments every node below the large-pod request, while packing them
leaves whole nodes free. Placement strategy, not capacity, decides
whether the large pods ever place.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.pipeline import bestfit_logits_from_obs
from kubernetriks_tpu_torch.batched.state import PHASE_RUNNING, PHASE_SUCCEEDED, PHASE_UNSCHEDULABLE
from kubernetriks_tpu_torch.rl.env import rollout


def bestfit_policy_apply(params, obs):
    """The best-fit heuristic as a policy_apply: the logits are the
    "best_fit" profile's MostAllocatedResources scorer on the observation
    channels (pipeline.bestfit_logits_from_obs). `params` is unused; the
    value head returns zeros."""
    return bestfit_logits_from_obs(obs), torch.zeros(obs.shape[:-2], dtype=torch.float32, device=obs.device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _summary(state, n_windows: int, large_cpu: Optional[int] = None) -> Dict[str, float]:
    """Placement metrics of a final state, per-cluster means. With
    `large_cpu`, also the placement fractions of the "large" pods (req_cpu
    >= large_cpu), the class whose fate depends on placement strategy."""
    m = state.metrics
    C = state.time.shape[0]
    placements = float(_host(m.scheduling_decisions).sum()) / C
    succeeded = float(_host(m.pods_succeeded).sum()) / C
    qt_count = _host(m.queue_time.count).astype(np.float64)
    qt_total = _host(m.queue_time.total).astype(np.float64)
    mean_queue_time = float(qt_total.sum() / np.maximum(qt_count.sum(), 1.0))
    phases = _host(state.pods.phase)
    unschedulable = float((phases == PHASE_UNSCHEDULABLE).sum()) / C
    placed_mask = (phases == PHASE_RUNNING) | (phases == PHASE_SUCCEEDED)
    out = {
        "placements_per_cluster": placements,
        "succeeded_per_cluster": succeeded,
        "mean_queue_time_s": mean_queue_time,
        "unschedulable_left_per_cluster": unschedulable,
        "placed_or_done_per_cluster": float(placed_mask.sum()) / C,
        "windows": float(n_windows),
    }
    if large_cpu is not None:
        req = _host(state.pods.req_cpu)
        large = (req >= large_cpu) & (phases != 0)  # created large-pod slots
        n_large = max(int(large.sum()), 1)
        out["large_pods_per_cluster"] = float(large.sum()) / C
        out["large_placed_frac"] = float((large & placed_mask).sum()) / n_large
        out["large_unschedulable_frac"] = float((large & (phases == PHASE_UNSCHEDULABLE)).sum()) / n_large
    return out


def eval_policy(
    sim,
    policy_apply,
    params,
    window_idxs,
    generator: Optional[torch.Generator] = None,
    greedy: bool = True,
    large_cpu: Optional[int] = None,
) -> Dict[str, float]:
    """Run the policy over windows 0..len(window_idxs)-1 from the sim's
    build state (rl/env.rollout; the sim is left as it is) and summarise.
    `window_idxs` must be 0, 1, ...: the plans start at the build."""
    idxs = np.asarray(window_idxs)
    if not np.array_equal(idxs, np.arange(len(idxs))):
        raise ValueError("eval_policy runs windows 0..W-1 from the build state")
    final_state, flat = rollout(
        sim, sim.state, sim.initial_window_plans(len(idxs)), params, policy_apply,
        generator=generator, greedy=greedy,
    )
    out = _summary(final_state, len(idxs), large_cpu)
    valid = _host(flat.valid)
    obs = _host(flat.obs)
    parks = valid & ~(obs[..., 1] > 0).any(axis=-1)
    C = valid.shape[-1]
    out["park_decisions_per_cluster"] = float(parks.sum()) / C
    out["mean_reward"] = float((_host(flat.reward) * valid).sum() / max(valid.sum(), 1))
    return out


def eval_kube(sim, window_idxs, large_cpu: Optional[int] = None) -> Dict[str, float]:
    """Run the KubeScheduler batched path over the same windows (a fresh
    sim: this one is stepped)."""
    sim._dispatch_windows(np.asarray(window_idxs, np.int32))
    return _summary(sim.state, len(window_idxs), large_cpu)


# --- the bimodal learning-proof scenario (reference evaluate.py:136-192) ----
# Long-lived small pods load ~59 % of a 16-node cluster; spread by
# LeastAllocated they fragment every node below the full-node large-pod
# request, packed they fit in ~10 nodes.
PROOF_N_NODES = 16
PROOF_NODE_CPU = 16_000
PROOF_NODE_RAM = 32 * 1024**3
PROOF_SMALL = dict(rate_per_second=0.25, cpu=2_000, ram=4 * 1024**3, duration_range=(250.0, 350.0))
PROOF_LARGE = dict(rate_per_second=0.015, cpu=16_000, ram=32 * 1024**3, duration_range=(250.0, 350.0))
PROOF_WINDOWS = 48  # x 10 s cycle interval = 480 s rollout
PROOF_HORIZON = 475.0
PROOF_MAX_PODS_PER_CYCLE = 16


def make_proof_sim(seed_base: int, n_clusters: int, n_seeds: int = 8, device=None, **engine_kwargs):
    """Cluster batch for the learning proof, cycling over n_seeds distinct
    trace seeds (seed_base + 100 k) so the signal does not hinge on one
    Poisson draw; on `device` (None: the card)."""
    from kubernetriks_tpu_torch.batched.engine import BatchedSimulation
    from kubernetriks_tpu_torch.batched.trace_compile import compile_cluster_trace
    from kubernetriks_tpu_torch.config import SimulationConfig
    from kubernetriks_tpu_torch.trace.generator import MergedWorkloadTrace, PoissonWorkloadTrace, UniformClusterTrace

    config = SimulationConfig.from_yaml("sim_name: rl_proof\nseed: 1\nscheduling_cycle_interval: 10.0")
    cluster_events = UniformClusterTrace(PROOF_N_NODES, cpu=PROOF_NODE_CPU, ram=PROOF_NODE_RAM).convert_to_simulator_events()
    compiled = []
    for k in range(min(n_seeds, n_clusters)):
        seed = seed_base + 100 * k
        workload = MergedWorkloadTrace(
            PoissonWorkloadTrace(horizon=PROOF_HORIZON, seed=seed, name_prefix="small", **PROOF_SMALL),
            PoissonWorkloadTrace(horizon=PROOF_HORIZON, seed=seed + 1, name_prefix="large", **PROOF_LARGE),
        )
        compiled.append(compile_cluster_trace(cluster_events, workload.convert_to_simulator_events(), config))
    traces = [compiled[i % len(compiled)] for i in range(n_clusters)]
    return BatchedSimulation(
        config, traces, device=device, max_pods_per_cycle=PROOF_MAX_PODS_PER_CYCLE, **engine_kwargs
    )
