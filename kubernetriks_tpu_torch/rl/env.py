"""RL environment: the batched simulator driven by a learned scheduler policy.

Port of the JAX package's `rl/env.py`. The policy replaces the
KubeScheduler's filter/score pass: per pending pod, node logits over the
cluster's nodes, masked to Fit-feasible nodes. Everything else (trace
events, queues, finishes, delays, metrics, the autoscalers) is the port's
unmodified window step, so the policy trains against the simulated
control-plane dynamics. On the card the window's events run the event
scatter and free kernels (ops/csrc/event_scatter.cu, free_resources.cu),
the commit runs the commit scatter kernel (commit_scatter.cu) and an
autoscaled sim's CA cycles run the two CA kernels; on the CPU their plain
versions.

What the reference's rollout (env.py:233) does, and so does this one:
- every window of the rollout runs (no fast-forward); the window-cost
  razor is off, which changes nothing (the reference's razor skips a
  window only where its work is provably the identity);
- no fault step: a sim with faults configured rolls out without them;
- under CA slot reclaim, no compaction pass: the CA pass stamps
  allocation indices (its reclaim leaves are present), and the window's
  reschedules order nodes by the static name ranks;
- no telemetry record.
The engine decides on the host which event chunks, removals and
autoscaler passes a window runs; those facts depend only on the trace and
the due times, so the rollout replays the plans of the build state
(BatchedSimulation.initial_window_plans) and never advances the engine's
own mirrors.

Sampling is `jax.random.categorical`'s: argmax(safe_logits + g) with g
Gumbel noise, the first index on ties; greedy is argmax(safe_logits). The
noise of a whole rollout, (W, K, C, N) float32, is drawn up front
(draw_gumbel) from an explicit generator, or passed in (`gumbel=`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from kubernetriks_tpu_torch.batched.pipeline import DEFAULT_PROFILE, profile_fit_mask
from kubernetriks_tpu_torch.batched.state import ClusterBatchState
from kubernetriks_tpu_torch.batched.step import (
    DeviceConstants,
    WindowPlan,
    apply_window_events,
    commit_cycle,
    cycle_timing,
    decision_metrics,
    prepare_cycle,
)

# The reference's finite mask value for infeasible nodes (env.py:137):
# keeps softmax / log_softmax gradients NaN-free.
MASK_LOGIT = -1e9


class Transition(NamedTuple):
    """One scheduling decision per (cluster,) slice; stacked over (W, K)."""

    obs: torch.Tensor  # (..., C, N, F) node features
    action: torch.Tensor  # (..., C) int64 chosen node
    log_prob: torch.Tensor  # (..., C)
    value: torch.Tensor  # (..., C)
    reward: torch.Tensor  # (..., C)
    valid: torch.Tensor  # (..., C) bool: a decision actually happened


def featurize(alive, alloc_cpu, alloc_ram, cap_cpu, cap_ram, req_cpu, req_ram) -> torch.Tensor:
    """Per-node features for one pending pod a cluster: (C, N, F). The
    feasibility channel is the scheduler pipeline's Fit plugin, so the
    action mask and the kube-scheduler's filter agree on what fits."""
    f32 = torch.float32
    fits = profile_fit_mask(DEFAULT_PROFILE, alive, alloc_cpu, alloc_ram, req_cpu[:, None], req_ram[:, None])
    return _node_features(
        alive.to(f32), fits, alloc_cpu, alloc_ram, torch.clamp(cap_cpu.to(f32), min=1.0),
        torch.clamp(cap_ram.to(f32), min=1.0), req_cpu.to(f32), req_ram.to(f32),
    )


def _node_features(alive_f, fits, alloc_cpu, alloc_ram, cap_cpu_f, cap_ram_f, req_cpu_f, req_ram_f):
    """featurize's stack from the float32 pieces (the capacities clamped to
    1), which the policy cycle converts once a cycle."""
    f32 = torch.float32
    return torch.stack(
        [
            alive_f,
            fits.to(f32),
            alloc_cpu.to(f32) / cap_cpu_f,
            alloc_ram.to(f32) / cap_ram_f,
            req_cpu_f[:, None] / cap_cpu_f,
            req_ram_f[:, None] / cap_ram_f,
        ],
        dim=-1,
    )


def draw_gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), float32, u uniform in [tiny, 1)
    (the range of jax.random.gumbel's draw), on the generator's device."""
    u = torch.rand(shape, dtype=torch.float32, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def policy_cycle(
    state: ClusterBatchState,
    W: torch.Tensor,
    k: DeviceConstants,
    K: int,
    policy_apply,
    params,
    gumbel: Optional[torch.Tensor] = None,
    conditional_move: bool = False,
    reward_size_weighted: bool = False,
    shaping_coef: float = 0.0,
    shaping_gamma: float = 0.99,
    wake=None,
) -> Tuple[ClusterBatchState, Transition]:
    """One scheduling cycle at window W where the policy picks the nodes
    (reference env.py:73): the K decisions in queue order, each
    featurize, apply, mask, sample (`gumbel` (K, C, N)) or argmax (None:
    greedy), deduct; then the decision metrics and the commit. Returns the
    post-cycle state and the K transitions stacked on axis 0.

    Reward options (defaults: +1 a placement, -1 a park, minus a
    queue-time penalty): `reward_size_weighted` pays req_cpu / node_cap
    instead of 1; `shaping_coef` adds shaping_coef * (shaping_gamma *
    phi' - phi), phi the count of whole-free alive nodes, on valid
    decisions (reference docstring)."""
    C = state.pods.phase.shape[0]
    dev = state.time.device
    f32 = torch.float32
    rows = torch.arange(C, device=dev)
    cc = prepare_cycle(state, W, k, K, conditional_move, wake)
    nodes = state.nodes
    alive = nodes.alive
    alive_count = alive.sum(dim=1, dtype=torch.int32).to(f32)
    pod_sched_time = k.time_per_node * alive_count
    pod_queue_time_k, start_s_k, park_s_k = cycle_timing(cc.valid, cc.waited, pod_sched_time, k)

    # What featurize and the rewards convert, once a cycle (the same
    # float32 values a decision would compute).
    alive_f = alive.to(f32)
    cap_cpu_f = torch.clamp(nodes.cap_cpu.to(f32), min=1.0)
    cap_ram_f = torch.clamp(nodes.cap_ram.to(f32), min=1.0)
    req_cpu_f, req_ram_f = cc.req_cpu.to(f32), cc.req_ram.to(f32)
    neg_cpu, neg_ram = -cc.req_cpu, -cc.req_ram
    queue_penalty = 0.01 * torch.clamp(pod_queue_time_k, max=100.0)

    def whole_free(alloc):
        return (alive & (alloc == nodes.cap_cpu)).sum(dim=1).to(f32)

    alloc_cpu, alloc_ram = nodes.alloc_cpu, nodes.alloc_ram
    free_before = whole_free(alloc_cpu) if shaping_coef else None
    assigns, parks, actions, steps = [], [], [], []
    for j in range(cc.valid.shape[1]):
        valid = cc.valid[:, j]
        fits = profile_fit_mask(
            DEFAULT_PROFILE, alive, alloc_cpu, alloc_ram, cc.req_cpu[:, j, None], cc.req_ram[:, j, None]
        )
        obs = _node_features(alive_f, fits, alloc_cpu, alloc_ram, cap_cpu_f, cap_ram_f, req_cpu_f[:, j], req_ram_f[:, j])
        any_fit = fits.any(dim=1)
        logits, value = policy_apply(params, obs)
        # A row where nothing fits is uniform over nodes; its decision parks.
        safe = torch.where(any_fit[:, None], torch.where(fits, logits, MASK_LOGIT), 0.0)
        action = torch.argmax(safe if gumbel is None else safe + gumbel[j], dim=1)
        log_prob = torch.log_softmax(safe, dim=-1)[rows, action]

        assign = valid & any_fit
        park = valid & ~any_fit
        at = action[:, None]
        alloc_cpu = alloc_cpu.scatter_add(1, at, torch.where(assign, neg_cpu[:, j], 0)[:, None])
        alloc_ram = alloc_ram.scatter_add(1, at, torch.where(assign, neg_ram[:, j], 0)[:, None])

        # (A Python scalar with a float32 tensor computes in float32, as
        # the reference's weak-typed constants do.)
        unit = req_cpu_f[:, j] / cap_cpu_f.gather(1, at)[:, 0] if reward_size_weighted else 1.0
        reward = torch.where(assign, unit - queue_penalty[:, j], torch.where(park, -unit, 0.0))
        if shaping_coef:
            free_after = whole_free(alloc_cpu)
            # Only valid decisions carry shaping: invalid slots stay
            # transparent to GAE's masked recursion.
            reward = reward + torch.where(valid, shaping_coef * (shaping_gamma * free_after - free_before), 0.0)
            free_before = free_after
        assigns.append(assign)
        parks.append(park)
        actions.append(action)
        steps.append(Transition(obs=obs, action=action, log_prob=log_prob, value=value, reward=reward, valid=valid))

    assign_k = torch.stack(assigns, dim=1)
    metrics = decision_metrics(state.metrics, assign_k, pod_queue_time_k, pod_sched_time)
    # The commit scatter is the hand kernel on the card (the two-kernel
    # route's commit), its plain version on the CPU.
    state = commit_cycle(
        state, cc, W, k, alloc_cpu, alloc_ram, metrics, assign_k, torch.stack(parks, dim=1),
        torch.stack(actions, dim=1).to(torch.int32), start_s_k, park_s_k, use_kernel=True,
    )
    return state, stack_transitions(steps)


def stack_transitions(steps: Sequence[Transition]) -> Transition:
    return Transition(*(torch.stack(field) for field in zip(*steps)))


def rollout(
    sim,
    state: ClusterBatchState,
    plans: List[WindowPlan],
    params,
    policy_apply,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    greedy: bool = False,
    reward_size_weighted: bool = False,
    shaping_coef: float = 0.0,
    shaping_gamma: float = 0.99,
) -> Tuple[ClusterBatchState, Transition]:
    """Windows 0..len(plans)-1 from `state` under the policy (reference
    env.py:233), on the engine `sim`'s slab, constants and autoscaler
    statics; `plans`: sim.initial_window_plans(W). Transitions stacked
    (W, K, C, ...). Sampled unless `greedy`: the noise is `gumbel`
    ((W, K, C, N) float32, any device) or drawn up front from
    `generator`. `state` is not modified (every step is functional); the
    caller keeps its own copy. Runs without autograd."""
    C, N = state.nodes.alive.shape
    dev = state.time.device
    K = sim.max_pods_per_cycle
    n_windows = len(plans)
    if not greedy:
        if gumbel is None:
            if generator is None:
                raise ValueError("a sampled rollout needs a generator or a gumbel tensor")
            gumbel = draw_gumbel(generator, (n_windows, K, C, N))
        if tuple(gumbel.shape) != (n_windows, K, C, N):
            raise ValueError(f"gumbel is {tuple(gumbel.shape)}, the rollout needs {(n_windows, K, C, N)}")
        gumbel = gumbel.to(device=dev, dtype=torch.float32)
    statics = sim.autoscale_statics
    # The reference's rollout ranks reschedules by the autoscaler statics'
    # name tables, and without autoscalers keeps none (slot order).
    name_ranks = sim.name_ranks if statics is not None else None
    out = []
    with torch.no_grad():
        for w, plan in enumerate(plans):
            W = torch.full((C,), w, dtype=torch.int32, device=dev)
            state, wake = apply_window_events(
                state, sim.slab, W, sim.consts, sim._k, sim.max_events_per_window, plan,
                conditional_move=sim.conditional_move, name_ranks=name_ranks,
            )
            pre_cycle = (state.pods.phase, state.pods.attempts, state.nodes.alloc_cpu, state.nodes.alloc_ram)
            state, transition = policy_cycle(
                state, W, sim._k, K, policy_apply, params, None if greedy else gumbel[w],
                conditional_move=sim.conditional_move, reward_size_weighted=reward_size_weighted,
                shaping_coef=shaping_coef, shaping_gamma=shaping_gamma, wake=wake,
            )
            if statics is not None:
                from kubernetriks_tpu_torch.batched.autoscale import ca_pass, hpa_pass

                if plan.hpa_cycle or plan.hpa_collect:
                    state = hpa_pass(state, statics, W, sim._k, sim.hpa_seg, plan.hpa_cycle)
                if plan.ca_due:
                    state = ca_pass(
                        state, statics, W, sim._k, sim.max_ca_pods_per_cycle, sim.max_pods_per_scale_down, pre_cycle,
                    )
            out.append(transition)
    return state, stack_transitions(out)


def final_state_value(state: ClusterBatchState, policy_apply, params) -> torch.Tensor:
    """Critic value of the post-rollout state (zero-request "no pending
    pod" features), which bootstraps truncated-rollout GAE."""
    zeros = torch.zeros(state.nodes.alive.shape[0], dtype=torch.int32, device=state.time.device)
    nodes = state.nodes
    obs = featurize(nodes.alive, nodes.alloc_cpu, nodes.alloc_ram, nodes.cap_cpu, nodes.cap_ram, zeros, zeros)
    with torch.no_grad():
        _, value = policy_apply(params, obs)
    return value
