"""PPO trainer for the scheduler policy over batches of simulated clusters.

Port of the JAX package's `rl/ppo.py`. The cluster axis C is the batch
axis. Each PPO iteration rolls W windows x K decisions under the current
policy from a fresh copy of the simulation's build state, computes masked
GAE over each cluster's decision sequence, and takes clipped-objective
gradient steps with Adam.

Adam is optax.adam's update written out (b1 0.9, b2 0.999, eps 1e-8
added outside the square root, bias correction from a step count),
over a dict of parameter tensors; its state is {"count", "mu", "nu"}.
Gradients come from autograd. Float32 throughout, no TF32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from kubernetriks_tpu_torch.rl.env import Transition, final_state_value, rollout

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class PPOConfig(NamedTuple):
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    learning_rate: float = 3e-4
    epochs_per_iteration: int = 4
    # Gradient accumulation over cluster chunks of this size (0: the whole
    # batch in one backward). The chunks' losses use the whole batch's
    # normalisation (advantage mean and std, valid count), so the summed
    # gradient equals the monolithic one up to float32 summation order.
    update_microbatch: int = 0
    # Rollout reward options (rl/env.py policy_cycle).
    reward_size_weighted: bool = False
    shaping_coef: float = 0.0


def compute_gae(
    rewards: torch.Tensor,  # (T, C)
    values: torch.Tensor,  # (T, C)
    valid: torch.Tensor,  # (T, C)
    gamma: float,
    lam: float,
    bootstrap_value: Optional[torch.Tensor] = None,  # (C,) V(s_final)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked generalised advantage estimation over the decision sequence
    (reference ppo.py:49): the reverse recursion seeded with the critic's
    value of the post-rollout state (rollouts are truncated, not
    terminal); invalid steps pass the carry through unchanged."""
    next_adv = torch.zeros_like(values[-1])
    next_value = torch.zeros_like(values[-1]) if bootstrap_value is None else bootstrap_value
    advantages = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value - values[t]
        adv = delta + gamma * lam * next_adv
        next_adv = torch.where(valid[t], adv, next_adv)
        next_value = torch.where(valid[t], values[t], next_value)
        advantages[t] = next_adv
    advantages = torch.stack(advantages)
    return advantages, advantages + values


def normalized_advantages(advantages: torch.Tensor, mask: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / std over the valid decisions (reference ppo.py:115-118)."""
    adv_mean = (advantages * mask).sum() / denom
    adv_std = torch.sqrt(((advantages - adv_mean) ** 2 * mask).sum() / denom + 1e-8)
    return (advantages - adv_mean) / adv_std


def ppo_loss(
    params,
    policy_apply,
    transition: Transition,  # flattened (T, C, ...)
    advantages: torch.Tensor,
    returns: torch.Tensor,
    config: PPOConfig,
    denom: Optional[torch.Tensor] = None,
):
    """Clipped PPO objective (reference ppo.py:85). With denom=None the
    advantages are normalised and the loss averaged over this batch's valid
    decisions; a microbatch caller passes the whole batch's valid count
    and normalised advantages, so the chunk losses sum to the monolithic
    objective. Returns (total, {"policy_loss", "value_loss", "entropy"})."""
    logits, values = policy_apply(params, transition.obs)
    fit = transition.obs[..., 1] > 0
    # Finite mask value: -inf gives NaN gradients through the entropy term.
    masked = torch.where(fit, logits, -1e9)
    any_fit = fit.any(dim=-1, keepdim=True)
    safe = torch.where(any_fit, masked, torch.zeros_like(masked))
    log_probs = torch.log_softmax(safe, dim=-1)
    action_log_prob = torch.gather(log_probs, -1, transition.action[..., None])[..., 0]

    mask = transition.valid.to(torch.float32)
    adv = advantages
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
        adv = normalized_advantages(adv, mask, denom)

    ratio = torch.exp(action_log_prob - transition.log_prob)
    clipped = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps)
    policy_loss = -(torch.minimum(ratio * adv, clipped * adv) * mask).sum() / denom
    value_loss = (((values - returns) ** 2) * mask).sum() / denom
    # Double-where: clamp before the product, so the backward never sees
    # 0 * inf (torch.where passes an inf branch's NaN gradient on, as
    # jnp.where does).
    lp_safe = torch.where(fit, log_probs, 0.0)
    p_safe = torch.where(fit, torch.exp(log_probs), 0.0)
    entropy = -((p_safe * lp_safe).sum(dim=-1) * mask).sum() / denom
    total = policy_loss + config.value_coef * value_loss - config.entropy_coef * entropy
    return total, {"policy_loss": policy_loss, "value_loss": value_loss, "entropy": entropy}


def adam_init(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """optax.adam's state for `params`: a step count and zero moments."""
    dev = next(iter(params.values())).device
    return {
        "count": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": {name: torch.zeros_like(p) for name, p in params.items()},
        "nu": {name: torch.zeros_like(p) for name, p in params.items()},
    }


def adam_update(grads, opt_state, params, learning_rate: float):
    """One optax.adam step: (new params, new state). mu = (1-b1) g + b1 mu,
    nu = (1-b2) g^2 + b2 nu, then -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 -
    b2^t)) + eps) added to each parameter."""
    count = opt_state["count"] + 1
    t = count.to(torch.float32)
    # Python scalars with float32 tensors compute in float32, as optax's
    # weak-typed constants do (and copy nothing to the device).
    bc1 = 1 - ADAM_B1 ** t
    bc2 = 1 - ADAM_B2 ** t
    step = -learning_rate
    new_params, mu, nu = {}, {}, {}
    for name, p in params.items():
        g = grads[name]
        mu[name] = (1 - ADAM_B1) * g + ADAM_B1 * opt_state["mu"][name]
        nu[name] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * opt_state["nu"][name]
        update = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + ADAM_EPS)
        new_params[name] = p + step * update
    return new_params, {"count": count, "mu": mu, "nu": nu}


def ppo_grads(params, policy_apply, transition, advantages, returns, config, denom=None):
    """(loss, aux, grads) of ppo_loss by autograd, in one backward."""
    leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
    with torch.enable_grad():
        loss, aux = ppo_loss(leaves, policy_apply, transition, advantages, returns, config, denom)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(leaves, grads))


def ppo_update(
    params,
    opt_state,
    policy_apply,
    transition: Transition,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    config: PPOConfig,
):
    """One optimizer step on the clipped loss (reference ppo.py:143):
    (new params, new Adam state, loss, aux). With
    config.update_microbatch, the gradient accumulates over cluster chunks
    of that size (it must divide C; reference ppo.py:167-230)."""
    grads_fn = ppo_grads_microbatched if config.update_microbatch else ppo_grads
    loss, aux, grads = grads_fn(params, policy_apply, transition, advantages, returns, config)
    params, opt_state = adam_update(grads, opt_state, params, config.learning_rate)
    return params, opt_state, loss, aux


def ppo_grads_microbatched(params, policy_apply, transition, advantages, returns, config):
    """(loss, aux, grads) summed over cluster chunks of
    config.update_microbatch: the advantages are normalised over the whole
    batch before chunking and every chunk divides by the whole batch's
    valid count, so the sums reproduce the monolithic objective."""
    C = advantages.shape[1]
    Cc = min(config.update_microbatch, C)
    if C % Cc:
        raise ValueError(f"update_microbatch={Cc} must divide the cluster batch ({C})")
    mask = transition.valid.to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    adv = normalized_advantages(advantages, mask, denom)
    grads = {name: torch.zeros_like(p) for name, p in params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=advantages.device)
    aux = {name: torch.zeros_like(loss) for name in ("policy_loss", "value_loss", "entropy")}
    for lo in range(0, C, Cc):
        chunk = Transition(*(x[:, lo:lo + Cc] for x in transition))
        loss_c, aux_c, grads_c = ppo_grads(
            params, policy_apply, chunk, adv[:, lo:lo + Cc], returns[:, lo:lo + Cc], config, denom
        )
        grads = {name: grads[name] + grads_c[name] for name in grads}
        loss = loss + loss_c
        aux = {name: aux[name] + aux_c[name] for name in aux}
    return loss, aux, grads


class PPOTrainer:
    """Owns the policy, its Adam state and the noise generator, and
    iterates rollout -> GAE -> updates against a fresh copy of a
    BatchedSimulation's build state each iteration (reference ppo.py:233).

    The sim must be at window 0, whole-resident (no sliding pod window,
    hence no stream feeder) and without lane clocks: the reference's
    rollout reads the whole slab from window 0. A sim with faults
    configured rolls out without them, as the reference's does. Parameters
    and the rollout live on the sim's device; the generator (seeded with
    `seed`) lives on the CPU, so a seed gives the same initial weights and
    the same noise on the card and on the CPU."""

    def __init__(
        self,
        sim,
        windows_per_rollout: int = 16,
        config: PPOConfig = PPOConfig(),
        hidden: int = 64,
        seed: int = 0,
        policy_kind: str = "mlp",
        device=None,
    ) -> None:
        from kubernetriks_tpu_torch.batched.engine import resolve_device
        from kubernetriks_tpu_torch.batched.state import clone_state

        if device is not None and resolve_device(device) != sim.device:
            raise ValueError(f"PPOTrainer(device={device}) on a sim built on {sim.device}")
        refuse = [
            (sim.pod_window is not None, f"a sliding pod window (pod_window={sim.pod_window})"),
            (sim.lane_async, "lane clocks (lane_async=True)"),
            (sim.next_window_idx != 0, f"a sim already stepped to window {sim.next_window_idx}"),
        ]
        for bad, what in refuse:
            if bad:
                raise ValueError(
                    f"PPOTrainer: the rollout replays the build state from window 0 over the whole slab; it "
                    f"cannot run on {what}. Build the sim whole-resident, without lane clocks, and do not step it."
                )
        self.sim = sim
        self.config = config
        self.device = sim.device
        self.windows = int(windows_per_rollout)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.policy_kind = policy_kind
        if policy_kind == "attention":
            from kubernetriks_tpu_torch.rl.attention_policy import attention_policy_apply, init_attention_policy

            self.policy = None
            self.params = init_attention_policy(hidden=hidden, generator=self.generator, device=self.device)
            self.policy_apply = attention_policy_apply
        elif policy_kind == "mlp":
            from kubernetriks_tpu_torch.rl.policy import init_policy, mlp_apply

            self.policy, self.params = init_policy(
                sim.n_nodes, hidden=hidden, generator=self.generator, device=self.device
            )
            self.policy_apply = mlp_apply(self.policy)
        else:
            raise ValueError(f"policy_kind {policy_kind!r}: one of 'mlp', 'attention'")
        self.opt_state = adam_init(self.params)
        self.initial_state = clone_state(sim.state)
        self.plans = sim.initial_window_plans(self.windows)

    def _payload(self):
        return {"params": self.params, "opt_state": self.opt_state, "rng": self.generator.get_state()}

    def save_checkpoint(self, path: str) -> None:
        """Persist the params, the Adam state and the generator's state
        (checkpoint.ckpt_save); the simulation side is re-derived from the
        sim (save it with BatchedSimulation.save_checkpoint where needed)."""
        from kubernetriks_tpu_torch.checkpoint import ckpt_save

        ckpt_save(path, self._payload())

    def load_checkpoint(self, path: str) -> None:
        from kubernetriks_tpu_torch.checkpoint import ckpt_restore

        restored = ckpt_restore(path, self._payload())
        self.params = restored["params"]
        self.opt_state = restored["opt_state"]
        self.generator.set_state(restored["rng"])

    def collect(self, greedy: bool = False, gumbel: Optional[torch.Tensor] = None):
        """(final state, transitions flattened to (W*K, C, ...)) of one
        rollout from the build state; `gumbel`: the rollout's noise in
        place of the generator's draw."""
        final_state, transitions = rollout(
            self.sim, self.initial_state, self.plans, self.params, self.policy_apply,
            generator=self.generator, gumbel=gumbel, greedy=greedy,
            reward_size_weighted=self.config.reward_size_weighted,
            shaping_coef=self.config.shaping_coef, shaping_gamma=self.config.gamma,
        )
        flat = Transition(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in transitions))
        return final_state, flat

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None) -> Dict[str, float]:
        final_state, flat = self.collect(gumbel=gumbel)
        bootstrap = final_state_value(final_state, self.policy_apply, self.params)
        advantages, returns = compute_gae(
            flat.reward, flat.value, flat.valid, self.config.gamma, self.config.gae_lambda,
            bootstrap_value=bootstrap,
        )
        aux = {}
        for _ in range(self.config.epochs_per_iteration):
            self.params, self.opt_state, _, aux = ppo_update(
                self.params, self.opt_state, self.policy_apply, flat, advantages, returns, self.config
            )
        mask = flat.valid.to(torch.float32)
        decisions = float(mask.sum())
        result = {k: float(v) for k, v in aux.items()}
        result["mean_reward"] = float((flat.reward * mask).sum()) / max(decisions, 1.0)
        result["decisions"] = int(decisions)
        result["placements"] = int(
            final_state.metrics.scheduling_decisions.sum() - self.initial_state.metrics.scheduling_decisions.sum()
        )
        return result

    def train(self, iterations: int):
        return [self.train_iteration() for _ in range(iterations)]
