"""Scheduler policy network: per-pod node logits from masked node features.

Port of the JAX package's `rl/policy.py`. The head replaces the
KubeScheduler score pass: for each pending pod it scores every node of its
cluster with one shared MLP (permutation-equivariant over nodes), and a
value head reads the mean-pooled node embeddings. The layout is the flax
module's: `layers` x (Linear, ReLU), a logit Linear, and two value
Linears, in that creation order (convert.policy_params_from_flax maps a
flax tree onto it). Float32 throughout.

The trainer drives the layout through `policy_apply(params, obs)`
(mlp_forward over a dict of tensors, the module's parameter names), the
same function form as the attention head's, so PPO treats both heads
alike.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Per-node feature vector layout (rl/env.featurize):
# [alive, fits, alloc_cpu_frac, alloc_ram_frac, req_cpu_over_cap, req_ram_over_cap]
NODE_FEATURES = 6

# flax's lecun_normal: a normal truncated to [-2, 2] std, rescaled so the
# truncated draw has variance 1 / fan_in (jax.nn.initializers
# variance_scaling's constant).
_TRUNC_STD = 0.87962566103423978


class SchedulerPolicy(nn.Module):
    """Maps (..., N, F) node features -> ((..., N) logits, (...,) value)."""

    def __init__(self, hidden: int = 64, layers: int = 2, features: int = NODE_FEATURES) -> None:
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        self.trunk = nn.ModuleList(
            nn.Linear(features if i == 0 else hidden, hidden) for i in range(layers)
        )
        self.logit = nn.Linear(hidden, 1)
        self.value1 = nn.Linear(hidden, hidden)
        self.value2 = nn.Linear(hidden, 1)

    def forward(self, node_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mlp_forward(dict(self.named_parameters()), node_features, self.layers)


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SchedulerPolicy's forward over a dict of its parameters (the
    module's names): the trunk, the logits, the value of the mean-pooled
    embeddings."""

    def dense(name, v):
        return F.linear(v, params[f"{name}.weight"], params[f"{name}.bias"])

    for i in range(layers):
        x = torch.relu(dense(f"trunk.{i}", x))
    logits = dense("logit", x)[..., 0]
    v = torch.relu(dense("value1", x.mean(dim=-2)))
    return logits, dense("value2", v)[..., 0]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax Dense's default kernel init on a (out, in) weight, drawn on
    the generator's device and copied in."""
    fan_out, fan_in = weight.shape
    draw = torch.empty((fan_out, fan_in), dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(draw, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    with torch.no_grad():
        weight.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


def init_policy(
    n_nodes: int,
    hidden: int = 64,
    layers: int = 2,
    generator: torch.Generator = None,
    device=None,
) -> Tuple[SchedulerPolicy, Dict[str, torch.Tensor]]:
    """(module, params): lecun-normal kernels and zero biases drawn from
    `generator` (a fresh one seeded 0 where None), on `device` (None: the
    card; see engine.resolve_device). `n_nodes` is the reference's
    signature; the weights do not depend on it."""
    from kubernetriks_tpu_torch.batched.engine import resolve_device

    del n_nodes
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    policy = SchedulerPolicy(hidden=hidden, layers=layers)
    for module in policy.modules():
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, generator)
            nn.init.zeros_(module.bias)
    policy = policy.to(resolve_device(device))
    return policy, policy_params(policy)


def policy_params(policy: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters as a dict of detached tensors (the form
    policy_apply and the optimizer take)."""
    return {name: p.detach().clone() for name, p in policy.named_parameters()}


def mlp_apply(policy: SchedulerPolicy):
    """policy_apply(params, obs) for `policy`'s layout over a params dict."""

    def apply(params, obs):
        return mlp_forward(params, obs, policy.layers)

    return apply
