"""Attention-based scheduler policy: a self-attention block over the node axis.

Port of the JAX package's `rl/attention_policy.py`. Same seam as the MLP
head (per pending pod, node logits over the cluster's nodes plus a pooled
value), but each node's logit can condition on the whole cluster's
occupancy. Pure functions over an explicit parameter dict with the
reference's names and its `(in, out)` layout (`x @ W`), so
convert.attention_params_from_jax carries a JAX tree across as it is, and
`attention_policy_apply` is a `policy_apply` for
`PPOTrainer(policy_kind="attention")`. Float32 throughout; the attention
is parallel/ring.full_attention.

`make_sharded_apply` (the tensor- and sequence-parallel forward over a
mesh) belongs to the multi-GPU port (ROADMAP Queue 1 item 15) and raises
until then.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from kubernetriks_tpu_torch.parallel.ring import full_attention
from kubernetriks_tpu_torch.rl.policy import NODE_FEATURES

PARAM_NAMES = (
    "embed_w", "embed_b", "q_w", "k_w", "v_w", "proj_w", "proj_b",
    "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "logit_w", "logit_b",
    "val1_w", "val1_b", "val2_w", "val2_b",
)


def init_attention_policy(
    hidden: int = 64,
    heads: int = 4,
    ffn_mult: int = 2,
    features: int = NODE_FEATURES,
    generator: torch.Generator = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """He-initialized parameter dict (normal x sqrt(2 / fan_in), zero
    biases), drawn from `generator` (a fresh one seeded 0 where None) on
    its device, then moved to `device` (None: the card)."""
    from kubernetriks_tpu_torch.batched.engine import resolve_device

    if hidden % heads:
        raise ValueError(f"hidden={hidden} must divide by heads={heads}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = resolve_device(device)
    ffn = ffn_mult * hidden

    def dense(fan_in, fan_out):
        w = torch.randn((fan_in, fan_out), dtype=torch.float32, generator=generator, device=generator.device)
        return (w * math.sqrt(2.0 / fan_in)).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "embed_w": dense(features, hidden),
        "embed_b": zeros(hidden),
        "q_w": dense(hidden, hidden),
        "k_w": dense(hidden, hidden),
        "v_w": dense(hidden, hidden),
        "proj_w": dense(hidden, hidden),
        "proj_b": zeros(hidden),
        "ffn1_w": dense(hidden, ffn),
        "ffn1_b": zeros(ffn),
        "ffn2_w": dense(ffn, hidden),
        "ffn2_b": zeros(hidden),
        "logit_w": dense(hidden, 1),
        "logit_b": zeros(1),
        "val1_w": dense(hidden, hidden),
        "val1_b": zeros(hidden),
        "val2_w": dense(hidden, 1),
        "val2_b": zeros(1),
    }


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., N, H*dh) -> (..., H, N, dh)."""
    *lead, n, d = x.shape
    return x.reshape(*lead, n, heads, d // heads).movedim(-2, -3)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, N, dh) -> (..., N, H*dh)."""
    x = x.movedim(-3, -2)
    *lead, n, h, dh = x.shape
    return x.reshape(*lead, n, h * dh)


def attention_policy_apply(params, feats: torch.Tensor, heads: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, F) node features -> ((..., N) logits, (...,) value)
    (reference attention_policy.py:89-124: the trunk, the FFN, the heads)."""
    alive = feats[..., 0] > 0
    x = torch.relu(feats @ params["embed_w"] + params["embed_b"])
    qh = _heads(x @ params["q_w"], heads)
    kh = _heads(x @ params["k_w"], heads)
    vh = _heads(x @ params["v_w"], heads)
    attn = _unheads(full_attention(qh, kh, vh, alive[..., None, :]))
    x = x + attn @ params["proj_w"] + params["proj_b"]
    h = torch.relu(x @ params["ffn1_w"] + params["ffn1_b"])
    x = x + h @ params["ffn2_w"] + params["ffn2_b"]
    x = torch.where(alive[..., None], x, 0.0)
    logits = (x @ params["logit_w"] + params["logit_b"])[..., 0]
    count = torch.clamp(alive.sum(dim=-1, keepdim=True).to(torch.float32), min=1.0)
    pooled = x.sum(dim=-2) / count
    v = torch.relu(pooled @ params["val1_w"] + params["val1_b"])
    value = (v @ params["val2_w"] + params["val2_b"])[..., 0]
    return logits, value


def make_sharded_apply(*args, **kwargs):
    """The mesh-sharded forward (reference attention_policy.py:127): not
    ported yet, ROADMAP Queue 1 item 15 (multi-GPU)."""
    raise NotImplementedError(
        "make_sharded_apply is not ported: it needs the multi-GPU port (ROADMAP Queue 1 item 15); "
        "attention_policy_apply is the single-device forward"
    )
