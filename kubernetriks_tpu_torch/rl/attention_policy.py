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

`make_sharded_apply(mesh, ...)` is the forward over a (data, seq, model)
DeviceMesh of a torch.distributed group: clusters data-parallel, the node
axis sequence-parallel through ring attention (parallel/ring.py), and the
FFN's hidden dimension tensor-parallel in the Megatron manner (column-split
W1, row-split W2, one all-reduce over the model axis). Its collectives are
autograd-aware, so gradients through it equal the plain forward's: training
through it is the same optimisation problem (reference
tests/test_parallel.py).
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


def _trunk(params, feats: torch.Tensor, attn_fn, heads: int):
    """The forward up to the per-node embeddings (reference
    `_trunk_local`, attention_policy.py:89): attn_fn is the full or the
    ring attention over (..., H, N, dh) blocks."""
    alive = feats[..., 0] > 0
    x = torch.relu(feats @ params["embed_w"] + params["embed_b"])
    qh = _heads(x @ params["q_w"], heads)
    kh = _heads(x @ params["k_w"], heads)
    vh = _heads(x @ params["v_w"], heads)
    attn = _unheads(attn_fn(qh, kh, vh, alive[..., None, :]))
    x = x + attn @ params["proj_w"] + params["proj_b"]
    return x, alive


def attention_policy_apply(params, feats: torch.Tensor, heads: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, F) node features -> ((..., N) logits, (...,) value)
    (reference attention_policy.py:89-124: the trunk, the FFN, the heads)."""
    x, alive = _trunk(params, feats, full_attention, heads)
    h = torch.relu(x @ params["ffn1_w"] + params["ffn1_b"])
    x = x + h @ params["ffn2_w"] + params["ffn2_b"]
    x = torch.where(alive[..., None], x, 0.0)
    logits = (x @ params["logit_w"] + params["logit_b"])[..., 0]
    count = torch.clamp(alive.sum(dim=-1, keepdim=True).to(torch.float32), min=1.0)
    pooled = x.sum(dim=-2) / count
    v = torch.relu(pooled @ params["val1_w"] + params["val1_b"])
    value = (v @ params["val2_w"] + params["val2_b"])[..., 0]
    return logits, value


class _SumGrads(torch.autograd.Function):
    """Identity forward; backward all-reduces the gradient (sum) over the
    group: a parameter replicated on every rank collects every rank's
    share of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherBlocks(torch.autograd.Function):
    """Forward: every rank's block of `group` concatenated along `dim` in
    rank order. Backward: this rank's slice of the output's gradient,
    divided by `share`. Every rank of the mesh computes the same loss on
    the gathered outputs, so each holds the whole gradient; a block
    computed alike on `share` ranks (replicated over the model axis, the
    value also over the sequence axis) takes 1/share of it there, and the
    parameters' all-reduce (_SumGrads) adds the shares back up."""

    @staticmethod
    def forward(ctx, x, group, dim, share):
        import torch.distributed as dist

        ctx.group, ctx.dim, ctx.share = group, dim, share
        ctx.n = x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        lo = dist.get_rank(ctx.group) * ctx.n
        return grad.narrow(ctx.dim, lo, ctx.n) / ctx.share, None, None, None


def make_sharded_apply(
    mesh,
    heads: int = 4,
    data_axis: str = "data",
    seq_axis: str = "seq",
    model_axis: str = "model",
):
    """apply(params, feats) for feats (C, N, F) over a 3-D DeviceMesh with
    axes (data_axis, seq_axis, model_axis) (reference
    attention_policy.py:127-194): every rank passes the same whole params
    and feats and gets the whole ((C, N) logits, (C,) value); it computes
    clusters [C/d block] of its data coordinate, nodes [N/s block] of its
    sequence coordinate (ring attention over the sequence axis) and FFN
    hidden units [block] of its model coordinate (W1 and b1 column-split,
    W2 row-split; one all-reduce over the model axis restores the
    activation). The pooled value's sums and counts are all-reduced over
    the sequence axis. Every rank of the mesh must call it. Gradients:
    torch.autograd on any rank gives the plain forward's gradient of a loss
    of the outputs (the all-reduces are torch.distributed.nn's, and each
    parameter's gradient is summed over the mesh). C, N and the FFN's
    hidden dimension must divide by the axes' sizes."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    from kubernetriks_tpu_torch.parallel.ring import ring_attention

    g_data, g_seq, g_model = (mesh.get_group(a) for a in (data_axis, seq_axis, model_axis))
    d, s, m = (dist.get_world_size(g) for g in (g_data, g_seq, g_model))
    di, si, mi = (dist.get_rank(g) for g in (g_data, g_seq, g_model))
    # The parameters' gradients are summed over the whole mesh.
    whole = None if mesh.size() == dist.get_world_size() else dist.new_group(ranks=mesh.mesh.flatten().tolist())

    def block(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
        n = x.shape[dim]
        if n % parts:
            raise ValueError(f"make_sharded_apply: axis of {n} does not divide over {parts} ranks")
        return x.narrow(dim, index * (n // parts), n // parts)

    def apply(params, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        p = {k: _SumGrads.apply(v, whole) for k, v in params.items()}
        # The model axis's column and row blocks of the FFN.
        p["ffn1_w"] = block(p["ffn1_w"], 1, m, mi)
        p["ffn1_b"] = block(p["ffn1_b"], 0, m, mi)
        p["ffn2_w"] = block(p["ffn2_w"], 0, m, mi)
        local = block(block(feats, 0, d, di), 1, s, si)

        def ring(qh, kh, vh, mask):
            return ring_attention(qh, kh, vh, mask, g_seq)

        x, alive = _trunk(p, local, ring, heads)
        h = torch.relu(x @ p["ffn1_w"] + p["ffn1_b"])
        y = all_reduce(h @ p["ffn2_w"], group=g_model)
        x = x + y + p["ffn2_b"]
        # Heads: the logits stay node-sharded; the pooled value needs the
        # masked mean over every node, so the local sums and counts are
        # all-reduced over the sequence axis.
        x = torch.where(alive[..., None], x, 0.0)
        logits = (x @ p["logit_w"] + p["logit_b"])[..., 0]
        count = alive.sum(dim=-1, keepdim=True).to(torch.float32)
        dist.all_reduce(count, group=g_seq)
        pooled = all_reduce(x.sum(dim=-2), group=g_seq) / torch.clamp(count, min=1.0)
        v = torch.relu(pooled @ p["val1_w"] + p["val1_b"])
        value = (v @ p["val2_w"] + p["val2_b"])[..., 0]
        logits = _GatherBlocks.apply(_GatherBlocks.apply(logits, g_seq, 1, 1), g_data, 0, m)
        value = _GatherBlocks.apply(value, g_data, 0, s * m)
        return logits, value

    return apply
