"""Attention over a cluster's node axis: the single-device form and the
sequence-parallel ring.

Port of the JAX package's `parallel/ring.py`. `full_attention` (its line
54) is the plain einsum form with the reference's finite mask value:
masked scores are -1e30, not -inf, so exp() and max() stay NaN-free and a
query with no valid key returns 0. `F.scaled_dot_product_attention`
returns NaN on such a row, so it is not a drop-in.

`ring_attention` (its line 77) is the sequence-parallel form: each rank of
a process group holds its block of the node axis; K, V and the mask rotate
around the ring once (torch.distributed.batch_isend_irecv, rank j sending
to j + 1), and every rank folds each incoming block into the online
softmax (the flash-attention accumulation), so the full N x N attention is
computed with O(N / s) memory a rank and neighbour-to-neighbour traffic
alone. The rotation is differentiable: its backward sends the gradients
the other way round, so training through it is the same optimisation
problem. The reference computes both outside any Pallas kernel; so does
the port (plain PyTorch with explicit point-to-point calls).
"""

from __future__ import annotations

from typing import Optional

import torch

# Finite "minus infinity" for masked scores (reference ring.py:31).
_NEG = -1e30


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax(q k^T / sqrt(d)) v over the full axis. kv_mask marks
    valid keys, broadcastable to (..., 1, nk); queries with no valid key
    return 0."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    s = torch.matmul(q, k.transpose(-1, -2)) * scale  # the float32 scale, as jnp.float32(scale)
    valid = kv_mask[..., None, :]
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v)
    return out / torch.clamp(l, min=1e-30)


def _accumulate_block(q, k, v, kv_mask, o, m, l, scale):
    """Fold one K/V block into the online-softmax accumulators (reference
    ring.py:34): o (..., nq, dv) the unnormalised output, m (..., nq) the
    running max, l (..., nq) the running denominator."""
    valid = kv_mask[..., None, :]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = torch.where(valid, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # A fully masked block leaves m_new == _NEG and would give exp(0) == 1
    # a masked element: zero them.
    p = torch.where(valid, p, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.matmul(p, v)
    return o_new, m_new, l_new


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """x sent `step` ranks on around the ring of `group` (rank j sends to j
    + step and receives from j - step), by batch_isend_irecv. gloo sends
    host tensors only, so on a gloo group a CUDA block goes through a host
    copy each way (a blocking read: the gloo path is the CPU's and the
    tests'); NCCL sends it as it is."""
    import torch.distributed as dist

    size, rank = dist.get_world_size(group), dist.get_rank(group)
    send_to = dist.get_global_rank(group, (rank + step) % size)
    recv_from = dist.get_global_rank(group, (rank - step) % size)
    staged = x.device.type != "cpu" and dist.get_backend(group) != "nccl"
    buf = (x.cpu() if staged else x).contiguous()
    out = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, send_to, group),
        dist.P2POp(dist.irecv, out, recv_from, group),
    ])
    for req in reqs:
        req.wait()
    return out.to(x.device) if staged else out


class _RingShift(torch.autograd.Function):
    """One step around the ring; the gradient goes one step back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    group=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sequence-parallel attention over the ranks of `group` (None: the
    default group), the node axis sharded in rank order. Each rank passes
    its own blocks: q, k, v (..., n_shard, d), kv_mask broadcastable to
    (..., 1, n_shard) marking its valid keys; it gets its queries' attention over every
    rank's keys. The K, V and mask blocks rotate once around the ring;
    rank j folds its own block first, then j - 1's, j - 2's, ... (the
    reference's ppermute order). Equals `full_attention` on the gathered
    axis up to float32 reassociation; a query with no valid key anywhere
    returns 0. Every rank of the group must call it."""
    import torch.distributed as dist

    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if group is None:
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), torch.promote_types(v.dtype, torch.float32))
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=dt, device=q.device)
    m = torch.full(q.shape[:-1], _NEG, dtype=dt, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=dt, device=q.device)
    msk = kv_mask.to(torch.uint8)
    for step in range(size):
        o, m, l = _accumulate_block(q, k, v, msk.bool(), o, m, l, scale)
        if step + 1 < size:
            k = _RingShift.apply(k, group)
            v = _RingShift.apply(v, group)
            msk = _shift(msk, group, 1)
    return o / torch.clamp(l[..., None], min=1e-30)
