"""Attention over a cluster's node axis: the single-device form.

Port of the JAX package's `parallel/ring.py` `full_attention` (its line
54), the plain einsum form with the reference's finite mask value: masked
scores are -1e30, not -inf, so exp() and max() stay NaN-free and a query
with no valid key returns 0. `F.scaled_dot_product_attention` returns
NaN on such a row, so it is not a drop-in. The reference computes this
outside any Pallas kernel; so does the port (plain PyTorch).

`ring_attention`, the sequence-parallel form over a mesh axis, belongs to
the multi-GPU port (ROADMAP Queue 1 item 15) and raises until then.
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


def ring_attention(*args, **kwargs):
    """Sequence-parallel attention over a mesh axis (reference ring.py:77):
    not ported yet, ROADMAP Queue 1 item 15 (multi-GPU)."""
    raise NotImplementedError(
        "ring_attention is not ported: it needs the multi-GPU port (ROADMAP Queue 1 item 15); "
        "full_attention is the single-device form"
    )
