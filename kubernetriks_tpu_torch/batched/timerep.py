"""Window-indexed time pairs: ``t = win * interval + off``.

Simulation time on the device is a pair (win: int32, off: float32) with
off in [0, interval): the window index is exact and the offset is bounded,
so no 64-bit array enters the hot loop. Infinity ("no pending effect") is
win >= INF_WIN with off = 0, so arithmetic never produces NaN.

Arithmetic rule of this port: every division takes a float32 TENSOR as its
divisor (`interval` below is a 0-dim float32 tensor on the state's
device). PyTorch's CUDA division by a Python scalar multiplies by the
scalar's reciprocal, which can differ from IEEE division in the last bit;
dividing by a tensor is IEEE division on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# "+infinity" window index: INF_WIN + INF_WIN + slack still fits int32.
INF_WIN = 1 << 29


class TPair(NamedTuple):
    """A batch of simulation times: (win * interval + off) seconds."""

    win: torch.Tensor  # int32 window index; >= INF_WIN means +inf
    off: torch.Tensor  # float32 offset in [0, interval); 0 where +inf


def t_full(shape, win: int, off: float, device) -> TPair:
    return TPair(
        win=torch.full(shape, win, dtype=torch.int32, device=device),
        off=torch.full(shape, off, dtype=torch.float32, device=device),
    )


def t_inf(shape, device) -> TPair:
    return t_full(shape, INF_WIN, 0.0, device)


def t_zeros(shape, device) -> TPair:
    return t_full(shape, 0, 0.0, device)


def t_lt(a: TPair, b: TPair) -> torch.Tensor:
    return (a.win < b.win) | ((a.win == b.win) & (a.off < b.off))


def t_le(a: TPair, b: TPair) -> torch.Tensor:
    return (a.win < b.win) | ((a.win == b.win) & (a.off <= b.off))


def t_min(a: TPair, b: TPair) -> TPair:
    take_b = t_lt(b, a)
    return TPair(
        win=torch.where(take_b, b.win, a.win),
        off=torch.where(take_b, b.off, a.off),
    )


def t_where(mask: torch.Tensor, a: TPair, b: TPair) -> TPair:
    return TPair(win=torch.where(mask, a.win, b.win), off=torch.where(mask, a.off, b.off))


def t_norm(win: torch.Tensor, off: torch.Tensor, interval: torch.Tensor) -> TPair:
    """Renormalize an unnormalized pair (off may be >= interval, any finite
    value >= 0) back to off in [0, interval). `interval` is a 0-dim
    float32 tensor (see the module note on division)."""
    off = off.to(torch.float32)
    q = torch.floor(off / interval)
    return TPair(
        win=(win + q.to(torch.int32)).to(torch.int32),
        off=(off - q * interval).to(torch.float32),
    )


def t_add(a: TPair, b: TPair, interval: torch.Tensor) -> TPair:
    """a + b. Offsets sum to < 2*interval, so one carry normalizes."""
    return t_norm(a.win + b.win, a.off + b.off, interval)


def to_f64(win: np.ndarray, off: np.ndarray, interval: float) -> np.ndarray:
    """Host-side absolute seconds (numpy float64); +inf where infinite."""
    win = np.asarray(win, np.int64)
    t = win * float(interval) + np.asarray(off, np.float64)
    return np.where(win >= INF_WIN, np.inf, t)


def from_f64_np(t: np.ndarray, interval: float):
    """Host-side split of absolute float64 seconds into (win, off) numpy
    arrays. +inf maps to (INF_WIN, 0). Computed in float64, so win is exact
    and off carries only the final float32 rounding; an offset that rounds
    up to exactly `interval` is clamped to the largest float32 below it
    (a carry would move the time into the next window)."""
    t = np.asarray(t, np.float64)
    finite = np.isfinite(t)
    win = np.where(finite, np.floor(t / interval), INF_WIN).astype(np.int64)
    off = np.where(finite, t - win * float(interval), 0.0)
    over = finite & (off >= interval)
    win = np.where(over, win + 1, win)
    off = np.where(over, off - interval, off)
    off32 = off.astype(np.float32)
    off32 = np.minimum(
        off32, np.nextafter(np.float32(interval), np.float32(0.0))
    ).astype(np.float32)
    return win.astype(np.int32), off32


def fma_f32(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add: the product
    is exact in float64 and the sum is rounded to float64 and then to
    float32; where that double rounding could differ (the float64 sum is
    exactly halfway between two float32 values and not exact), the exact
    error of the sum (TwoSum) picks the float32 neighbour. Finite
    operands."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    tie = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    r64 = r.to(torch.float64)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    fixed = torch.where(err > 0, torch.where(r64 < s, up, r), torch.where(r64 > s, down, r))
    return torch.where(tie & (err != 0), fixed, r)
