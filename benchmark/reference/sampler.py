"""The plain reference of the Euler sampler with classifier-free guidance.

Rectified flow integrated from t = 1 to 0 in N Euler steps on the
α-shifted grid t_i = s(i/N), i = N…1, s(t) = tα/(1 + (α − 1)t); each step
x ← x + (t_i − t_{i−1})·v with the guided velocity v = u + w·(c − u) of the
conditional c and the unconditional u (zero context) predictions; the
accumulator x is float32.
"""

from __future__ import annotations

from typing import List

import torch


def shift(t: float, alpha: float) -> float:
    return t * alpha / (1 + (alpha - 1) * t)


def grid(steps: int, alpha: float):
    """(t_i, dt_i) of the N steps, first to last, rounded to float32."""
    ts, dts = [], []
    for i in range(steps, 0, -1):
        t, t_next = shift(i / steps, alpha), shift((i - 1) / steps, alpha)
        ts.append(float(torch.tensor(t, dtype=torch.float32)))
        dts.append(float(torch.tensor(t - t_next, dtype=torch.float32)))
    return ts, dts


def guided(out2: torch.Tensor, scale: float) -> torch.Tensor:
    """v = u + w·(c − u) of a batch [c; u] of predictions, in float32."""
    c, u = out2.float().chunk(2)
    return u + scale * (c - u)


def integrate(start: torch.Tensor, outs: List[torch.Tensor], steps: int,
              alpha: float, scale: float,
              acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The end of the trajectory from `start` given each step's
    predictions [c; u] (`outs`, first to last), accumulated in
    `acc_dtype`."""
    _, dts = grid(steps, alpha)
    acc = start.float().to(acc_dtype)
    for dt, out2 in zip(dts, outs):
        acc = (acc.float() + dt * guided(out2, scale)).to(acc_dtype)
    return acc.float()
