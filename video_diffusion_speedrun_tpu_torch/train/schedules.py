"""LR schedule multipliers λ(step) (port of `train/schedules.py`).

Warmup is a linear ramp over `warmup_steps`; "constant" is linear decay to
a 1e10 horizon (the reference's quirk). The optimizer evaluates λ at the
step count taken before its increment, as the JAX `fused_apply` does
(`lr_t = schedule_fn(state.count)`). Values are Python floats.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def linear_with_warmup(warmup_steps: int, total_steps: float) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        return max(0.0, (total_steps - step)
                   / max(1.0, total_steps - warmup_steps))

    return schedule


def cosine_with_warmup(warmup_steps: int, total_steps: int,
                       num_cycles: float = 0.5) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0
                                              * progress)))

    return schedule


def constant_with_warmup(warmup_steps: int) -> Schedule:
    return linear_with_warmup(warmup_steps, 10_000_000_000)


def get_schedule(name: str, warmup_steps: int, total_steps: int) -> Schedule:
    if name == "linear":
        return linear_with_warmup(warmup_steps, total_steps)
    if name == "cosine":
        return cosine_with_warmup(warmup_steps, total_steps)
    if name == "constant":
        return constant_with_warmup(warmup_steps)
    raise ValueError(f"unknown lr scheduler type: {name}")
