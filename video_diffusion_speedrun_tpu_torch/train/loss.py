"""Rectified-flow loss helpers (port of `train/loss.py`).

Only `time_shift` is ported; the sampler needs it. The loss itself comes
with the training slice.
"""

from __future__ import annotations


def time_shift(t, alpha: float):
    """t ← tα/(1+(α−1)t): shifts the sampling density toward noise."""
    return t * alpha / (1 + (alpha - 1) * t)
