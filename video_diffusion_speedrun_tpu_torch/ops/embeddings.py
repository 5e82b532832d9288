"""Sinusoidal timestep embedding (port of `ops/embeddings.py`)."""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """[B] float timesteps → [B, dim] fp32 embedding (cos ‖ sin)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
