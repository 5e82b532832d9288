"""Synthetic Cosmos-shaped data (the port's copy of `data/synthetic.py`).

Latents shaped like Cosmos CV4x8x8 outputs (float, roughly unit scale),
made with numpy: row idx of a dataset seeded `seed` draws from
`default_rng(seed·1_000_003 + idx)`, so the port and the JAX package see
the same rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_CAPTION_VOCAB = (
    "a tranquil mountain range shrouded in fog", "a woman practicing yoga by the ocean",
    "a busy city street at night in the rain", "a golden retriever running on a beach",
    "timelapse of clouds over a desert canyon", "a chef plating a colorful dish",
    "drone shot over a winding forest river", "close-up of raindrops on a window",
)


class SyntheticLatentDataset:
    """Deterministic rows {"latent": [C, T, H, W] float32, "caption": str}."""

    def __init__(self, num_rows: int = 1024,
                 latent_shape: Tuple[int, int, int, int] = (16, 5, 32, 32),
                 seed: int = 0, dtype=np.float32):
        self.num_rows = num_rows
        self.latent_shape = tuple(latent_shape)
        self.seed = seed
        self.dtype = dtype

    def __len__(self) -> int:
        return self.num_rows

    def __getitem__(self, idx: int) -> Dict:
        if not 0 <= idx < self.num_rows:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        latent = rng.standard_normal(self.latent_shape).astype(self.dtype)
        return {"latent": latent,
                "caption": _CAPTION_VOCAB[idx % len(_CAPTION_VOCAB)]}


def synthetic_context(rng: np.random.Generator, batch: int, tokens: int,
                      dim: int, dtype=np.float32) -> np.ndarray:
    """Stand-in for T5 embeddings: 0.05·N(0, 1) [batch, tokens, dim]."""
    return (rng.standard_normal((batch, tokens, dim)) * 0.05).astype(dtype)
