"""Synthetic Cosmos-shaped data (the port's copy of `data/synthetic.py`).

Latents shaped like Cosmos CV4x8x8 outputs (float, roughly unit scale),
made with numpy: row idx of a dataset seeded `seed` draws from
`default_rng(seed·1_000_003 + idx)`, so the port and the JAX package see
the same rows. With `t_choices` (variable-length clips) row idx has
t_choices[idx mod len] frames (`data/synthetic.py:26-60`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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
                 seed: int = 0, dtype=np.float32,
                 t_choices: Tuple[int, ...] = ()):
        self.num_rows = num_rows
        self.latent_shape = tuple(latent_shape)
        self.seed = seed
        self.dtype = dtype
        # variable-length mode: row idx takes t_choices[idx mod len] frames
        self.t_choices = tuple(t_choices)

    def __len__(self) -> int:
        return self.num_rows

    def latent_shapes(self) -> List[Tuple[int, ...]]:
        """The latent shapes this dataset emits, with multiplicity
        (t_choices=(5, 5, 9) emits shape-5 rows twice as often): what the
        coordinated bucketing schedule weights its draws by."""
        if not self.t_choices:
            return [self.latent_shape]
        c, _, h, w = self.latent_shape
        return [(c, t, h, w) for t in self.t_choices]

    def __getitem__(self, idx: int) -> Dict:
        if not 0 <= idx < self.num_rows:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        shape = self.latent_shape
        if self.t_choices:
            c, _, h, w = shape
            shape = (c, self.t_choices[idx % len(self.t_choices)], h, w)
        latent = rng.standard_normal(shape).astype(self.dtype)
        return {"latent": latent,
                "caption": _CAPTION_VOCAB[idx % len(_CAPTION_VOCAB)]}


def synthetic_context(rng: np.random.Generator, batch: int, tokens: int,
                      dim: int, dtype=np.float32) -> np.ndarray:
    """Stand-in for T5 embeddings: 0.05·N(0, 1) [batch, tokens, dim]."""
    return (rng.standard_normal((batch, tokens, dim)) * 0.05).astype(dtype)
