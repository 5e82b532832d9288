"""Polynomial Φ for the MLP's GELU (port of `ops/fused_gelu.py:47-74`).

Only the forward polynomial is ported: on the sampling path the MLP computes
gelu(h) = h·Φ_poly(h) in plain torch after the fc1 product, as the JAX model
does in plain JAX (`models/dit.py:372-385`). The bias+GELU kernel and its
backward come with the training slice.
"""

from __future__ import annotations

import torch

# odd fit of Φ(x)-1/2 on |x| ≤ _POLY_R, saturated to 0/1 outside
_POLY_R = 4.2
_PHI_C = (1.6730854313132952, -4.819356366004858, 11.665324048457048,
          -19.2571592112833, 20.043393683968894, -11.692634553213583,
          2.887810706082727)


def _odd_poly(coeffs, t: torch.Tensor) -> torch.Tensor:
    t2 = t * t
    acc = t2 * coeffs[-1] + coeffs[-2]
    for c in reversed(coeffs[:-2]):
        acc = acc * t2 + c
    return acc * t


def _phi_poly(x: torch.Tensor) -> torch.Tensor:
    """Φ(x) = 0.5 + odd-poly(x/R) on |x| < R, exactly 0 / 1 beyond. The
    selects discard the diverging polynomial outside; NaN propagates."""
    t = x * (1.0 / _POLY_R)
    phi = 0.5 + _odd_poly(_PHI_C, t)
    return torch.where(x <= -_POLY_R, 0.0, torch.where(x >= _POLY_R, 1.0, phi))
