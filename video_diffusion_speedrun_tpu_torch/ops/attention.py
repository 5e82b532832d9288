"""Plain attention composition (port of `ops/attention.py`).

The unfused path of the model (`attention_impl="plain"`) and the reference
the fused kernels are checked against. The hot path is ops/fused_attention.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          kbias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[B, H, Lq, D] x [B, H, Lk, D] x [B, H, Lk, D] → [B, H, Lq, D].

    scale = D^-0.5; logits and the softmax in fp32, probabilities cast to
    v's dtype before the PV product, which accumulates in fp32. `kbias`
    [Lk] fp32 joins the scaled logits (the context-parallel padding's
    −1e30, `ops/fused_attention.py:ring_kbias`); None: no mask."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kbias is not None:
        logits = logits + kbias
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
