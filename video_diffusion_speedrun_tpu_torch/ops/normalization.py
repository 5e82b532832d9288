"""RMSNorm in fp32 whatever the input dtype (port of `ops/normalization.py`)."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """Mean of squares over the last dim, optional trainable scale, result
    cast back to the input dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        out = out * scale.float()
    return out.to(x.dtype)
