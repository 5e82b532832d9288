"""torch.save'd rows of the dataset (port of `data/serialization.py`).

The dataset stores every latent as the bytes of `torch.save`. The JAX
package parses them without torch (a restricted unpickler and a C++
parser), because it may not import torch; the port reads them with
`torch.load(weights_only=True)`, whose unpickler admits tensors and plain
containers only. `load_tensor` keeps the JAX refusal of anything but one
plain tensor.
"""

from __future__ import annotations

import io
from typing import Any

import torch


def load_object(blob: bytes) -> Any:
    """torch.save bytes → tensors in plain containers, on the CPU."""
    return torch.load(io.BytesIO(blob), weights_only=True,
                      map_location="cpu")


def load_tensor(blob: bytes) -> torch.Tensor:
    """torch.save bytes of one tensor → that tensor (contiguous, on the
    CPU); raises ValueError for anything else."""
    obj = load_object(blob)
    if not isinstance(obj, torch.Tensor):
        raise ValueError(f"expected a single tensor, got {type(obj)}")
    return obj.contiguous()
