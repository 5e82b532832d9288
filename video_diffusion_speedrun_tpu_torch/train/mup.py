"""muP per-parameter learning rate and weight decay (port of `train/mup.py`).

The four rules of the JAX `_leaf_rule` (`train/mup.py:35-65`), in the same
order, over the port's `named_parameters()` names:

1. name contains "bias", "norm" or "lambda" → lr × no_decay_lr_mult, wd 0;
2. otherwise lr × base_width/dim, wd × dim/wd_width, with dim the fan-in.
   A torch weight is [out, in] (Conv3d [out, in, kt, kh, kw]), so the
   fan-in of a Linear weight is shape[-1]; the JAX tree stores [in, out]
   and reads shape[-2]. Every other leaf uses shape[-1] in both;
3. a constant-class name ("patch_proj", "context_kv",
   "positional_embedding") → lr × no_decay_lr_mult, wd 0, overriding 1–2
   (so the Conv3d patch weight, whose shape[-1] is a kernel size, never
   reaches rule 2's value);
4. "time" or "modulation" in the name → lr × time_modulation_lr_mult; the
   wd of rules 1–2 stays.

The port's names differ from the JAX tree's (`mlp.0.weight` for
`mlp.fc1.weight`, `norm1.weight` for `norm1.scale`) but hit the same rules.
The shapes are the global ones: a sharded parameter is a DTensor, whose
`shape` is the whole tensor's (a row-parallel kernel's local shard is
[D, D/t], and its fan-in is D, not D/t).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.core.config import OptimizerConfig

NO_DECAY_SUBSTRINGS = ("bias", "norm", "lambda")


def leaf_rule(name: str, shape: Tuple[int, ...], learning_rate: float,
              weight_decay: float, cfg: OptimizerConfig
              ) -> Tuple[float, float]:
    """(absolute lr, wd) of one parameter."""
    if any(s in name for s in NO_DECAY_SUBSTRINGS):
        lr = learning_rate * cfg.no_decay_lr_mult
        wd = 0.0
    else:
        dim = shape[-1]
        lr = learning_rate * (cfg.mup_base_width / dim)
        wd = weight_decay * dim / cfg.mup_wd_width

    if any(c in name for c in cfg.constant_param_classes):
        lr = learning_rate * cfg.no_decay_lr_mult
        wd = 0.0

    if "time" in name or "modulation" in name:
        lr = learning_rate * cfg.time_modulation_lr_mult

    return lr, wd


def mup_table(named_params: Iterable[Tuple[str, torch.Tensor]],
              learning_rate: float, weight_decay: float,
              cfg: OptimizerConfig) -> Dict[str, Dict]:
    """name → {"lr", "wd", "shape"}, in the order of `named_params` (the
    JAX `settings` dict)."""
    table = {}
    for name, p in named_params:
        shape = tuple(p.shape)  # a DTensor's global shape
        lr, wd = leaf_rule(name, shape, learning_rate, weight_decay, cfg)
        table[name] = {"lr": lr, "wd": wd, "shape": shape}
    return table
