"""The plain reference of the muP-AdamW update and its schedule.

Written from the optimizer's description (the speedrun's muP AdamW, the
JAX package's `train/mup.py`, `train/optim.py` and `train/inloop.py`
rules): a learning rate and weight decay per parameter by its name and
fan-in, a linear schedule with warm-up, bias-corrected AdamW with
decoupled weight decay scaled by the learning rate, and, for the
optimizer-in-backward configuration with factored ν, Adafactor's rank-1
second moment for the large block weights. The arithmetic is float32;
parameters and moments are rounded to the storage dtypes the
configuration states after every update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

NO_DECAY = ("bias", "norm", "lambda")
CONSTANT = ("patch_proj", "context_kv", "positional_embedding")


def lr_wd(name: str, shape, o: Dict):
    """(lr, wd) of one parameter: no-decay names at lr·0.01 and wd 0;
    others lr·base/fan_in and wd·fan_in/wd_width (fan-in the last dim of a
    torch [out, in] weight); constant classes lr·0.01 and wd 0; names with
    "time" or "modulation" at lr·0.1, their wd kept."""
    lr, wd = o["learning_rate"], o["weight_decay"]
    if any(s in name for s in NO_DECAY):
        out = (lr * 0.01, 0.0)
    else:
        fan = shape[-1]
        out = (lr * 32 / fan, wd * fan / 1024)
    if any(s in name for s in CONSTANT):
        out = (lr * 0.01, 0.0)
    if "time" in name or "modulation" in name:
        out = (lr * 0.1, out[1])
    return out


def schedule(o: Dict, count: int) -> float:
    """The linear schedule's multiplier at update `count` (0 first)."""
    w, total = o["warmup_steps"], o["max_steps"]
    if count < w:
        return count / max(1, w)
    return max(0.0, (total - count) / max(1, total - w))


def block_of(name: str) -> Optional[str]:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else None


class AdamW:
    """The optimizer's state over a dict of float32 parameters (holding
    values of the parameter dtype). `o`: learning_rate, weight_decay,
    beta1, beta2, eps, warmup_steps, max_steps, param_dtype,
    moments_dtype, factored (bool), factored_min (elements over all
    blocks)."""

    def __init__(self, params: Dict[str, torch.Tensor], o: Dict,
                 depth: int):
        self.o = o
        self.count = 0
        self.table = {n: lr_wd(n, tuple(p.shape), o)
                      for n, p in params.items()}
        mdt = o["moments_dtype"]
        self.m = {n: torch.zeros_like(p, dtype=mdt)
                  for n, p in params.items()}
        self.factored = {
            n for n, p in params.items()
            if o["factored"] and block_of(n) is not None and p.ndim == 2
            and depth * p.numel() >= o["factored_min"]}
        self.v = {}
        for n, p in params.items():
            if n in self.factored:
                self.v[n] = (torch.zeros(p.shape[1], device=p.device),
                             torch.zeros(p.shape[0], device=p.device))
            else:
                self.v[n] = torch.zeros_like(p, dtype=mdt)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]]) -> None:
        o = self.o
        b1, b2, eps = o["beta1"], o["beta2"], o["eps"]
        lam = schedule(o, self.count)
        bc1 = 1.0 - b1 ** (self.count + 1)
        bc2 = 1.0 - b2 ** (self.count + 1)
        for n, p in params.items():
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g.float()
            lr, wd = self.table[n]
            m = b1 * self.m[n].float() + (1 - b1) * g
            if n in self.factored:
                vr, vc = self.v[n]
                sq = g.square()
                vr2 = b2 * vr + (1 - b2) * sq.mean(0)  # [in]
                vc2 = b2 * vc + (1 - b2) * sq.mean(1)  # [out]
                v = vc2[:, None] * vr2[None, :] / vr2.mean().clamp(min=1e-30)
                self.v[n] = (vr2, vc2)
            else:
                v = b2 * self.v[n].float() + (1 - b2) * g.square()
                self.v[n].copy_(v)
            direction = (m / bc1) / ((v / bc2).sqrt() + eps)
            new = p - lr * lam * (direction + wd * p)
            p.copy_(new.to(o["param_dtype"]).float())
            self.m[n].copy_(m)
        self.count += 1


def leaf_norms(ts: Dict[str, Optional[torch.Tensor]],
               names: List[str]) -> torch.Tensor:
    """The float32 norm of each named tensor (0 for None), in order."""
    out = []
    for n in names:
        t = ts.get(n)
        out.append(torch.zeros(()) if t is None
                   else t.float().norm().cpu())
    return torch.stack(out)
