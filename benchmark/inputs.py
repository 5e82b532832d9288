"""Everything a run feeds the program, made from `--seed` on the device in a
few large calls: the weights, the training batches and the sampling
requests. The same seed gives the same tensors, so the plain reference is
handed the same inputs by making them again.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference.dit import param_shapes

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def derive(seed: int, what: str) -> int:
    """A 63-bit seed of its own for each stream of one run's seed."""
    h = hashlib.blake2b(f"{seed}/{what}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, what))


def fan_in(name: str, shapes: Dict[str, Sequence[int]]) -> int:
    """The fan-in of a weight (all dims but the first), or of the weight a
    bias belongs to."""
    if name.endswith(".bias"):
        name = name[: -len("bias")] + "weight"
    return math.prod(shapes[name][1:])


@torch.no_grad()
def weights(c: Dict, seed: int, device, dtype: torch.dtype
            ) -> Dict[str, torch.Tensor]:
    """Every parameter of configuration `c`, drawn in one call: weights and
    biases U(±1/√fan_in), register tokens of unit variance, λ in [0, 1),
    RMSNorm scales 1 ± 0.1. Layers the program initialises at zero (the
    AdaLN and final projections) are random too, so that every layer moves
    the loss from the first step."""
    shapes = param_shapes(c)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator(seed, "weights", device),
                   device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = u[at:at + n].view(shape)
        at += n
        if name.endswith("lambda_param"):
            out[name] = x.clone()
        elif name == "register_tokens":
            out[name] = (x * 2 - 1) * math.sqrt(3.0)
        elif name.endswith("norm.weight") or ".norm" in name:
            out[name] = 1 + (x * 2 - 1) * 0.1
        else:
            out[name] = (x * 2 - 1) / math.sqrt(fan_in(name, shapes))
    return out


@torch.no_grad()
def train_batches(c: Dict, t: Dict, seed: int, device, count: int,
                  stream: str = "batches") -> List[Dict[str, torch.Tensor]]:
    """`count` batches of the train traffic `t`: latents N(0, 1) [B, C, T,
    H, W] (float32, as the dataset's rows), context 0.05·N(0, 1) [B, Lc,
    ctx] (bf16, as precomputed T5 states), logit-normal timesteps shifted
    by α, noise N(0, 1) (bf16) of the patch-cropped latent, and RoPE crop
    offsets uniform over the positions the grid leaves free. `t["batch"]`
    rows a batch, drawn from the seed's stream `stream`."""
    b, lat, lc = t["batch"], t["latent"], t["context_tokens"]
    ch, tt, hh, ww = lat
    pt, p = c["time_patch_size"], c["patch_size"]
    crop = (ch, tt // pt * pt, hh // p * p, ww // p * p)
    gen = generator(seed, stream, device)
    n = count * b
    latents = torch.randn((n, *lat), generator=gen, device=device)
    context = (torch.randn((n, lc, c["cross_attn_input_size"]),
                           generator=gen, device=device,
                           dtype=torch.bfloat16) * 0.05)
    z = torch.randn(n, generator=gen, device=device)
    alpha = t["alpha"]
    s = torch.sigmoid(z)
    timesteps = s * alpha / (1 + (alpha - 1) * s)
    noise = torch.randn((n, *crop), generator=gen, device=device,
                        dtype=torch.bfloat16)
    grid = (tt // pt, hh // p, ww // p)
    free = torch.tensor([c["rope_max"] - g for g in grid], device=device)
    offs = (torch.rand((count, 3), generator=gen, device=device)
            * (free + 1)).long()
    return [{"latent": latents[i * b:(i + 1) * b],
             "context": context[i * b:(i + 1) * b],
             "timesteps": timesteps[i * b:(i + 1) * b],
             "noise": noise[i * b:(i + 1) * b],
             "rope_offsets": offs[i]} for i in range(count)]


@torch.no_grad()
def requests(c: Dict, t: Dict, seed: int, device, count: int):
    """`count` sampling requests of traffic `t`: initial noise N(0, 1) [1,
    C, frames, 2·(H/16), 2·(W/16)] (drawn in float32, served in bf16) and
    a context 0.05·N(0, 1) [1, Lc, ctx] (bf16)."""
    gen = generator(seed, "requests", device)
    shape = (c["in_channels"], t["frames"], 2 * (t["height"] // 16),
             2 * (t["width"] // 16))
    noise = torch.randn((count, 1, *shape), generator=gen,
                        device=device).to(torch.bfloat16)
    context = (torch.randn((count, 1, t["context_tokens"],
                            c["cross_attn_input_size"]), generator=gen,
                           device=device, dtype=torch.bfloat16) * 0.05)
    return list(noise), list(context)
