"""Axis-factored 3D rotary position embedding (port of `models/rope.py`).

Rotary dim d = head_dim/2, split d/2 time + d/4 height + d/4 width, base
100. Register tokens are prepended with the identity rotation (cos=1,
sin=0). The rotation is the half-split one by −θ: y1 = x1·c + x2·s,
y2 = −x1·s + x2·c, computed in fp32.

HunyuanVideo's tables (`nd_rope_cos_sin`, `apply_rotary_pairs`; Tencent's
`hyvideo/modules/posemb_layers.py`) differ in all three: the head dim is
split by `rope_dim_list` ([16, 56, 56] over t, h, w) with θ 256, tokens
are ordered (t, h, w), and the rotation is by +θ of interleaved pairs
(x[2j], x[2j+1]).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_inv_freqs(head_dim: int, base: float = 100.0,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv_freq_space [d/4], inv_freq_time [d/2]) with d = head_dim/2."""
    dim = head_dim // 2
    ar_s = torch.arange(0, dim, 4, dtype=torch.float32, device=device)
    ar_t = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (base ** (ar_s / dim)), 1.0 / (base ** (ar_t / dim))


def rope_cos_sin(
    head_dim: int,
    grid_t: int,
    grid_h: int,
    grid_w: int,
    offsets: torch.Tensor,
    *,
    base: float = 100.0,
    num_registers: int = 0,
    order: str = "matched",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[num_registers + grid_t·grid_h·grid_w, head_dim/2] fp32 cos/sin on
    the device of `offsets` ([3] ints: start t, h, w)."""
    dev = offsets.device
    inv_space, inv_time = rope_inv_freqs(head_dim, base, dev)
    off = offsets.float()
    pos_t = off[0] + torch.arange(grid_t, dtype=torch.float32, device=dev)
    pos_h = off[1] + torch.arange(grid_h, dtype=torch.float32, device=dev)
    pos_w = off[2] + torch.arange(grid_w, dtype=torch.float32, device=dev)

    freqs_t = pos_t[:, None] * inv_time[None, :]   # [T, d/2]
    freqs_h = pos_h[:, None] * inv_space[None, :]  # [H, d/4]
    freqs_w = pos_w[:, None] * inv_space[None, :]  # [W, d/4]
    shape = (grid_t, grid_h, grid_w)
    freqs = torch.cat([
        freqs_t[:, None, None, :].expand(*shape, -1),
        freqs_h[None, :, None, :].expand(*shape, -1),
        freqs_w[None, None, :, :].expand(*shape, -1),
    ], dim=-1)  # [T, H, W, d], features (t ‖ h ‖ w)

    if order == "reference":
        flat = freqs.reshape(grid_t * grid_h * grid_w, -1)
    elif order == "matched":
        flat = freqs.permute(1, 2, 0, 3).reshape(grid_t * grid_h * grid_w, -1)
    else:
        raise ValueError(f"unknown rope order: {order}")

    cos, sin = torch.cos(flat), torch.sin(flat)
    if num_registers > 0:
        n = cos.shape[-1]
        cos = torch.cat([torch.ones(num_registers, n, device=dev), cos])
        sin = torch.cat([torch.zeros(num_registers, n, device=dev), sin])
    return cos, sin


def random_rope_offsets(
    generator: Optional[torch.Generator],
    grid_t: int,
    grid_h: int,
    grid_w: int,
    max_t: int = 128,
    max_h: int = 128,
    max_w: int = 128,
) -> torch.Tensor:
    """Random crop offsets [3], each uniform over [0, max − grid] inclusive.
    Drawn on the generator's device."""
    dev = generator.device if generator is not None else None
    return torch.stack([
        torch.randint(0, hi + 1, (), generator=generator, device=dev)
        for hi in (max_t - grid_t, max_h - grid_h, max_w - grid_w)
    ])


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate q/k in fp32: x [B, nH, L, head_dim]; cos/sin [L, head_dim/2]."""
    xf = x.float()
    d = xf.shape[-1] // 2
    x1, x2 = xf[..., :d], xf[..., d:]
    y1 = x1 * cos + x2 * sin
    y2 = -x1 * sin + x2 * cos
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def nd_rope_cos_sin(grid: Tuple[int, int, int], rope_dim_list, theta: float,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T·H·W, head_dim/2] fp32 cos/sin of one frequency a pair, tokens
    ordered (t, h, w): pair j of a token is its axis's position times that
    axis's frequency θ^(−2i/dim), the axes' pairs concatenated t ‖ h ‖ w
    (`get_nd_rotary_pos_embed` with `use_real`, before its
    `repeat_interleave(2)`)."""
    parts = []
    for axis, (n, dim) in enumerate(zip(grid, rope_dim_list)):
        inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device)[:dim // 2] / dim))
        f = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv
        shape = [1, 1, 1, dim // 2]
        shape[axis] = n
        parts.append(f.reshape(shape).expand(*grid, dim // 2))
    freqs = torch.cat(parts, dim=-1).reshape(-1, sum(rope_dim_list) // 2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_pairs(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs by +θ in fp32 (`apply_rotary_emb`):
    x [..., L, D], cos/sin [L, D/2]; y[2j] = x[2j]·c − x[2j+1]·s,
    y[2j+1] = x[2j+1]·c + x[2j]·s, rounded back to x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    y = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return y.flatten(-2).to(x.dtype)
