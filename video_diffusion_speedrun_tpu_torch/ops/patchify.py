"""3D patchify / unpatchify as reshape + matmul (port of `ops/patchify.py`).

A kernel==stride Conv3d is a block reshape followed by a dense projection.
Tokens are ordered (h w t), t fastest; patch features (c, kt, kh, kw), so a
Conv3d weight [D, C, pt, p, p] is `kernel = weight.reshape(D, -1).T`.
Unpatchify inverts "b (h w t) (p1 p2 p3 c) -> b c (t p3) (h p1) (w p2)".
"""

from __future__ import annotations

from typing import Optional

import torch


def extract_patches(x: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """[B, C, T, H, W] → [B, (H/p · W/p · T/pt), C·pt·p·p].

    Extents that are not patch multiples are floor-cropped, as a strided
    Conv3d does (Cosmos latents have 1+4k frames)."""
    b, c, t, h, w = x.shape
    gt, gh, gw = t // pt, h // p, w // p
    x = x[:, :, : gt * pt, : gh * p, : gw * p]
    x = x.reshape(b, c, gt, pt, gh, p, gw, p)
    # → [B, gh, gw, gt, C, pt, p, p]
    x = x.permute(0, 4, 6, 2, 1, 3, 5, 7)
    return x.reshape(b, gh * gw * gt, c * pt * p * p)


def patchify(x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor], pt: int, p: int,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Patch embedding [B, C, T, H, W] → [B, L, D]: the product accumulates
    in fp32, the bias is added in fp32, then the result is cast."""
    patches = extract_patches(x, pt, p).to(compute_dtype)
    out = torch.matmul(patches.float(), kernel.to(compute_dtype).float())
    if bias is not None:
        out = out + bias.float()
    return out.to(compute_dtype)


def unpatchify(tokens: torch.Tensor, grid_t: int, grid_h: int, grid_w: int,
               pt: int, p: int, channels: int) -> torch.Tensor:
    """[B, (h w t), p·p·pt·c] → [B, C, T, H, W], features (p1, p2, p3, c)."""
    b, l, f = tokens.shape
    if l != grid_h * grid_w * grid_t or f != p * p * pt * channels:
        raise ValueError(f"unpatchify: tokens {tuple(tokens.shape)} do not "
                         f"match grid {(grid_t, grid_h, grid_w)}, patch "
                         f"{(pt, p)}, channels {channels}")
    x = tokens.reshape(b, grid_h, grid_w, grid_t, p, p, pt, channels)
    # [B, gh, gw, gt, p1, p2, p3, c] → [B, c, gt, p3, gh, p1, gw, p2]
    x = x.permute(0, 7, 3, 6, 1, 4, 2, 5)
    return x.reshape(b, channels, grid_t * pt, grid_h * p, grid_w * p)
