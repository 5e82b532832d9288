"""Cosmos CV4x8x8 causal video-VAE decoder as `nn.Module`s (port of
`models/cosmos_vae.py`).

    latent [B, 16, T, h, w]  →  video [B, 3, 4·(T−1)+1, 8·h, 8·w]  in [-1, 1]

Causal 3D convolutions (time padded on the left with kt−1 copies of frame
0, space padded (k−1)//2 on the left and the rest on the right),
per-frame group norm (statistics per (b, group, frame) over (c/g, h, w)
in fp32, eps 1e-6), res blocks, a spatial then a causal temporal
single-head attention at the bottleneck, and causal upsampling (H and W
repeated; T repeated with its first copy dropped, T → 2T−1). Every
rounding point is the JAX one: convs accumulate in fp32 and round to the
compute dtype, attention logits and softmax are fp32 (the temporal mask
is −1e30), probabilities and p·v are cast back, tanh is taken in fp32.
Plain `F.conv3d` and `torch.matmul`: the JAX decoder runs no Pallas
kernel.

Modules are named after the Cosmos-Tokenizer decoder state dict
(`decoder.conv_in.conv3d.weight`, `decoder.mid.attn_1.0.norm.norm.weight`,
`proj_out`, `decoder.up.0` the shallowest level), as pinned in
`tests/fixtures/cosmos_decoder_layer_map.json`, so a real `decoder.jit`
state dict loads with `load_state_dict`; `load_decoder_params` reads the
`.npz` of JAX leaf paths that `scripts/convert_cosmos.py convert` writes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_diffusion_speedrun_tpu_torch.core.config import resolve_device
from video_diffusion_speedrun_tpu_torch.models.cosmos_layer_map import (
    has_upsample,
)


@dataclass(frozen=True)
class CosmosDecoderConfig:
    z_channels: int = 16
    out_channels: int = 3
    channels: int = 128
    channels_mult: Tuple[int, ...] = (2, 4, 4)
    num_res_blocks: int = 2
    # per up-level flags, from deepest (bottleneck) to shallowest
    temporal_up: Tuple[bool, ...] = (True, True, False)   # ×4 temporal
    spatial_up: Tuple[bool, ...] = (True, True, True)     # ×8 spatial
    norm_groups: int = 32
    attn_bottleneck: bool = True
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def block_in(self) -> int:
        return self.channels * self.channels_mult[-1]


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Per-frame GroupNorm: moments per (b, group, frame) over (c/g, h, w),
    as `F.group_norm` over the frames stacked into the batch ([B·T, C, H,
    W]; moments and the affine in fp32 inside, one rounding to x's dtype,
    the scale and bias taken in x's dtype). On the card this is 2× faster
    than explicit fp32 moments over a [B, g, c/g, T, H·W] view at the
    decoder's largest activation (`chip_smoke.py` t2v phase)."""
    b, c, t, h, w = x.shape
    y = F.group_norm(x.transpose(1, 2).reshape(b * t, c, h, w),
                     min(groups, c), weight.to(x.dtype), bias.to(x.dtype),
                     eps)
    return y.view(b, t, c, h, w).transpose(1, 2).contiguous()


class CausalConv3d(nn.Module):
    """A 3D conv causal in time (left-padded with kt−1 copies of the first
    frame) with SAME spatial padding; the inner `conv3d` holds the
    weights."""

    def __init__(self, cin: int, cout: int, kernel: int, **factory):
        super().__init__()
        self.conv3d = nn.Conv3d(cin, cout, kernel, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.conv3d.kernel_size
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x],
                          dim=2)
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        pad = (0, ph, pw)
        if kh - 1 - ph != ph or kw - 1 - pw != pw:  # even kernels: pad right
            x = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph))
            pad = 0
        w = self.conv3d.weight
        return F.conv3d(x, w.to(x.dtype), self.conv3d.bias.to(x.dtype),
                        padding=pad)


class CausalNormalize(nn.Module):
    """Per-frame group norm; the inner `norm` holds the scale and bias."""

    def __init__(self, c: int, groups: int, **factory):
        super().__init__()
        self.norm = nn.GroupNorm(min(groups, c), c, eps=1e-6, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.norm.weight, self.norm.bias,
                          self.norm.num_groups, self.norm.eps)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, **factory):
        super().__init__()
        self.norm1 = CausalNormalize(cin, groups, **factory)
        self.conv1 = CausalConv3d(cin, cout, 3, **factory)
        self.norm2 = CausalNormalize(cout, groups, **factory)
        self.conv2 = CausalConv3d(cout, cout, 3, **factory)
        if cin != cout:
            self.nin_shortcut = CausalConv3d(cin, cout, 1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-head attention over [N, L, C]: fp32 logits × C^-0.5 (masked
    to −1e30), fp32 softmax cast to v's dtype, p·v accumulated in fp32 and
    cast."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) \
        * (q.shape[-1] ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


class AttnBlock(nn.Module):
    """Spatial (per frame, over H·W) or causal temporal (per location,
    over T) single-head self-attention with a residual."""

    def __init__(self, c: int, groups: int, temporal: bool, **factory):
        super().__init__()
        self.temporal = temporal
        self.norm = CausalNormalize(c, groups, **factory)
        self.q = CausalConv3d(c, c, 1, **factory)
        self.k = CausalConv3d(c, c, 1, **factory)
        self.v = CausalConv3d(c, c, 1, **factory)
        self.proj_out = CausalConv3d(c, c, 1, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        hn = self.norm(x)
        q, k, v = self.q(hn), self.k(hn), self.v(hn)
        if self.temporal:  # [B, C, T, H, W] → [B·H·W, T, C]
            def flat(a):
                return a.permute(0, 3, 4, 2, 1).reshape(b * h * w, t, c)
            mask = torch.ones(t, t, dtype=torch.bool,
                              device=x.device).tril()[None]
            out = _attend(flat(q), flat(k), flat(v), mask)
            out = out.view(b, h, w, t, c).permute(0, 4, 3, 1, 2)
        else:  # → [B·T, H·W, C]
            def flat(a):
                return a.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
            out = _attend(flat(q), flat(k), flat(v))
            out = out.view(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return x + self.proj_out(out.contiguous())


class CausalUpsample(nn.Module):
    """Nearest-neighbour upsampling then a causal conv; in time T → 2T−1
    (each frame doubled, the leading copy of frame 0 dropped)."""

    def __init__(self, c: int, temporal: bool, spatial: bool, **factory):
        super().__init__()
        self.temporal, self.spatial = temporal, spatial
        self.conv = CausalConv3d(c, c, 3, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        s, tt = 2 if self.spatial else 1, 2 if self.temporal else 1
        # nearest neighbour as one broadcast copy (`jnp.repeat` per axis)
        x = x[:, :, :, None, :, None, :, None].expand(
            b, c, t, tt, h, s, w, s).reshape(b, c, t * tt, h * s, w * s)
        if self.temporal:
            x = x[:, :, 1:]
        return self.conv(x)


class UpLevel(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: CosmosDecoderConfig,
                 level: int, **factory):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, cfg.norm_groups,
                        **factory)
            for j in range(cfg.num_res_blocks + 1))
        if has_upsample(cfg, level):
            self.upsample = CausalUpsample(cout, cfg.temporal_up[level],
                                           cfg.spatial_up[level], **factory)


class MidBlock(nn.Module):
    def __init__(self, c: int, cfg: CosmosDecoderConfig, **factory):
        super().__init__()
        g = cfg.norm_groups
        self.block_1 = ResnetBlock(c, c, g, **factory)
        if cfg.attn_bottleneck:
            self.attn_1 = nn.Sequential(AttnBlock(c, g, False, **factory),
                                        AttnBlock(c, g, True, **factory))
        self.block_2 = ResnetBlock(c, c, g, **factory)


class Decoder(nn.Module):
    def __init__(self, cfg: CosmosDecoderConfig, **factory):
        super().__init__()
        n = len(cfg.channels_mult)
        self.conv_in = CausalConv3d(cfg.z_channels, cfg.block_in, 3, **factory)
        self.mid = MidBlock(cfg.block_in, cfg, **factory)
        levels = []
        cin = cfg.block_in
        for level, mult in enumerate(reversed(cfg.channels_mult)):
            levels.append(UpLevel(cin, cfg.channels * mult, cfg, level,
                                  **factory))
            cin = cfg.channels * mult
        # torch indexes up[0] = the shallowest level (processed last)
        self.up = nn.ModuleList(levels[n - 1 - i] for i in range(n))
        c0 = cfg.channels * cfg.channels_mult[0]
        self.norm_out = CausalNormalize(c0, cfg.norm_groups, **factory)
        self.conv_out = CausalConv3d(c0, cfg.out_channels, 3, **factory)


class CosmosDecoder(nn.Module):
    """The CV4x8x8 decoder on `device` (default the card), weights drawn
    from a generator seeded with `seed` with the JAX `init_cosmos_decoder`
    distributions (U(±1/√fan_in) conv weights and biases, unit norms).
    Parameters stay fp32 (as JAX's); convs cast them to the compute dtype.
    On the meta device nothing is initialised."""

    def __init__(self, cfg: CosmosDecoderConfig = CosmosDecoderConfig(), *,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.decoder = Decoder(cfg)
        if device.type == "meta":
            return
        self.to_empty(device=device)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))
        self.eval().requires_grad_(False)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Conv3d):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @torch.no_grad()
    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """`cosmos_decode`: [B, 16, T, h, w] → [B, 3, 4(T−1)+1, 8h, 8w] in
        the compute dtype, values in [-1, 1]."""
        d = self.decoder
        x = d.conv_in(latent.to(self.cfg.compute_dtype))
        x = d.mid.block_1(x)
        if hasattr(d.mid, "attn_1"):
            x = d.mid.attn_1(x)
        x = d.mid.block_2(x)
        for up in reversed(d.up):  # deepest first
            for block in up.block:
                x = block(x)
            if hasattr(up, "upsample"):
                x = up.upsample(x)
        x = d.conv_out(F.silu(d.norm_out(x)))
        return torch.tanh(x.float()).to(self.cfg.compute_dtype)


def cosmos_decode(decoder: CosmosDecoder, latent: torch.Tensor
                  ) -> torch.Tensor:
    """[B, 16, T, h, w] → [B, 3, 4(T−1)+1, 8h, 8w], values in [-1, 1]."""
    return decoder(latent)


def decode_video(decoder: CosmosDecoder, latent: torch.Tensor,
                 chunk_frames: Optional[int] = None,
                 context_frames: int = 2) -> torch.Tensor:
    """Decode [16, T, h, w] or [B, 16, T, h, w], whole or in causal
    temporal chunks: each chunk of `chunk_frames` latent frames is decoded
    with the `context_frames` latents before it and keeps only its own
    4·n output frames (the first chunk keeps all, frame 0 included). Exact
    for every conv whose temporal receptive field fits the context; the
    bottleneck's temporal attention sees only the window."""
    squeeze = latent.ndim == 4
    if squeeze:
        latent = latent[None]
    t = latent.shape[2]
    if chunk_frames is None or t <= chunk_frames:
        out = decoder(latent)
        return out[0] if squeeze else out
    pieces = []
    for a in range(0, t, chunk_frames):
        lo = max(0, a - context_frames)
        out = decoder(latent[:, :, lo: a + chunk_frames])
        if a == 0:
            pieces.append(out)
        else:
            pieces.append(out[:, :, -4 * min(chunk_frames, t - a):])
    video = torch.cat(pieces, dim=2)
    return video[0] if squeeze else video


def load_decoder_params(npz_path: str,
                        cfg: CosmosDecoderConfig = CosmosDecoderConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The state dict of `CosmosDecoder(cfg)` from the flat dotted-path
    `.npz` of `scripts/convert_cosmos.py convert` (JAX leaf paths, JAX
    layouts) — the file the JAX package's loader reads."""
    import numpy as np

    from video_diffusion_speedrun_tpu_torch.models.convert import (
        cosmos_state_dict_from_jax_params,
    )

    with np.load(npz_path) as flat:
        return cosmos_state_dict_from_jax_params(dict(flat), cfg)
