"""HunyuanVideo's MM-DiT (`HYVideo-T/2-cfgdistill`) for sampling.

Tencent's `hyvideo/modules/models.py` (`HYVideoDiffusionTransformer`),
`token_refiner.py` and `posemb_layers.py`; arXiv:2412.03603. Parameter
names are the published state dict's (`img_in.proj`, `txt_in.
individual_token_refiner.blocks.{i}.…`, `double_blocks.{i}.img_attn_qkv`,
`single_blocks.{i}.linear1`, `final_layer.…`), so a published checkpoint
loads with `strict=True` (`load_published`). No weight is permuted: the
q/k kernel rotates the published interleaved pairs itself.

A forward, batch 1 (the model is guidance-distilled: no CFG pair):
- conditioning, once a request (`condition`): the refiner's input
  projection of the valid text rows and its context vector (the linear
  projection of their mean), and vector_in(CLIP-pooled text) +
  guidance_in(guidance);
- each step: vec = time_in(t) + that sum; the token refiner's two blocks
  over the valid text rows, conditioned on its own timestep embedding plus
  the context vector (span `vds/mm/text`);
- 20 double-stream blocks (`vds/mm/double`): per stream (video, text)
  (shift₁, scale₁, gate₁, shift₂, scale₂, gate₂) = Linear(SiLU(vec)); both
  streams' qkv of LN(x)·(1 + scale₁) + shift₁ written into one joint
  [video; text] buffer, q and k RMS-normed per head with their stream's
  weights and the video rows rotated (`qk_norm_rope`), one joint attention
  (the long kernel), then x += gate₁·proj(attn) and x += gate₂·MLP(LN(x)·
  (1 + scale₂) + shift₂) with a GELU-tanh MLP;
- 40 single-stream parallel blocks (`vds/mm/single`) over x = [video;
  text]: (shift, scale, gate) = Linear(SiLU(vec)); [qkv, m] =
  linear1(LN(x)·(1 + scale) + shift); q, k normed and the video rows
  rotated; x += gate·linear2([attn; GELU-tanh(m)]);
- the final layer over the video rows: LN, a 2-way modulation (shift
  first), Linear to the 64 patch features (c, pt, ph, pw), unpatchified.

The padded text slots are dropped before the refiner (`condition` keeps
the rows the mask marks valid). For the video output of a batch of 1 that
is exactly what the published masks compute: the refiner's valid rows see
only valid keys, and its varlen joint attention puts the padding in a
sequence of its own that no video row reads.

On CUDA tensors the model runs in bf16 through its kernels: `ops/
fused_mmdit.py` (q/k norm + RoPE, the LayerNorm modulation, GELU-tanh) and
the long attention forward (`ops/fused_attention.py:
long_attention_forward`) for every attention, the refiner's included; on
CPU tensors through their twins, in the configuration's compute dtype.
Inference only: nothing here has a backward.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_diffusion_speedrun_tpu_torch.core.config import (
    HunyuanVideoConfig,
    resolve_device,
)
from video_diffusion_speedrun_tpu_torch.models.rope import nd_rope_cos_sin
from video_diffusion_speedrun_tpu_torch.ops.embeddings import (
    timestep_embedding,
)
from video_diffusion_speedrun_tpu_torch.ops.fused_attention import (
    long_attention_forward,
)
from video_diffusion_speedrun_tpu_torch.ops.fused_mmdit import (
    gelu_tanh,
    ln_modulate,
    qk_norm_rope,
)
from video_diffusion_speedrun_tpu_torch.utils.profiling import span

_EPS = 1e-6


def _lin(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x·W + b in x's dtype (the compute dtype)."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int) -> torch.Tensor:
    """Attention of [L, H·D] row views (any row stride), all keys."""
    o, _ = long_attention_forward(q[None], k[None], v[None], heads,
                                  (q.shape[-1] // heads) ** -0.5)
    return o[0]


class Conditioning(NamedTuple):
    """What a request's text gives every step: the refiner's input
    projection of the valid text rows [1, n, D], its context vector [1, D]
    and vector_in + guidance_in [1, D], in the compute dtype."""

    txt: torch.Tensor
    txt_c: torch.Tensor
    vec: torch.Tensor


class RMSNorm(nn.Module):
    """Holds a per-head RMSNorm's weight; the norm runs in `qk_norm_rope`."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class ModulateDiT(nn.Module):
    def __init__(self, d: int, factor: int):
        super().__init__()
        self.linear = nn.Linear(d, factor * d)


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class TimestepEmbedder(nn.Module):
    def __init__(self, d: int, freq: int):
        super().__init__()
        self.freq = freq
        self.mlp = nn.Sequential(nn.Linear(freq, d), nn.SiLU(),
                                 nn.Linear(d, d))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        e = timestep_embedding(t, self.freq).to(dtype)
        return _lin(self.mlp[2], F.silu(_lin(self.mlp[0], e)))


class MLPEmbedder(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.in_layer = nn.Linear(d_in, d)
        self.out_layer = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _lin(self.out_layer, F.silu(_lin(self.in_layer, x)))


class TextProjection(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _lin(self.linear_2, F.silu(_lin(self.linear_1, x)))


class RefinerBlock(nn.Module):
    """`IndividualTokenRefinerBlock`: LayerNorm with affine, no qk-norm, a
    SiLU MLP, two gates from Linear(SiLU(c))."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.heads_num
        self.norm1 = nn.LayerNorm(d, eps=_EPS)
        self.self_attn_qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.self_attn_proj = nn.Linear(d, d, bias=cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(d, eps=_EPS)
        self.mlp = MLP(d, cfg.mlp_hidden)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))

    def _ln(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, norm.normalized_shape,
                            norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                            norm.eps)

    def forward(self, x: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
        """x [n, D] (the valid rows), sc = SiLU(c) [1, D]."""
        d = x.shape[-1]
        gate_msa, gate_mlp = _lin(self.adaLN_modulation[1], sc).chunk(2, -1)
        qkv = _lin(self.self_attn_qkv, self._ln(self.norm1, x))
        attn = _attend(qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:],
                       self.heads)
        x = torch.addcmul(x, _lin(self.self_attn_proj, attn), gate_msa)
        h = F.silu(_lin(self.mlp.fc1, self._ln(self.norm2, x)))
        return torch.addcmul(x, _lin(self.mlp.fc2, h), gate_mlp)


class IndividualTokenRefiner(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.blocks = nn.ModuleList(RefinerBlock(cfg)
                                    for _ in range(cfg.refiner_depth))


class SingleTokenRefiner(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        d = cfg.hidden_size
        self.input_embedder = nn.Linear(cfg.text_states_dim, d)
        self.t_embedder = TimestepEmbedder(d, cfg.frequency_embedding_size)
        self.c_embedder = TextProjection(cfg.text_states_dim, d)
        self.individual_token_refiner = IndividualTokenRefiner(cfg)

    def forward(self, txt: torch.Tensor, t: torch.Tensor,
                txt_c: torch.Tensor) -> torch.Tensor:
        """The refiner's blocks over the projected valid text rows [1, n, D]
        with c = t_embedder(t) + the context vector."""
        c = self.t_embedder(t, txt.dtype) + txt_c
        sc, x = F.silu(c), txt[0]
        for blk in self.individual_token_refiner.blocks:
            x = blk(x, sc)
        return x[None]


class DoubleBlock(nn.Module):
    """`MMDoubleStreamBlock`: video and text with their own weights, one
    joint attention."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.mlp_hidden
        self.heads = cfg.heads_num
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", ModulateDiT(d, 6))
            setattr(self, f"{s}_attn_qkv", nn.Linear(d, 3 * d,
                                                     bias=cfg.qkv_bias))
            setattr(self, f"{s}_attn_q_norm", RMSNorm(cfg.head_dim))
            setattr(self, f"{s}_attn_k_norm", RMSNorm(cfg.head_dim))
            setattr(self, f"{s}_attn_proj", nn.Linear(d, d,
                                                      bias=cfg.qkv_bias))
            setattr(self, f"{s}_mlp", MLP(d, f))

    def _mlp(self, mlp: MLP, x: torch.Tensor, shift, scale) -> torch.Tensor:
        xm = ln_modulate(x, shift, scale)[0]
        h = torch.matmul(xm, mlp.fc1.weight.to(xm.dtype).t())
        return _lin(mlp.fc2, gelu_tanh(h, mlp.fc1.bias.to(xm.dtype), out=h))

    def forward(self, img: torch.Tensor, txt: torch.Tensor, svec, cos, sin
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img [1, Li, D], txt [1, n, D], svec = SiLU(vec) [1, D]."""
        d = img.shape[-1]
        li = img.shape[1]
        im = _lin(self.img_mod.linear, svec).chunk(6, -1)
        tm = _lin(self.txt_mod.linear, svec).chunk(6, -1)
        qkv = img.new_empty(li + txt.shape[1], 3 * d)
        for rows, x, m, lin in ((qkv[:li], img, im, self.img_attn_qkv),
                                (qkv[li:], txt, tm, self.txt_attn_qkv)):
            torch.addmm(lin.bias.to(x.dtype), ln_modulate(x, m[0], m[1])[0],
                        lin.weight.to(x.dtype).t(), out=rows)
        qk_norm_rope(qkv, li, self.heads, self.img_attn_q_norm.weight,
                     self.img_attn_k_norm.weight, self.txt_attn_q_norm.weight,
                     self.txt_attn_k_norm.weight, cos, sin)
        attn = _attend(qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:],
                       self.heads)
        out = []
        for x, a, m, proj, mlp in (
                (img, attn[:li], im, self.img_attn_proj, self.img_mlp),
                (txt, attn[li:], tm, self.txt_attn_proj, self.txt_mlp)):
            x = torch.addcmul(x, _lin(proj, a), m[2])
            out.append(torch.addcmul(x, self._mlp(mlp, x, m[3], m[4]), m[5]))
        return out[0], out[1]


class SingleBlock(nn.Module):
    """`MMSingleStreamBlock`: a parallel block over [video; text]."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.mlp_hidden
        self.heads = cfg.heads_num
        self.linear1 = nn.Linear(d, 3 * d + f)
        self.linear2 = nn.Linear(d + f, d)
        self.q_norm = RMSNorm(cfg.head_dim)
        self.k_norm = RMSNorm(cfg.head_dim)
        self.modulation = ModulateDiT(d, 3)

    def forward(self, x: torch.Tensor, svec, n_img: int, cos, sin
                ) -> torch.Tensor:
        """x [1, L, D] = [video; text], its first `n_img` rows video."""
        d = x.shape[-1]
        shift, scale, gate = _lin(self.modulation.linear, svec).chunk(3, -1)
        y = _lin(self.linear1, ln_modulate(x, shift, scale)[0])
        qk_norm_rope(y, n_img, self.heads, self.q_norm.weight,
                     self.k_norm.weight, cos=cos, sin=sin)
        cat = y.new_empty(y.shape[0], y.shape[1] - 2 * d)
        cat[:, :d] = _attend(y[:, :d], y[:, d:2 * d], y[:, 2 * d:3 * d],
                             self.heads)
        gelu_tanh(y[:, 3 * d:], out=cat[:, d:])
        return torch.addcmul(x, _lin(self.linear2, cat), gate)


class PatchEmbed(nn.Module):
    """Holds the Conv3d patch weight (`img_in.proj`); it runs as a reshape
    and a product, tokens ordered (t, h, w)."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        k = tuple(cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_channels, cfg.hidden_size, k, stride=k)


class FinalLayer(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        d = cfg.hidden_size
        self.linear = nn.Linear(d, cfg.out_patch_dim)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))


class HunyuanVideo(nn.Module):
    """The MM-DiT. Built on `device` (default: the card; a CUDA device with
    no card present raises; "meta" for names and shapes) with weights and
    biases U(±1/√fan_in) from a `torch.Generator` seeded with `seed`
    (every layer, the modulations and the final layer too), norm weights 1
    and biases 0, in `cfg.param_dtype`."""

    def __init__(self, cfg: HunyuanVideoConfig, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.frequency_embedding_size
        with torch.device("meta"):
            self.img_in = PatchEmbed(cfg)
            self.txt_in = SingleTokenRefiner(cfg)
            self.time_in = TimestepEmbedder(d, f)
            self.vector_in = MLPEmbedder(cfg.text_states_dim_2, d)
            if cfg.guidance_embed:
                self.guidance_in = TimestepEmbedder(d, f)
            self.double_blocks = nn.ModuleList(
                DoubleBlock(cfg) for _ in range(cfg.mm_double_blocks_depth))
            self.single_blocks = nn.ModuleList(
                SingleBlock(cfg) for _ in range(cfg.mm_single_blocks_depth))
            self.final_layer = FinalLayer(cfg)
        self.to_empty(device=device)
        self._rope: Dict = {}
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
            self._init_weights(gen)
        self.to(cfg.param_dtype)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv3d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, (nn.LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def condition(self, text_states: torch.Tensor,
                  text_states_2: torch.Tensor, guidance: torch.Tensor,
                  text_mask: Optional[torch.Tensor] = None) -> Conditioning:
        """What a request's text gives every step (batch 1): text_states
        [1, Lt, 4096], text_mask [1, Lt] (None: all valid), text_states_2
        [1, 768], guidance [1] (the scale × 1000)."""
        dt = self.cfg.compute_dtype
        if text_states.shape[0] != 1:
            raise ValueError("the sampler runs batch 1")
        if text_mask is not None:
            text_states = text_states[:, text_mask[0].bool()]
        ts = text_states.to(dt)
        refiner = self.txt_in
        txt = _lin(refiner.input_embedder, ts)
        txt_c = refiner.c_embedder(text_states.float().mean(dim=1).to(dt))
        vec = self.vector_in(text_states_2.to(dt))
        if self.cfg.guidance_embed:
            vec = vec + self.guidance_in(guidance, dt)
        return Conditioning(txt, txt_c, vec)

    def rope(self, grid: Tuple[int, int, int], device) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
        """The video rows' cos/sin [T·H·W, D/2], made once a grid."""
        key = (grid, str(device))
        if key not in self._rope:
            cfg = self.cfg
            self._rope[key] = nd_rope_cos_sin(grid, cfg.rope_dim_list,
                                              cfg.rope_theta, device)
        return self._rope[key]

    def patchify(self, x: torch.Tensor):
        """[1, C, T, H, W] → tokens [1, T'·H'·W', D] ordered (t, h, w), and
        the grid (T', H', W')."""
        cfg = self.cfg
        pt, ph, pw = cfg.patch_size
        b, c, t, h, w = x.shape
        grid = (t // pt, h // ph, w // pw)
        p = x.reshape(b, c, grid[0], pt, grid[1], ph, grid[2], pw)
        p = p.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, -1, cfg.patch_dim)
        proj = self.img_in.proj
        dt = cfg.compute_dtype
        return F.linear(p.to(dt), proj.weight.reshape(cfg.hidden_size, -1)
                        .to(dt), proj.bias.to(dt)), grid

    def unpatchify(self, tokens: torch.Tensor,
                   grid: Tuple[int, int, int]) -> torch.Tensor:
        """[1, L, (c, pt, ph, pw)] → [1, C, T, H, W]."""
        cfg = self.cfg
        pt, ph, pw = cfg.patch_size
        gt, gh, gw = grid
        b = tokens.shape[0]
        x = tokens.reshape(b, gt, gh, gw, cfg.out_channels, pt, ph, pw)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return x.reshape(b, cfg.out_channels, gt * pt, gh * ph, gw * pw)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                cond: Conditioning) -> torch.Tensor:
        """x [1, C, T, H, W], timestep [1] (1000·σ), `cond` of `condition`
        → the velocity [1, C, T, H, W] in the compute dtype."""
        dt, dev = self.cfg.compute_dtype, x.device
        img, grid = self.patchify(x)
        n_img = img.shape[1]
        vec = self.time_in(timestep, dt) + cond.vec
        with span("mm/text", dev):
            txt = self.txt_in(cond.txt, timestep, cond.txt_c)
        cos, sin = self.rope(grid, dev)
        svec = F.silu(vec)
        for blk in self.double_blocks:
            with span("mm/double", dev):
                img, txt = blk(img, txt, svec, cos, sin)
        x = torch.cat([img, txt], dim=1)
        del img, txt
        for blk in self.single_blocks:
            with span("mm/single", dev):
                x = blk(x, svec, n_img, cos, sin)
        fl = self.final_layer
        shift, scale = _lin(fl.adaLN_modulation[1], svec).chunk(2, -1)
        out = _lin(fl.linear, ln_modulate(x[:, :n_img], shift, scale))
        return self.unpatchify(out, grid)


def load_published(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a published checkpoint file (its "module" entry,
    or the file's dict itself)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("module", sd)
