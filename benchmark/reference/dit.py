"""The plain reference of the video DiT and its rectified-flow loss.

Plain PyTorch in float32, written from the architecture's description (the
speedrun's `train.py`/`model.py` DiT: 3D patchify, register tokens, axis-
factored 3D RoPE, a timestep MLP, blocks of AdaLN-modulated self-attention,
cross-attention to the text context and a GELU MLP with value-residual
mixing, a final AdaLN and projection). It imports nothing of the program
under test: it reads a dict of parameters by name, which the benchmark
makes from the seed and hands to both sides.

`Ops` holds the precision the products run at: `Ops()` is float32 with
TF32 off; `Ops(fp8=True)` rounds both operands of every product (the linear
layers and the two products of attention) to float8 e4m3 with a scale per
tensor first, and their gradients to e5m2: the control, a step below the
bf16 the configurations state.

Conventions (the architecture's, not any implementation's):
- tokens are ordered (h, w, t), t fastest; a patch's features (c, kt, kh,
  kw); the output patch's (p1, p2, p3, c);
- RoPE rotates half-split pairs by −θ, with θ of a token the concatenation
  of t·f_t (head_dim/4 frequencies), h·f_s and w·f_s (head_dim/8 each),
  f = base^(−2i/(head_dim/2)) (time) and base^(−4i/(head_dim/2)) (space);
  registers are not rotated;
- the AdaLN projection gives nine chunks in the order shift, scale, gate of
  self-attention, cross-attention and the MLP; a modulated norm is
  rms(x)·(1 + scale) + shift, eps 1e-6;
- the packed qkv projection's features are (q | k | v), each (head, dim);
  the context K/V projection's (k | v);
- value residual: from block 1 on v ← λ·v + (1 − λ)·v₀, v₀ block 0's v;
- the MLP's activation is the exact erf GELU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to the float8 `dtype` under one scale for the tensor that
    maps its largest magnitude to `top`."""
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """An operand of a float8 product: e4m3 in the forward, its gradient
    e5m2 in the backward (the usual hybrid float8 recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Ops:
    """The precision of the products: float32, or float8 operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.fp8 else t

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = torch.matmul(self.q(x), self.q(w.float()).t())
        return y if b is None else y + b.float()

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


def fp32_matmuls() -> None:
    """Products in true float32: TF32 would round their operands to 10
    bits of mantissa."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def param_shapes(c: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of configuration `c` by its state-dict name."""
    d, f = c["hidden_size"], int(c["hidden_size"] * c["mlp_ratio"])
    pt, p, ch = c["time_patch_size"], c["patch_size"], c["in_channels"]
    bias = c["train_bias_and_rms"]
    out = {"register_tokens": (1, c["num_registers"], d),
           "patch_embed.patch_proj.weight": (d, ch, pt, p, p),
           "patch_embed.patch_proj.bias": (d,),
           "time_embed.0.weight": (4 * d, d), "time_embed.0.bias": (4 * d,),
           "time_embed.2.weight": (d, 4 * d), "time_embed.2.bias": (d,)}
    for i in range(c["depth"]):
        b = f"blocks.{i}."
        if bias:
            out[b + "norm1.weight"] = (d,)
            out[b + "norm3.weight"] = (d,)
        if c["residual_v"]:
            out[b + "lambda_param"] = (1,)
        out[b + "qkv.weight"] = (3 * d, d)
        if bias:
            out[b + "qkv.bias"] = (3 * d,)
        out[b + "attn_proj.weight"] = (d, d)
        out[b + "mlp.0.weight"] = (f, d)
        out[b + "mlp.0.bias"] = (f,)
        out[b + "mlp.2.weight"] = (d, f)
        out[b + "mlp.2.bias"] = (d,)
        out[b + "adaLN_modulation.1.weight"] = (9 * d, d)
        out[b + "adaLN_modulation.1.bias"] = (9 * d,)
        if c["cross_attn_input_size"]:
            if bias:
                out[b + "norm2.weight"] = (d,)
            out[b + "q_cross.weight"] = (d, d)
            if bias:
                out[b + "q_cross.bias"] = (d,)
            out[b + "context_kv.weight"] = (2 * d, c["cross_attn_input_size"])
            if bias:
                out[b + "context_kv.bias"] = (2 * d,)
            out[b + "cross_proj.weight"] = (d, d)
    out["final_modulation.1.weight"] = (2 * d, d)
    out["final_modulation.1.bias"] = (2 * d,)
    if bias:
        out["final_norm.weight"] = (d,)
    out["final_proj.weight"] = (pt * p * p * c["in_channels"], d)
    out["final_proj.bias"] = (pt * p * p * c["in_channels"],)
    return out


def grid_of(c: Dict, latent_shape) -> Tuple[int, int, int]:
    """The token grid (T, H, W) of a latent [B, C, T, H, W]; extents that
    are not patch multiples are cut off."""
    _, _, t, h, w = latent_shape
    return (t // c["time_patch_size"], h // c["patch_size"],
            w // c["patch_size"])


def patchify(c: Dict, x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] → [B, L, C·pt·p·p], tokens (h, w, t)."""
    pt, p = c["time_patch_size"], c["patch_size"]
    gt, gh, gw = grid_of(c, x.shape)
    b, ch = x.shape[:2]
    x = x[:, :, :gt * pt, :gh * p, :gw * p]
    x = x.reshape(b, ch, gt, pt, gh, p, gw, p)
    x = x.permute(0, 4, 6, 2, 1, 3, 5, 7)  # b, h, w, t, c, kt, kh, kw
    return x.reshape(b, gh * gw * gt, ch * pt * p * p)


def unpatchify(c: Dict, tokens: torch.Tensor, grid) -> torch.Tensor:
    """[B, L, p·p·pt·C] (features p1, p2, p3, c) → [B, C, T, H, W]."""
    pt, p, ch = c["time_patch_size"], c["patch_size"], c["in_channels"]
    gt, gh, gw = grid
    b = tokens.shape[0]
    x = tokens.reshape(b, gh, gw, gt, p, p, pt, ch)
    x = x.permute(0, 7, 3, 6, 1, 4, 2, 5)  # b, c, t, p3, h, p1, w, p2
    return x.reshape(b, ch, gt * pt, gh * p, gw * p)


def rope_tables(c: Dict, grid, offsets, device):
    """cos, sin [R + L, head_dim/2] of the token grid, rows (h, w, t)."""
    hd = c["hidden_size"] // c["num_heads"]
    half = hd // 2
    base = float(c["rope_base"])
    f_t = base ** (-torch.arange(0, half, 2, dtype=torch.float64) / half)
    f_s = base ** (-torch.arange(0, half, 4, dtype=torch.float64) / half)
    off = [int(o) for o in offsets]
    gt, gh, gw = grid
    t = torch.arange(gt, dtype=torch.float64) + off[0]
    h = torch.arange(gh, dtype=torch.float64) + off[1]
    w = torch.arange(gw, dtype=torch.float64) + off[2]
    th = torch.cat([
        (h[:, None, None, None] * f_s).expand(gh, gw, gt, -1),
        (w[None, :, None, None] * f_s).expand(gh, gw, gt, -1),
    ], dim=-1)
    tt = (t[None, None, :, None] * f_t).expand(gh, gw, gt, -1)
    theta = torch.cat([tt, th], dim=-1).reshape(gh * gw * gt, half)
    r = c["num_registers"]
    theta = torch.cat([torch.zeros(r, half, dtype=torch.float64), theta])
    return (torch.cos(theta).float().to(device),
            torch.sin(theta).float().to(device))


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, L, hd] rotated by −θ in half-split pairs."""
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos + b * sin, b * cos - a * sin], dim=-1)


def attention(ops: Ops, q, k, v, rows: int = 2048) -> torch.Tensor:
    """softmax(q·kᵀ/√hd)·v over [B, H, L, hd], in blocks of query rows."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for s in range(0, q.shape[2], rows):
        logits = ops.bmm(q[:, :, s:s + rows], k.transpose(-1, -2)) * scale
        outs.append(ops.bmm(torch.softmax(logits, dim=-1), v))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def rms(x: torch.Tensor, weight=None, eps: float = 1e-6) -> torch.Tensor:
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return y if weight is None else y * weight.float()


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] → [B, dim]: cos ‖ sin of t·10000^(−i/(dim/2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    a = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, nh, d // nh).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    b, nh, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, nh * hd)


def context_kv(ops: Ops, P, c: Dict, i: int, context: torch.Tensor):
    """Block i's cross-attention K/V [B, Lc, 2D] of the context."""
    pre = f"blocks.{i}."
    return ops.linear(context.float(), P[pre + "context_kv.weight"],
                      P.get(pre + "context_kv.bias"))


def block(ops: Ops, P, c: Dict, i: int, x, te, cos, sin, v0, ckv):
    """Block i: (x, v) from x [B, L, D], the timestep embedding te [B, D],
    block 0's v (None in block 0) and the context K/V [B, Lc, 2D]."""
    pre = f"blocks.{i}."
    d, nh = c["hidden_size"], c["num_heads"]
    mod = ops.linear(F.silu(te), P[pre + "adaLN_modulation.1.weight"],
                     P[pre + "adaLN_modulation.1.bias"])
    ch = [m[:, None, :] for m in mod.chunk(9, dim=-1)]

    def modulated(y, norm, n):
        return rms(y, P.get(pre + norm)) * (1 + ch[n + 1]) + ch[n]

    qkv = ops.linear(modulated(x, "norm1.weight", 0), P[pre + "qkv.weight"],
                     P.get(pre + "qkv.bias"))
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    if c["residual_v"] and v0 is not None:
        lam = P[pre + "lambda_param"].float()
        v = lam * v + (1 - lam) * v0
    qh, kh = rotate(heads(q, nh), cos, sin), rotate(heads(k, nh), cos, sin)
    a = merge(attention(ops, qh, kh, heads(v, nh)))
    x = x + ops.linear(a, P[pre + "attn_proj.weight"]) * ch[2]
    if ckv is not None:
        qc = ops.linear(modulated(x, "norm2.weight", 3),
                        P[pre + "q_cross.weight"], P.get(pre + "q_cross.bias"))
        a = merge(attention(ops, heads(qc, nh), heads(ckv[..., :d], nh),
                            heads(ckv[..., d:], nh)))
        x = x + ops.linear(a, P[pre + "cross_proj.weight"]) * ch[5]
    h = F.gelu(ops.linear(modulated(x, "norm3.weight", 6),
                          P[pre + "mlp.0.weight"], P[pre + "mlp.0.bias"]))
    x = x + ops.linear(h, P[pre + "mlp.2.weight"], P[pre + "mlp.2.bias"]) \
        * ch[8]
    return x, v


def forward(ops: Ops, P, c: Dict, x: torch.Tensor, t: torch.Tensor,
            offsets=(0, 0, 0), context: Optional[torch.Tensor] = None,
            ckvs=None, remat: bool = False) -> torch.Tensor:
    """The velocity [B, C, T', H', W'] of latents x [B, C, T, H, W] at
    timesteps t [B], conditioned on `context` [B, Lc, ctx] or on every
    block's context K/V (`ckvs`, a list). With `remat` each block's
    activations are recomputed in the backward (the same arithmetic)."""
    d = c["hidden_size"]
    grid = grid_of(c, x.shape)
    w = P["patch_embed.patch_proj.weight"].reshape(d, -1)
    tok = ops.linear(patchify(c, x.float()), w,
                     P["patch_embed.patch_proj.bias"])
    b = tok.shape[0]
    regs = P["register_tokens"].float().expand(b, -1, -1)
    tok = torch.cat([regs, tok], dim=1)
    cos, sin = rope_tables(c, grid, offsets, x.device)
    te = ops.linear(timestep_embedding(t, d), P["time_embed.0.weight"],
                    P["time_embed.0.bias"])
    te = ops.linear(F.silu(te), P["time_embed.2.weight"],
                    P["time_embed.2.bias"])
    v0 = None
    for i in range(c["depth"]):
        if ckvs is not None:
            ckv = ckvs[i]
        elif context is not None and c["cross_attn_input_size"]:
            ckv = context_kv(ops, P, c, i, context)
        else:
            ckv = None
        if remat:
            tok, v = checkpoint(block, ops, P, c, i, tok, te, cos, sin, v0,
                                ckv, use_reentrant=False)
        else:
            tok, v = block(ops, P, c, i, tok, te, cos, sin, v0, ckv)
        if i == 0:
            v0 = v
    fm = ops.linear(F.silu(te), P["final_modulation.1.weight"],
                    P["final_modulation.1.bias"])
    shift, scale = (m[:, None, :] for m in fm.chunk(2, dim=-1))
    y = rms(tok[:, c["num_registers"]:], P.get("final_norm.weight"))
    y = y * (1 + scale) + shift
    y = ops.linear(y, P["final_proj.weight"], P["final_proj.bias"])
    return unpatchify(c, y, grid)


def flow_loss(ops: Ops, P, c: Dict, batch: Dict, dropped: torch.Tensor,
              rows: slice = slice(None), remat: bool = True) -> torch.Tensor:
    """The sum over the samples `rows` of the per-sample rectified-flow
    MSE: z = x·(1 − t) + n·t, target x − n, the mean over (C, T, H, W) of
    the squared error. `dropped` [B] marks the samples whose context is
    zeroed (caption dropout)."""
    lat = batch["latent"][rows].float()
    grid = grid_of(c, lat.shape)
    pt, p = c["time_patch_size"], c["patch_size"]
    lat = lat[:, :, :grid[0] * pt, :grid[1] * p, :grid[2] * p]
    noise = batch["noise"][rows].float()
    t = batch["timesteps"][rows].float()
    tr = t[:, None, None, None, None]
    z = lat * (1 - tr) + noise * tr
    ctx = batch["context"][rows].float()
    ctx = torch.where(dropped[rows][:, None, None], torch.zeros_like(ctx),
                      ctx)
    out = forward(ops, P, c, z, t, batch["rope_offsets"].tolist(),
                  context=ctx, remat=remat)
    return (lat - noise - out).square().mean(dim=(1, 2, 3, 4)).sum()
