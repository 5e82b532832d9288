"""The plain reference of HunyuanVideo's MM-DiT (`HYVideo-T/2-cfgdistill`)
and its guidance-distilled Euler sampler.

Plain PyTorch in float32 (the caller turns TF32 off), written from the
published code: Tencent's `hyvideo/modules/models.py`
(`HYVideoDiffusionTransformer`, `MMDoubleStreamBlock`,
`MMSingleStreamBlock`, `FinalLayer`), `token_refiner.py`
(`SingleTokenRefiner`), `posemb_layers.py` (`get_nd_rotary_pos_embed`,
`apply_rotary_emb`), `embed_layers.py` and `modulate_layers.py`, and the
`FlowMatchDiscreteScheduler`'s Euler step; arXiv:2412.03603. It imports
nothing of the program under test: parameters come by state-dict name from
`P(group)`, a callable that hands over one group's float32 tensors
(`groups`: the embedders and final layer, then each block), so a caller
may make each block's weights when the walk reaches it and hold one block
at a time.

As published: the full text of `text_len` slots with its mask; the
refiner's self-attention mask (valid query and key, key 0 always allowed);
the joint attention's varlen layout (the video and the valid text rows one
sequence, the padded text rows a second); RoPE of the video rows by +θ in
interleaved pairs with the cos/sin tables repeated per pair; modulate x·(1 +
scale) + shift, gate x·g; LayerNorm eps 1e-6 (affine only in the refiner);
per-head RMSNorm eps 1e-6 with its weight; GELU-tanh in the MM MLPs, SiLU
in the refiner's; the timestep and guidance embedded as cos ‖ sin of 256.

Departures: everything is float32 (the published model runs in bf16 under
autocast); attention is softmax(q·kᵀ/√d)·v written out, in blocks of query
rows, with the varlen layout as a mask, where the published code calls
flash-attention's varlen kernel; `ops` carries the precision of the
products (`reference.dit.Ops`: float32, or float8 operands for the
control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6


def _dims(c: Dict) -> Tuple[int, int, int]:
    d = c["hidden_size"]
    return d, c["heads_num"], int(d * c["mlp_width_ratio"])


def param_shapes(c: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of configuration `c` by its published state-dict
    name."""
    d, _, f = _dims(c)
    hd = d // c["heads_num"]
    pt, ph, pw = c["patch_size"]
    fe, td, td2 = (c["frequency_embedding_size"], c["text_states_dim"],
                   c["text_states_dim_2"])
    out = {}

    def lin(name, n_in, n_out, bias=True):
        out[name + ".weight"] = (n_out, n_in)
        if bias:
            out[name + ".bias"] = (n_out,)

    out["img_in.proj.weight"] = (d, c["in_channels"], pt, ph, pw)
    out["img_in.proj.bias"] = (d,)
    r = "txt_in."
    lin(r + "input_embedder", td, d)
    lin(r + "t_embedder.mlp.0", fe, d)
    lin(r + "t_embedder.mlp.2", d, d)
    lin(r + "c_embedder.linear_1", td, d)
    lin(r + "c_embedder.linear_2", d, d)
    for i in range(c["refiner_depth"]):
        b = f"{r}individual_token_refiner.blocks.{i}."
        for norm in ("norm1", "norm2"):
            out[b + norm + ".weight"] = (d,)
            out[b + norm + ".bias"] = (d,)
        lin(b + "self_attn_qkv", d, 3 * d, c["qkv_bias"])
        lin(b + "self_attn_proj", d, d, c["qkv_bias"])
        lin(b + "mlp.fc1", d, f)
        lin(b + "mlp.fc2", f, d)
        lin(b + "adaLN_modulation.1", d, 2 * d)
    lin("time_in.mlp.0", fe, d)
    lin("time_in.mlp.2", d, d)
    lin("vector_in.in_layer", td2, d)
    lin("vector_in.out_layer", d, d)
    if c["guidance_embed"]:
        lin("guidance_in.mlp.0", fe, d)
        lin("guidance_in.mlp.2", d, d)
    for i in range(c["mm_double_blocks_depth"]):
        b = f"double_blocks.{i}."
        for s in ("img", "txt"):
            lin(b + s + "_mod.linear", d, 6 * d)
            lin(b + s + "_attn_qkv", d, 3 * d, c["qkv_bias"])
            out[b + s + "_attn_q_norm.weight"] = (hd,)
            out[b + s + "_attn_k_norm.weight"] = (hd,)
            lin(b + s + "_attn_proj", d, d, c["qkv_bias"])
            lin(b + s + "_mlp.fc1", d, f)
            lin(b + s + "_mlp.fc2", f, d)
    for i in range(c["mm_single_blocks_depth"]):
        b = f"single_blocks.{i}."
        lin(b + "linear1", d, 3 * d + f)
        lin(b + "linear2", d + f, d)
        out[b + "q_norm.weight"] = (hd,)
        out[b + "k_norm.weight"] = (hd,)
        lin(b + "modulation.linear", d, 3 * d)
    lin("final_layer.linear", d, c["out_channels"] * pt * ph * pw)
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    return out


def group_of(name: str) -> str:
    """A parameter's group: its block (`double_blocks.3`), or `embed`."""
    parts = name.split(".")
    if parts[0] in ("double_blocks", "single_blocks"):
        return ".".join(parts[:2])
    return "embed"


def groups(c: Dict) -> List[str]:
    return (["embed"]
            + [f"double_blocks.{i}"
               for i in range(c["mm_double_blocks_depth"])]
            + [f"single_blocks.{i}"
               for i in range(c["mm_single_blocks_depth"])])


# ---- pieces ----

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] → [B, dim]: cos ‖ sin of t·10000^(−i/(dim/2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    a = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def rope_tables(c: Dict, grid, device):
    """cos, sin [T·H·W, head_dim] of the video tokens, ordered (t, h, w),
    each axis's pair frequencies repeated for both members of a pair."""
    axes = [torch.arange(n, dtype=torch.float32) for n in grid]
    mesh = torch.meshgrid(*axes, indexing="ij")
    coss, sins = [], []
    for pos, dim in zip(mesh, c["rope_dim_list"]):
        f = 1.0 / (c["rope_theta"] ** (torch.arange(0, dim, 2)[:dim // 2]
                                       .float() / dim))
        a = torch.outer(pos.reshape(-1), f)
        coss.append(a.cos().repeat_interleave(2, dim=1))
        sins.append(a.sin().repeat_interleave(2, dim=1))
    return torch.cat(coss, 1).to(device), torch.cat(sins, 1).to(device)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, D] rotated by +θ in interleaved pairs: x·cos +
    rotate_half(x)·sin, rotate_half(x) = (−x[2j+1], x[2j])."""
    re, im = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    rh = torch.stack([-im, re], dim=-1).flatten(3)
    return x * cos[None, :, None, :] + rh * sin[None, :, None, :]


def rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def layer_norm(x: torch.Tensor, w=None, b=None) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w, b, EPS)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def gate(x, g):
    return x * g[:, None, :]


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x.pow(3))))


def attention(ops, q, k, v, segment: torch.Tensor,
              rows: int = 512) -> torch.Tensor:
    """softmax(q·kᵀ/√D)·v of [B, L, H, D], a query row attending the keys
    of its own segment (`segment` [B, L] ints), in blocks of query rows →
    [B, L, H·D]."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    outs = []
    for s in range(0, q.shape[1], rows):
        logits = ops.bmm(qh[:, :, s:s + rows], kh.transpose(-1, -2)) * scale
        same = segment[:, s:s + rows, None] == segment[:, None, :]
        logits = logits.masked_fill(~same[:, None], float("-inf"))
        outs.append(ops.bmm(torch.softmax(logits, dim=-1), vh))
    o = torch.cat(outs, dim=2)
    b, h, l, d = o.shape
    return o.transpose(1, 2).reshape(b, l, h * d)


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, nh, hd // nh)


def _mlp(ops, p, pre, x, act):
    h = act(ops.linear(x, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
    return ops.linear(h, p[pre + "fc2.weight"], p[pre + "fc2.bias"])


def _embedder(ops, p, pre, x):
    """Linear, SiLU, Linear under the names `pre` + (0, 2)."""
    h = F.silu(ops.linear(x, p[pre + "0.weight"], p[pre + "0.bias"]))
    return ops.linear(h, p[pre + "2.weight"], p[pre + "2.bias"])


# ---- the model ----

def refiner(ops, p, c: Dict, x: torch.Tensor, t: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """`SingleTokenRefiner`: text states x [B, Lt, td], mask [B, Lt] →
    [B, Lt, D]."""
    _, nh, _ = _dims(c)
    r = "txt_in."
    te = _embedder(ops, p, r + "t_embedder.mlp.", timestep_embedding(
        t, c["frequency_embedding_size"]))
    m = mask.float()[:, :, None]
    mean = (x * m).sum(dim=1) / m.sum(dim=1)
    ctx = ops.linear(F.silu(ops.linear(mean, p[r + "c_embedder.linear_1."
                                               "weight"],
                                       p[r + "c_embedder.linear_1.bias"])),
                     p[r + "c_embedder.linear_2.weight"],
                     p[r + "c_embedder.linear_2.bias"])
    cvec = te + ctx
    x = ops.linear(x, p[r + "input_embedder.weight"],
                   p[r + "input_embedder.bias"])
    valid = mask.bool()
    allowed = valid[:, :, None] & valid[:, None, :]
    allowed[:, :, 0] = True
    for i in range(c["refiner_depth"]):
        b = f"{r}individual_token_refiner.blocks.{i}."
        g_msa, g_mlp = ops.linear(F.silu(cvec),
                                  p[b + "adaLN_modulation.1.weight"],
                                  p[b + "adaLN_modulation.1.bias"]).chunk(2, 1)
        qkv = ops.linear(layer_norm(x, p[b + "norm1.weight"],
                                    p[b + "norm1.bias"]),
                         p[b + "self_attn_qkv.weight"],
                         p.get(b + "self_attn_qkv.bias"))
        q, k, v = (_heads(u, nh).transpose(1, 2) for u in qkv.chunk(3, -1))
        logits = ops.bmm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        logits = logits.masked_fill(~allowed[:, None], float("-inf"))
        a = ops.bmm(torch.softmax(logits, dim=-1), v)
        a = a.transpose(1, 2).reshape(x.shape)
        x = x + gate(ops.linear(a, p[b + "self_attn_proj.weight"],
                                p.get(b + "self_attn_proj.bias")), g_msa)
        x = x + gate(_mlp(ops, p, b + "mlp.", layer_norm(
            x, p[b + "norm2.weight"], p[b + "norm2.bias"]), F.silu), g_mlp)
    return x


def double_block(ops, p, c: Dict, i: int, img, txt, vec, cos, sin, segment):
    d, nh, _ = _dims(c)
    b = f"double_blocks.{i}."
    mods, qs, ks, vs = [], [], [], []
    for s, x in (("img", img), ("txt", txt)):
        m = ops.linear(F.silu(vec), p[b + s + "_mod.linear.weight"],
                       p[b + s + "_mod.linear.bias"]).chunk(6, dim=-1)
        mods.append(m)
        qkv = ops.linear(modulate(layer_norm(x), m[0], m[1]),
                         p[b + s + "_attn_qkv.weight"],
                         p.get(b + s + "_attn_qkv.bias"))
        q, k, v = (_heads(u, nh) for u in qkv.chunk(3, -1))
        q = rms(q, p[b + s + "_attn_q_norm.weight"])
        k = rms(k, p[b + s + "_attn_k_norm.weight"])
        if s == "img":
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        qs.append(q), ks.append(k), vs.append(v)
    a = attention(ops, torch.cat(qs, 1), torch.cat(ks, 1), torch.cat(vs, 1),
                  segment)
    li = img.shape[1]
    out = []
    for s, x, m, a_s in (("img", img, mods[0], a[:, :li]),
                         ("txt", txt, mods[1], a[:, li:])):
        x = x + gate(ops.linear(a_s, p[b + s + "_attn_proj.weight"],
                                p.get(b + s + "_attn_proj.bias")), m[2])
        x = x + gate(_mlp(ops, p, b + s + "_mlp.",
                          modulate(layer_norm(x), m[3], m[4]), gelu_tanh),
                     m[5])
        out.append(x)
    return out[0], out[1]


def single_block(ops, p, c: Dict, i: int, x, li: int, vec, cos, sin,
                 segment):
    d, nh, f = _dims(c)
    b = f"single_blocks.{i}."
    shift, scale, g = ops.linear(F.silu(vec),
                                 p[b + "modulation.linear.weight"],
                                 p[b + "modulation.linear.bias"]).chunk(3, -1)
    y = ops.linear(modulate(layer_norm(x), shift, scale),
                   p[b + "linear1.weight"], p[b + "linear1.bias"])
    q, k, v = (_heads(u, nh) for u in y[..., :3 * d].chunk(3, -1))
    q, k = rms(q, p[b + "q_norm.weight"]), rms(k, p[b + "k_norm.weight"])
    q = torch.cat([rotate(q[:, :li], cos, sin), q[:, li:]], 1)
    k = torch.cat([rotate(k[:, :li], cos, sin), k[:, li:]], 1)
    a = attention(ops, q, k, v, segment)
    out = ops.linear(torch.cat([a, gelu_tanh(y[..., 3 * d:])], -1),
                     p[b + "linear2.weight"], p[b + "linear2.bias"])
    return x + gate(out, g)


def forward(ops, P: Callable[[str], Dict[str, torch.Tensor]], c: Dict,
            x: torch.Tensor, t: torch.Tensor, text_states: torch.Tensor,
            text_mask: torch.Tensor, text_states_2: torch.Tensor,
            guidance: torch.Tensor, taps: Optional[Dict] = None
            ) -> torch.Tensor:
    """The velocity [B, C, T, H, W] of latents x [B, C, T, H, W] at model
    timesteps t [B] (1000·σ), with text_states [B, Lt, td], text_mask
    [B, Lt], text_states_2 [B, td2], guidance [B] (the scale × 1000).
    `P(group)` gives a group's float32 parameters. A `taps` dict receives
    the refiner's output [B, Lt, D] under "txt_in"."""
    d, _, _ = _dims(c)
    pt, ph, pw = c["patch_size"]
    e = P("embed")
    bsz, ch, tt, hh, ww = x.shape
    grid = (tt // pt, hh // ph, ww // pw)
    patches = x.float().reshape(bsz, ch, grid[0], pt, grid[1], ph, grid[2],
                                pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    img = ops.linear(patches.reshape(bsz, -1, ch * pt * ph * pw),
                     e["img_in.proj.weight"].reshape(d, -1),
                     e["img_in.proj.bias"])
    fe = c["frequency_embedding_size"]
    vec = _embedder(ops, e, "time_in.mlp.", timestep_embedding(t, fe))
    vec = vec + ops.linear(F.silu(ops.linear(
        text_states_2.float(), e["vector_in.in_layer.weight"],
        e["vector_in.in_layer.bias"])), e["vector_in.out_layer.weight"],
        e["vector_in.out_layer.bias"])
    if c["guidance_embed"]:
        vec = vec + _embedder(ops, e, "guidance_in.mlp.",
                              timestep_embedding(guidance, fe))
    txt = refiner(ops, e, c, text_states.float(), t, text_mask)
    if taps is not None:
        taps["txt_in"] = txt
    li = img.shape[1]
    cos, sin = rope_tables(c, grid, x.device)
    # the varlen layout: the video and the valid text rows one sequence
    # (0), the padded text rows another (1)
    segment = torch.cat([torch.zeros(bsz, li, dtype=torch.long,
                                     device=x.device),
                         (~text_mask.bool()).long()], dim=1)
    for i in range(c["mm_double_blocks_depth"]):
        img, txt = double_block(ops, P(f"double_blocks.{i}"), c, i, img, txt,
                                vec, cos, sin, segment)
    h = torch.cat([img, txt], dim=1)
    del img, txt
    for i in range(c["mm_single_blocks_depth"]):
        h = single_block(ops, P(f"single_blocks.{i}"), c, i, h, li, vec,
                         cos, sin, segment)
    shift, scale = ops.linear(F.silu(vec),
                              e["final_layer.adaLN_modulation.1.weight"],
                              e["final_layer.adaLN_modulation.1.bias"]
                              ).chunk(2, -1)
    y = ops.linear(modulate(layer_norm(h[:, :li]), shift, scale),
                   e["final_layer.linear.weight"],
                   e["final_layer.linear.bias"])
    y = y.reshape(bsz, *grid, c["out_channels"], pt, ph, pw)
    y = y.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return y.reshape(bsz, c["out_channels"], grid[0] * pt, grid[1] * ph,
                     grid[2] * pw)


# ---- the sampler ----

def grid(steps: int, shift: float):
    """(σ_i, σ_{i+1} − σ_i) of the N steps, first to last, each rounded to
    float32: σ = s(1 − i/N), s(σ) = shift·σ/(1 + (shift − 1)·σ)."""
    def s(v):
        return shift * v / (1 + (shift - 1) * v)
    sig, dsig = [], []
    for i in range(steps):
        a, b = s(1 - i / steps), s(1 - (i + 1) / steps)
        sig.append(float(torch.tensor(a, dtype=torch.float32)))
        dsig.append(float(torch.tensor(b - a, dtype=torch.float32)))
    return sig, dsig


def integrate(start: torch.Tensor, outs: List[torch.Tensor], steps: int,
              shift: float, acc_dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """The end of the trajectory from `start` given each step's velocity
    (`outs`, first to last): x ← x + (σ_{i+1} − σ_i)·v, accumulated in
    `acc_dtype`."""
    _, dsig = grid(steps, shift)
    acc = start.float().to(acc_dtype)
    for ds, v in zip(dsig, outs):
        acc = (acc.float() + ds * v.float()).to(acc_dtype)
    return acc.float()
