"""Video DiT as an `nn.Module` (port of `models/dit.py`).

Same architecture as the JAX model: 3D patchify, register tokens, 3D RoPE,
timestep MLP, N blocks of [AdaLN-modulated self-attention + cross-attention
+ MLP] with value-residual mixing, final AdaLN + RMSNorm + projection,
unpatchify. Parameter names are the reference torch state-dict names
(`blocks.{i}.qkv`, `mlp.0`, `adaLN_modulation.1`, …), so the output of
`models/convert.py:state_dict_from_jax_params` loads with `strict=True`.

Each block follows `block_forward` (`models/dit.py:232-395` of the JAX
package) op for op, including where it dispatches to the fused ops
(`DiTConfig.attention_impl`, `DiTConfig.fused_adaln`): self-attention
takes the short kernel reading q/k from qkv up to SHORT_MAX_KV tokens and
the long path (`rope_flash_attention`) beyond, as `dit.py:287-299` does;
a no-RoPE model goes through `norope_flash_attention`. Under context
parallelism (`context_parallel`, a ring of `parallel/ring.py`; JAX's
`token_sharding`) the tokens are padded to the ring's layout, each rank
keeps its chunk, self-attention is the ring (`ring_flash_attention`: its
kernels, or their twins for CPU tensors) or, where JAX takes XLA
attention over the token-sharded axis (a no-RoPE model, "plain", CUDA
operands the kernels refuse under "auto"), the gathered attention
(`_gathered_attention`), and everything else stays per token; the output
is gathered over the ring after the final projection. Under tensor
parallelism (`DiTBlock.tp`, set by `parallel/fsdp.py:shard_model`) each
block computes on its rank's heads and MLP columns, Megatron-style: the
column-parallel products (qkv, q_cross, context_kv, the AdaLN modulation,
fc1) take this rank's output columns of the whole replicated input, the row-parallel ones (attn_proj, cross_proj,
fc2) sum their partial products over the tensor group and add their bias
once; the modulation is gathered whole. Where the fused
AdaLN runs, the MLP's bias + Φ-poly GELU after the fc1 product is the
bias+GELU kernel (`mlp_bias_gelu`, the JAX fc1 epilogue at
`dit.py:383-385`), and with `cfg.fused_residual` the joins after self- and
cross-attention fuse with the next norm (`gated_residual_adaln`,
`dit.py:312-325,356-366`). With `cfg.remat` and grad enabled, each block
runs under `torch.utils.checkpoint` and its backward recomputes the block,
as `jax.checkpoint` does (`dit.py:480-501`), reusing what
`cfg.remat_policy` keeps (`remat_context_fn`): under "nothing" the whole
block runs again, kernels included; "dots" keeps the outputs of the
products with no batch dims; "attn" the attention kernels' o and lse, so
the recompute launches no attention forward; "dots_attn" both.
"""

from __future__ import annotations

import math
from contextlib import ExitStack
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from video_diffusion_speedrun_tpu_torch.core.config import (
    DiTConfig,
    resolve_device,
)
from video_diffusion_speedrun_tpu_torch.models.rope import (
    apply_rotary,
    rope_cos_sin,
)
from video_diffusion_speedrun_tpu_torch.ops.attention import (
    dot_product_attention,
)
from video_diffusion_speedrun_tpu_torch.ops.embeddings import (
    timestep_embedding,
)
from video_diffusion_speedrun_tpu_torch.ops.fused_adaln import (
    adaln_rms_modulate,
    gated_residual_adaln,
)
from video_diffusion_speedrun_tpu_torch.ops.fused_attention import (
    SHORT_MAX_KV,
    cross_flash_attention,
    keep_attention_contexts,
    norope_flash_attention,
    qkv_rope_flash_attention,
    ring_flash_attention,
    ring_kbias,
    ring_layout,
    rope_flash_attention,
)
from video_diffusion_speedrun_tpu_torch.ops.fused_gelu import mlp_bias_gelu
from video_diffusion_speedrun_tpu_torch.ops.normalization import rms_norm
from video_diffusion_speedrun_tpu_torch.ops.patchify import (
    patchify,
    unpatchify,
)
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    copy_to_region,
    gather_from_region,
    reduce_from_region,
)


def _use_fused_adaln(cfg: DiTConfig, x: torch.Tensor) -> bool:
    return cfg.fused_adaln == "fused" or (
        cfg.fused_adaln == "auto" and x.is_cuda)


def fused_attention_takes(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA attention kernels accept these operands: bf16 and
    head_dim 64 or 128 (`ops/fused_attention.py:_check_qkv`)."""
    return dtype == torch.bfloat16 and head_dim in (64, 128)


def use_fused_attention(attention_impl: str, head_dim: int,
                        dtype: torch.dtype, on_cuda: bool,
                        context_parallel: bool = False,
                        rope: bool = True) -> bool:
    """Attention dispatch (JAX `_use_fused_attention`, `dit.py:211-229`).
    "fused" always takes the fused ops, which raise on operands the kernels
    refuse, as JAX's "pallas" does. "auto" takes them for CUDA tensors the
    kernels accept and the plain composition otherwise (the port of XLA
    attention, never a kernel's twin).

    Under context parallelism True means the ring and False the gathered
    attention (JAX's XLA attention over the token-sharded axis): a no-RoPE
    model (the ring kernels are RoPE-fused) and "plain" take the gathered
    attention everywhere; "auto" takes the ring for CPU tensors (its
    twins) and CUDA tensors its kernels accept, the gathered attention for
    the rest; "fused" takes the ring and raises ValueError at once for
    CUDA tensors the kernels refuse."""
    takes = fused_attention_takes(head_dim, dtype)
    if context_parallel:
        if not rope or attention_impl == "plain":
            return False
        if attention_impl == "fused" and on_cuda and not takes:
            raise ValueError(
                f"attention_impl 'fused' under context parallelism: the ring "
                f"kernels take bf16 with head_dim 64 or 128, got head_dim "
                f"{head_dim} and {dtype}")
        return attention_impl == "fused" or not on_cuda or takes
    if attention_impl == "fused":
        return True
    return attention_impl == "auto" and on_cuda and takes


def _use_fused_attention(cfg: DiTConfig, x: torch.Tensor) -> bool:
    return use_fused_attention(cfg.attention_impl, cfg.head_dim, x.dtype,
                               x.is_cuda)


def _ring_attention(cfg: DiTConfig, x: torch.Tensor, rope: bool) -> bool:
    """Whether self-attention under context parallelism runs the ring
    (else the gathered attention)."""
    return use_fused_attention(cfg.attention_impl, cfg.head_dim, x.dtype,
                               x.is_cuda, context_parallel=True, rope=rope)


def _gathered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cos: Optional[torch.Tensor],
                        sin: Optional[torch.Tensor], kbias: torch.Tensor,
                        num_heads: int, ring) -> torch.Tensor:
    """Self-attention under context parallelism without the ring: JAX's
    XLA attention over the token-sharded axis (`dit.py:300-309`, where
    GSPMD gathers k and v). q, k, v [B, lc, H·D] are the ring's local rows
    of the padded axis, cos/sin [lp, D/2] (None: no RoPE) and kbias [lp]
    cover all of it. Each rank rotates its q and k rows with their rows of
    the tables, gathers k and v over the ring (`ring.gather_kv`, whose
    backward sums their gradients over the ranks) and runs the plain
    composition of its q rows against the whole kv, the padded tail masked
    by the kv-bias."""
    b, lc, d = q.shape
    hd = d // num_heads
    qh, kh, vh = (t.reshape(b, lc, num_heads, hd).transpose(1, 2)
                  for t in (q, k, v))
    if cos is not None:
        cos, sin = ring.local(cos, dim=0), ring.local(sin, dim=0)
        qh, kh = apply_rotary(qh, cos, sin), apply_rotary(kh, cos, sin)
    kh, vh = ring.gather_kv(kh, dim=2), ring.gather_kv(vh, dim=2)
    out = dot_product_attention(qh, kh, vh, kbias=kbias)
    return out.transpose(1, 2).reshape(b, lc, d)


# the products with no batch dims: what `_dense` / `_column` / `_row` /
# the fused MLP's fc1 lower to (`F.linear` → addmm, `torch.matmul` of a
# 3-D input and a weight → mm); the attention's batched products (bmm)
# are not among them, in JAX either
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """JAX `dots_with_no_batch_dims_saveable` as a selective-checkpoint
    policy: keep the outputs of `_DOTS`, recompute everything else (the
    fused ops' allocations and launches included)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _Together:
    """Context managers entered together, in order, as one."""

    def __init__(self, managers):
        self.managers = managers

    def __enter__(self):
        self.stack = ExitStack()
        for m in self.managers:
            self.stack.enter_context(m)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def remat_context_fn(policy: str):
    """The `context_fn` of `torch.utils.checkpoint` for a remat policy
    (JAX `dit.py:486-497`): "nothing" none (the whole block runs again);
    "dots" selective checkpointing that keeps `_DOTS` outputs; "attn" the
    attention outputs (o, lse) kept and replayed
    (`ops/fused_attention.py:keep_attention_contexts`); "dots_attn" both
    pairs at once (JAX `save_from_both_policies`)."""
    if policy == "nothing":
        return noop_context_fn
    makers = []
    if policy in ("dots", "dots_attn"):
        makers.append(lambda: create_selective_checkpoint_contexts(_save_dots))
    if policy in ("attn", "dots_attn"):
        makers.append(keep_attention_contexts)

    def context_fn():
        pairs = [make() for make in makers]
        return (_Together([f for f, _ in pairs]),
                _Together([r for _, r in pairs]))

    return context_fn


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x·W + b in x's dtype (the compute dtype), as the JAX `_dense`."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _local(p: torch.Tensor) -> torch.Tensor:
    """A tensor-parallel parameter's local shard (a DTensor over the tensor
    sub-mesh), or the parameter itself."""
    return p.to_local() if isinstance(p, DTensor) else p


def _column(lin: nn.Linear, x: torch.Tensor, tp, split: int = 1
            ) -> torch.Tensor:
    """Column-parallel x·W + b: this rank's output columns (of the packed
    (split, heads, head_dim) layout for split > 1), from the whole
    replicated x, whose gradient the ranks sum."""
    if tp is None:
        return _dense(lin, x)
    bias = (None if lin.bias is None
            else tp.columns(lin.bias, split).to(x.dtype))
    return F.linear(copy_to_region(x, tp.group),
                    _local(lin.weight).to(x.dtype), bias)


def _row(lin: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """Row-parallel x·W + b from this rank's input columns: the partial
    products summed over the ranks, then the bias added once."""
    if tp is None:
        return _dense(lin, x)
    y = reduce_from_region(F.linear(x, _local(lin.weight).to(x.dtype)),
                           tp.group)
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


class RMSNorm(nn.Module):
    """Holds the optional trainable RMSNorm scale (`norm*.weight`); the norm
    itself runs inside `_norm_modulate`."""

    def __init__(self, dim: int, trainable: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim)) if trainable else None


def _norm_modulate(cfg: DiTConfig, x: torch.Tensor, norm: RMSNorm,
                   shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """modulate(rms_norm(x, γ), shift, scale): the fused op, or the plain
    composition (rms_norm rounds to x's dtype before the modulation)."""
    if _use_fused_adaln(cfg, x):
        return adaln_rms_modulate(x, shift, scale, norm.weight)
    xn = rms_norm(x, norm.weight)
    return xn * (1 + scale[:, None, :]) + shift[:, None, :]


class MLP(nn.Sequential):
    """`mlp.0` (fc1), GELU, `mlp.2` (fc2); the GELU is chosen per call."""

    def __init__(self, dim: int, hidden: int):
        super().__init__(nn.Linear(dim, hidden), nn.GELU(),
                         nn.Linear(hidden, dim))


class DiTBlock(nn.Module):
    # this rank's `TensorRegion` (parallel/fsdp.py) under tensor
    # parallelism: the block computes on its heads and MLP columns
    tp = None

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d = cfg.hidden_size
        bias = cfg.train_bias_and_rms
        self.cfg = cfg
        self.norm1 = RMSNorm(d, cfg.train_bias_and_rms)
        self.qkv = nn.Linear(d, 3 * d, bias=bias)
        self.attn_proj = nn.Linear(d, d, bias=False)
        self.norm3 = RMSNorm(d, cfg.train_bias_and_rms)
        self.mlp = MLP(d, cfg.mlp_hidden)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 9 * d))
        if cfg.residual_v:
            self.lambda_param = nn.Parameter(torch.full((1,), 0.5))
        if cfg.cross_attn_input_size is not None:
            self.norm2 = RMSNorm(d, cfg.train_bias_and_rms)
            self.q_cross = nn.Linear(d, d, bias=bias)
            self.context_kv = nn.Linear(cfg.cross_attn_input_size, 2 * d,
                                        bias=bias)
            self.cross_proj = nn.Linear(d, d, bias=False)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                t_emb: torch.Tensor, cos: Optional[torch.Tensor],
                sin: Optional[torch.Tensor], v0: Optional[torch.Tensor],
                context_kv: Optional[torch.Tensor] = None,
                context_parallel=None, kbias: Optional[torch.Tensor] = None,
                use_ring: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, v): v is the (value-residual-mixed) self-attention
        value; the model keeps block 0's as v0. v0 is None in block 0.
        With `context_parallel` (a ring), x holds the ring's local tokens of
        the padded axis, cos/sin [lp, D/2] and `kbias` [lp] cover all of
        it, and self-attention runs over the ring (`use_ring`, which the
        model decides once a forward) or gathers k and v.
        Under tensor parallelism (`self.tp`) x stays whole and replicated;
        the heads, the MLP columns and v/v0 are this rank's (nh and d below
        are local), and the AdaLN modulation is gathered whole."""
        cfg = self.cfg
        tp = self.tp
        ways = 1 if tp is None else tp.size
        nh, hd = cfg.num_heads // ways, cfg.head_dim
        b, l, _ = x.shape
        d = nh * hd

        if tp is None:
            mod = _dense(self.adaLN_modulation[1], F.silu(t_emb))  # [B, 9D]
        else:
            lin = self.adaLN_modulation[1]
            mod = gather_from_region(F.linear(
                copy_to_region(F.silu(t_emb), tp.group),
                _local(lin.weight).to(t_emb.dtype)), tp.group)
            mod = mod + lin.bias.to(mod.dtype)
        (shift_sa, scale_sa, gate_sa, shift_ca, scale_ca, gate_ca,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(9, dim=-1)

        # --- self-attention ---
        xn = _norm_modulate(cfg, x, self.norm1, shift_sa, scale_sa)
        qkv = _column(self.qkv, xn, tp, 3)  # [B, L, 3D], features (k, h, d)
        v = qkv[..., 2 * d:]
        if cfg.residual_v and v0 is not None:
            lam = self.lambda_param.to(x.dtype)
            v = lam * v + (1 - lam) * v0

        if context_parallel is not None:
            q, k = qkv[..., :d], qkv[..., d:2 * d]
            if use_ring:
                attn = ring_flash_attention(q, k, v, cos, sin, kbias, nh,
                                            context_parallel)
            else:
                attn = _gathered_attention(q, k, v, cos, sin, kbias, nh,
                                           context_parallel)
        elif _use_fused_attention(cfg, x):
            q, k = qkv[..., :d], qkv[..., d:2 * d]
            if cos is None:  # no-RoPE model
                attn = norope_flash_attention(q, k, v, nh)
            elif l <= SHORT_MAX_KV:  # q/k read straight from qkv
                attn = qkv_rope_flash_attention(qkv, v, cos, sin, nh)
            else:  # the long path: q/k rotated once, then the long kernel
                attn = rope_flash_attention(q, k, v, cos, sin, nh)
        else:
            qh, kh, vh = (t.reshape(b, l, nh, hd).transpose(1, 2)
                          for t in (qkv[..., :d], qkv[..., d:2 * d], v))
            if cos is not None:
                qh = apply_rotary(qh, cos, sin)
                kh = apply_rotary(kh, cos, sin)
            attn = dot_product_attention(qh, kh, vh)
            attn = attn.transpose(1, 2).reshape(b, l, d)
        attn = _row(self.attn_proj, attn, tp)
        has_cross = cfg.cross_attn_input_size is not None
        # fuse each residual join with the next sub-layer's norm prologue
        fuse_join = _use_fused_adaln(cfg, x) and cfg.fused_residual
        if fuse_join:
            norm, shift, scale = ((self.norm2, shift_ca, scale_ca) if has_cross
                                  else (self.norm3, shift_mlp, scale_mlp))
            x, xn = gated_residual_adaln(x, attn, gate_sa, shift, scale,
                                         norm.weight)
        else:
            x = x + attn * gate_sa[:, None, :]
            xn = None

        # --- cross-attention ---
        if has_cross:
            if xn is None:
                xn = _norm_modulate(cfg, x, self.norm2, shift_ca, scale_ca)
            qc = _column(self.q_cross, xn, tp)
            # [B, Lc, 2D], features (2, h, d): projected once per trajectory
            # by the sampler, or here from the context
            ckv = context_kv if context_kv is not None else _column(
                self.context_kv, context.to(x.dtype), tp, 2)
            lc = ckv.shape[1]
            if _use_fused_attention(cfg, x):
                cross = cross_flash_attention(qc, ckv[..., :d], ckv[..., d:],
                                              nh)
            else:
                qch = qc.reshape(b, l, nh, hd).transpose(1, 2)
                ckvh = ckv.reshape(b, lc, 2, nh, hd).permute(2, 0, 3, 1, 4)
                cross = dot_product_attention(qch, ckvh[0], ckvh[1])
                cross = cross.transpose(1, 2).reshape(b, l, d)
            cross = _row(self.cross_proj, cross, tp)
            if fuse_join:
                x, xn = gated_residual_adaln(x, cross, gate_ca, shift_mlp,
                                             scale_mlp, self.norm3.weight)
            else:
                x = x + cross * gate_ca[:, None, :]
                xn = None

        # --- MLP ---
        if xn is None:
            xn = _norm_modulate(cfg, x, self.norm3, shift_mlp, scale_mlp)
        fc1, fc2 = self.mlp[0], self.mlp[2]
        if _use_fused_adaln(cfg, x):
            # the JAX model's fc1 epilogue: bias in the compute dtype, then
            # h·Φ_poly(h) in fp32, one kernel
            if tp is None:
                h = torch.matmul(xn, fc1.weight.to(x.dtype).t())
                h = mlp_bias_gelu(h, fc1.bias.to(x.dtype))
            else:
                h = torch.matmul(copy_to_region(xn, tp.group),
                                 _local(fc1.weight).to(x.dtype).t())
                h = mlp_bias_gelu(h, tp.columns(fc1.bias).to(x.dtype))
        else:
            h = F.gelu(_column(fc1, xn, tp))  # exact erf GELU
        x = x + _row(fc2, h, tp) * gate_mlp[:, None, :]
        return x, v


class PatchEmbed(nn.Module):
    """Holds the Conv3d patch weight (`patch_embed.patch_proj`); the
    projection runs as reshape + matmul in `ops/patchify.py`."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        k = (cfg.time_patch_size, cfg.patch_size, cfg.patch_size)
        self.patch_proj = nn.Conv3d(cfg.in_channels, cfg.hidden_size, k,
                                    stride=k)


class DiT(nn.Module):
    """The video DiT. Built on `device` (default: the card; a CUDA device
    with no card present raises) with the init of the JAX `init_dit`,
    drawn from a `torch.Generator` seeded with `seed`."""

    def __init__(self, cfg: DiTConfig, *, device="cuda",
                 init_std_factor: float = 1.0, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.hidden_size
        with torch.device("meta"):
            self.patch_embed = PatchEmbed(cfg)
            self.register_tokens = nn.Parameter(
                torch.empty(1, cfg.num_registers, d))
            self.time_embed = nn.Sequential(
                nn.Linear(d, 4 * d), nn.SiLU(), nn.Linear(4 * d, d))
            self.blocks = nn.ModuleList(
                DiTBlock(cfg) for _ in range(cfg.depth))
            self.final_modulation = nn.Sequential(nn.SiLU(),
                                                  nn.Linear(d, 2 * d))
            self.final_norm = RMSNorm(d, cfg.train_bias_and_rms)
            self.final_proj = nn.Linear(d, cfg.out_patch_dim)
            if not cfg.use_rope:
                self.positional_embedding = nn.Parameter(
                    torch.empty(1, cfg.max_tokens_no_rope, d))
        self.to_empty(device=device)
        if device.type != "meta":  # meta: names and shapes only
            gen = torch.Generator(device=device).manual_seed(seed)
            self._init_weights(gen, init_std_factor)
        self.to(cfg.param_dtype)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator, std_factor: float) -> None:
        """`init_dit`: U(±1/√fan_in) weights and biases, 2-D weights scaled
        by `std_factor` except the patch projection; zero AdaLN and final
        layers; N(0, 1) registers; λ = 0.5; RMSNorm scales 1."""

        def uniform(lin: nn.Module, factor: float) -> None:
            fan_in = lin.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.weight.mul_(factor)
            if lin.bias is not None:
                lin.bias.uniform_(-bound, bound, generator=gen)

        def zero(lin: nn.Linear) -> None:
            lin.weight.zero_()
            lin.bias.zero_()

        uniform(self.patch_embed.patch_proj, 1.0)
        self.register_tokens.normal_(generator=gen)
        uniform(self.time_embed[0], std_factor)
        uniform(self.time_embed[2], std_factor)
        zero(self.final_modulation[1])
        zero(self.final_proj)
        if not self.cfg.use_rope:
            self.positional_embedding.zero_()
        for blk in self.blocks:
            for lin in (blk.qkv, blk.attn_proj, blk.mlp[0], blk.mlp[2]):
                uniform(lin, std_factor)
            zero(blk.adaLN_modulation[1])
            if self.cfg.residual_v:
                blk.lambda_param.fill_(0.5)
            if self.cfg.cross_attn_input_size is not None:
                for lin in (blk.q_cross, blk.context_kv, blk.cross_proj):
                    uniform(lin, std_factor)
        for mod in self.modules():
            if isinstance(mod, RMSNorm) and mod.weight is not None:
                mod.weight.fill_(1.0)

    def precompute_context_kv(self, context: torch.Tensor) -> torch.Tensor:
        """Every layer's cross-attention K/V [depth, B, Lc, 2D], projected
        once when the same context serves many forwards (sampling)."""
        ctx = context.to(self.cfg.compute_dtype)
        return torch.stack([_dense(blk.context_kv, ctx)
                            for blk in self.blocks])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                timesteps: torch.Tensor,
                rope_offsets: Optional[torch.Tensor] = None,
                context_kv: Optional[torch.Tensor] = None,
                context_parallel=None) -> torch.Tensor:
        """x [B, C, T, H, W], context [B, Lc, ctx_dim] (or None with
        `context_kv` [depth, B, Lc, 2D]), timesteps [B] → [B, C, T, H, W].
        `rope_offsets` [3] ints; zeros by default. `context_parallel`: the
        ring (`LocalRing` or `DistRing`) whose ranks split the token axis;
        every rank of it passes the same inputs and gets the whole
        output."""
        cfg = self.cfg
        r = cfg.num_registers
        tokens, t_emb, cos, sin = self.prefix(x, timesteps, rope_offsets)

        ring, kbias, l_all = context_parallel, None, tokens.shape[1]
        use_ring = False
        if ring is not None:
            # "fused" on operands the ring kernels refuse raises here, before
            # any block runs
            use_ring = _ring_attention(cfg, tokens, cos is not None)
            # pad to cp·chunk rows (the tail masked by the kv-bias) and keep
            # this rank's chunk; the tables and the bias stay whole (a no-RoPE
            # model's positional table is already in the tokens)
            _, lp = ring_layout(l_all, ring.size)
            tokens = ring.local(F.pad(tokens, (0, 0, 0, lp - l_all)))
            if cos is not None:
                cos, sin = (F.pad(t, (0, 0, 0, lp - l_all))
                            for t in (cos, sin))
            kbias = ring_kbias(l_all, lp, x.device)

        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = remat_context_fn(cfg.remat_policy)
        v0 = None
        for i, blk in enumerate(self.blocks):
            args = (tokens, context, t_emb, cos, sin, v0,
                    None if context_kv is None else context_kv[i], ring,
                    kbias, use_ring)
            if remat:
                tokens, v = checkpoint(blk, *args, use_reentrant=False,
                                       context_fn=context_fn)
            else:
                tokens, v = blk(*args)
            if i == 0:
                v0 = v

        if ring is None:
            return self.suffix(tokens, t_emb, self.grid(x))
        tokens = self.suffix(tokens, t_emb)
        # every rank gets the whole output
        return self.unpatchify(ring.gather(tokens)[:, r:l_all], self.grid(x))

    def grid(self, x: torch.Tensor) -> Tuple[int, int, int]:
        """The token grid (T, H, W) of a latent x [B, C, T, H, W]."""
        cfg = self.cfg
        return (x.shape[2] // cfg.time_patch_size,
                x.shape[3] // cfg.patch_size, x.shape[4] // cfg.patch_size)

    def prefix(self, x: torch.Tensor, timesteps: torch.Tensor,
               rope_offsets: Optional[torch.Tensor] = None):
        """What runs before the blocks (JAX `inloop.py:prefix_fn`): the
        patchified tokens behind the registers (plus the positional table
        of a no-RoPE model) [B, R+L, D], the timestep embedding [B, D],
        and the RoPE tables (None without RoPE)."""
        cfg = self.cfg
        cdt = cfg.compute_dtype
        b = x.shape[0]
        gt, gh, gw = self.grid(x)
        r = cfg.num_registers

        proj = self.patch_embed.patch_proj
        tokens = patchify(x, proj.weight.reshape(cfg.hidden_size, -1).t(),
                          proj.bias, cfg.time_patch_size, cfg.patch_size,
                          compute_dtype=cdt)
        regs = self.register_tokens.to(cdt).expand(b, r, cfg.hidden_size)
        tokens = torch.cat([regs, tokens], dim=1)  # [B, R+L, D]

        if cfg.use_rope:
            if rope_offsets is None:
                rope_offsets = torch.zeros(3, dtype=torch.int64)
            cos, sin = rope_cos_sin(
                cfg.head_dim, gt, gh, gw, rope_offsets.to(x.device),
                base=cfg.rope_base, num_registers=r, order=cfg.rope_order)
        else:
            cos = sin = None
            pos = self.positional_embedding[:, : tokens.shape[1]].to(cdt)
            tokens = tokens + pos

        t_emb = timestep_embedding(timesteps, cfg.hidden_size).to(cdt)
        t_emb = _dense(self.time_embed[2],
                       F.silu(_dense(self.time_embed[0], t_emb)))
        return tokens, t_emb, cos, sin

    def suffix(self, tokens: torch.Tensor, t_emb: torch.Tensor,
               grid: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        """What runs after the blocks (JAX `inloop.py:suffix_fn` without
        the loss): the final modulation, norm and projection of the tokens
        [B, R+L, D] → [B, L, patch], and with `grid` the unpatchified
        output [B, C, T, H, W]. Without `grid` the registers stay (a ring's
        local tokens, gathered by the caller)."""
        cfg = self.cfg
        if grid is not None:
            tokens = tokens[:, cfg.num_registers:, :]
        fmod = _dense(self.final_modulation[1], F.silu(t_emb))
        final_shift, final_scale = fmod.chunk(2, dim=-1)  # shift first
        tokens = _norm_modulate(cfg, tokens, self.final_norm, final_shift,
                                final_scale)
        tokens = _dense(self.final_proj, tokens)
        return tokens if grid is None else self.unpatchify(tokens, grid)

    def unpatchify(self, tokens: torch.Tensor, grid: Tuple[int, int, int]
                   ) -> torch.Tensor:
        cfg = self.cfg
        return unpatchify(tokens, *grid, cfg.time_patch_size, cfg.patch_size,
                          cfg.out_channels)
