"""T5 v1.1 text encoder as `nn.Module`s (port of `text/t5.py`).

The frozen prompt encoder: RMS layer norm (no bias, no mean subtraction),
a relative position bias computed once in block 0 and shared by every
layer, unscaled attention (no 1/√d) with **no attention mask** (pads are
attended, as the reference's `encode_prompt_with_t5` does), gated-GELU
feed-forward with the tanh approximation, a final RMS norm.

Module and parameter names are those of transformers' `T5EncoderModel`
(`shared`, `encoder.block.{i}.layer.0.SelfAttention.q`, …), so a local HF
state dict loads with `load_state_dict` after `convert_torch_t5` drops the
keys the encoder has no use for. Every product and rounding point follows
the JAX functions: projections in the compute dtype, attention logits and
the softmax in fp32, probabilities cast back to the compute dtype, p·v
accumulated in fp32 and cast. Attention is plain `torch.matmul` and
softmax: the JAX encoder runs outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_diffusion_speedrun_tpu_torch.core.config import resolve_device


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    # "gated-gelu" (v1.1) or "relu" (original T5)
    feed_forward_proj: str = "gated-gelu"
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def xxl(cls) -> "T5Config":
        """google/t5-v1_1-xxl — FLUX.1-dev text_encoder_2 (4.76 B
        parameters: 9.5 GB in bf16)."""
        return cls()

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5LayerNorm as the JAX `_rms`: the variance in fp32, the normalised
    value cast back to the input dtype, then × scale in that dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing → [qlen, klen] int64:
    `log` of the fp32 n/max_exact + 1e-9, truncated toward zero."""
    ctx = torch.arange(qlen, device=device)[:, None]
    mem = torch.arange(klen, device=device)[None, :]
    rel = mem - ctx  # relative position of key wrt query
    num_buckets = num_buckets // 2
    ret = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32).long()
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **factory))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms(x, self.weight, self.eps)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, **factory):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.d_model, cfg.inner_dim
        self.q = nn.Linear(d, inner, bias=False, **factory)
        self.k = nn.Linear(d, inner, bias=False, **factory)
        self.v = nn.Linear(d, inner, bias=False, **factory)
        self.o = nn.Linear(inner, d, bias=False, **factory)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **factory)

    def position_bias(self, qlen: int, klen: int) -> torch.Tensor:
        """[1, heads, qlen, klen] fp32 additive bias (block 0's)."""
        cfg = self.cfg
        buckets = relative_position_buckets(
            qlen, klen, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
            device=self.relative_attention_bias.weight.device)
        bias = self.relative_attention_bias.weight[buckets]  # [q, k, heads]
        return bias.permute(2, 0, 1)[None].float()

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = cfg.compute_dtype
        b, l, _ = x.shape

        def proj(lin: nn.Linear) -> torch.Tensor:
            y = F.linear(x, lin.weight.to(cdt))
            return y.view(b, l, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = proj(self.q), proj(self.k), proj(self.v)  # no 1/√d_kv
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(logits, dim=-1).to(cdt)
        out = torch.matmul(probs.float(), v.float()).to(cdt)
        out = out.transpose(1, 2).reshape(b, l, cfg.inner_dim)
        return F.linear(out, self.o.weight.to(cdt))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config, **factory):
        super().__init__()
        self.cfg = cfg
        if cfg.feed_forward_proj == "gated-gelu":
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
        elif cfg.feed_forward_proj == "relu":
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
        else:
            raise ValueError(f"unknown feed_forward_proj: "
                             f"{cfg.feed_forward_proj}")
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.cfg.compute_dtype
        if self.cfg.feed_forward_proj == "gated-gelu":
            h = F.gelu(F.linear(x, self.wi_0.weight.to(cdt)),
                       approximate="tanh")  # gelu_new
            h = h * F.linear(x, self.wi_1.weight.to(cdt))
        else:
            h = F.relu(F.linear(x, self.wi.weight.to(cdt)))
        return F.linear(h, self.wo.weight.to(cdt))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, **factory):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias, **factory)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps,
                                      **factory)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, **factory):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg, **factory)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps,
                                      **factory)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, **factory):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, has_bias, **factory),
            T5LayerFF(cfg, **factory)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, shared: nn.Embedding, **factory):
        super().__init__()
        self.embed_tokens = shared  # tied, as in transformers
        self.block = nn.ModuleList(T5Block(cfg, i == 0, **factory)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps,
                                            **factory)


class T5Encoder(nn.Module):
    """The T5 encoder stack, its weights uninitialised on `device`: load a
    state dict, or build it with `init_t5`. `state_dict()` keys are
    transformers' `T5EncoderModel` names (`shared.weight`,
    `encoder.embed_tokens.weight` — the same tensor —
    `encoder.block.{i}.layer.{0,1}.…`, `encoder.final_layer_norm.weight`)."""

    def __init__(self, cfg: T5Config, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        with torch.device("meta"):  # no default init of 4.7 B weights
            self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                       dtype=dtype)
            self.encoder = T5Stack(cfg, self.shared, dtype=dtype)
        self.to_empty(device=device)

    def hidden_states(self, input_ids: torch.Tensor) -> List[torch.Tensor]:
        """The JAX `t5_encode`: transformers' `hidden_states` list —
        [embeddings, layer 1, …, layer N] with the last entry replaced by
        the post-final-norm output (N + 1 entries)."""
        cfg = self.cfg
        x = self.shared.weight[input_ids].to(cfg.compute_dtype)
        states = [x]
        blocks = self.encoder.block
        l = x.shape[1]
        bias = blocks[0].layer[0].SelfAttention.position_bias(l, l)
        for block in blocks:
            x = block(x, bias)
            states.append(x)
        states[-1] = self.encoder.final_layer_norm(x)
        return states

    def encode(self, input_ids: torch.Tensor,
               return_index: int = -1) -> torch.Tensor:
        """`hidden_states[return_index]`, re-normed by the final layer norm
        when return_index ≠ -1 (`encode_prompt_with_t5`)."""
        out = self.hidden_states(input_ids)[return_index]
        if return_index != -1:
            out = self.encoder.final_layer_norm(out)
        return out

    forward = encode


def convert_torch_t5(state_dict: Mapping[str, torch.Tensor],
                     cfg: T5Config) -> Dict[str, torch.Tensor]:
    """A transformers T5 state dict (encoder-only or full) → the keys of
    `T5Encoder(cfg).state_dict()`: the names already agree, so this keeps
    the encoder's keys (and fills the tied embedding from whichever of
    `shared.weight` / `encoder.embed_tokens.weight` is present)."""
    emb = state_dict.get("shared.weight",
                         state_dict.get("encoder.embed_tokens.weight"))
    if emb is None:
        raise KeyError("no token embedding (shared.weight or "
                       "encoder.embed_tokens.weight) in the state dict")
    out = {"shared.weight": emb, "encoder.embed_tokens.weight": emb}
    want = T5Encoder(cfg, device="meta").state_dict().keys()
    for key in want:
        if key not in out:
            out[key] = state_dict[key]
    return out


@torch.no_grad()
def init_t5(cfg: T5Config, *, device="cuda", dtype: torch.dtype = torch.float32,
            generator: Optional[torch.Generator] = None) -> T5Encoder:
    """Random init (tests, smoke runs; real weights come from a state dict)
    built in `dtype` on `device` with the JAX `init_t5` distributions:
    N(0, 1) embeddings, N(0, 1/fan_in) linears, 0.1·N(0, 1) relative bias,
    unit norms. At XXL size in bf16 that is 9.5 GB of device memory."""
    model = T5Encoder(cfg, device=device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=model.shared.weight.device)
        generator.manual_seed(0)
    for name, p in model.named_parameters():
        if name.endswith("layer_norm.weight"):
            p.fill_(1.0)
            continue
        p.normal_(generator=generator)
        if name.endswith("relative_attention_bias.weight"):
            p.mul_(0.1)
        elif p.ndim == 2 and not name.endswith("shared.weight"):
            p.mul_(1.0 / math.sqrt(p.shape[1]))
    return model.eval().requires_grad_(False)
