"""Fused RoPE + flash attention on the short path, flat [B, L, H·D] layout.

Port of the short path of `ops/fused_attention.py`: `_forward_short_qkv`
(self-attention, q/k read from the fused qkv projection, RoPE in the kernel)
and `_forward_short` through `cross_flash_attention` (RoPE off). On a CUDA
tensor both launch the hand-written kernel `csrc/short_attention_fwd.cu`;
on a CPU tensor they run its plain twin, `short_attention_plain`, which
keeps the kernel's rounding points. The backward kernels come with the
training slice, so on CUDA an input that requires grad raises.

Head h of q, k and v lives in columns [h·D, (h+1)·D). The self-attention
entry reads q at column h·D and k at column (H+h)·D of qkv through strides;
the cross entry reads k/v as strided column views of the (2, h, d)-laid-out
context projection. Neither copies a slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.ops import _build

# the JAX package's short-path limit on the kv length; longer sequences take
# its blocked long path, which this port does not have yet
SHORT_MAX_KV = 2048
_LOG2E = 1.4426950408889634  # the softmax runs in the exp2 domain
_LIB = "short_attention_fwd"


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """y = [x1·c + x2·s, −x1·s + x2·c] over the last dim, fp32 in and out."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos + x2 * sin, -x1 * sin + x2 * cos], dim=-1)


def short_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: Optional[torch.Tensor],
                          sin: Optional[torch.Tensor], num_heads: int,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin. q [B, Lq, H·D], k/v [B, Lk, H·D] (strided
    views allowed), cos/sin [L, D/2] fp32 or None for no RoPE.

    Returns o [B, Lq, H·D] in v's dtype and the exp2-domain lse [B, H, Lq]
    fp32. q and k rotate in fp32, q takes scale·log2e, both round to v's
    dtype; logits and the row sum are fp32, p rounds to v's dtype for PV."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    h = num_heads
    d = hd // h
    dt = v.dtype
    qh = q.reshape(b, lq, h, d).transpose(1, 2).float()
    kh = k.reshape(b, lk, h, d).transpose(1, 2).float()
    vh = v.reshape(b, lk, h, d).transpose(1, 2).float()
    if cos is not None:
        qh = _rope_rotate(qh, cos[:lq], sin[:lq])
        kh = _rope_rotate(kh, cos[:lk], sin[:lk])
    qh = (qh * (scale * _LOG2E)).to(dt).float()
    kh = kh.to(dt).float()
    s = torch.matmul(qh, kh.transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(dt).float(), vh)
    o = (acc / l).to(dt).transpose(1, 2).reshape(b, lq, hd)
    return o, (m + torch.log2(l)).squeeze(-1)


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.short_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if t.dim() != 3 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, L, H·D] with unit column stride")
    if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides and start must allow 16-byte loads")


def short_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: Optional[torch.Tensor],
                         sin: Optional[torch.Tensor], num_heads: int,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/short_attention_fwd.cu`; same contract as the twin.
    Raises on anything the kernel does not take."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    if d not in (64, 128) or d * num_heads != hd:
        raise ValueError(f"CUDA short attention takes head_dim 64 or 128, "
                         f"got {hd}/{num_heads}")
    if k.shape != (b, lk, hd) or v.shape != (b, lk, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if lk > SHORT_MAX_KV:
        raise NotImplementedError(
            f"kv length {lk} exceeds the short path ({SHORT_MAX_KV}); the "
            "long attention path is not ported yet")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError("the CUDA attention kernel has no backward yet; "
                           "run under torch.no_grad()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    rope = cos is not None
    if rope:
        for name, t in (("cos", cos), ("sin", sin)):
            if (t.device != q.device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.shape[0] < max(lq, lk)
                    or t.shape[1] != d // 2):
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"[>= {max(lq, lk)}, {d // 2}] on {q.device}")
    o = torch.empty((b, lq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device)
    # k rotated once by the kernel's first launch, streamed by the second
    k_rot = torch.empty((b, lk, hd), dtype=k.dtype, device=k.device) \
        if rope else None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            cos.data_ptr() if rope else None, sin.data_ptr() if rope else None,
            k_rot.data_ptr() if rope else None, o.data_ptr(), lse.data_ptr(),
            b, num_heads, lq, lk, d, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), scale * _LOG2E, int(rope),
            stream)
    _build.check(_LIB, err)
    return o, lse


def qkv_rope_flash_forward(qkv: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE self-attention reading q/k from the fused projection qkv
    [B, L, 3·H·D] (feature layout (k, h, d)); v [B, L, H·D] is passed apart
    because the caller may have value-residual-mixed it. cos/sin [L, D/2].
    Returns (o [B, L, H·D], lse [B, H, L] fp32, exp2 domain)."""
    hd = qkv.shape[-1] // 3
    q, k = qkv[..., :hd], qkv[..., hd:2 * hd]
    scale = (hd // num_heads) ** -0.5 if scale is None else scale
    cos, sin = cos.float(), sin.float()
    if not qkv.is_cuda:
        return short_attention_plain(q, k, v, cos, sin, num_heads, scale)
    out = short_attention_cuda(q, k, v, cos, sin, num_heads, scale)
    qkv_rope_flash_forward.launches += 1
    return out


qkv_rope_flash_forward.launches = 0


def cross_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention without RoPE: q [B, Lq, H·D] against k/v [B, Lk, H·D]
    (the context's K/V, or q/k of a no-RoPE model). Returns (o, lse)."""
    scale = (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale
    if not q.is_cuda:
        return short_attention_plain(q, k, v, None, None, num_heads, scale)
    out = short_attention_cuda(q, k, v, None, None, num_heads, scale)
    cross_flash_forward.launches += 1
    return out


cross_flash_forward.launches = 0


def qkv_rope_flash_attention(qkv: torch.Tensor, v: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """Self-attention output of `qkv_rope_flash_forward`."""
    return qkv_rope_flash_forward(qkv, v, cos, sin, num_heads)[0]


def cross_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Cross-attention output of `cross_flash_forward`."""
    return cross_flash_forward(q, k, v, num_heads)[0]
