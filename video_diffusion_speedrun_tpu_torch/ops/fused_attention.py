"""Fused RoPE + flash attention on the short path, flat [B, L, H·D] layout.

Port of the short path of `ops/fused_attention.py`: `_forward_short_qkv`
(self-attention, q/k read from the fused qkv projection, RoPE in the kernel)
and `_forward_short` through `cross_flash_attention` (RoPE off). On a CUDA
tensor both launch the hand-written kernel `csrc/short_attention_fwd.cu`;
on a CPU tensor they run its plain twin, `short_attention_plain`, which
keeps the kernel's rounding points. The public entries are
`torch.autograd.Function`s whose backward is `_backward_short_qkv` /
`_backward_short` (`_bwd_short_kernel`): the hand-written kernel
`csrc/short_attention_bwd.cu` on CUDA, its twin `short_attention_bwd_plain`
on the CPU.

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
_LIB_BWD = "short_attention_bwd"


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """y = [x1·c + x2·s, −x1·s + x2·c] over the last dim, fp32 in and out."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos + x2 * sin, -x1 * sin + x2 * cos], dim=-1)


def _rope_rotate_t(x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """The transpose (= inverse) rotation, dy → dx, fp32 in and out."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, H·D] → [B, H, L, D] fp32."""
    b, l, hd = t.shape
    return t.reshape(b, l, h, hd // h).transpose(1, 2).float()


def _flat(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, D] → [B, L, H·D] in `dtype`."""
    b, h, l, d = t.shape
    return t.to(dtype).transpose(1, 2).reshape(b, l, h * d)


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
    dt = v.dtype
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
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
    return _flat(acc / l, dt), (m + torch.log2(l)).squeeze(-1)


def short_attention_bwd_plain(q, k, v, cos, sin, o, lse, do, num_heads: int,
                              scale: float):
    """The backward kernel's plain twin: (dq, dk, dv) in the dtypes of q, k
    and v, from the forward's o [B, Lq, H·D] and exp2-domain lse [B, H, Lq]
    and the output gradient do. The rounding points of `_bwd_short_kernel`:
    rotated q and k round to v's dtype as qs = q·scale·log2e, qd = q·scale,
    kc = k, kd = k·scale; p and δ = rowsum(do ⊙ o) stay fp32, p rounds for
    dv = pᵀ·do, ds = p·(dp − δ) rounds for dq = ds·kd and dk = dsᵀ·qd, which
    rotate back by Rᵀ in fp32."""
    lq, lk = q.shape[1], k.shape[1]
    h = num_heads
    dt = v.dtype
    qh, kh, vh, doh = (_heads(t, h) for t in (q, k, v, do))
    if cos is not None:
        qh = _rope_rotate(qh, cos[:lq], sin[:lq])
        kh = _rope_rotate(kh, cos[:lk], sin[:lk])
    qs = (qh * (scale * _LOG2E)).to(dt).float()
    qd = (qh * scale).to(dt).float()
    kc = kh.to(dt).float()
    kd = (kh * scale).to(dt).float()
    delta = (doh * _heads(o, h)).sum(dim=-1, keepdim=True)
    p = torch.exp2(torch.matmul(qs, kc.transpose(-1, -2)) - lse[..., None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, kd)
    dk = torch.matmul(ds.transpose(-1, -2), qd)
    if cos is not None:
        dq = _rope_rotate_t(dq, cos[:lq], sin[:lq])
        dk = _rope_rotate_t(dk, cos[:lk], sin[:lk])
    return _flat(dq, q.dtype), _flat(dk, k.dtype), _flat(dv, dt)


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.short_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _library_bwd() -> ctypes.CDLL:
    lib = _build.load(_LIB_BWD)
    fn = lib.short_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 16 + [i] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
            i, p]
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


def _check_shapes(q, k, v, cos, sin, num_heads: int) -> None:
    """What both kernels refuse: head_dim other than 64/128, mismatched
    k/v, kv beyond the short path, non-bf16 or misaligned operands."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    if cos is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            if (t.device != q.device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.shape[0] < max(lq, lk)
                    or t.shape[1] != d // 2):
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"[>= {max(lq, lk)}, {d // 2}] on {q.device}")


def short_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: Optional[torch.Tensor],
                         sin: Optional[torch.Tensor], num_heads: int,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/short_attention_fwd.cu`; same contract as the twin.
    Raises on anything the kernel does not take."""
    _check_shapes(q, k, v, cos, sin, num_heads)
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    rope = cos is not None
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


def short_attention_bwd_cuda(q, k, v, cos, sin, o, lse, do, num_heads: int,
                            scale: float, dq: Optional[torch.Tensor] = None,
                            dk: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch `csrc/short_attention_bwd.cu`; same contract as the twin.
    dq/dk may be given as [B, L, H·D] views with unit column stride (the
    column slices of one d(qkv) buffer); dv is allocated contiguous.
    Raises on anything the kernel does not take."""
    _check_shapes(q, k, v, cos, sin, num_heads)
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    dev = q.device
    do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        _check_operand(name, t, dev)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q")
    if lse.shape != (b, num_heads, lq) or not lse.is_contiguous() \
            or lse.dtype != torch.float32:
        raise ValueError("lse must be contiguous fp32 [B, H, Lq]")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if dq is None else dq
    dk = torch.empty_like(k, memory_format=torch.contiguous_format) \
        if dk is None else dk
    dv = torch.empty((b, lk, hd), dtype=v.dtype, device=dev)
    for name, t, ref in (("dq", dq, q), ("dk", dk, k)):
        _check_operand(name, t, dev)
        if t.shape != ref.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match")
    scratch = dict(dtype=torch.bfloat16, device=dev)
    qs = torch.empty((b, num_heads, lq, d), **scratch)
    qd = torch.empty_like(qs)
    kc = torch.empty((b, num_heads, lk, d), **scratch)
    kd = torch.empty_like(kc)
    delta = torch.empty((b, num_heads, lq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 16)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:2]))
    rope = cos is not None
    lib = _library_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.short_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), cos.data_ptr() if rope else None,
            sin.data_ptr() if rope else None, qs.data_ptr(), qd.data_ptr(),
            kc.data_ptr(), kd.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, num_heads, lq, lk, d, strides,
            scale, scale * _LOG2E, int(rope), stream)
    _build.check(_LIB_BWD, err)
    return dq, dk, dv


def qkv_rope_flash_backward(qkv, v, cos, sin, o, lse, do, num_heads: int,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `qkv_rope_flash_forward`: d(qkv) [B, L, 3·H·D] with its
    v columns zero, and dv for the separately passed v (as the JAX
    `_qkv_rope_flash_bwd`, `ops/fused_attention.py:952-957`). On CUDA the
    kernel writes dq and dk straight into the column slices of d(qkv)."""
    hd = qkv.shape[-1] // 3
    q, k = qkv[..., :hd], qkv[..., hd:2 * hd]
    if not qkv.is_cuda:
        dq, dk, dv = short_attention_bwd_plain(q, k, v, cos, sin, o, lse, do,
                                               num_heads, scale)
        return torch.cat([dq, dk, torch.zeros_like(dq)], dim=-1), dv
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    dqkv[..., 2 * hd:].zero_()
    _, _, dv = short_attention_bwd_cuda(q, k, v, cos, sin, o, lse, do,
                                        num_heads, scale, dq=dqkv[..., :hd],
                                        dk=dqkv[..., hd:2 * hd])
    qkv_rope_flash_backward.launches += 1
    return dqkv, dv


qkv_rope_flash_backward.launches = 0


def cross_flash_backward(q, k, v, o, lse, do, num_heads: int, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `cross_flash_forward`."""
    if not q.is_cuda:
        return short_attention_bwd_plain(q, k, v, None, None, o, lse, do,
                                         num_heads, scale)
    out = short_attention_bwd_cuda(q, k, v, None, None, o, lse, do,
                                   num_heads, scale)
    cross_flash_backward.launches += 1
    return out


cross_flash_backward.launches = 0


class _QKVRopeFlash(torch.autograd.Function):
    """The JAX `_qkv_rope_flash` custom_vjp: saves (qkv, v, cos, sin, o,
    lse) and differentiates qkv and v."""

    @staticmethod
    def forward(ctx, qkv, v, cos, sin, num_heads, scale):
        o, lse = qkv_rope_flash_forward(qkv, v, cos, sin, num_heads, scale)
        ctx.save_for_backward(qkv, v, cos, sin, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, v, cos, sin, o, lse = ctx.saved_tensors
        dqkv, dv = qkv_rope_flash_backward(qkv, v, cos, sin, o, lse, do,
                                           ctx.num_heads, ctx.scale)
        return dqkv, dv, None, None, None, None


class _CrossFlash(torch.autograd.Function):
    """The JAX `_rope_flash` custom_vjp with RoPE off (the short path of
    `cross_flash_attention`): differentiates q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        o, lse = cross_flash_forward(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = cross_flash_backward(q, k, v, o, lse, do, ctx.num_heads,
                                          ctx.scale)
        return dq, dk, dv, None, None


def qkv_rope_flash_attention(qkv: torch.Tensor, v: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """Differentiable self-attention output of `qkv_rope_flash_forward`."""
    scale = (qkv.shape[-1] // (3 * num_heads)) ** -0.5
    return _QKVRopeFlash.apply(qkv, v, cos.float(), sin.float(), num_heads,
                               scale)


def cross_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Differentiable cross-attention output of `cross_flash_forward`."""
    scale = (q.shape[-1] // num_heads) ** -0.5
    return _CrossFlash.apply(q, k, v, num_heads, scale)
