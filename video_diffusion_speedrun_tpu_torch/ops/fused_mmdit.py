"""The fused ops of HunyuanVideo's MM-DiT blocks (`models/hunyuan_video.py`).

None replaces a Pallas kernel: the JAX package has no such model. Each runs
its kernel on a CUDA tensor and its plain twin (fp32 inside) on a CPU
tensor, and counts its launches in `.launches`.

- `qk_norm_rope`: per-head RMSNorm of q and k (affine over the head dim,
  eps 1e-6) and the RoPE rotation of the video rows by +θ in interleaved
  pairs, in place over the q and k columns of a qkv buffer; the text rows
  are normalised with their own weights and left unrotated. CUDA →
  `csrc/qk_norm_rope.cu` (whose note gives the design). It hands the long
  attention kernel its pre-rotated q and k, where the DiT's long path
  calls `rotate_flat`.
- `ln_modulate`: LayerNorm without affine (eps 1e-6) then x̂·(1 + scale) +
  shift, the published `modulate(norm(x), shift, scale)`. Triton, one
  program a row (the DiT's `adaln_rms_modulate` is RMS-only). Bytes bound:
  it reads x and writes y once.
- `gelu_tanh`: GELU with the tanh approximation of the optional bias sum,
  over strided row views in and out, so the single block's MLP half is read
  straight out of `linear1`'s output and written next to the attention
  output that `linear2` reads. Triton, 2-D tiles over rows × columns (the
  DiT's `bias_gelu` forward is the erf/Φ-polynomial one). Bytes bound.

Triton is imported at the first launch, never at import: the CPU tests
import this module on a machine without it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from video_diffusion_speedrun_tpu_torch.ops import _build

_LIB = "qk_norm_rope"
_EPS = 1e-6
_GELU_C = math.sqrt(2.0 / math.pi)
# the Triton kernels, built at the first launch
_ln_kernel = None
_gelu_kernel = None
_BLOCK_R = 16
_BLOCK_F = 256


# ---------------------------------------------------------------------------
# per-head q/k RMSNorm + RoPE of the video rows
# ---------------------------------------------------------------------------

def qk_norm_rope_plain(buf: torch.Tensor, n_img: int, num_heads: int,
                       wq: torch.Tensor, wk: torch.Tensor,
                       wq_txt: torch.Tensor, wk_txt: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       eps: float = _EPS) -> torch.Tensor:
    """The twin of `qk_norm_rope_cuda`, in place: fp32 inside, rounded once
    to buf's dtype."""
    rows = buf.shape[0]
    d = wq.shape[0]
    width = num_heads * d
    x = buf[:, :2 * width].float().reshape(rows, 2, num_heads, d)
    x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    w = torch.empty(rows, 2, 1, d, dtype=torch.float32, device=buf.device)
    w[:n_img, 0, 0], w[:n_img, 1, 0] = wq.float(), wk.float()
    w[n_img:, 0, 0], w[n_img:, 1, 0] = wq_txt.float(), wk_txt.float()
    x = x * w
    if n_img:
        xi = x[:n_img].unflatten(-1, (-1, 2))
        c, s = cos[:n_img, None, None, :], sin[:n_img, None, None, :]
        x0, x1 = xi[..., 0], xi[..., 1]
        x[:n_img] = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s],
                                dim=-1).flatten(-2)
    buf[:, :2 * width] = x.reshape(rows, 2 * width).to(buf.dtype)
    return buf


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.qk_norm_rope
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, LL, I, I, I, I, P, P, P, P, P, P, ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return lib


def qk_norm_rope_cuda(buf, n_img: int, num_heads: int, wq, wk, wq_txt,
                      wk_txt, cos, sin, eps: float = _EPS) -> torch.Tensor:
    """Launch `csrc/qk_norm_rope.cu` on buf bf16 [rows, ld]; same contract
    as the twin. Raises on anything the kernel does not take."""
    rows = buf.shape[0]
    d = wq.shape[0]
    if buf.dtype != torch.bfloat16 or buf.dim() != 2 or buf.stride(1) != 1 \
            or buf.stride(0) % 8 or buf.data_ptr() % 16:
        raise ValueError("buf must be bf16 [rows, ld] with unit column "
                         "stride, ld a multiple of 8, 16-byte aligned")
    if d != 128 or buf.shape[1] < 2 * num_heads * d:
        raise ValueError(f"the kernel takes head_dim 128 and q, k in the "
                         f"first {2 * num_heads * d} columns")
    for name, w in (("wq", wq), ("wk", wk), ("wq_txt", wq_txt),
                    ("wk_txt", wk_txt)):
        if w.dtype != torch.bfloat16 or w.shape != (d,) or w.device != \
                buf.device or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous bf16 [{d}] on "
                             f"{buf.device}")
    if not 0 <= n_img <= rows:
        raise ValueError(f"n_img {n_img} outside [0, {rows}]")
    if n_img:
        for name, t in (("cos", cos), ("sin", sin)):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.device != buf.device or t.shape[0] < n_img \
                    or t.shape[1] != d // 2 or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"[>= {n_img}, {d // 2}] on {buf.device}")
    lib = _library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.qk_norm_rope(
            buf.data_ptr(), buf.stride(0), rows, n_img, num_heads, d,
            wq.data_ptr(), wk.data_ptr(), wq_txt.data_ptr(), wk_txt.data_ptr(),
            cos.data_ptr() if n_img else None,
            sin.data_ptr() if n_img else None, eps, stream)
    _build.check(_LIB, err)
    return buf


def qk_norm_rope(buf: torch.Tensor, n_img: int, num_heads: int,
                 wq: torch.Tensor, wk: torch.Tensor,
                 wq_txt: Optional[torch.Tensor] = None,
                 wk_txt: Optional[torch.Tensor] = None,
                 cos: Optional[torch.Tensor] = None,
                 sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place over buf [rows, ld] (q in columns [0, H·D), k in [H·D,
    2·H·D)): q, k ← RMSNorm over each head (weights wq, wk of [D]; rows from
    `n_img` on take wq_txt, wk_txt, by default the same), then the rows
    below `n_img` rotated by cos/sin [>= n_img, D/2] in interleaved pairs.
    The kernel on a CUDA tensor, the twin on a CPU one. Returns buf."""
    wq_txt = wq if wq_txt is None else wq_txt
    wk_txt = wk if wk_txt is None else wk_txt
    if not buf.is_cuda:
        return qk_norm_rope_plain(buf, n_img, num_heads, wq, wk, wq_txt,
                                  wk_txt, cos, sin)
    qk_norm_rope_cuda(buf, n_img, num_heads, wq, wk, wq_txt, wk_txt, cos,
                      sin)
    qk_norm_rope.launches += 1
    return buf


qk_norm_rope.launches = 0


# ---------------------------------------------------------------------------
# LayerNorm modulation
# ---------------------------------------------------------------------------

def ln_modulate_plain(x: torch.Tensor, shift: torch.Tensor,
                      scale: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """LN(x)·(1 + scale[b]) + shift[b] over x [B, L, D], fp32 inside,
    rounded once to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * (1 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return y.to(x.dtype)


def _ln_triton():
    global _ln_kernel
    if _ln_kernel is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["L"])
        def hyv_ln_modulate(x_ptr, shift_ptr, scale_ptr, y_ptr, L, D, x_sb,
                            x_sl, mod_sb, eps, BLOCK_D: tl.constexpr):
            row = tl.program_id(0)
            b = tl.program_id(1)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            x_row = x_ptr + b.to(tl.int64) * x_sb + row.to(tl.int64) * x_sl
            x = tl.load(x_row + cols, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / D
            xc = tl.where(mask, x - mean, 0.0)
            r = tl.rsqrt(tl.sum(xc * xc, axis=0) / D + eps)
            mul = 1.0 + tl.load(scale_ptr + b * mod_sb + cols, mask=mask,
                                other=0.0).to(tl.float32)
            sh = tl.load(shift_ptr + b * mod_sb + cols, mask=mask,
                         other=0.0).to(tl.float32)
            y_row = y_ptr + (b.to(tl.int64) * L + row) * D
            tl.store(y_row + cols, (xc * r * mul + sh).to(
                y_ptr.dtype.element_ty), mask=mask)

        _ln_kernel = hyv_ln_modulate
    return _ln_kernel


def ln_modulate(x: torch.Tensor, shift: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [B, L, D] (rows may be strided; unit column stride), shift/scale
    [B, D] views with one row stride → y [B, L, D] contiguous: the Triton
    kernel on CUDA, the twin on the CPU."""
    if not x.is_cuda:
        return ln_modulate_plain(x, shift, scale)
    b, l, d = x.shape
    if x.stride(-1) != 1 or shift.shape != (b, d) or scale.shape != (b, d) \
            or shift.stride(-1) != 1 or scale.stride(-1) != 1 \
            or shift.stride(0) != scale.stride(0):
        raise ValueError("ln_modulate: x must have a unit column stride and "
                         "shift/scale be [B, D] views with one row stride")
    y = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    block = max(16, 1 << (d - 1).bit_length())
    with torch.cuda.device(x.device):
        _ln_triton()[(l, b)](x, shift, scale, y, l, d, x.stride(0),
                             x.stride(1), shift.stride(0), _EPS,
                             BLOCK_D=block,
                             num_warps=min(8, max(1, block // 256)))
    ln_modulate.launches += 1
    return y


ln_modulate.launches = 0


# ---------------------------------------------------------------------------
# GELU (tanh approximation)
# ---------------------------------------------------------------------------

def gelu_tanh_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0.5·s·(1 + tanh(√(2/π)·(s + 0.044715·s³))), s = x (+ bias), fp32
    inside, rounded once to x's dtype (into `out` where given)."""
    s = x.float() if bias is None else x.float() + bias.float()
    y = (0.5 * s * (1 + torch.tanh(_GELU_C * (s + 0.044715 * s * s * s)))
         ).to(x.dtype)
    if out is None:
        return y
    out.copy_(y)
    return out


def _gelu_triton():
    global _gelu_kernel
    if _gelu_kernel is None:
        import triton
        import triton.language as tl

        @triton.jit(do_not_specialize=["N"])
        def hyv_gelu_tanh(x_ptr, b_ptr, y_ptr, N, F, x_sr, y_sr,
                          HAS_BIAS: tl.constexpr, BLOCK_R: tl.constexpr,
                          BLOCK_F: tl.constexpr):
            rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
            cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
            cmask = cols < F
            mask = (rows < N)[:, None] & cmask[None, :]
            r64 = rows[:, None].to(tl.int64)
            s = tl.load(x_ptr + r64 * x_sr + cols[None, :], mask=mask,
                        other=0.0).to(tl.float32)
            if HAS_BIAS:
                s = s + tl.load(b_ptr + cols, mask=cmask,
                                other=0.0).to(tl.float32)[None, :]
            u = 0.7978845608028654 * (s + 0.044715 * s * s * s)
            # tanh(u) = 1 − 2/(e^{2u} + 1), saturating to ±1
            t = 1.0 - 2.0 / (tl.exp2(u * 2.8853900817779268) + 1.0)
            tl.store(y_ptr + r64 * y_sr + cols[None, :],
                     (0.5 * s * (1.0 + t)).to(y_ptr.dtype.element_ty),
                     mask=mask)

        _gelu_kernel = hyv_gelu_tanh
    return _gelu_kernel


def gelu_tanh(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GELU-tanh of x (+ bias) over x [N, F] and `out` [N, F] (a new tensor
    by default), either with any row stride and a unit column stride: the
    Triton kernel on CUDA, the twin on the CPU. Returns out."""
    if not x.is_cuda:
        return gelu_tanh_plain(x, bias, out)
    n, f = x.shape
    out = torch.empty_like(x) if out is None else out
    if x.stride(1) != 1 or out.shape != (n, f) or out.stride(1) != 1 \
            or out.dtype != x.dtype or out.device != x.device:
        raise ValueError("gelu_tanh: x and out must be [N, F] of one dtype "
                         "with unit column strides")
    if bias is not None and (bias.shape != (f,) or bias.stride(0) != 1):
        raise ValueError(f"gelu_tanh: bias must be a unit-stride [{f}]")
    with torch.cuda.device(x.device):
        _gelu_triton()[(-(-n // _BLOCK_R), -(-f // _BLOCK_F))](
            x, x if bias is None else bias, out, n, f, x.stride(0),
            out.stride(0), HAS_BIAS=bias is not None, BLOCK_R=_BLOCK_R,
            BLOCK_F=_BLOCK_F, num_warps=4)
    gelu_tanh.launches += 1
    return out


gelu_tanh.launches = 0
