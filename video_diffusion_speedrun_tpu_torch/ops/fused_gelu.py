"""Fused bias + GELU (port of `ops/fused_gelu.py`).

Two ops of one kernel pair:

- `bias_gelu(x, bias=None)`: the JAX `bias_gelu` custom_vjp. GELU(x + bias)
  with the sum in fp32, Φ as the odd polynomial for bf16 x and as the A&S
  7.1.26 erf for fp32 x; the backward is `_dgelu_poly` or the A&S closed
  form, dbias the fp32 sum of the unrounded dx.
- `mlp_bias_gelu(h, bias)`: the DiT block's MLP epilogue
  (`models/dit.py:383-385` of the JAX package): hf = f32(h + bias in h's
  dtype), then hf·Φ_poly(hf). Its backward is what JAX's autodiff of that
  expression gives, g·(Φ_poly(hf) + hf·Φ_poly'(hf)) with Φ_poly' the
  derivative of the same polynomial, 0 outside |hf| < R; dh is rounded to
  h's dtype and dbias is the fp32 sum of that rounded dh. One intended
  difference: JAX's autodiff multiplies the diverging polynomial's
  derivative (±inf at |hf| ≳ 7e3) by the zero cotangent of the saturating
  select and gives NaN; here Φ_poly' is selected to 0 before it meets hf or
  g, so the gradient saturates to 0/1, as JAX's own `bias_gelu` gives.

Both ops are `torch.autograd.Function`s. Their forward replaces the Pallas
`_forward` (`ops/fused_gelu.py:157`), their backward the Pallas `_backward`
(`:184`). On CUDA tensors both launch the Triton kernels below (bf16 or
fp32); on CPU tensors they run the plain twins `bias_gelu_fwd_plain` and
`bias_gelu_bwd_plain`, fp32 inside.

What bounds it on the card: an elementwise pass with a few tens of fp32
flops an element (the polynomial), so bandwidth: the forward reads x and
writes y once (~0.54 GB at 2×8208×8192 bf16), the backward reads x and g
and writes dx. The design is the plain one: 2-D tiles over (rows, F), so
F = 8192 need not fit one program and the bias loads once per tile as a row
vector. The dbias column sum cannot carry across programs the way the TPU
kernel carries it across its row grid in VMEM: each backward program walks
256 rows of one column block, keeps a 2-D register partial, and writes one
fp32 row of partials [programs, F]; one torch sum over those finishes it.
"""

from __future__ import annotations

from typing import Optional

import torch

# bound at the first launch (triton is imported there, never at import:
# the CPU tests import this module on a machine without triton)
tl = None
_fwd_kernel = None
_bwd_kernel = None

_LOG2E = 1.4426950408889634
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
# Abramowitz & Stegun 7.1.26 coefficients
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
# odd fits of Φ(x)-1/2 and gelu'(x)-1/2 on |x| ≤ _POLY_R, saturated to 0/1
# outside; the Triton helpers below spell the same numbers out
_POLY_R = 4.2
_PHI_C = (1.6730854313132952, -4.819356366004858, 11.665324048457048,
          -19.2571592112833, 20.043393683968894, -11.692634553213583,
          2.887810706082727)
_DGELU_C = (3.3437508389045996, -19.301024758068174, 71.6240707797499,
            -169.03201824319132, 256.1130938463848, -239.9744046965949,
            125.8564616128173, -28.13100148328976)
# d/dt of the odd Φ polynomial: Σ (2i+1)·c_i·t^2i
_DPHI_C = tuple((2 * i + 1) * c for i, c in enumerate(_PHI_C))

# what the kernels compute of the pre-activation s
BLOCK = 0  # the MLP: s rounded to x's dtype, Φ_poly, exact Φ_poly'
POLY = 1  # `bias_gelu` on bf16: s in fp32, Φ_poly, `_dgelu_poly`
ERF = 2  # `bias_gelu` on fp32: s in fp32, A&S erf and its closed form

# launch shapes: rows × columns of a tile, warps; backward row tiles a
# program walks before writing its dbias partials — the fastest of the
# shapes tried on the H100 at the MLP's shapes (the forward barely moves)
_BLOCK_R, _BLOCK_F, _WARPS = 16, 512, 8
_BWD_ITERS = 16


def _even_poly(coeffs, t2: torch.Tensor) -> torch.Tensor:
    acc = t2 * coeffs[-1] + coeffs[-2]
    for c in reversed(coeffs[:-2]):
        acc = acc * t2 + c
    return acc


def _odd_poly(coeffs, t: torch.Tensor) -> torch.Tensor:
    return _even_poly(coeffs, t * t) * t


def _saturate(x: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """`inside` on |x| < R, exactly 0 / 1 beyond. The selects discard the
    diverging polynomial outside; NaN propagates."""
    return torch.where(x <= -_POLY_R, 0.0,
                       torch.where(x >= _POLY_R, 1.0, inside))


def _phi_poly(x: torch.Tensor) -> torch.Tensor:
    """Φ(x) = 0.5 + odd-poly(x/R) on |x| < R, exactly 0 / 1 beyond."""
    return _saturate(x, 0.5 + _odd_poly(_PHI_C, x * (1.0 / _POLY_R)))


def _dgelu_poly(x: torch.Tensor) -> torch.Tensor:
    """gelu'(x) as its own fit on |x| < R, exactly 0 / 1 beyond."""
    return _saturate(x, 0.5 + _odd_poly(_DGELU_C, x * (1.0 / _POLY_R)))


def _dphi_poly(x: torch.Tensor) -> torch.Tensor:
    """Φ_poly'(x) on |x| < R, 0 beyond (where Φ_poly is constant)."""
    t = x * (1.0 / _POLY_R)
    d = _even_poly(_DPHI_C, t * t) * (1.0 / _POLY_R)
    return torch.where(x.abs() < _POLY_R, d, 0.0)


def _erf(u: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 erf, fp32, exp2-domain exponential. |err| ≤ 1.5e-7."""
    a = u.abs()
    t = 1.0 / (1.0 + _AS_P * a)
    poly = t * (_AS_A[0] + t * (_AS_A[1] + t * (_AS_A[2] + t * (
        _AS_A[3] + t * _AS_A[4]))))
    return torch.sign(u) * (1.0 - poly * torch.exp2(-(a * a) * _LOG2E))


def _gelu_parts(x: torch.Tensor) -> torch.Tensor:
    """Φ(x) = 0.5(1 + erf(x/√2)) by the A&S erf."""
    return 0.5 * (1.0 + _erf(x * _INV_SQRT2))


def _preact(x, bias, mode: int) -> torch.Tensor:
    """The pre-activation s in fp32: x + bias, in x's dtype for the MLP."""
    if bias is None:
        return x.float()
    if mode == BLOCK:
        return (x + bias.to(x.dtype)).float()
    return x.float() + bias.float()


def bias_gelu_fwd_plain(x: torch.Tensor, bias: Optional[torch.Tensor],
                        mode: int) -> torch.Tensor:
    """Plain twin of the forward kernel: s·Φ(s) in x's dtype."""
    s = _preact(x, bias, mode)
    cdf = _gelu_parts(s) if mode == ERF else _phi_poly(s)
    return (s * cdf).to(x.dtype)


def bias_gelu_bwd_plain(x, bias, g, mode: int):
    """Plain twin of the backward kernel: (dx in x's dtype, dbias in the
    bias's dtype or None). Each derivative is selected before it meets s
    or g, so no 0·inf is formed."""
    s = _preact(x, bias, mode)
    if mode == BLOCK:
        dg = _phi_poly(s) + s * _dphi_poly(s)
    elif mode == POLY:
        dg = _dgelu_poly(s)
    else:
        pdf = torch.exp2(-(s * s) * (0.5 * _LOG2E)) * _INV_SQRT2PI
        dg = _gelu_parts(s) + s * pdf
    dx = g.float() * dg
    dx_out = dx.to(x.dtype)
    dbias = None
    if bias is not None:
        summed = dx_out.float() if mode == BLOCK else dx
        dbias = summed.reshape(-1, x.shape[-1]).sum(dim=0).to(bias.dtype)
    return dx_out, dbias


def _triton_kernels():
    global tl, _fwd_kernel, _bwd_kernel
    global _tl_phi_poly, _tl_dphi_poly, _tl_dgelu_poly, _tl_gelu_parts
    if _fwd_kernel is not None:
        return _fwd_kernel, _bwd_kernel
    import triton
    import triton.language as tl

    # Triton kernels may not read Python globals that are not constexpr, so
    # the coefficients of `_PHI_C`, `_DPHI_C`, `_DGELU_C` and `_AS_A` are
    # written out; 0.23809523809523808 = 1 / _POLY_R

    @triton.jit
    def _tl_phi_poly(x):
        t = x * 0.23809523809523808
        t2 = t * t
        acc = t2 * 2.887810706082727 + -11.692634553213583
        acc = acc * t2 + 20.043393683968894
        acc = acc * t2 + -19.2571592112833
        acc = acc * t2 + 11.665324048457048
        acc = acc * t2 + -4.819356366004858
        acc = acc * t2 + 1.6730854313132952
        phi = 0.5 + acc * t
        return tl.where(x <= -4.2, 0.0, tl.where(x >= 4.2, 1.0, phi))

    @triton.jit
    def _tl_dphi_poly(x):
        t = x * 0.23809523809523808
        t2 = t * t
        acc = t2 * 37.54153917907545 + -128.61898008534942
        acc = acc * t2 + 180.39054315572005
        acc = acc * t2 + -134.80011447898312
        acc = acc * t2 + 58.326620242285244
        acc = acc * t2 + -14.458069098014576
        acc = acc * t2 + 1.6730854313132952
        d = acc * 0.23809523809523808
        return tl.where(tl.abs(x) < 4.2, d, 0.0)

    @triton.jit
    def _tl_dgelu_poly(x):
        t = x * 0.23809523809523808
        t2 = t * t
        acc = t2 * -28.13100148328976 + 125.8564616128173
        acc = acc * t2 + -239.9744046965949
        acc = acc * t2 + 256.1130938463848
        acc = acc * t2 + -169.03201824319132
        acc = acc * t2 + 71.6240707797499
        acc = acc * t2 + -19.301024758068174
        acc = acc * t2 + 3.3437508389045996
        dg = 0.5 + acc * t
        return tl.where(x <= -4.2, 0.0, tl.where(x >= 4.2, 1.0, dg))

    @triton.jit
    def _tl_gelu_parts(x):
        u = x * 0.7071067811865476
        a = tl.abs(u)
        t = 1.0 / (1.0 + 0.3275911 * a)
        poly = t * (0.254829592 + t * (-0.284496736 + t * (
            1.421413741 + t * (-1.453152027 + t * 1.061405429))))
        e = 1.0 - poly * tl.exp2(-(a * a) * 1.4426950408889634)
        erf = tl.where(u > 0, e, tl.where(u < 0, -e, 0.0))
        return 0.5 * (1.0 + erf)

    @triton.jit
    def bias_gelu_fwd(x_ptr, b_ptr, y_ptr, N, F, MODE: tl.constexpr,
                      HAS_BIAS: tl.constexpr, BLOCK_R: tl.constexpr,
                      BLOCK_F: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
        cmask = cols < F
        mask = (rows < N)[:, None] & cmask[None, :]
        off = rows[:, None].to(tl.int64) * F + cols[None, :]
        s = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        if HAS_BIAS:
            b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
            if MODE == 0:  # the MLP: bias and sum in x's dtype
                b = b.to(x_ptr.dtype.element_ty)
            s = s + b.to(tl.float32)[None, :]
            if MODE == 0:
                s = s.to(x_ptr.dtype.element_ty).to(tl.float32)
        if MODE == 2:
            cdf = _tl_gelu_parts(s)
        else:
            cdf = _tl_phi_poly(s)
        tl.store(y_ptr + off, (s * cdf).to(y_ptr.dtype.element_ty),
                 mask=mask)

    @triton.jit
    def bias_gelu_bwd(x_ptr, b_ptr, g_ptr, dx_ptr, part_ptr, N, F,
                      MODE: tl.constexpr, HAS_BIAS: tl.constexpr,
                      BLOCK_R: tl.constexpr, BLOCK_F: tl.constexpr,
                      ITERS: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
        cmask = cols < F
        if HAS_BIAS:
            b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
            if MODE == 0:
                b = b.to(x_ptr.dtype.element_ty)
            b = b.to(tl.float32)
        # the dbias partial stays 2-D in registers across the row tiles;
        # one cross-row reduction at the end
        acc = tl.zeros([BLOCK_R, BLOCK_F], dtype=tl.float32)
        for it in range(ITERS):
            rows = (pid * ITERS + it) * BLOCK_R + tl.arange(0, BLOCK_R)
            mask = (rows < N)[:, None] & cmask[None, :]
            off = rows[:, None].to(tl.int64) * F + cols[None, :]
            s = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
            if HAS_BIAS:
                s = s + b[None, :]
                if MODE == 0:
                    s = s.to(x_ptr.dtype.element_ty).to(tl.float32)
            g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
            # every derivative is selected before it meets s or g
            if MODE == 0:
                dg = _tl_phi_poly(s) + s * _tl_dphi_poly(s)
            elif MODE == 1:
                dg = _tl_dgelu_poly(s)
            else:  # 0.7213475204444817 = _LOG2E / 2
                pdf = tl.exp2(-(s * s) * 0.7213475204444817) \
                    * 0.3989422804014327
                dg = _tl_gelu_parts(s) + s * pdf
            dx = g * dg
            dx_out = dx.to(dx_ptr.dtype.element_ty)
            tl.store(dx_ptr + off, dx_out, mask=mask)
            if HAS_BIAS:
                if MODE == 0:  # the MLP sums the rounded dh
                    acc += dx_out.to(tl.float32)
                else:
                    acc += dx
        if HAS_BIAS:
            tl.store(part_ptr + pid.to(tl.int64) * F + cols,
                     tl.sum(acc, axis=0), mask=cmask)

    _fwd_kernel, _bwd_kernel = bias_gelu_fwd, bias_gelu_bwd
    return _fwd_kernel, _bwd_kernel


def _check(x, bias, g=None) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bias+GELU takes bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if bias is not None:
        if bias.device != x.device:
            raise ValueError(f"bias is on {bias.device}, x on {x.device}")
        if bias.shape != x.shape[-1:] or bias.stride(-1) != 1:
            raise ValueError(f"bias must be a unit-stride [{x.shape[-1]}]")
    if g is not None and (g.shape != x.shape or g.device != x.device):
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")


def _tile_f(f: int) -> int:
    return min(_BLOCK_F, max(16, 1 << (f - 1).bit_length()))


def bias_gelu_forward(x: torch.Tensor, bias: Optional[torch.Tensor],
                      mode: int) -> torch.Tensor:
    """The forward of `mode` (BLOCK, POLY or ERF): the Triton kernel on
    CUDA, the twin on the CPU. `.launches` counts kernel launches."""
    if not x.is_cuda:
        return bias_gelu_fwd_plain(x, bias, mode)
    _check(x, bias)
    f = x.shape[-1]
    n = x.numel() // f
    y = torch.empty_like(x)
    block_f = _tile_f(f)
    kernel, _ = _triton_kernels()
    with torch.cuda.device(x.device):
        kernel[(-(-n // _BLOCK_R), -(-f // block_f))](
            x, x if bias is None else bias, y, n, f, MODE=mode,
            HAS_BIAS=bias is not None, BLOCK_R=_BLOCK_R, BLOCK_F=block_f,
            num_warps=_WARPS)
    bias_gelu_forward.launches += 1
    return y


bias_gelu_forward.launches = 0


def bias_gelu_backward(x: torch.Tensor, bias: Optional[torch.Tensor],
                       g: torch.Tensor, mode: int):
    """The backward of `mode`: (dx, dbias or None). The Triton kernel on
    CUDA, the twin on the CPU. `.launches` counts kernel launches."""
    if not x.is_cuda:
        return bias_gelu_bwd_plain(x, bias, g, mode)
    g = g.contiguous()
    _check(x, bias, g)
    f = x.shape[-1]
    n = x.numel() // f
    dx = torch.empty_like(x)
    block_f = _tile_f(f)
    n_prog = -(-n // (_BLOCK_R * _BWD_ITERS))
    part = torch.empty((n_prog, f) if bias is not None else (1,),
                       dtype=torch.float32, device=x.device)
    _, kernel = _triton_kernels()
    with torch.cuda.device(x.device):
        kernel[(n_prog, -(-f // block_f))](
            x, x if bias is None else bias, g, dx, part, n, f, MODE=mode,
            HAS_BIAS=bias is not None, BLOCK_R=_BLOCK_R, BLOCK_F=block_f,
            ITERS=_BWD_ITERS, num_warps=_WARPS)
    bias_gelu_backward.launches += 1
    dbias = None if bias is None else part.sum(dim=0).to(bias.dtype)
    return dx, dbias


bias_gelu_backward.launches = 0


class _BiasGelu(torch.autograd.Function):
    """The JAX `_bias_gelu` custom_vjp: saves the pre-bias x and the bias."""

    @staticmethod
    def forward(ctx, x, bias, mode):
        ctx.save_for_backward(x, bias)
        ctx.mode = mode
        return bias_gelu_forward(x, bias, mode)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, dbias = bias_gelu_backward(x, bias, g, ctx.mode)
        return dx, dbias, None


def bias_gelu(x: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GELU(x + bias) in one pass, exact-erf semantics: Φ-poly for bf16 x,
    the A&S erf for fp32 x (the JAX `bias_gelu`). x [..., F]; bias [F] or
    None. Differentiable in x and bias."""
    mode = POLY if x.dtype == torch.bfloat16 else ERF
    return _BiasGelu.apply(x, bias, mode)


def mlp_bias_gelu(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The DiT MLP's epilogue: hf = f32(h + bias in h's dtype), then
    hf·Φ_poly(hf) in h's dtype (the JAX block at `models/dit.py:383-385`),
    with the backward of JAX's autodiff of it, saturated outside |hf| < R.
    h [..., F] (fc1's product without its bias); bias [F]."""
    return _BiasGelu.apply(h, bias, BLOCK)
