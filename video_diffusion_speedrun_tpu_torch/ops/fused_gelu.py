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

Both ops are `torch.autograd.Function`s (bf16 or fp32 x). On CPU tensors
they run the plain twins `bias_gelu_fwd_plain` and `bias_gelu_bwd_plain`,
fp32 inside; on CUDA tensors:

- the forward replaces the Pallas `_forward` (`ops/fused_gelu.py:157`) with
  the Triton kernel below. What bounds it: bytes — it reads x and writes y
  once (~0.54 GB at 2×8208×8192 bf16) at ~20 fp32 flops an element. The
  plain design reaches that: 2-D tiles over (rows, F), the bias loaded once
  a tile as a row vector.
- the backward replaces the Pallas `_backward` (`:184`) with the CUDA
  kernel of `csrc/bias_gelu_bwd.cu` (whose note gives the design), one
  launch a call. What bounds it: bytes — it reads x and g and writes dx
  once (415 MB at [64, 528, 2048] bf16) — with ~40 fp32 flops an element,
  and the dbias column sum runs across all rows, which the TPU kernel
  carries across its sequential row grid in VMEM. Why CUDA: the kernel
  keeps the next rows in flight by bulk copies into a shared-memory ring
  while it computes a row, and finishes the column sum in the same launch
  through release/acquire tickets between CTAs, in a fixed order (the same
  bits every launch). Triton leaves both to its compiler; its kernel waited
  on each tile's loads in program order and needed a torch sum and a cast
  after it. The host plans the work (`_bwd_plan`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.ops import _build

# bound at the first launch (triton is imported there, never at import:
# the CPU tests import this module on a machine without triton)
tl = None
_fwd_kernel = None

_LOG2E = 1.4426950408889634
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
# Abramowitz & Stegun 7.1.26 coefficients
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
# odd fits of Φ(x)-1/2 and gelu'(x)-1/2 on |x| ≤ _POLY_R, saturated to 0/1
# outside; the Triton helpers below and csrc/bias_gelu_bwd.cu spell the same
# numbers out
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

# the forward's launch shape: rows × columns of a tile, warps — the fastest
# of the shapes tried on the H100 at the MLP's shapes
_BLOCK_R, _BLOCK_F, _WARPS = 16, 512, 8


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


def _triton_kernel():
    global tl, _fwd_kernel, _tl_phi_poly, _tl_gelu_parts
    if _fwd_kernel is not None:
        return _fwd_kernel
    import triton
    import triton.language as tl

    # Triton kernels may not read Python globals that are not constexpr, so
    # the coefficients of `_PHI_C` and `_AS_A` are written out;
    # 0.23809523809523808 = 1 / _POLY_R

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

    _fwd_kernel = bias_gelu_fwd
    return _fwd_kernel


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
    kernel = _triton_kernel()
    with torch.cuda.device(x.device):
        kernel[(-(-n // _BLOCK_R), -(-f // block_f))](
            x, x if bias is None else bias, y, n, f, MODE=mode,
            HAS_BIAS=bias is not None, BLOCK_R=_BLOCK_R, BLOCK_F=block_f,
            num_warps=_WARPS)
    bias_gelu_forward.launches += 1
    return y


bias_gelu_forward.launches = 0


# ---------------------------------------------------------------------------
# the backward kernel (row 16): csrc/bias_gelu_bwd.cu
# ---------------------------------------------------------------------------

_LIB = "bias_gelu_bwd"
_SMEM_LIMIT = 232448  # dynamic shared memory of one block on sm_90
# the kernel's consumer warps a CTA, ring stages and rows a consumer thread
# takes from one stage (NW, STAGES, RPT)
_BWD_WARPS, _BWD_STAGES, _RPT = 8, 3, 4
# 16-byte chunks of a slab at most: 2 KB of a row
_SLAB_CHUNKS = 128
_DTYPES = (torch.bfloat16, torch.float32)


class _Params(ctypes.Structure):
    """`BiasGeluBwdParams` of csrc/bias_gelu_bwd.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "g", "bias", "dx", "dbias", "part", "ticket")]
        + [(n, ctypes.c_int) for n in (
            "N", "F", "fc", "slabs", "splits", "base", "rem", "group",
            "bias_bf16")])


class _BwdPlan(NamedTuple):
    """The backward's work over x [N, F], as the kernel does it: the columns
    in `slabs` slabs of `fc` (the last may be narrower), the rows in
    `splits` contiguous runs [start(k), start(k + 1)) that differ by at
    most one row; CTA c takes slab c % slabs of split c // slabs. Its
    consumer thread owns one chunk of `vec` columns of the slab in one of
    `row_groups` groups; group r takes rows start + r, start + r +
    row_groups, ... of the run. A slab's dbias adds, per split, the row
    groups' sums in group order; then the splits in order, in groups of
    `group` (split k in group k // group); then the group sums in order."""
    n: int
    f: int
    vec: int  # columns of a 16-byte chunk
    fc: int
    slabs: int
    splits: int
    base: int  # rows of a run; the first `rem` runs hold one more
    rem: int
    group: int  # splits a first-level finish adds

    @property
    def ctas(self) -> int:
        return self.slabs * self.splits

    @property
    def row_groups(self) -> int:
        """Consumer threads over the chunks of a slab."""
        return 32 * _BWD_WARPS // _build.cdiv(self.fc, self.vec)

    def start(self, k: int) -> int:
        return k * self.base + min(k, self.rem)

    def columns(self, slab: int) -> Tuple[int, int]:
        """[first, end) columns of the slab."""
        return slab * self.fc, min(self.f, (slab + 1) * self.fc)

    @property
    def split_groups(self) -> int:
        return _build.cdiv(self.splits, self.group)

    @property
    def tickets(self) -> int:
        """(slab, group of splits), then slab."""
        return self.slabs * (self.split_groups + 1)

    @property
    def scratch(self) -> int:
        """fp32 scratch of the finish: [splits + split_groups, F]."""
        return (self.splits + self.split_groups) * self.f


def _bwd_plan(n: int, f: int, t_size: int, ctas: int) -> _BwdPlan:
    """The plan of a launch of about `ctas` CTAs over x [n, f] of
    t_size-byte elements: at least two column slabs (where F has two
    chunks), each at most 2 KB of a row and one chunk a consumer thread, as
    even as whole chunks allow; the rows split `ctas // slabs` ways, at
    most one split a row; the finish in groups of ⌈√splits⌉ splits, so that
    both of its levels add about √splits rows. On the H100 2 KB slabs beat
    4 KB ones and whole rows at F = 2048 and 8192, and two slabs of 512
    bytes one of 1 KB at F = 512: the finish reads splits·(slab width)
    partials a slab, and neighbouring CTAs read the slabs of the same rows;
    1 KB slabs lost at F = 8192."""
    vec = 16 // t_size
    chunks = _build.cdiv(f, vec)
    per = min(32 * _BWD_WARPS, _SLAB_CHUNKS)
    slabs = max(min(2, chunks), _build.cdiv(chunks, per))
    fc = _build.cdiv(chunks, slabs) * vec
    slabs = _build.cdiv(f, fc)
    splits = max(1, min(n, ctas // slabs))
    return _BwdPlan(n, f, vec, fc, slabs, splits, n // splits, n % splits,
                    math.isqrt(splits - 1) + 1)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _bwd_smem(bulk: bool, fc: int, t_size: int) -> int:
    """Shared memory of one CTA, the layout of `smem_bytes` in the kernel:
    the ring (stages of x and g, RPT·row_groups rows of a slab each) and
    its mbarriers, the row groups' dbias sums, the flags."""
    vec = 16 // t_size
    nt = 32 * _BWD_WARPS
    n = 0
    if bulk:
        rows = _RPT * (nt // _build.cdiv(fc, vec))
        n = _align16(_BWD_STAGES * 2 * rows * fc * t_size) + _BWD_STAGES * 16
    return _align16(n + nt * vec * 4) + 16


# (device, flags, shared memory) → CTAs an SM holds
_occupancy: Dict[tuple, int] = {}
# (device, stream) → int32 tickets, zero between launches
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.bias_gelu_bwd.argtypes is None:
        lib.bias_gelu_bwd.argtypes = ([ctypes.POINTER(_Params)]
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int)])
        lib.bias_gelu_bwd.restype = ctypes.c_int
        lib.bias_gelu_bwd_smem.argtypes = [ctypes.c_int] * 3
        lib.bias_gelu_bwd_smem.restype = ctypes.c_longlong
    return lib


def _bwd_cuda(x, bias, g, mode: int):
    """One launch of csrc/bias_gelu_bwd.cu on contiguous x and g: (dx,
    dbias or None). Raises on what the kernel does not take."""
    if g.dtype != x.dtype:
        raise TypeError(f"g must have x's dtype {x.dtype}, got {g.dtype}")
    if bias is not None and bias.dtype not in _DTYPES:
        raise TypeError(f"the bias must be bf16 or fp32, got {bias.dtype}")
    if mode not in (BLOCK, POLY, ERF):
        raise ValueError(f"unknown bias+GELU mode {mode}")
    f = x.shape[-1] if x.dim() else 0
    n = x.numel() // f if f else 0
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"the bias+GELU backward takes 0 < rows < 2^31 and "
                         f"F > 0, got {tuple(x.shape)}")
    t_size = x.element_size()
    bulk = f * t_size % 16 == 0 and x.data_ptr() % 16 == 0 \
        and g.data_ptr() % 16 == 0
    fc = _bwd_plan(n, f, t_size, 1).fc
    smem = _bwd_smem(bulk, fc, t_size)
    flags = (int(x.dtype == torch.bfloat16), mode, int(bias is not None),
             int(bulk))
    lib = _library()
    dev = x.device
    p = _Params(F=f, fc=fc)
    with torch.cuda.device(dev):
        key = (dev.index, *flags, smem)
        occ = _occupancy.get(key)
        if occ is None:
            k = ctypes.c_int(0)
            _build.check(_LIB, lib.bias_gelu_bwd(ctypes.byref(p), *flags, None,
                                                 ctypes.byref(k)))
            if k.value < 1:
                raise ValueError(f"no CTA of the bias+GELU backward fits an "
                                 f"SM at F = {f}")
            occ = _occupancy[key] = k.value
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _bwd_plan(n, f, t_size, occ * n_sm)
        dx = torch.empty_like(x)
        dbias = part = tickets = None
        if bias is not None:
            stream = torch.cuda.current_stream(dev).cuda_stream
            tickets = _tickets.get((dev.index, stream))
            if tickets is None or tickets.numel() < plan.tickets:
                tickets = torch.zeros(max(plan.tickets, 1024),
                                      dtype=torch.int32, device=dev)
                _tickets[(dev.index, stream)] = tickets
            part = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
            dbias = torch.empty(f, dtype=bias.dtype, device=dev)
            p.bias, p.dbias = bias.data_ptr(), dbias.data_ptr()
            p.part, p.ticket = part.data_ptr(), tickets.data_ptr()
            p.bias_bf16 = int(bias.dtype == torch.bfloat16)
        p.x, p.g, p.dx = x.data_ptr(), g.data_ptr(), dx.data_ptr()
        p.N, p.slabs, p.splits = n, plan.slabs, plan.splits
        p.base, p.rem, p.group = plan.base, plan.rem, plan.group
        err = lib.bias_gelu_bwd(ctypes.byref(p), *flags,
                                torch.cuda.current_stream(dev).cuda_stream,
                                None)
    _build.check(_LIB, err)
    return dx, dbias


def bias_gelu_backward(x: torch.Tensor, bias: Optional[torch.Tensor],
                       g: torch.Tensor, mode: int):
    """The backward of `mode`: (dx, dbias or None, in the bias's dtype).
    One launch of csrc/bias_gelu_bwd.cu on CUDA tensors (g is copied first
    only if it is not contiguous), the twin on CPU tensors. `.launches`
    counts kernel launches."""
    if not x.is_cuda:
        return bias_gelu_bwd_plain(x, bias, g, mode)
    g = g.contiguous()
    _check(x, bias, g)
    out = _bwd_cuda(x, bias, g, mode)
    bias_gelu_backward.launches += 1
    return out


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
