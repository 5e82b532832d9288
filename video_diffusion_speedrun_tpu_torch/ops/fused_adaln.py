"""Fused AdaLN-modulated RMSNorm (port of `ops/fused_adaln.py`).

    y = rms_norm(x) · γ? · (1 + scale[b]) + shift[b],   fp32 inside

`adaln_rms_modulate` is a `torch.autograd.Function` (the JAX `_adaln_rms`
custom_vjp). Its forward replaces the Pallas `_forward`
(`ops/fused_adaln.py:68`, kernels `_fwd_kernel` / `_fwd_kernel_nogamma`)
with the Triton kernel below; its backward replaces the Pallas `_backward`
(`:156`, kernels `_bwd_kernel` / `_bwd_kernel_nogamma`) with the CUDA
kernel of `csrc/adaln_bwd.cu`. On CPU tensors both run the plain twins
`adaln_rms_modulate_plain` and `adaln_rms_modulate_bwd_plain`.

What bounds it on the card: one row reduction plus one elementwise pass, so
it is bandwidth-bound — it must read x and write y once (~17 MB at
2×1040×2048 bf16), a few flops a byte, far below the tensor cores' line.
The forward's design is therefore the plain one: each program owns one
whole row in registers (one read of x, one write of y, fp32 in between);
tensor cores and shared-memory staging buy nothing. x may be a strided row
view (the final layer strips the registers with a slice), and shift/scale
may be column views of the AdaLN projection, so nothing is copied before
the kernel.

The backward is bandwidth-bound too: it must read x and the output
gradient g and write dx (~104 MB at 64×528×512 bf16). Per row it recomputes
r = rsqrt(mean(x²)+eps), n = x·r and writes dx = r·(dn − n·mean(n·dn)),
dn = g·(1+scale)·γ?, and it sums the columns over L (dshift = Σg, dscale =
Σg·n·γ?, dγ = Σg·n·(1+scale)). Its kernel (`csrc/adaln_bwd.cu`, whose
note gives the design) keeps the next rows of every input in flight by
bulk copies into a shared-memory ring while it computes a row, and
finishes the column sums in the same launch in a fixed order: one launch
per backward, the same bits every launch. The host plans its work
(`_bwd_plan`, `_bwd_config`).

`gated_residual_adaln` fuses the block's residual join with the next
sub-layer's norm (the JAX `_gr_adaln` custom_vjp, `DiTConfig.fused_residual`):
x_new = x + δ·gate in fp32, stored in x's dtype, and y the modulated norm of
the unrounded fp32 x_new. Its forward replaces the Pallas `_gr_forward`
(`ops/fused_adaln.py:281`, kernels `_gr_fwd_kernel*`), one Triton program
per row as row 3 (read x and δ once, write x_new and y once); its backward
the Pallas `_gr_backward` (`:379`, `_gr_bwd_kernel*`), the same CUDA
kernel as row 12 with the residual cotangent gx added to dx, dδ = dx·gate,
and dgate = Σ_L dx·δ as a fourth column sum. It saves the rounded x_new,
not x, as JAX does.
"""

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from video_diffusion_speedrun_tpu_torch.ops import _build

# bound at the first launch (triton is imported there, never at import:
# the CPU tests import this module on a machine without triton)
tl = None
_kernel = None
_gr_kernel = None


def adaln_rms_modulate_plain(x: torch.Tensor, shift: torch.Tensor,
                             scale: torch.Tensor,
                             gamma: Optional[torch.Tensor] = None,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain twin: x [B, L, D]; shift/scale [B, D]; gamma [D] or None."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    mul = 1.0 + scale.float()
    if gamma is not None:
        mul = mul * gamma.float()
    return (n * mul[:, None, :] + shift.float()[:, None, :]).to(x.dtype)


def adaln_rms_modulate_bwd_plain(x, shift, scale, gamma, g, eps: float = 1e-6):
    """Plain twin of the backward (`_bwd_kernel`, fp32 inside): returns
    (dx, dshift, dscale, dγ or None) in the dtypes of x, shift, scale, γ."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    n = xf * r
    one_p_scale = 1.0 + scale.float()[:, None, :]
    dgamma = None
    if gamma is not None:
        gam = gamma.float()
        mul = one_p_scale * gam
        dgamma = (gf * n * one_p_scale).sum(dim=(0, 1)).to(gamma.dtype)
        dscale = (gf * n * gam).sum(dim=1)
    else:
        mul = one_p_scale
        dscale = (gf * n).sum(dim=1)
    dshift = gf.sum(dim=1)
    dn = gf * mul
    dx = r * (dn - n * (n * dn).sum(dim=-1, keepdim=True) / x.shape[-1])
    return dx.to(x.dtype), dshift.to(shift.dtype), dscale.to(scale.dtype), \
        dgamma


def _triton_kernel():
    global tl, _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def adaln_rms_modulate_fwd(x_ptr, shift_ptr, scale_ptr, gamma_ptr,
                                   y_ptr, L, D, x_sb, x_sl, mod_sb, eps,
                                   HAS_GAMMA: tl.constexpr,
                                   BLOCK_D: tl.constexpr):
            row = tl.program_id(0)
            b = tl.program_id(1)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            x_row = x_ptr + b.to(tl.int64) * x_sb + row.to(tl.int64) * x_sl
            x = tl.load(x_row + cols, mask=mask, other=0.0).to(tl.float32)
            r = tl.rsqrt(tl.sum(x * x, axis=0) / D + eps)
            mul = 1.0 + tl.load(scale_ptr + b * mod_sb + cols, mask=mask,
                                other=0.0).to(tl.float32)
            if HAS_GAMMA:
                mul = mul * tl.load(gamma_ptr + cols, mask=mask,
                                    other=0.0).to(tl.float32)
            sh = tl.load(shift_ptr + b * mod_sb + cols, mask=mask,
                         other=0.0).to(tl.float32)
            y = x * r * mul + sh
            y_row = y_ptr + (b.to(tl.int64) * L + row) * D
            tl.store(y_row + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

        _kernel = adaln_rms_modulate_fwd
    return _kernel


def _check_operands(x, shift, scale, gamma) -> None:
    b, l, d = x.shape
    operands = [("shift", shift), ("scale", scale)]
    if gamma is not None:
        operands.append(("gamma", gamma))
    for name, t in operands:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.shape[-1] != d or t.stride(-1) != 1:
            raise ValueError(f"{name} must end in a unit-stride dim of {d}")
    if shift.shape != (b, d) or scale.shape != (b, d) \
            or shift.stride(0) != scale.stride(0):
        raise ValueError("shift/scale must be [B, D] views with one row stride")
    if x.stride(-1) != 1:
        raise ValueError("x must have a unit column stride")


def _forward(x, shift, scale, gamma, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return adaln_rms_modulate_plain(x, shift, scale, gamma, eps)
    _check_operands(x, shift, scale, gamma)
    b, l, d = x.shape
    y = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    block = max(16, 1 << (d - 1).bit_length())
    kernel = _triton_kernel()
    with torch.cuda.device(x.device):
        kernel[(l, b)](x, shift, scale, x if gamma is None else gamma, y,
                       l, d, x.stride(0), x.stride(1), shift.stride(0), eps,
                       HAS_GAMMA=gamma is not None, BLOCK_D=block,
                       num_warps=min(8, max(1, block // 256)))
    adaln_rms_modulate.launches += 1
    return y


# ---------------------------------------------------------------------------
# the backward kernel of rows 12 and 14: csrc/adaln_bwd.cu
# ---------------------------------------------------------------------------

_LIB = "adaln_bwd"
# the kernel's instantiations: column partials in registers (16 or 32
# columns a lane, D ≤ 1024) or in shared memory, all with rows bulk-copied
# into the ring; or loads from global memory, each column checked (MASKED)
C16, C32, SMEM, MASKED = range(4)
_MAX_D = 8192
_SMEM_LIMIT = 232448  # dynamic shared memory of one block on sm_90
_RPW = 2  # rows a consumer warp takes from one stage (the kernel's RPW)
_DTYPES = (torch.bfloat16, torch.float32)


class _Params(ctypes.Structure):
    """`AdaLNBwdParams` of csrc/adaln_bwd.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "g", "gx", "dl", "scale", "gate", "gamma", "dx", "dd", "dshift",
        "dscale", "dgate", "dgamma", "part", "ticket")]
        + [(n, ctypes.c_longlong) for n in (
            "x_sb", "x_sl", "g_sb", "g_sl", "gx_sb", "gx_sl", "dl_sb",
            "dl_sl", "scale_sb", "gate_sb")]
        + [(n, ctypes.c_int) for n in (
            "B", "L", "D", "ctas", "base", "rem", "stages", "warps")]
        + [("eps", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in (
            "scale_bf16", "gate_bf16", "gamma_bf16", "dshift_bf16",
            "dscale_bf16", "dgate_bf16", "dgamma_bf16")])


class _BwdPlan(NamedTuple):
    """The backward's work over the B·L rows, as the kernel does it: CTA c
    owns the contiguous run [start(c), start(c + 1)), runs differing by at
    most one row; its rows of one b form a segment, whose column partials
    go to slot c + b. b's finish adds its CTAs' slots in CTA order, in
    groups of GROUP (CTAs c with c // GROUP equal; one group's sum is
    slot kg + b of the group slots), then the group sums in order; dγ adds
    the b's in b order, in groups of GROUP b's and then the groups. A
    CTA's warp w takes rows lo + w, lo + w + nw, ... of each segment."""
    b: int
    l: int
    ctas: int
    base: int  # rows of a run; the first `rem` runs hold one more
    rem: int

    GROUP = 8  # the kernel's GROUP

    def start(self, c: int) -> int:
        return c * self.base + min(c, self.rem)

    def cta_of(self, r: int) -> int:
        cut = self.rem * (self.base + 1)
        if r < cut:
            return r // (self.base + 1)
        return self.rem + (r - cut) // self.base

    def segments(self, c: int):
        """(b, first row, end row) of CTA c's run, cut at the b boundaries."""
        lo, end = self.start(c), self.start(c + 1)
        while lo < end:
            hi = min(end, (lo // self.l + 1) * self.l)
            yield lo // self.l, lo, hi
            lo = hi

    def finish_groups(self, bi: int):
        """b's CTAs in the groups whose slots the finish adds, in order."""
        c0 = self.cta_of(bi * self.l)
        c1 = self.cta_of((bi + 1) * self.l - 1)
        return [list(range(max(c0, k * self.GROUP),
                           min(c1, k * self.GROUP + self.GROUP - 1) + 1))
                for k in range(c0 // self.GROUP, c1 // self.GROUP + 1)]

    @property
    def slots(self) -> int:
        """(CTA, b) slots, indexed c + b."""
        return self.ctas + self.b - 1

    @property
    def group_slots(self) -> int:
        """(group, b) slots and tickets, indexed c // GROUP + b."""
        return _build.cdiv(self.ctas, self.GROUP) + self.b - 1

    @property
    def b_groups(self) -> int:
        """Groups of GROUP b's whose dγ rows add first."""
        return _build.cdiv(self.b, self.GROUP)

    @property
    def tickets(self) -> int:
        """(group, b), b, group of b's, dγ."""
        return self.group_slots + self.b + self.b_groups + 1

    def scratch(self, ns: int, d: int) -> int:
        """fp32 scratch of the finish: the slots and group slots of ns
        sums, dγ rows of the b's and of the groups of b's."""
        return (self.slots + self.group_slots) * ns * d \
            + (self.b + self.b_groups) * d


def _bwd_plan(b: int, l: int, ctas: int) -> _BwdPlan:
    """The plan of a launch of `ctas` CTAs (at most one a row) over B·L rows."""
    rows = b * l
    ctas = max(1, min(ctas, rows))
    return _BwdPlan(b, l, ctas, rows // ctas, rows % ctas)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _bwd_smem(mode: int, d: int, nw: int, stages: int, t_size: int,
              td_size: int, gated: bool, has_gamma: bool) -> int:
    """Shared memory of one CTA, the layout of `smem_bytes` in the kernel:
    the ring (stages of RPW·nw row slots) and its mbarriers, the per-b
    constants, the warps' partials."""
    vec = 16 // t_size
    ns = 2 + gated  # Σg, Σg·n (dscale and dγ), Σdx·δ
    nc = 1 + has_gamma + gated
    nk = _build.cdiv(d, vec)
    cpl = _build.cdiv(nk, 32) * vec
    n = 0
    if mode != MASKED:
        slot = d * (t_size * (3 if gated else 2) + (td_size if gated else 0))
        n = _align16(_RPW * nw * stages * slot) + stages * 16
    n = _align16(n + nc * nk * vec * 4)
    n = _align16(n + nw * ns * cpl * 32 * 4)
    return n + 16


def _bwd_config(d: int, t_size: int, td_size: int, gated: bool,
                has_gamma: bool, aligned: bool) -> Tuple[int, int, int]:
    """(mode, consumer warps a CTA, ring stages) of the backward. Rows that
    bulk copies can take get a ring of two stages and the most warps (8)
    whose ring fits a block's shared memory: on the H100 three or four
    stages were no faster and four warps a CTA slower (`chip_smoke.py
    --adaln-configs`). Others, or rows too wide for two stages, get the
    masked loads."""
    vec = 16 // t_size
    if aligned and d * t_size % 16 == 0 and d * td_size % 16 == 0:
        cpl = _build.cdiv(_build.cdiv(d, vec), 32) * vec
        mode = C16 if cpl <= 16 else C32 if cpl <= 32 else SMEM
        for nw in (8, 4, 2, 1):
            if _bwd_smem(mode, d, nw, 2, t_size, td_size, gated,
                         has_gamma) <= _SMEM_LIMIT:
                return mode, nw, 2
    for nw in (8, 4, 2, 1):
        if _bwd_smem(MASKED, d, nw, 0, t_size, td_size, gated,
                     has_gamma) <= _SMEM_LIMIT:
            return MASKED, nw, 0
    raise ValueError(f"the AdaLN backward takes D ≤ {_MAX_D}, got {d}")


# (device, flags, mode, warps, stages, D) → CTAs an SM holds
_occupancy: Dict[tuple, int] = {}
# (device, stream) → int32 tickets, zero between launches
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.adaln_bwd.argtypes is None:
        lib.adaln_bwd.argtypes = ([ctypes.POINTER(_Params)]
                                  + [ctypes.c_int] * 5
                                  + [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)])
        lib.adaln_bwd.restype = ctypes.c_int
        lib.adaln_bwd_smem.argtypes = [ctypes.c_int] * 8
        lib.adaln_bwd_smem.restype = ctypes.c_longlong
    return lib


def _bulk_aligned(t: torch.Tensor) -> bool:
    """Whether every row of t starts on 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or s * t.element_size() % 16 == 0
        for n, s in zip(t.shape[:2], t.stride()[:2]))


def _bwd_cuda(x, g, scale, gamma, eps: float, sum_dtypes, gx=None,
              delta=None, gate=None, config=None):
    """One launch of csrc/adaln_bwd.cu: (dx, dδ, dshift, dscale, dgate,
    dγ), dδ and dgate None for row 12 (gx is None), dγ None without γ.
    sum_dtypes: the dtypes of dshift, dscale and dgate. config (mode,
    warps, stages) overrides `_bwd_config`, to measure the design's
    choices. Raises on what the kernel does not take."""
    b, l, d = x.shape
    gated, has_gamma = gx is not None, gamma is not None
    rows = (x, g, gx, delta) if gated else (x, g)
    for t in rows:
        if t.dtype not in _DTYPES:
            raise TypeError(f"the AdaLN backward takes bf16 or fp32 rows, "
                            f"got {t.dtype}")
        if t.shape != x.shape or t.device != x.device or t.stride(-1) != 1:
            raise ValueError("the rows must be [B, L, D] on x's device with "
                             "a unit column stride")
    if g.dtype != x.dtype or (gated and gx.dtype != x.dtype):
        raise TypeError("the cotangents must have x's dtype")
    for t in (scale, gamma, gate):
        if t is not None and t.dtype not in _DTYPES:
            raise TypeError(f"scale, γ and gate must be bf16 or fp32, got "
                            f"{t.dtype}")
    if not 0 < d <= _MAX_D or b * l == 0 or b * l >= 2 ** 31:
        raise ValueError(f"the AdaLN backward takes 0 < D ≤ {_MAX_D} and "
                         f"0 < B·L < 2^31, got {tuple(x.shape)}")
    t_size = x.element_size()
    td_size = delta.element_size() if gated else t_size
    mode, nw, stages = config or _bwd_config(
        d, t_size, td_size, gated, has_gamma,
        all(_bulk_aligned(t) for t in rows))
    flags = (int(gated), int(has_gamma), int(x.dtype == torch.bfloat16),
             int(gated and delta.dtype == torch.bfloat16), mode)
    lib = _library()
    dev = x.device
    p = _Params(D=d, stages=stages, warps=nw)
    with torch.cuda.device(dev):
        key = (dev.index, *flags, nw, stages, d)
        occ = _occupancy.get(key)
        if occ is None:
            n = ctypes.c_int(0)
            _build.check(_LIB, lib.adaln_bwd(ctypes.byref(p), *flags, None,
                                             ctypes.byref(n)))
            if n.value < 1:
                raise ValueError(f"no CTA of the AdaLN backward fits an SM "
                                 f"at D = {d}, {nw} warps, {stages} stages")
            occ = _occupancy[key] = n.value
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _bwd_plan(b, l, occ * n_sm)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _tickets.get((dev.index, stream))
        if tickets is None or tickets.numel() < plan.tickets:
            tickets = torch.zeros(max(plan.tickets, 1024), dtype=torch.int32,
                                  device=dev)
            _tickets[(dev.index, stream)] = tickets
        ns = 2 + gated  # Σg, Σg·n (dscale and dγ), Σdx·δ
        part = torch.empty(plan.scratch(ns, d), dtype=torch.float32,
                           device=dev)
        dx = torch.empty((b, l, d), dtype=x.dtype, device=dev)
        dd = (torch.empty((b, l, d), dtype=delta.dtype, device=dev)
              if gated else None)
        dshift = torch.empty((b, d), dtype=sum_dtypes[0], device=dev)
        dscale = torch.empty((b, d), dtype=sum_dtypes[1], device=dev)
        dgate = (torch.empty((b, d), dtype=sum_dtypes[2], device=dev)
                 if gated else None)
        dgamma = (torch.empty(d, dtype=gamma.dtype, device=dev)
                  if has_gamma else None)

        def ptr(t):
            return None if t is None else t.data_ptr()

        def bf16(t):
            return int(t is not None and t.dtype == torch.bfloat16)

        p.x, p.g, p.gx, p.dl = ptr(x), ptr(g), ptr(gx), ptr(delta)
        p.scale, p.gate, p.gamma = ptr(scale), ptr(gate), ptr(gamma)
        p.dx, p.dd, p.dshift, p.dscale = ptr(dx), ptr(dd), ptr(dshift), \
            ptr(dscale)
        p.dgate, p.dgamma, p.part = ptr(dgate), ptr(dgamma), ptr(part)
        p.ticket = ptr(tickets)
        p.x_sb, p.x_sl = x.stride(0), x.stride(1)
        p.g_sb, p.g_sl = g.stride(0), g.stride(1)
        if gated:
            p.gx_sb, p.gx_sl = gx.stride(0), gx.stride(1)
            p.dl_sb, p.dl_sl = delta.stride(0), delta.stride(1)
            p.gate_sb = gate.stride(0)
        p.scale_sb = scale.stride(0)
        p.B, p.L = b, l
        p.ctas, p.base, p.rem = plan.ctas, plan.base, plan.rem
        p.eps = eps
        p.scale_bf16, p.gate_bf16, p.gamma_bf16 = bf16(scale), bf16(gate), \
            bf16(gamma)
        p.dshift_bf16, p.dscale_bf16 = bf16(dshift), bf16(dscale)
        p.dgate_bf16, p.dgamma_bf16 = bf16(dgate), bf16(dgamma)
        err = lib.adaln_bwd(ctypes.byref(p), *flags, stream, None)
    _build.check(_LIB, err)
    return dx, dd, dshift, dscale, dgate, dgamma


def adaln_rms_modulate_bwd(x, shift, scale, gamma, g, eps: float = 1e-6):
    """The backward: (dx, dshift, dscale, dγ or None) in the dtypes of x,
    shift, scale and γ. One launch of csrc/adaln_bwd.cu on CUDA tensors
    (g is copied first only if its columns are strided), the twin on CPU
    tensors."""
    if not x.is_cuda:
        return adaln_rms_modulate_bwd_plain(x, shift, scale, gamma, g, eps)
    _check_operands(x, shift, scale, gamma)
    if g.stride(-1) != 1:
        g = g.contiguous()
    dx, _, dshift, dscale, _, dgamma = _bwd_cuda(
        x, g, scale, gamma, eps, (shift.dtype, scale.dtype, None))
    adaln_rms_modulate_bwd.launches += 1
    return dx, dshift, dscale, dgamma


adaln_rms_modulate_bwd.launches = 0


class _AdaLNRms(torch.autograd.Function):
    """The JAX `_adaln_rms` custom_vjp: saves (x, shift, scale, γ)."""

    @staticmethod
    def forward(ctx, x, shift, scale, gamma, eps):
        ctx.save_for_backward(x, shift, scale, gamma)
        ctx.eps = eps
        return _forward(x, shift, scale, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, shift, scale, gamma = ctx.saved_tensors
        dx, dshift, dscale, dgamma = adaln_rms_modulate_bwd(
            x, shift, scale, gamma, g, ctx.eps)
        return dx, dshift, dscale, dgamma, None


def adaln_rms_modulate(x: torch.Tensor, shift: torch.Tensor,
                       scale: torch.Tensor,
                       gamma: Optional[torch.Tensor] = None,
                       eps: float = 1e-6) -> torch.Tensor:
    """`rms_norm(x[, gamma]) * (1 + scale) + shift` in one pass,
    differentiable in x, shift, scale and γ.

    x [B, L, D] (rows may be strided); shift/scale [B, D] (unit column
    stride, one row stride); gamma [D] or None. Returns a contiguous
    [B, L, D] in x's dtype. `adaln_rms_modulate.launches` counts forward
    kernel launches.
    """
    return _AdaLNRms.apply(x, shift, scale, gamma, eps)


adaln_rms_modulate.launches = 0


# ---------------------------------------------------------------------------
# gated residual + AdaLN-RMSNorm: x_new = x + δ·gate; y = modulated-norm(x_new)
# ---------------------------------------------------------------------------


def gated_residual_adaln_plain(x, delta, gate, shift, scale, gamma=None,
                               eps: float = 1e-6):
    """Plain twin of the forward (`_gr_fwd_kernel`, fp32 inside): (x_new,
    y) in x's dtype, y normalising the unrounded fp32 x_new."""
    xf = x.float() + delta.float() * gate.float()[:, None, :]
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    mul = 1.0 + scale.float()
    if gamma is not None:
        mul = mul * gamma.float()
    y = n * mul[:, None, :] + shift.float()[:, None, :]
    return xf.to(x.dtype), y.to(x.dtype)


def gated_residual_adaln_bwd_plain(x_new, delta, gate, scale, gamma, gx, gy,
                                   eps: float = 1e-6):
    """Plain twin of the backward (`_gr_bwd_kernel`, fp32 inside), from the
    saved x_new: (dx, dδ, dgate, dshift, dscale, dγ or None) in the dtypes
    of x_new, δ, gate, gy, gy and γ."""
    xf, gyf = x_new.float(), gy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    n = xf * r
    one_p_scale = 1.0 + scale.float()[:, None, :]
    dgamma = None
    if gamma is not None:
        gam = gamma.float()
        mul = one_p_scale * gam
        dgamma = (gyf * n * one_p_scale).sum(dim=(0, 1)).to(gamma.dtype)
        dscale = (gyf * n * gam).sum(dim=1)
    else:
        mul = one_p_scale
        dscale = (gyf * n).sum(dim=1)
    dshift = gyf.sum(dim=1)
    dn = gyf * mul
    dx = r * (dn - n * (n * dn).sum(dim=-1, keepdim=True) / x_new.shape[-1])
    dx = dx + gx.float()  # the residual stream's cotangent
    ddelta = dx * gate.float()[:, None, :]
    dgate = (dx * delta.float()).sum(dim=1)
    return (dx.to(x_new.dtype), ddelta.to(delta.dtype), dgate.to(gate.dtype),
            dshift.to(gy.dtype), dscale.to(gy.dtype), dgamma)


def _triton_gr_kernel():
    global tl, _gr_kernel
    if _gr_kernel is not None:
        return _gr_kernel
    import triton
    import triton.language as tl

    @triton.jit
    def gated_residual_adaln_fwd(x_ptr, d_ptr, gate_ptr, shift_ptr,
                                 scale_ptr, gamma_ptr, xn_ptr, y_ptr, L, D,
                                 x_sb, x_sl, d_sb, d_sl, mod_sb, eps,
                                 HAS_GAMMA: tl.constexpr,
                                 BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + b.to(tl.int64) * x_sb + row.to(tl.int64) * x_sl
                    + cols, mask=mask, other=0.0).to(tl.float32)
        dl = tl.load(d_ptr + b.to(tl.int64) * d_sb + row.to(tl.int64) * d_sl
                     + cols, mask=mask, other=0.0).to(tl.float32)
        gate = tl.load(gate_ptr + b * mod_sb + cols, mask=mask,
                       other=0.0).to(tl.float32)
        xf = x + dl * gate
        out_row = (b.to(tl.int64) * L + row) * D
        tl.store(xn_ptr + out_row + cols, xf.to(xn_ptr.dtype.element_ty),
                 mask=mask)
        # the norm of the unrounded sum
        r = tl.rsqrt(tl.sum(xf * xf, axis=0) / D + eps)
        mul = 1.0 + tl.load(scale_ptr + b * mod_sb + cols, mask=mask,
                            other=0.0).to(tl.float32)
        if HAS_GAMMA:
            mul = mul * tl.load(gamma_ptr + cols, mask=mask,
                                other=0.0).to(tl.float32)
        sh = tl.load(shift_ptr + b * mod_sb + cols, mask=mask,
                     other=0.0).to(tl.float32)
        y = xf * r * mul + sh
        tl.store(y_ptr + out_row + cols, y.to(y_ptr.dtype.element_ty),
                 mask=mask)

    _gr_kernel = gated_residual_adaln_fwd
    return _gr_kernel


def _check_gr_operands(x, delta, gate, shift, scale, gamma) -> None:
    for name, t in (("x", x), ("delta", delta)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} must be bf16 or fp32, got {t.dtype}")
    if delta.shape != x.shape or delta.device != x.device \
            or delta.stride(-1) != 1:
        raise ValueError("delta must match x, with a unit column stride")
    _check_operands(x, shift, scale, gamma)
    if gate.device != x.device or gate.shape != shift.shape \
            or gate.stride() != shift.stride():
        raise ValueError("gate must be a [B, D] view with shift's strides")


def _gr_forward(x, delta, gate, shift, scale, gamma, eps: float):
    if not x.is_cuda:
        return gated_residual_adaln_plain(x, delta, gate, shift, scale, gamma,
                                          eps)
    _check_gr_operands(x, delta, gate, shift, scale, gamma)
    b, l, d = x.shape
    x_new = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x_new)
    block = max(16, 1 << (d - 1).bit_length())
    kernel = _triton_gr_kernel()
    with torch.cuda.device(x.device):
        kernel[(l, b)](x, delta, gate, shift, scale,
                       x if gamma is None else gamma, x_new, y, l, d,
                       x.stride(0), x.stride(1), delta.stride(0),
                       delta.stride(1), shift.stride(0), eps,
                       HAS_GAMMA=gamma is not None, BLOCK_D=block,
                       num_warps=min(8, max(1, block // 256)))
    gated_residual_adaln.launches += 1
    return x_new, y


def gated_residual_adaln_bwd(x_new, delta, gate, scale, gamma, gx, gy,
                             eps: float = 1e-6):
    """The backward from the saved x_new: (dx, dδ, dgate, dshift, dscale,
    dγ or None). One launch of csrc/adaln_bwd.cu on CUDA tensors (gx / gy
    copied first only if their columns are strided), the twin on CPU
    tensors."""
    if not x_new.is_cuda:
        return gated_residual_adaln_bwd_plain(x_new, delta, gate, scale,
                                              gamma, gx, gy, eps)
    _check_gr_operands(x_new, delta, gate, scale, scale, gamma)
    gx = gx if gx.stride(-1) == 1 else gx.contiguous()
    gy = gy if gy.stride(-1) == 1 else gy.contiguous()
    dx, ddelta, dshift, dscale, dgate, dgamma = _bwd_cuda(
        x_new, gy, scale, gamma, eps, (gy.dtype, gy.dtype, gate.dtype),
        gx=gx, delta=delta, gate=gate)
    gated_residual_adaln_bwd.launches += 1
    return dx, ddelta, dgate, dshift, dscale, dgamma


gated_residual_adaln_bwd.launches = 0


class _GatedResidualAdaLN(torch.autograd.Function):
    """The JAX `_gr_adaln` custom_vjp: saves (x_new, δ, gate, scale, γ).
    Both outputs take cotangents: x_new feeds the residual stream, y the
    next GEMM; autograd hands a zero tensor for one that none reached."""

    @staticmethod
    def forward(ctx, x, delta, gate, shift, scale, gamma, eps):
        x_new, y = _gr_forward(x, delta, gate, shift, scale, gamma, eps)
        ctx.save_for_backward(x_new, delta, gate, scale, gamma)
        ctx.eps = eps
        return x_new, y

    @staticmethod
    def backward(ctx, gx, gy):
        x_new, delta, gate, scale, gamma = ctx.saved_tensors
        grads = gated_residual_adaln_bwd(x_new, delta, gate, scale, gamma,
                                         gx, gy, ctx.eps)
        return (*grads, None)


def gated_residual_adaln(x: torch.Tensor, delta: torch.Tensor,
                         gate: torch.Tensor, shift: torch.Tensor,
                         scale: torch.Tensor,
                         gamma: Optional[torch.Tensor] = None,
                         eps: float = 1e-6):
    """(x + δ·gate, rms_norm(x + δ·gate)[·γ]·(1 + scale) + shift) in one
    pass, differentiable in every tensor argument.

    x/δ [B, L, D] (rows may be strided, bf16 or fp32); gate/shift/scale
    [B, D] views with one row stride (column views of the AdaLN
    projection); γ [D] or None. Returns (x_new, y), contiguous, in x's
    dtype. `gated_residual_adaln.launches` counts forward launches.
    """
    return _GatedResidualAdaLN.apply(x, delta, gate, shift, scale, gamma, eps)


gated_residual_adaln.launches = 0
