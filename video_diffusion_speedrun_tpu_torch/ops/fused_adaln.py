"""Fused AdaLN-modulated RMSNorm (port of `ops/fused_adaln.py`).

    y = rms_norm(x) · γ? · (1 + scale[b]) + shift[b],   fp32 inside

`adaln_rms_modulate` is a `torch.autograd.Function` (the JAX `_adaln_rms`
custom_vjp). Its forward replaces the Pallas `_forward`
(`ops/fused_adaln.py:68`, kernels `_fwd_kernel` / `_fwd_kernel_nogamma`),
its backward the Pallas `_backward` (`:156`, kernels `_bwd_kernel` /
`_bwd_kernel_nogamma`). On CUDA tensors both launch the Triton kernels
below; on CPU tensors they run the plain twins `adaln_rms_modulate_plain`
and `adaln_rms_modulate_bwd_plain`.

What bounds it on the card: one row reduction plus one elementwise pass, so
it is bandwidth-bound — it must read x and write y once (~17 MB at
2×1040×2048 bf16), a few flops a byte, far below the tensor cores' line.
The design is therefore the plain one: each program owns one whole row in
registers (one read of x, one write of y, fp32 in between); tensor cores and
shared-memory staging buy nothing. x may be a strided row view (the final
layer strips the registers with a slice), and shift/scale may be column
views of the AdaLN projection, so nothing is copied before the kernel.

The backward is bandwidth-bound too: it must read x and the output
gradient g and write dx (~104 MB at 64×528×512 bf16). Per row it recomputes
r = rsqrt(mean(x²)+eps), n = x·r and writes dx = r·(dn − n·mean(n·dn)),
dn = g·(1+scale)·γ?. The column sums over L (dshift = Σg, dscale =
Σg·n·γ?, dγ = Σg·n·(1+scale)) cannot carry across Triton programs the way
the TPU kernel carries them across its row grid in VMEM; each program
walks 64 rows in tiles of a few rows, keeps the column partials as 2-D
register accumulators (one cross-row reduction at the end instead of one
per tile), and writes fp32 partials [B, programs, D]; one torch sum over
the small partials finishes them (JAX also sums its per-b dγ partials
outside the kernel).

`gated_residual_adaln` fuses the block's residual join with the next
sub-layer's norm (the JAX `_gr_adaln` custom_vjp, `DiTConfig.fused_residual`):
x_new = x + δ·gate in fp32, stored in x's dtype, and y the modulated norm of
the unrounded fp32 x_new. Its forward replaces the Pallas `_gr_forward`
(`ops/fused_adaln.py:281`, kernels `_gr_fwd_kernel*`), one program per row
as row 3 (read x and δ once, write x_new and y once); its backward the
Pallas `_gr_backward` (`:379`, `_gr_bwd_kernel*`), row 12's scheme with the
residual cotangent gx added to dx, dδ = dx·gate, and dgate = Σ_L dx·δ as a
fourth column partial. It saves the rounded x_new, not x, as JAX does.
"""

from typing import Optional

import torch

# bound at the first launch (triton is imported there, never at import:
# the CPU tests import this module on a machine without triton)
tl = None
_kernel = None
_bwd_kernel = None
_gr_kernel = None
_gr_bwd_kernel = None
# backward launch shape: rows a program covers before writing its column
# partials, rows per register tile (at D=512; scaled by 512/D), warps —
# the fastest shape tried on the H100 at [64, 528, 512]
_BWD_ROWS = 64
_BWD_TILE_ROWS = 4
_BWD_WARPS = 4


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


def _triton_bwd_kernel():
    global tl, _bwd_kernel
    if _bwd_kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def adaln_rms_modulate_bwd(x_ptr, g_ptr, scale_ptr, gamma_ptr,
                                   dx_ptr, part_ptr, L, D, x_sb, x_sl,
                                   mod_sb, eps, n_prog,
                                   HAS_GAMMA: tl.constexpr,
                                   ROWS: tl.constexpr, ITERS: tl.constexpr,
                                   BLOCK_D: tl.constexpr):
            pid = tl.program_id(0)
            b = tl.program_id(1)
            cols = tl.arange(0, BLOCK_D)
            cmask = cols < D
            ops = 1.0 + tl.load(scale_ptr + b * mod_sb + cols, mask=cmask,
                                other=0.0).to(tl.float32)
            if HAS_GAMMA:
                gam = tl.load(gamma_ptr + cols, mask=cmask,
                              other=0.0).to(tl.float32)
                mul = ops * gam
            else:
                mul = ops
            # column partials stay 2-D in registers across the row tiles;
            # one cross-row reduction at the end
            dsh = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
            dsc = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
            dga = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
            for it in range(ITERS):
                rows = (pid * ITERS + it) * ROWS + tl.arange(0, ROWS)
                mask = (rows < L)[:, None] & cmask[None, :]
                x_off = (b.to(tl.int64) * x_sb + rows[:, None].to(tl.int64)
                         * x_sl + cols[None, :])
                x = tl.load(x_ptr + x_off, mask=mask, other=0.0).to(tl.float32)
                row_off = ((b.to(tl.int64) * L + rows[:, None]) * D
                           + cols[None, :])
                g = tl.load(g_ptr + row_off, mask=mask,
                            other=0.0).to(tl.float32)
                r = tl.rsqrt(tl.sum(x * x, axis=1) / D + eps)
                n = x * r[:, None]
                gn = g * n
                dsh += g
                if HAS_GAMMA:
                    dsc += gn * gam[None, :]
                    dga += gn * ops[None, :]
                else:
                    dsc += gn
                dn = g * mul[None, :]
                dot = tl.sum(n * dn, axis=1)
                dx = r[:, None] * (dn - n * dot[:, None] / D)
                tl.store(dx_ptr + row_off, dx.to(dx_ptr.dtype.element_ty),
                         mask=mask)
            part = part_ptr + ((b * n_prog + pid) * 3).to(tl.int64) * D
            tl.store(part + cols, tl.sum(dsh, axis=0), mask=cmask)
            tl.store(part + D + cols, tl.sum(dsc, axis=0), mask=cmask)
            if HAS_GAMMA:
                tl.store(part + 2 * D + cols, tl.sum(dga, axis=0), mask=cmask)

        _bwd_kernel = adaln_rms_modulate_bwd
    return _bwd_kernel


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


def adaln_rms_modulate_bwd(x, shift, scale, gamma, g, eps: float = 1e-6):
    """The backward: (dx, dshift, dscale, dγ or None) in the dtypes of x,
    shift, scale and γ. The Triton kernel on CUDA, the twin on the CPU."""
    if not x.is_cuda:
        return adaln_rms_modulate_bwd_plain(x, shift, scale, gamma, g, eps)
    _check_operands(x, shift, scale, gamma)
    b, l, d = x.shape
    g = g.contiguous()
    dx = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    block = max(16, 1 << (d - 1).bit_length())
    rows = max(1, min(_BWD_ROWS, _BWD_TILE_ROWS * 512 // block))
    iters = _BWD_ROWS // rows
    n_prog = -(-l // _BWD_ROWS)
    part = torch.empty((b, n_prog, 3, d), dtype=torch.float32,
                       device=x.device)
    kernel = _triton_bwd_kernel()
    with torch.cuda.device(x.device):
        kernel[(n_prog, b)](x, g, scale, x if gamma is None else gamma, dx,
                            part, l, d, x.stride(0), x.stride(1),
                            scale.stride(0), eps, n_prog,
                            HAS_GAMMA=gamma is not None, ROWS=rows,
                            ITERS=iters, BLOCK_D=block,
                            num_warps=_BWD_WARPS)
    adaln_rms_modulate_bwd.launches += 1
    sums = part.sum(dim=1)  # [B, 3, D]
    dgamma = None
    if gamma is not None:
        dgamma = sums[:, 2].sum(dim=0).to(gamma.dtype)
    return dx, sums[:, 0].to(shift.dtype), sums[:, 1].to(scale.dtype), dgamma


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


def _triton_gr_kernels():
    global tl, _gr_kernel, _gr_bwd_kernel
    if _gr_kernel is not None:
        return _gr_kernel, _gr_bwd_kernel
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

    @triton.jit
    def gated_residual_adaln_bwd(xn_ptr, d_ptr, gx_ptr, gy_ptr, gate_ptr,
                                 scale_ptr, gamma_ptr, dx_ptr, dd_ptr,
                                 part_ptr, L, D, d_sb, d_sl, mod_sb, eps,
                                 n_prog, HAS_GAMMA: tl.constexpr,
                                 ROWS: tl.constexpr, ITERS: tl.constexpr,
                                 BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        ops = 1.0 + tl.load(scale_ptr + b * mod_sb + cols, mask=cmask,
                            other=0.0).to(tl.float32)
        if HAS_GAMMA:
            gam = tl.load(gamma_ptr + cols, mask=cmask,
                          other=0.0).to(tl.float32)
            mul = ops * gam
        else:
            mul = ops
        gate = tl.load(gate_ptr + b * mod_sb + cols, mask=cmask,
                       other=0.0).to(tl.float32)
        # column partials stay 2-D in registers across the row tiles
        dga = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
        dsh = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
        dsc = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
        dgm = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
        for it in range(ITERS):
            rows = (pid * ITERS + it) * ROWS + tl.arange(0, ROWS)
            mask = (rows < L)[:, None] & cmask[None, :]
            row_off = ((b.to(tl.int64) * L + rows[:, None]) * D
                       + cols[None, :])
            x = tl.load(xn_ptr + row_off, mask=mask, other=0.0).to(tl.float32)
            gy = tl.load(gy_ptr + row_off, mask=mask,
                         other=0.0).to(tl.float32)
            r = tl.rsqrt(tl.sum(x * x, axis=1) / D + eps)
            n = x * r[:, None]
            gn = gy * n
            dsh += gy
            if HAS_GAMMA:
                dsc += gn * gam[None, :]
                dgm += gn * ops[None, :]
            else:
                dsc += gn
            dn = gy * mul[None, :]
            dot = tl.sum(n * dn, axis=1)
            dx = r[:, None] * (dn - n * dot[:, None] / D)
            dx += tl.load(gx_ptr + row_off, mask=mask,
                          other=0.0).to(tl.float32)
            tl.store(dx_ptr + row_off, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)
            tl.store(dd_ptr + row_off,
                     (dx * gate[None, :]).to(dd_ptr.dtype.element_ty),
                     mask=mask)
            d_off = (b.to(tl.int64) * d_sb + rows[:, None].to(tl.int64) * d_sl
                     + cols[None, :])
            dga += dx * tl.load(d_ptr + d_off, mask=mask,
                                other=0.0).to(tl.float32)
        part = part_ptr + ((b * n_prog + pid) * 4).to(tl.int64) * D
        tl.store(part + cols, tl.sum(dga, axis=0), mask=cmask)
        tl.store(part + D + cols, tl.sum(dsh, axis=0), mask=cmask)
        tl.store(part + 2 * D + cols, tl.sum(dsc, axis=0), mask=cmask)
        if HAS_GAMMA:
            tl.store(part + 3 * D + cols, tl.sum(dgm, axis=0), mask=cmask)

    _gr_kernel, _gr_bwd_kernel = (gated_residual_adaln_fwd,
                                  gated_residual_adaln_bwd)
    return _gr_kernel, _gr_bwd_kernel


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
    kernel, _ = _triton_gr_kernels()
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
    dγ or None). The Triton kernel on CUDA, the twin on the CPU."""
    if not x_new.is_cuda:
        return gated_residual_adaln_bwd_plain(x_new, delta, gate, scale,
                                              gamma, gx, gy, eps)
    _check_gr_operands(x_new, delta, gate, scale, scale, gamma)
    if not x_new.is_contiguous():
        raise ValueError("x_new must be contiguous (the forward's output)")
    b, l, d = x_new.shape
    gx, gy = gx.contiguous(), gy.contiguous()
    dx = torch.empty_like(x_new)
    ddelta = torch.empty((b, l, d), dtype=delta.dtype, device=x_new.device)
    block = max(16, 1 << (d - 1).bit_length())
    rows = max(1, min(_BWD_ROWS, _BWD_TILE_ROWS * 512 // block))
    n_prog = -(-l // _BWD_ROWS)
    part = torch.empty((b, n_prog, 4, d), dtype=torch.float32,
                       device=x_new.device)
    _, kernel = _triton_gr_kernels()
    with torch.cuda.device(x_new.device):
        kernel[(n_prog, b)](x_new, delta, gx, gy, gate, scale,
                            x_new if gamma is None else gamma, dx, ddelta,
                            part, l, d, delta.stride(0), delta.stride(1),
                            scale.stride(0), eps, n_prog,
                            HAS_GAMMA=gamma is not None, ROWS=rows,
                            ITERS=_BWD_ROWS // rows, BLOCK_D=block,
                            num_warps=_BWD_WARPS)
    gated_residual_adaln_bwd.launches += 1
    sums = part.sum(dim=1)  # [B, 4, D]
    dgamma = None
    if gamma is not None:
        dgamma = sums[:, 3].sum(dim=0).to(gamma.dtype)
    return (dx, ddelta, sums[:, 0].to(gate.dtype), sums[:, 1].to(gy.dtype),
            sums[:, 2].to(gy.dtype), dgamma)


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
