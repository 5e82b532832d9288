"""Fused AdaLN-modulated RMSNorm forward (port of `ops/fused_adaln.py`).

    y = rms_norm(x) · γ? · (1 + scale[b]) + shift[b],   fp32 inside

Replaces the Pallas forward `_forward` (`ops/fused_adaln.py:68`, kernels
`_fwd_kernel` / `_fwd_kernel_nogamma`). On a CUDA tensor
`adaln_rms_modulate` launches the Triton kernel below; on a CPU tensor it
runs the plain twin `adaln_rms_modulate_plain`.

What bounds it on the card: one row reduction plus one elementwise pass, so
it is bandwidth-bound — it must read x and write y once (~17 MB at
2×1040×2048 bf16), a few flops a byte, far below the tensor cores' line.
The design is therefore the plain one: each program owns one whole row in
registers (one read of x, one write of y, fp32 in between); tensor cores and
shared-memory staging buy nothing. x may be a strided row view (the final
layer strips the registers with a slice), and shift/scale may be column
views of the AdaLN projection, so nothing is copied before the kernel.
The backward kernel comes with the training slice.
"""

from typing import Optional

import torch

# bound at the first launch (triton is imported there, never at import:
# the CPU tests import this module on a machine without triton)
tl = None
_kernel = None


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


def adaln_rms_modulate(x: torch.Tensor, shift: torch.Tensor,
                       scale: torch.Tensor,
                       gamma: Optional[torch.Tensor] = None,
                       eps: float = 1e-6) -> torch.Tensor:
    """`rms_norm(x[, gamma]) * (1 + scale) + shift` in one pass.

    x [B, L, D] (rows may be strided); shift/scale [B, D] (unit column
    stride); gamma [D] or None. Returns a contiguous [B, L, D] in x's dtype.
    """
    if not x.is_cuda:
        return adaln_rms_modulate_plain(x, shift, scale, gamma, eps)
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, shift, scale, gamma)):
        raise RuntimeError("the AdaLN kernel has no backward yet; run under "
                           "torch.no_grad()")
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


adaln_rms_modulate.launches = 0
