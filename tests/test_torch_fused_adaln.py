"""AdaLN+RMSNorm of the PyTorch port against the JAX package.

On the CPU the port's `adaln_rms_modulate` runs its plain twin; it is held
against the Pallas kernel in interpret mode, with and without γ, fp32 at
atol 1e-5 (two fp32 row reductions in different orders). The backward of
its autograd Function (the twin on the CPU) is held against `jax.vjp` of
the JAX op, whose custom_vjp runs the Pallas backward in interpret mode:
dx, dshift, dscale, dγ at a ragged L, fp32, atol 1e-4 and rtol 1e-5 (the
column sums run over up to B·L rows in another order). The gated-residual
op `gated_residual_adaln` is held the same way against the JAX op of that
name (Pallas `_gr_forward` / `_gr_backward` in interpret mode), forward and
VJP, with and without γ, at a ragged L: fp32 at those tolerances; bf16
within one bf16 ulp (2^-7 relative) plus 1e-4, both sides rounding the
same fp32 values once. The Triton kernels are held against the twins in
tests/test_torch_gpu_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.ops.fused_adaln import (
    adaln_rms_modulate as j_adaln,
)
from video_diffusion_speedrun_tpu.ops.fused_adaln import (
    gated_residual_adaln as j_gr,
)
from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as tad


def _inputs(b, l, d, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, l, d)).astype(np.float32)
    shift, scale = (r.normal(size=(b, d)).astype(np.float32) for _ in "ab")
    gamma = r.normal(size=(d,)).astype(np.float32)
    return x, shift, scale, gamma


@pytest.mark.parametrize("with_gamma", [False, True])
def test_twin_matches_pallas(with_gamma):
    x, shift, scale, gamma = _inputs(2, 37, 96)
    g = gamma if with_gamma else None
    want = j_adaln(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale),
                   None if g is None else jnp.asarray(g))
    got = tad.adaln_rms_modulate(
        torch.from_numpy(x), torch.from_numpy(shift), torch.from_numpy(scale),
        None if g is None else torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert tad.adaln_rms_modulate.launches == 0  # CPU runs the twin


def test_strided_operands_on_cpu():
    """A row-sliced x and column views of a 9-way modulation, as the model
    passes them, give the result of contiguous copies."""
    x, shift, scale, _ = _inputs(2, 40, 64, seed=1)
    mod = torch.from_numpy(np.concatenate([shift, scale], -1))
    xs = torch.from_numpy(x)[:, 8:]
    got = tad.adaln_rms_modulate(xs, mod[:, :64], mod[:, 64:])
    want = tad.adaln_rms_modulate_plain(xs.contiguous(), torch.from_numpy(shift),
                                        torch.from_numpy(scale))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("with_gamma", [False, True])
def test_backward_matches_jax_vjp(with_gamma):
    x, shift, scale, gamma = _inputs(2, 37, 96, seed=2)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    args = [x, shift, scale] + ([gamma] if with_gamma else [])
    _, vjp = jax.vjp(lambda *a: j_adaln(*a), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))

    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tad.adaln_rms_modulate(*tensors)
    y.backward(torch.from_numpy(g))
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-5)
    assert tad.adaln_rms_modulate_bwd.launches == 0


def test_backward_through_strided_views():
    """The model's calling convention: x a row slice, shift/scale column
    views of the 9-way modulation; gradients land in the right columns."""
    x, shift, scale, _ = _inputs(2, 40, 64, seed=3)
    full = torch.from_numpy(x).requires_grad_()
    mod = torch.from_numpy(np.concatenate([shift, scale], -1)).requires_grad_()
    y = tad.adaln_rms_modulate(full[:, 8:], mod[:, :64], mod[:, 64:])
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    y.backward(g)
    dx, dsh, dsc, _ = tad.adaln_rms_modulate_bwd_plain(
        full.detach()[:, 8:], torch.from_numpy(shift), torch.from_numpy(scale),
        None, g)
    assert not full.grad[:, :8].any()
    torch.testing.assert_close(full.grad[:, 8:], dx, rtol=0, atol=0)
    torch.testing.assert_close(mod.grad, torch.cat([dsh, dsc], -1), rtol=0,
                               atol=0)


# dtype → (torch, JAX, forward (rtol, atol), backward (rtol, atol))
GR_DTYPES = {"fp32": (torch.float32, jnp.float32, (1e-5, 1e-5), (1e-5, 1e-4)),
             "bf16": (torch.bfloat16, jnp.bfloat16, (2 ** -7, 1e-4),
                      (2 ** -7, 1e-4))}


def _gr_inputs(b, l, d, seed):
    r = np.random.default_rng(seed)
    x, delta, gx, gy = (r.normal(size=(b, l, d)).astype(np.float32)
                        for _ in range(4))
    gate, shift, scale = (r.normal(size=(b, d)).astype(np.float32)
                          for _ in range(3))
    gamma = r.normal(size=(d,)).astype(np.float32)
    return [x, delta, gate, shift, scale, gamma], gx, gy


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol[0], atol=tol[1], err_msg=what)


@pytest.mark.parametrize("with_gamma", [False, True])
@pytest.mark.parametrize("dtype", sorted(GR_DTYPES))
def test_gated_residual_matches_jax(dtype, with_gamma):
    tdt, jdt, fwd_tol, bwd_tol = GR_DTYPES[dtype]
    args, gx, gy = _gr_inputs(2, 37, 96, seed=7)
    args = args if with_gamma else args[:5]
    (x_new, y), vjp = jax.vjp(lambda *a: j_gr(*a),
                              *(jnp.asarray(a, jdt) for a in args))
    want = vjp((jnp.asarray(gx, jdt), jnp.asarray(gy, jdt)))

    tensors = [torch.from_numpy(a).to(tdt).requires_grad_() for a in args]
    t_new, t_y = tad.gated_residual_adaln(*tensors)
    assert t_new.dtype == t_y.dtype == tdt
    _close(t_new, x_new, fwd_tol, "x_new")
    _close(t_y, y, fwd_tol, "y")
    torch.autograd.backward((t_new, t_y), (torch.from_numpy(gx).to(tdt),
                                           torch.from_numpy(gy).to(tdt)))
    names = ("dx", "ddelta", "dgate", "dshift", "dscale", "dgamma")
    for name, t, w in zip(names, tensors, want):
        _close(t.grad, w, bwd_tol, name)
    assert tad.gated_residual_adaln.launches == 0  # CPU runs the twins
    assert tad.gated_residual_adaln_bwd.launches == 0


def test_gated_residual_without_a_residual_cotangent():
    """Only y reaches the loss: autograd hands the Function a zero gx, and
    the gradients are JAX's with a zero residual cotangent."""
    args, _, gy = _gr_inputs(2, 21, 64, seed=8)
    (_, _), vjp = jax.vjp(lambda *a: j_gr(*a), *map(jnp.asarray, args))
    want = vjp((jnp.zeros(gy.shape, jnp.float32), jnp.asarray(gy)))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    _, t_y = tad.gated_residual_adaln(*tensors)
    t_y.backward(torch.from_numpy(gy))
    for t, w in zip(tensors, want):
        _close(t.grad, w, GR_DTYPES["fp32"][3], "grad")


def test_gated_residual_through_strided_views():
    """The model's calling convention: gate/shift/scale column views of
    the 9-way modulation, x a row slice; gradients land in the right
    columns and equal the backward twin's."""
    (x, delta, gate, shift, scale, _), gx, gy = _gr_inputs(2, 40, 64, seed=9)
    full = torch.from_numpy(np.concatenate([x, x[:, :8]], 1)).requires_grad_()
    mod = torch.from_numpy(np.concatenate([shift, scale, gate], -1))
    mod.requires_grad_()
    td = torch.from_numpy(delta)
    x_new, y = tad.gated_residual_adaln(full[:, :40], td, mod[:, 128:],
                                        mod[:, :64], mod[:, 64:128])
    torch.autograd.backward((x_new, y), (torch.from_numpy(gx),
                                         torch.from_numpy(gy)))
    want_new, want_y = tad.gated_residual_adaln_plain(
        torch.from_numpy(x), td, torch.from_numpy(gate),
        torch.from_numpy(shift), torch.from_numpy(scale))
    torch.testing.assert_close(x_new, want_new, rtol=0, atol=0)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    dx, _, dgate, dshift, dscale, _ = tad.gated_residual_adaln_bwd_plain(
        want_new, td, torch.from_numpy(gate), torch.from_numpy(scale), None,
        torch.from_numpy(gx), torch.from_numpy(gy))
    assert not full.grad[:, 40:].any()
    torch.testing.assert_close(full.grad[:, :40], dx, rtol=0, atol=0)
    torch.testing.assert_close(mod.grad, torch.cat([dshift, dscale, dgate],
                                                   -1), rtol=0, atol=0)
