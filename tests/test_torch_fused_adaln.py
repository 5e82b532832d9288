"""AdaLN+RMSNorm of the PyTorch port against the JAX package.

On the CPU the port's `adaln_rms_modulate` runs its plain twin; it is held
against the Pallas kernel in interpret mode, with and without γ, fp32 at
atol 1e-5 (two fp32 row reductions in different orders). The backward of
its autograd Function (the twin on the CPU) is held against `jax.vjp` of
the JAX op, whose custom_vjp runs the Pallas backward in interpret mode:
dx, dshift, dscale, dγ at a ragged L, fp32, atol 1e-4 and rtol 1e-5 (the
column sums run over up to B·L rows in another order). The Triton kernels
are held against the twins in tests/test_torch_gpu_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.ops.fused_adaln import (
    adaln_rms_modulate as j_adaln,
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
