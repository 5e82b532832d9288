"""Bias + GELU of the PyTorch port against the JAX package.

On the CPU the port's ops run their plain twins.

- `bias_gelu` against the JAX `bias_gelu` (its Pallas kernels in interpret
  mode), forward and `jax.vjp`: bf16 (Φ-poly) and fp32 (A&S erf), with and
  without bias, ragged L = 19, saturated tails. fp32 values within 1e-6
  absolute, dbias within 1e-5 relative (a column sum in another order).
  bf16 within one bf16 ulp (2^-7 of the value) plus four fp32 ulps of the
  polynomial's largest term times its factor (|s| for y, |g| for dx): the
  fits cancel terms up to 20·t^8 (Φ) and 256·t^8 (gelu'), XLA contracts
  their Horner chains into FMAs and torch does not, so the fp32 values
  differ by ~1e-6 where the result is ~1e-4, enough to move its rounding
  by a few bf16 ulps there.
- `mlp_bias_gelu` against `jax.vjp` of the JAX block expression
  `(h + b.astype(cdt)).astype(f32) · _phi_poly(…)` (`models/dit.py:383-385`).
  The forward agrees to the bit. The derivative of the Φ polynomial
  cancels terms up to 180·t^8 (Σ|(2i+1)c_i| = 556), and JAX's autodiff of
  the Horner chain and the port's closed form round differently: dh is
  held at four fp32 ulps of the largest term of g·(Φ + hf·Φ'), measured
  ≤ 2, plus one bf16 ulp in bf16; dbias at the sum of that bound over the
  rows plus 1e-5 relative. In bf16 dbias is held against the fp32 column
  sum of JAX's bf16 dh rounded to bf16, the reduction the port and the TPU
  do: JAX on the CPU reduces the bf16 cotangent at a lower precision (up
  to 0.125 off at |dbias| ~ 1).
- The C2 difference: at |h| = 1e4 JAX's autodiff of the block gives NaN,
  the port the saturated 0/1 of the JAX `bias_gelu` VJP.

The kernels (the Triton forward, the CUDA backward) are held against the
twins in tests/test_torch_gpu_kernels.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.ops import fused_gelu as jg
from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as tg

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
ULP = {"fp32": 0.0, "bf16": 2.0 ** -7}
TAILS = [-1e4, -64.0, -8.0, -4.5, -4.2, 4.2, 4.5, 8.0, 64.0, 1e4]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(f=96, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(2, 19, f)) * 3).astype(np.float32)
    x[0, 0, :len(TAILS)] = TAILS
    bias = (r.normal(size=(f,)) * 0.5).astype(np.float32)
    g = r.normal(size=x.shape).astype(np.float32)
    return x, bias, g


def _check(got, want, rtol, atol, what):
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_array_less(np.abs(got - want),
                                 atol + rtol * np.abs(want) + 1e-30,
                                 err_msg=what)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bias_gelu_matches_jax(dtype, with_bias):
    tdt, jdt = DTYPES[dtype]
    x, bias, g = _inputs()
    args = [jnp.asarray(x).astype(jdt)]
    if with_bias:
        args.append(jnp.asarray(bias).astype(jdt))
    y, vjp = jax.vjp(lambda *a: jg.bias_gelu(*a), *args)
    want = vjp(jnp.asarray(g).astype(jdt))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).to(tdt).requires_grad_() if with_bias else None
    ty = tg.bias_gelu(tx, tb)
    ty.backward(torch.from_numpy(g).to(tdt))
    assert ty.dtype == tdt and ty.shape == tx.shape
    rtol, atol_y, atol_dx = ULP[dtype], 1e-6, 1e-6
    if dtype == "bf16":
        s = _f32(tx) + (_f32(tb) if with_bias else 0.0)
        atol_y = _poly_bound(s, tg._PHI_C, np.abs(s))
        atol_dx = _poly_bound(s, tg._DGELU_C, np.abs(g))
    _check(ty, y, rtol, atol_y, "y")
    _check(tx.grad, want[0], rtol, atol_dx, "dx")
    if with_bias:
        assert tb.grad.dtype == tdt
        _check(tb.grad, want[1], max(rtol, 1e-5), 1e-6, "dbias")
    assert tg.bias_gelu_forward.launches == 0  # CPU runs the twins
    assert tg.bias_gelu_backward.launches == 0


def _jax_block(h, b):
    hf = (h + b.astype(h.dtype)).astype(jnp.float32)
    return (hf * jg._phi_poly(hf)).astype(h.dtype)


def _port_block(h, bias, g, tdt):
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()  # an fp32 parameter
    ty = tg.mlp_bias_gelu(th, tb.to(tdt))
    ty.backward(torch.from_numpy(g).to(tdt))
    return ty, th.grad, tb.grad


def _poly_bound(s, coeffs, factor):
    """Four fp32 ulps of factor·(0.5 + Σ|c_i|·t^2i), t = min(|s|/R, 1):
    the largest term of a fitted polynomial in fp32."""
    t2 = np.minimum(np.abs(s) / tg._POLY_R, 1.0) ** 2
    terms = sum(abs(c) * t2 ** i for i, c in enumerate(coeffs))
    return 2.0 ** -22 * factor * (0.5 + terms)


def _dh_bound(hf, g):
    """Four fp32 ulps of the largest term of g·(Φ + hf·Φ'(hf))."""
    t2 = np.minimum(np.abs(hf) / tg._POLY_R, 1.0) ** 2
    terms = sum(abs(c) * t2 ** i for i, c in enumerate(tg._DPHI_C))
    return 2.0 ** -22 * np.abs(g) * (1 + np.abs(hf) * terms / tg._POLY_R)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_bias_gelu_matches_jax_block(dtype):
    tdt, jdt = DTYPES[dtype]
    x, bias, g = _inputs(seed=1)
    x[0, 0, :len(TAILS)] = np.clip(TAILS, -64, 64)  # |h| < 7e3: JAX finite
    jh = jnp.asarray(x).astype(jdt)
    y, vjp = jax.vjp(_jax_block, jh, jnp.asarray(bias))
    dh, db = vjp(jnp.asarray(g).astype(jdt))

    ty, tdh, tdb = _port_block(x, bias, g, tdt)
    np.testing.assert_array_equal(_f32(ty), _f32(y))
    hf = _f32((torch.from_numpy(x).to(tdt)
               + torch.from_numpy(bias).to(tdt)).float())
    bound = _dh_bound(hf, _f32(jnp.asarray(g).astype(jdt)))
    _check(tdh, dh, ULP[dtype], bound, "dh")
    # dbias: the fp32 sum of the rounded dh, in the bias's dtype
    want_db = _f32(dh).reshape(-1, x.shape[-1]).sum(axis=0)
    want_db = _f32(torch.from_numpy(want_db).to(tdt))
    db_bound = bound.reshape(-1, x.shape[-1]).sum(axis=0)
    _check(tdb, want_db, max(ULP[dtype], 1e-5), db_bound, "dbias")
    if dtype == "fp32":
        _check(tdb, db, 1e-5, db_bound, "dbias against JAX")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_gelu_gradient_saturates_where_jax_gives_nan(dtype):
    """ROADMAP C2: JAX's autodiff of the block meets the polynomial's
    derivative (±inf at |h| = 1e4) with a zero and gives NaN; the port
    gives what the JAX `bias_gelu` VJP gives there, 1 and 0."""
    tdt, jdt = DTYPES[dtype]
    h = np.asarray([[[1e4, -1e4, 9e3, -9e3, 1.5]]], np.float32)
    g = np.ones_like(h)
    zero = np.zeros(h.shape[-1], np.float32)
    _, vjp = jax.vjp(_jax_block, jnp.asarray(h).astype(jdt),
                     jnp.asarray(zero))
    jax_dh = _f32(vjp(jnp.asarray(g).astype(jdt))[0])
    assert np.isnan(jax_dh[..., :4]).all()

    _, gelu_vjp = jax.vjp(lambda a: jg.bias_gelu(a), jnp.asarray(h).astype(jdt))
    want = _f32(gelu_vjp(jnp.asarray(g).astype(jdt))[0])
    ty, tdh, tdb = _port_block(h, zero, g, tdt)
    np.testing.assert_array_equal(_f32(tdh)[..., :4], want[..., :4])
    np.testing.assert_array_equal(_f32(tdh)[..., :4], [[[1, 0, 1, 0]]])
    np.testing.assert_array_equal(_f32(ty)[..., :4],
                                  _f32(torch.from_numpy(h).to(tdt))[..., :4]
                                  * [[[1, 0, 1, 0]]])
    assert np.isfinite(_f32(tdb)).all()


def test_kernel_coefficients_are_the_modules():
    """The kernels spell the polynomial and A&S coefficients out (a Triton
    kernel may not read Python globals; the CUDA backward has none to read):
    the Triton forward's helpers in the module and the helpers of
    csrc/bias_gelu_bwd.cu must hold these numbers. The backward's MLP
    variant sums Φ_poly + s·Φ_poly' into one polynomial, coefficients
    (2i+2)·c_i of `_PHI_C`."""

    def literals(text):
        return [float(v) for v in re.findall(r"-?\d+\.\d+", text)]

    src = Path(tg.__file__).read_text()
    cu = (Path(tg.__file__).parent.parent / "csrc"
          / "bias_gelu_bwd.cu").read_text()
    tl_body = {name: src.split(f"def {name}(x):")[1].split("@triton.jit")[0]
               for name in ("_tl_phi_poly", "_tl_gelu_parts")}
    cu_body = {name: cu.split(f"float {name}(float s) {{")[1].split("}")[0]
               for name in ("dmlp_poly", "dgelu_poly", "gelu_parts")}
    summed = tuple((2 * i + 2) * c for i, c in enumerate(tg._PHI_C))
    for body, coeffs in ((tl_body["_tl_phi_poly"], tg._PHI_C),
                         (cu_body["dmlp_poly"], summed),
                         (cu_body["dgelu_poly"], tg._DGELU_C)):
        found = literals(body)
        assert found[0] == 1.0 / tg._POLY_R, body
        assert found[1:1 + len(coeffs)] == list(reversed(coeffs)), body
        assert tg._POLY_R in found[1 + len(coeffs):], body  # the saturation
    for body in (tl_body["_tl_gelu_parts"], cu_body["gelu_parts"]):
        assert all(v in literals(body)
                   for v in (tg._INV_SQRT2, tg._AS_P, *tg._AS_A, tg._LOG2E))
    assert 0.5 * tg._LOG2E == 0.7213475204444817
    assert "0.7213475204444817f" in cu and "0.3989422804014327f" in cu
    assert float("0.3989422804014327") == tg._INV_SQRT2PI
