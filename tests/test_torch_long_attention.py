"""Long-path attention of the PyTorch port against the JAX package.

On the CPU the port's long ops run their plain twins: `long_attention_plain`
/ `long_attention_bwd_plain`, what the one-launch CUDA kernels compute, and
`split_attention_plain` / `split_attention_bwd_plain`, JAX's split-prefix
decomposition (`_split_rope_flash`). They are held against the JAX
functions with the Pallas kernels in interpret mode, forward and `jax.vjp`.

Tolerances, as max |got − want| over max |want| of each output:
- fp32: 1e-5 (both sides compute in fp32; only the summation order and
  the split's merge differ; measured ≤ 1.3e-6);
- bf16: 2^-6, two bf16 ulps of the largest value (measured ≤ 9.6e-3):
  dk and dv round twice on both sides (each q range's part, then their
  sum), and the two sides split the work differently — the one-launch
  twin takes the long forward's rounding (dot, then × scale·log2e) for the
  prefix columns too, where JAX's `_tail_merge_kernel` rounds
  q·scale·log2e first, and JAX's `_backward` sums its dq partials in bf16.
The CUDA kernels are held against the twins on the card by
tests/test_torch_gpu_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.models.rope import rope_cos_sin
from video_diffusion_speedrun_tpu.ops import fused_attention as jfa
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa

H, D = 2, 32
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 2 ** -6}


def _inputs(l, h=H, d=D, b=1, seed=0, grid=None):
    """q, k, v, do as fp32 numpy [b, l, h·d]; cos/sin [l, d/2] of 16
    registers and l − 16 tokens (on one axis unless `grid` is given)."""
    r = np.random.default_rng(seed)
    q, k, v, do = (r.normal(size=(b, l, h * d)).astype(np.float32)
                   for _ in range(4))
    grid = (1, 1, l - 16) if grid is None else grid
    cos, sin = rope_cos_sin(d, *grid, jnp.asarray([2, 0, 5]), num_registers=16)
    return q, k, v, do, np.asarray(cos), np.asarray(sin)


def _rel(got: torch.Tensor, want) -> float:
    """max |got − want| over max |want|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _jax_vjp(fn, q, k, v, do, jdt):
    out, vjp = jax.vjp(fn, *(jnp.asarray(t, jdt) for t in (q, k, v)))
    return (out, *vjp(jnp.asarray(do, jdt)))


def _port_grads(fn, q, k, v, do, tdt):
    """Output and (dq, dk, dv) of a differentiable port entry."""
    ts = [torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do).to(tdt))
    return (out.detach(), *(t.grad for t in ts))


@pytest.mark.parametrize("lq,lk,block,want", [
    (8208, 8208, 1024, 16), (2064, 2064, 1024, 16), (8192, 8192, 1024, 0),
    (8208, 512, 1024, 0), (1040, 1040, 1024, 0), (8200, 8200, 1024, 0),
    (144, 144, 64, 16), (240, 240, 64, 48)])
def test_split_prefix_matches_jax(lq, lk, block, want):
    """The dispatch rule (tests/test_fused_attention.py:609-619 and the
    miniatures there)."""
    assert tfa._split_prefix(lq, lk, block) == want
    assert jfa._split_prefix(lq, lk, block) == want
    assert tfa.DEFAULT_BLOCK == jfa.DEFAULT_BLOCK_Q == jfa.DEFAULT_BLOCK_K


@pytest.mark.parametrize("n_pfx,bulk,block", [
    (16, 8192, 1024), (16, 2048, 1024), (16, 128, 64), (48, 192, 64),
    (256, 8192, 1024), (16, 32 * 1024, 1024)])
def test_use_tail_matches_jax(n_pfx, bulk, block):
    """JAX's tail-fused choice, as its CPU tests see it (interpret mode
    lifts the TPU's bf16-only clause); fp32 and bf16 alike."""
    for dt in (jnp.float32, jnp.bfloat16):
        assert tfa._use_tail(n_pfx, bulk, block) == jfa._use_tail(
            jnp.zeros((1, 8, 8), dt), n_pfx, bulk, block)


def test_rotate_flat_matches_jax():
    """`rotate_flat` and its transpose against `_rotate_flat`: fp32 to
    1e-6; bf16 within one ulp (fp32 math, one rounding each side)."""
    q, _, _, _, cos, sin = _inputs(80, h=4, d=64, b=2)
    for transpose in (False, True):
        want = jfa._rotate_flat(jnp.asarray(q), jnp.asarray(cos),
                                jnp.asarray(sin), 4, transpose=transpose)
        got = tfa.rotate_flat(torch.from_numpy(q), torch.from_numpy(cos),
                              torch.from_numpy(sin), 4, transpose=transpose)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        want = jfa._rotate_flat(jnp.asarray(q, jnp.bfloat16), jnp.asarray(cos),
                                jnp.asarray(sin), 4, transpose=transpose)
        got = tfa.rotate_flat(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(cos), torch.from_numpy(sin), 4,
                              transpose=transpose)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -8, atol=0)


def _split_twin(n_pfx, block, split):
    """The port's long path over unrotated q/k as a differentiable
    function: rotate, attend (split decomposition or one launch), rotate
    dq/dk back."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, cos, sin):
            q_r, k_r = (tfa.rotate_flat(t, cos, sin, H) for t in (q, k))
            scale = D ** -0.5
            if split:
                o, lse = tfa.split_attention_plain(q_r, k_r, v, H, scale,
                                                   n_pfx, block)
            else:
                o, lse = tfa.long_attention_plain(q_r, k_r, v, H, scale)
            ctx.save_for_backward(q_r, k_r, v, o, lse, cos, sin)
            return o

        @staticmethod
        def backward(ctx, do):
            q_r, k_r, v, o, lse, cos, sin = ctx.saved_tensors
            scale = D ** -0.5
            if split:
                dq, dk, dv = tfa.split_attention_bwd_plain(
                    q_r, k_r, v, o, lse, do, H, scale, n_pfx)
            else:
                dq, dk, dv = tfa.long_attention_bwd_plain(
                    q_r, k_r, v, o, lse, do, H, scale)
            dq, dk = (tfa.rotate_flat(t, cos, sin, H, transpose=True)
                      for t in (dq, dk))
            return dq, dk, dv, None, None

    return Fn.apply


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", ["split", "one_launch"])
@pytest.mark.parametrize("l,n_pfx,block", [(144, 16, 64), (288, 16, 16)])
def test_twin_matches_split_rope_flash(l, n_pfx, block, form, dtype):
    """L = 144 = 16 + 2·64, n_pfx 16, block 64: the production
    8208 = 16 + 8·1024 in miniature (tests/test_fused_attention.py:648),
    where JAX folds the prefix into the bulk kernels (`_use_tail`); and
    L = 288 = 16 + 17·16, whose 17 bulk blocks take JAX's 3-call merge
    (`_split_fwd` / `_split_bwd`) instead."""
    jdt, tdt = DTYPES[dtype]
    assert tfa._use_tail(n_pfx, l - n_pfx, block) == (l == 144)
    q, k, v, do, cos, sin = _inputs(l, seed=7)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    want = _jax_vjp(lambda a, b, c: jfa._split_rope_flash(
        a, b, c, jc, js, jc, js, H, D ** -0.5, n_pfx, block), q, k, v, do, jdt)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    fn = _split_twin(n_pfx, block, form == "split")
    got = _port_grads(lambda a, b, c: fn(a, b, c, tc, ts), q, k, v, do, tdt)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        assert _rel(g, w) <= TOL[dtype], (name, _rel(g, w))


def test_split_lse_matches_jax():
    """The merged exp2-domain lse of the split (`_split_fwd`) and of the one
    launch, fp32."""
    q, k, v, _, cos, sin = _inputs(144, seed=3)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    _, want = jfa._split_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jc, js, jc, js, H, D ** -0.5, 16, 64)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    q_r, k_r = (tfa.rotate_flat(torch.from_numpy(t), tc, ts, H)
                for t in (q, k))
    v_t = torch.from_numpy(v)
    _, split = tfa.split_attention_plain(q_r, k_r, v_t, H, D ** -0.5, 16, 64)
    _, one = tfa.long_attention_plain(q_r, k_r, v_t, H, D ** -0.5)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(one.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_long_flash_matches_preroted_flash(dtype):
    """The port's `_LongFlash` (twins on the CPU) against JAX
    `_preroted_flash` with explicit blocks of 128 at a ragged L = 333: the
    same kernel math, ragged tiles masked on the JAX side."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, cos, sin = _inputs(333, seed=5)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    want = _jax_vjp(lambda a, b, c: jfa._preroted_flash(
        a, b, c, jc, js, jc, js, H, D ** -0.5, 128, 128), q, k, v, do, jdt)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = _port_grads(lambda a, b, c: tfa._LongFlash.apply(
        a, b, c, tc, ts, H, D ** -0.5), q, k, v, do, tdt)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= TOL[dtype], (name, _rel(g, w))
    assert tfa.long_attention_forward.launches == 0  # CPU runs the twin
    assert tfa.long_attention_backward.launches == 0


def test_rope_flash_attention_matches_jax_at_2064():
    """The public entries at L = 2064 > SHORT_MAX_KV, H = 2, D = 64: JAX
    auto-dispatches through the split (n_pfx 16, blocks 1024), the port
    through the long path. fp32, forward and vjp."""
    h, d = 2, 64
    q, k, v, do, cos, sin = _inputs(2064, h=h, d=d, seed=11,
                                    grid=(8, 16, 16))
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    want = _jax_vjp(lambda a, b, c: jfa.rope_flash_attention(
        a, b, c, jc, js, h), q, k, v, do, jnp.float32)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = _port_grads(lambda a, b, c: tfa.rope_flash_attention(
        a, b, c, tc, ts, h), q, k, v, do, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("l", [333, 2064])
def test_norope_flash_attention_matches_jax(l):
    """No-RoPE self-attention on the short path (L = 333: the short kernel
    with RoPE off) and the long one (L = 2064: JAX's split with identity
    tables, the port's long path unrotated). fp32, forward and vjp."""
    h, d = 2, 64
    q, k, v, do, _, _ = _inputs(l, h=h, d=d, seed=13)
    want = _jax_vjp(lambda a, b, c: jfa.norope_flash_attention(a, b, c, h),
                    q, k, v, do, jnp.float32)
    got = _port_grads(lambda a, b, c: tfa.norope_flash_attention(a, b, c, h),
                      q, k, v, do, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def test_short_rope_entry_matches_jax():
    """`rope_flash_attention` below the limit takes the short kernel, as
    JAX's: fp32, forward and vjp at L = 96."""
    q, k, v, do, cos, sin = _inputs(96, seed=17)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    want = _jax_vjp(lambda a, b, c: jfa.rope_flash_attention(
        a, b, c, jc, js, H), q, k, v, do, jnp.float32)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = _port_grads(lambda a, b, c: tfa.rope_flash_attention(
        a, b, c, tc, ts, H), q, k, v, do, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def test_cross_attention_refuses_long_kv():
    """JAX raises past the short path (`:1981-1983`); so does the port."""
    q = np.zeros((1, 8, H * D), np.float32)
    kv = np.zeros((1, tfa.SHORT_MAX_KV + 1, H * D), np.float32)
    with pytest.raises(ValueError, match="short-path limit"):
        jfa.cross_flash_attention(jnp.asarray(q), jnp.asarray(kv),
                                  jnp.asarray(kv), H)
    with pytest.raises(ValueError, match="short-path limit"):
        tfa.cross_flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                                  torch.from_numpy(kv), H)


@pytest.mark.parametrize("lq,lk", [(70, 70), (40, 150)])
def test_long_backward_twin_equals_autograd_of_forward_twin(lq, lk):
    """In fp32 the long backward twin is the exact gradient of the long
    forward twin, at lengths that are no multiple of the twins' chunk."""
    r = np.random.default_rng(19)
    q = torch.from_numpy(r.normal(size=(2, lq, H * D)).astype(np.float32))
    k, v = (torch.from_numpy(r.normal(size=(2, lk, H * D)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = tfa.long_attention_plain(q, k, v, H, D ** -0.5)
    do = torch.from_numpy(r.normal(size=o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tfa.long_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       o.detach(), lse.detach(), do, H,
                                       D ** -0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


def test_twin_chunks_agree_with_one_chunk(monkeypatch):
    """The twins run over chunks of q rows; a ragged chunking gives the
    same numbers as one chunk (fp32)."""
    q, k, v, do, _, _ = _inputs(150, seed=23)
    args = [torch.from_numpy(t) for t in (q, k, v)]
    o1, lse1 = tfa.long_attention_plain(*args, H, D ** -0.5)
    g1 = tfa.long_attention_bwd_plain(*args, o1, lse1, torch.from_numpy(do),
                                      H, D ** -0.5)
    monkeypatch.setattr(tfa, "_TWIN_ROWS", 64)
    o2, lse2 = tfa.long_attention_plain(*args, H, D ** -0.5)
    g2 = tfa.long_attention_bwd_plain(*args, o1, lse1, torch.from_numpy(do),
                                      H, D ** -0.5)
    torch.testing.assert_close(o2, o1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse2, lse1, atol=1e-6, rtol=1e-6)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
