"""Short-path attention of the PyTorch port against the JAX package.

On the CPU the port's fused ops run their plain twin; it is held against
the Pallas kernels run in interpret mode (`_forward_short_qkv` for RoPE
self-attention, `_forward_short` with RoPE off for cross-attention), on o
and the exp2-domain lse, at a ragged shape. fp32: atol 2e-5, rtol 1e-4, as
tests/test_fused_attention.py. The backward of the port's autograd
Functions (the twin `short_attention_bwd_plain` on the CPU) is held against
`jax.vjp` of the JAX public entries, whose custom_vjp runs the Pallas
backward in interpret mode: fp32, atol 5e-5, rtol 1e-4 (gradients sum L
terms, twice the forward's atol). The CUDA kernels are held against the
twins in tests/test_torch_gpu_kernels.py.
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


def _inputs(b, l, lk, h=H, d=D, seed=0):
    r = np.random.default_rng(seed)
    qkv = r.normal(size=(b, l, 3 * h * d)).astype(np.float32)
    v = r.normal(size=(b, l, h * d)).astype(np.float32)
    q = r.normal(size=(b, l, h * d)).astype(np.float32)
    ckv = r.normal(size=(b, lk, 2 * h * d)).astype(np.float32)
    grid = (1, 1, l - 16)  # 16 registers + l-16 tokens on one axis
    cos, sin = rope_cos_sin(d, *grid, jnp.asarray([2, 0, 5]), num_registers=16)
    return qkv, v, q, ckv, np.array(cos), np.array(sin)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


def test_self_attention_twin_matches_pallas():
    qkv, v, _, _, cos, sin = _inputs(2, 333, 77)
    d = D
    jo, jlse = jfa._forward_short_qkv(
        jnp.asarray(qkv), jnp.asarray(v), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(cos), jnp.asarray(sin), H, d ** -0.5, True)
    to, tlse = tfa.qkv_rope_flash_forward(
        torch.from_numpy(qkv), torch.from_numpy(v), torch.from_numpy(cos),
        torch.from_numpy(sin), H)
    _close(to, jo)
    _close(tlse, np.asarray(jlse)[..., 0])
    assert tfa.qkv_rope_flash_forward.launches == 0  # CPU runs the twin


def test_cross_attention_twin_matches_pallas():
    _, _, q, ckv, _, _ = _inputs(2, 333, 77)
    hd = H * D
    k, v = ckv[..., :hd], ckv[..., hd:]
    z_q = jnp.zeros((q.shape[1], D // 2), jnp.float32)
    z_k = jnp.zeros((k.shape[1], D // 2), jnp.float32)
    jo, jlse = jfa._forward_short(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), z_q, z_q, z_k, z_k, H,
                                  D ** -0.5, False)
    ckv_t = torch.from_numpy(ckv)
    to, tlse = tfa.cross_flash_forward(torch.from_numpy(q), ckv_t[..., :hd],
                                       ckv_t[..., hd:], H)
    _close(to, jo)
    _close(tlse, np.asarray(jlse)[..., 0])
    # the public o-only entry agrees with JAX's public cross entry
    _close(tfa.cross_flash_attention(torch.from_numpy(q), ckv_t[..., :hd],
                                     ckv_t[..., hd:], H),
           jfa.cross_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), H))


def test_self_attention_entry_matches_public_jax():
    qkv, v, _, _, cos, sin = _inputs(1, 48, 48, seed=3)
    want = jfa.qkv_rope_flash_attention(jnp.asarray(qkv), jnp.asarray(v),
                                        jnp.asarray(cos), jnp.asarray(sin), H)
    got = tfa.qkv_rope_flash_attention(
        torch.from_numpy(qkv), torch.from_numpy(v), torch.from_numpy(cos),
        torch.from_numpy(sin), H)
    _close(got, want)



def _grad_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=5e-5, rtol=1e-4)


def test_self_attention_backward_matches_jax_vjp():
    """d(qkv) with its zero v columns, and dv of the separately passed v."""
    qkv, v, _, _, cos, sin = _inputs(2, 333, 77)
    do = np.random.default_rng(9).normal(size=v.shape).astype(np.float32)
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    _, vjp = jax.vjp(
        lambda a, b: jfa.qkv_rope_flash_attention(a, b, jc, js, H),
        jnp.asarray(qkv), jnp.asarray(v))
    jdqkv, jdv = vjp(jnp.asarray(do))

    tqkv = torch.from_numpy(qkv).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    out = tfa.qkv_rope_flash_attention(tqkv, tv, torch.from_numpy(cos),
                                       torch.from_numpy(sin), H)
    out.backward(torch.from_numpy(do))
    assert not tqkv.grad[..., 2 * H * D:].any()
    _grad_close(tqkv.grad, jdqkv)
    _grad_close(tv.grad, jdv)
    assert tfa.qkv_rope_flash_backward.launches == 0  # CPU runs the twin


def test_cross_attention_backward_matches_jax_vjp():
    """dq, and dk/dv through the strided column views of the context K/V."""
    _, _, q, ckv, _, _ = _inputs(2, 333, 77)
    hd = H * D
    do = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jfa.cross_flash_attention(a, b, c, H),
                     jnp.asarray(q), jnp.asarray(ckv[..., :hd]),
                     jnp.asarray(ckv[..., hd:]))
    jdq, jdk, jdv = vjp(jnp.asarray(do))

    tq = torch.from_numpy(q).requires_grad_()
    tckv = torch.from_numpy(ckv).requires_grad_()
    out = tfa.cross_flash_attention(tq, tckv[..., :hd], tckv[..., hd:], H)
    out.backward(torch.from_numpy(do))
    _grad_close(tq.grad, jdq)
    _grad_close(tckv.grad[..., :hd], jdk)
    _grad_close(tckv.grad[..., hd:], jdv)
    assert tfa.cross_flash_backward.launches == 0


def test_backward_twin_equals_autograd_of_forward_twin():
    """In fp32 the twin's hand-written backward is the exact gradient of
    the forward twin (no bf16 rounding points in play): RoPE on and off."""
    qkv, v, _, _, cos, sin = _inputs(1, 40, 40, seed=4)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    hd = H * D
    for rope in (True, False):
        c, s = (tc, ts) if rope else (None, None)
        q, k = (torch.from_numpy(qkv[..., i * hd:(i + 1) * hd]).requires_grad_()
                for i in range(2))
        tv = torch.from_numpy(v).requires_grad_()
        o, lse = tfa.short_attention_plain(q, k, tv, c, s, H, D ** -0.5)
        do = torch.ones_like(o) + 0.1 * torch.arange(o.numel()).reshape(
            o.shape).sin()
        want = torch.autograd.grad(o, (q, k, tv), do)
        got = tfa.short_attention_bwd_plain(q.detach(), k.detach(),
                                            tv.detach(), c, s, o.detach(),
                                            lse.detach(), do, H, D ** -0.5)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("what,b,h,lq,lk,want", [
    ("train self-attention, row 4", 64, 4, 528, 528, 1),
    ("train cross-attention, row 5", 64, 4, 528, 512, 1),
    ("train-long cross-attention", 2, 4, 8208, 512, 4),
    ("train-long self-attention, row 7", 2, 4, 8208, 8208, 1),
    ("ring fallback at cp 4, row 7 with the bias", 2, 4, 2064, 2064, 3),
    ("ring fallback at cp 2", 2, 4, 4112, 4112, 1),
    ("ring train chunk at cp 8, row 11", 2, 4, 1040, 1040, 3),
])
def test_backward_split_on_an_h100(what, b, h, lq, lk, want):
    """The backward kernel splits each 128-row kv block's q tiles over
    blocks only where the kv blocks alone leave the card's 132 SMs idle;
    these are the splits that PERF.md §6 measured against no split."""
    n_blocks = -(-lk // tfa._BWD_BN) * b * h
    assert tfa._bwd_splits(n_blocks, -(-lq // tfa._BWD_BQ), 132) == want, what
