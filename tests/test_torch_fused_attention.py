"""Short-path attention of the PyTorch port against the JAX package.

On the CPU the port's fused ops run their plain twin; it is held against
the Pallas kernels run in interpret mode (`_forward_short_qkv` for RoPE
self-attention, `_forward_short` with RoPE off for cross-attention), on o
and the exp2-domain lse, at a ragged shape. fp32: atol 2e-5, rtol 1e-4, as
tests/test_fused_attention.py. The CUDA kernel is held against the twin in
tests/test_torch_gpu_kernels.py.
"""

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

