"""The ring (context-parallel) attention of the PyTorch port against the JAX
package, on the CPU.

The port's ring chunk ops run their plain twins on CPU tensors
(`ring_chunk_plain` / `ring_chunk_bwd_plain`, what `csrc/ring_attention_
{fwd,bwd}.cu` compute; above the ceilings the long twins with the
kv-bias). They are held against JAX's `_ring_chunk_fwd` / `_ring_chunk_bwd`
with the Pallas kernels in interpret mode, below and above the ceilings
(forced small on both packages), with a padded tail and with a chunk that
is all padding; `online_merge` against `_online_merge`; and
`cp_rope_flash_attention` over `LocalRing(4)` against JAX's
`cp_rope_flash_attention` on the 8-device CPU mesh (context = 4), forward
and q/k/v gradients.

Tolerances, both sides in fp32:
- chunk ops and the merge: max |got − want| ≤ 1e-5 of max |want| (only
  the summation order differs; the fallback rotates q/k once outside the
  long kernel, as JAX rotates them inside it, in fp32 either way);
- the whole ring: atol 1e-4, rtol 1e-3, JAX's own bound for its ring
  against unsharded attention (tests/test_fused_attention.py:297-301).
The CUDA kernels are held against the twins on the card by
tests/test_torch_gpu_kernels.py and chip_smoke.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.models.rope import rope_cos_sin
from video_diffusion_speedrun_tpu.ops import fused_attention as jfa
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

H, D = 2, 32
TOL = 1e-5


def _rel(got: torch.Tensor, want) -> float:
    """max |got − want| over max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


def _chunk_inputs(lq, lk, pad, seed=0, k_row0=100):
    """q [1, lq, H·D], k/v/do, the q rows' and the kv chunk's tables (rows
    of one table at offsets 0 and `k_row0`) and the kv-bias [lk] with
    −1e30 on the last `pad` rows, as numpy."""
    r = np.random.default_rng(seed)
    q, do = (r.normal(size=(2, lq, H * D)).astype(np.float32)
             for _ in range(2))
    k, v = (r.normal(size=(2, lk, H * D)).astype(np.float32)
            for _ in range(2))
    ang = r.uniform(0, 6, size=(k_row0 + lk, D // 2)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    tabs = (cos[:lq], sin[:lq], cos[k_row0:], sin[k_row0:])
    kbias = np.where(np.arange(lk) < lk - pad, 0.0, -1e30).astype(np.float32)
    return q, k, v, do, tabs, kbias


def _ceilings(fwd, bwd):
    """Both packages' ring ceilings patched to (fwd, bwd)."""
    stack = []
    for mod in (jfa, tfa):
        stack.append(mock.patch.object(mod, "_RING_FULLK_MAX_FWD", fwd))
        stack.append(mock.patch.object(mod, "_RING_FULLK_MAX_BWD", bwd))
    return stack


# (lq, lk, pad, ceilings): both ring kernels; both fallbacks; the forward
# kernel beside the backward fallback (the cp = 4 serve case in miniature);
# ragged Lq ≠ Lk
CHUNKS = [(48, 64, 16, (4096, 2048)), (48, 64, 16, (32, 32)),
          (33, 80, 5, (96, 32)), (64, 48, 0, (4096, 2048))]


@pytest.mark.parametrize("lq,lk,pad,ceil", CHUNKS)
def test_ring_chunk_matches_jax(lq, lk, pad, ceil):
    q, k, v, do, tabs, kbias = _chunk_inputs(lq, lk, pad)
    j = [jnp.asarray(t) for t in (q, k, v, *tabs)]
    t = [torch.from_numpy(a) for a in (q, k, v, *tabs)]
    patches = _ceilings(*ceil)
    for p in patches:
        p.start()
    try:
        jo, jlse = jfa._ring_chunk_fwd(*j, jnp.asarray(kbias)[None], H,
                                       D ** -0.5)
        o, lse = tfa.ring_chunk_forward(*t, torch.from_numpy(kbias), H,
                                        D ** -0.5)
        assert _rel(o, jo) < TOL and _rel(lse, jlse[..., 0]) < TOL
        # a merged lse above the chunk's own (other chunks' mass): p < 1
        lse_m = np.asarray(jlse) + np.random.default_rng(1).uniform(
            0, 2, size=jlse.shape).astype(np.float32)
        want = jfa._ring_chunk_bwd(*j, jnp.asarray(kbias)[None], jo,
                                   jnp.asarray(lse_m), jnp.asarray(do), H,
                                   D ** -0.5)
        got = tfa.ring_chunk_backward(
            *t, torch.from_numpy(kbias), torch.from_numpy(np.array(jo)),
            torch.from_numpy(lse_m[..., 0]).contiguous(),
            torch.from_numpy(do), H, D ** -0.5)
    finally:
        for p in patches:
            p.stop()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) < TOL, name


@pytest.mark.parametrize("ceil", [(4096, 2048), (32, 32)])
def test_fully_masked_chunk_is_finite(ceil):
    """A chunk that is all padding (tiny L or large cp): finite o and
    lse ≈ −1e30 on both sides, so the merge gives it zero weight. On the
    ring kernels' path the o agree too (the mean of v); JAX's blocked
    fallback also averages its zero-padded block columns there, which
    the port masks, a difference the merge never sees."""
    q, k, v, _, tabs, kbias = _chunk_inputs(32, 64, 64, seed=2)
    patches = _ceilings(*ceil)
    for p in patches:
        p.start()
    try:
        jo, jlse = jfa._ring_chunk_fwd(
            *(jnp.asarray(a) for a in (q, k, v, *tabs)),
            jnp.asarray(kbias)[None], H, D ** -0.5)
        o, lse = tfa.ring_chunk_forward(
            *(torch.from_numpy(a) for a in (q, k, v, *tabs)),
            torch.from_numpy(kbias), H, D ** -0.5)
    finally:
        for p in patches:
            p.stop()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert lse.max().item() < -1e29 and float(jnp.max(jlse)) < -1e29
    if ceil[0] >= 64:
        assert _rel(o, jo) < TOL


def test_online_merge_matches_jax():
    """Random partials, and rows where both lse are −1e30 (a padded query
    row that has seen only padding): finite, lse −1e30."""
    r = np.random.default_rng(3)
    o1, o2 = (r.normal(size=(2, 40, H * D)).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (r.normal(size=(2, H, 40)).astype(np.float32) * 4
                  for _ in range(2))
    lse1[:, :, -5:] = lse2[:, :, -5:] = -1e30
    jo, jlse = jfa._online_merge(jnp.asarray(o1), jnp.asarray(lse1)[..., None],
                                 jnp.asarray(o2), jnp.asarray(lse2)[..., None],
                                 H)
    o, lse = tfa.online_merge(*(torch.from_numpy(a)
                                for a in (o1, lse1, o2, lse2)), H)
    assert _rel(o, jo) < TOL
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=1e-6, atol=1e-5)
    assert torch.isfinite(o).all() and (lse[:, :, -5:] == -1e30).all()


@pytest.fixture(scope="module")
def token_sharding():
    from jax.sharding import NamedSharding

    from video_diffusion_speedrun_tpu.core.config import MeshConfig
    from video_diffusion_speedrun_tpu.parallel.mesh import (
        build_mesh,
        token_pspec,
    )

    mesh = build_mesh(MeshConfig(replica=1, fsdp=2, context=4, tensor=1))
    return NamedSharding(mesh, token_pspec())


# L = 52 (ragged: chunk 16, the last 12 rows padding), 144 (chunk 48,
# 48 padded rows: the last chunk is all padding), 244 with the ceilings
# forced to 32 (chunk 64: every step takes the long kernels with the bias)
@pytest.mark.parametrize("l,ceil", [(52, None), (144, None), (244, (32, 32))])
def test_cp_rope_flash_attention_matches_jax(token_sharding, l, ceil):
    r = np.random.default_rng(l)
    d = 16
    q, k, v, do = (r.normal(size=(2, l, H * d)).astype(np.float32)
                   for _ in range(4))
    cos, sin = (np.asarray(t)[:l] for t in rope_cos_sin(
        d, 16, 4, 4, jnp.zeros(3, jnp.int32)))

    def loss(q, k, v):
        out = jfa.cp_rope_flash_attention(q, k, v, jnp.asarray(cos),
                                          jnp.asarray(sin), H, token_sharding)
        return jnp.sum(out * jnp.asarray(do)), out

    patches = [] if ceil is None else _ceilings(*ceil)
    for p in patches:
        p.start()
    try:
        (_, want), wgrads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        got = tfa.cp_rope_flash_attention(*ts, torch.from_numpy(cos),
                                          torch.from_numpy(sin), H,
                                          LocalRing(4))
        got.backward(torch.from_numpy(do))
    finally:
        for p in patches:
            p.stop()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-3)
    for name, t, w in zip("qkv", ts, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-3, err_msg=f"d{name}")


def test_ring_layout_matches_jax():
    """chunk = ⌈L/(cp·16)⌉·16 (`fused_attention.py:2025-2026`) at the
    canonical L = 8208 and the tests' lengths."""
    for l, cp, want in ((8208, 2, 4112), (8208, 4, 2064), (8208, 8, 1040),
                        (52, 4, 16), (29, 8, 16)):
        chunk, lp = tfa.ring_layout(l, cp)
        assert chunk == want == jfa._cdiv(l, cp * jfa._ALIGN) * jfa._ALIGN
        assert lp == cp * chunk
    bias = tfa.ring_kbias(52, 64, "cpu")
    assert bias.dtype == torch.float32 and (bias[:52] == 0).all()
    assert (bias[52:] == -1e30).all()
