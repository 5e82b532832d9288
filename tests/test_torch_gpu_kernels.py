"""The port's kernels against their plain twins, on the card.

Every test here carries the `gpu` marker and skips when no CUDA card is
present. The file imports torch only, so it also runs where JAX is not
installed; on such a machine run it without the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import pytest
import torch

from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as tad
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("l,lk,h,d", [(1040, 512, 16, 128),
                                      (333, 77, 16, 128), (333, 77, 4, 64)])
def test_attention_kernel_matches_twin(dev, l, lk, h, d):
    """bf16 kernel against the twin on the same bf16 inputs, self-attention
    with RoPE (q/k strided out of qkv) and cross-attention (k/v strided out
    of the context K/V). Both round q, k and p to bf16 at the same points,
    but the online softmax rescales p and sums p·v in another order, so o
    may differ by about one bf16 ulp of values of order 1."""
    hd = h * d
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    qkv, v, ckv = randn(2, l, 3 * hd), randn(2, l, hd), randn(2, lk, 2 * hd)
    ang = torch.arange(l * (d // 2), dtype=torch.float32, device=dev)
    ang = ang.reshape(l, d // 2) * 0.01
    cos, sin = ang.cos(), ang.sin()
    cases = [(qkv[..., :hd], qkv[..., hd:2 * hd], v, cos, sin),
             (qkv[..., :hd], ckv[..., :hd], ckv[..., hd:], None, None)]
    for q, k, vv, c, s in cases:
        o, lse = tfa.short_attention_cuda(q, k, vv, c, s, h, d ** -0.5)
        po, plse = tfa.short_attention_plain(q, k, vv, c, s, h, d ** -0.5)
        torch.cuda.synchronize()
        assert o.shape == (2, l, hd) and lse.shape == (2, h, l)
        assert (o.float() - po.float()).abs().max().item() < 2e-2
        assert (lse - plse).abs().max().item() < 1e-3


def test_attention_entry_points_launch_the_kernel(dev):
    h, d = 2, 64
    qkv = torch.randn(1, 40, 3 * h * d, device=dev).bfloat16()
    cos = torch.ones(40, d // 2, device=dev)
    before = tfa.qkv_rope_flash_forward.launches
    o = tfa.qkv_rope_flash_attention(qkv, qkv[..., 2 * h * d:], cos,
                                     torch.zeros_like(cos), h)
    assert tfa.qkv_rope_flash_forward.launches == before + 1
    ref, _ = tfa.short_attention_plain(qkv[..., :h * d],
                                       qkv[..., h * d:2 * h * d],
                                       qkv[..., 2 * h * d:], None, None, h,
                                       d ** -0.5)
    assert (o.float() - ref.float()).abs().max().item() < 2e-2


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 16, 2 * 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim 32
        tfa.short_attention_cuda(q, q, q, None, None, 2, 1.0)
    with pytest.raises(TypeError):  # fp32
        tfa.short_attention_cuda(q.float(), q.float(), q.float(), None, None,
                                 1, 1.0)
    qg = q.reshape(1, 16, 64).clone().requires_grad_()
    with pytest.raises(RuntimeError):  # no backward kernel yet
        tfa.cross_flash_attention(qg, qg, qg, 1)


@pytest.mark.parametrize("l,with_gamma", [(1040, False), (333, True)])
def test_adaln_kernel_matches_twin(dev, l, with_gamma):
    """bf16 in and out, fp32 inside on both sides: they differ only by the
    order of the row sum, which can flip the last bf16 rounding of y, one
    ulp being at most 2^-7 of |y|. x is a row slice and shift/scale are
    column views of a 9-way modulation, as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(0)
    d = 2048
    x = torch.randn(2, l + 16, d, generator=gen, device=dev).bfloat16()[:, 16:]
    mod = torch.randn(2, 9 * d, generator=gen, device=dev).bfloat16()
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    gamma = torch.randn(d, generator=gen, device=dev) if with_gamma else None
    before = tad.adaln_rms_modulate.launches
    y = tad.adaln_rms_modulate(x, shift, scale, gamma)
    want = tad.adaln_rms_modulate_plain(x, shift, scale, gamma)
    torch.cuda.synchronize()
    assert tad.adaln_rms_modulate.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    torch.testing.assert_close(y.float(), want.float(), rtol=2 ** -7,
                               atol=1e-2)
