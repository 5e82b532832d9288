"""The port's kernels against their plain twins, on the card.

Every test here carries the `gpu` marker and skips when no CUDA card is
present. The file imports torch only, so it also runs where JAX is not
installed; on such a machine run it without the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import math

import pytest
import torch

from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as tfw
from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as tad
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.models.rope import nd_rope_cos_sin
from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as tfg
from video_diffusion_speedrun_tpu_torch.ops import fused_mmdit as fm

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
    long_kv = torch.zeros(1, tfa.SHORT_MAX_KV + 16, 64, device=dev,
                          dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # long kv takes the long kernels
        tfa.short_attention_cuda(q, long_kv, long_kv, None, None, 1, 1.0)
    with pytest.raises(ValueError):  # head_dim 32
        tfa.long_attention_cuda(q, q, q, 2, 1.0)


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


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("b,l,lk,h,d", [(4, 528, 512, 4, 128),
                                        (2, 333, 77, 4, 128),
                                        (2, 333, 77, 2, 64)])
def test_attention_bwd_kernel_matches_twin(dev, b, l, lk, h, d):
    """dq, dk, dv of the bf16 kernel against the twin on the same inputs,
    self-attention (RoPE, q/k strided out of qkv, dq/dk written into the
    column slices of d(qkv)) and cross-attention. Both round p and ds to
    bf16 at the same points; δ and the products sum in other orders, which
    can flip a bf16 rounding of ds and the final bf16 rounding of the
    result: within 2% of the tensor's largest magnitude."""
    hd = h * d
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    qkv, v, ckv = randn(b, l, 3 * hd), randn(b, l, hd), randn(b, lk, 2 * hd)
    ang = torch.arange(l * (d // 2), dtype=torch.float32, device=dev)
    ang = ang.reshape(l, d // 2) * 0.01
    cos, sin = ang.cos(), ang.sin()
    scale = d ** -0.5
    for q, k, vv, c, s in ((qkv[..., :hd], qkv[..., hd:2 * hd], v, cos, sin),
                           (qkv[..., :hd], ckv[..., :hd], ckv[..., hd:], None,
                            None)):
        o, lse = tfa.short_attention_cuda(q, k, vv, c, s, h, scale)
        do = randn(b, l, hd)
        got = tfa.short_attention_bwd_cuda(q, k, vv, c, s, o, lse, do, h,
                                           scale)
        want = tfa.short_attention_bwd_plain(q, k, vv, c, s, o, lse, do, h,
                                             scale)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and x.dtype == torch.bfloat16, name
            assert _rel_err(x, y) < 2e-2, name
    # the self-attention entry: d(qkv) with zero v columns, and dv
    before = tfa.qkv_rope_flash_backward.launches
    o, lse = tfa.qkv_rope_flash_forward(qkv, v, cos, sin, h)
    do = randn(b, l, hd)
    dqkv, dv = tfa.qkv_rope_flash_backward(qkv, v, cos, sin, o, lse, do, h,
                                           scale)
    dq, dk, dv_want = tfa.short_attention_bwd_plain(
        qkv[..., :hd], qkv[..., hd:2 * hd], v, cos, sin, o, lse, do, h, scale)
    torch.cuda.synchronize()
    assert tfa.qkv_rope_flash_backward.launches == before + 1
    assert not dqkv[..., 2 * hd:].any()
    assert _rel_err(dqkv[..., :hd], dq) < 2e-2
    assert _rel_err(dqkv[..., hd:2 * hd], dk) < 2e-2
    assert _rel_err(dv, dv_want) < 2e-2


def test_attention_autograd_launches_both_kernels(dev):
    h, d, l = 4, 128, 100
    gen = torch.Generator(device=dev).manual_seed(2)
    qkv = torch.randn(2, l, 3 * h * d, generator=gen, device=dev).bfloat16()
    qkv.requires_grad_()
    cos = torch.ones(l, d // 2, device=dev)
    fwd, bwd = (tfa.qkv_rope_flash_forward.launches,
                tfa.qkv_rope_flash_backward.launches)
    out = tfa.qkv_rope_flash_attention(qkv, qkv[..., 2 * h * d:], cos,
                                       torch.zeros_like(cos), h)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert tfa.qkv_rope_flash_forward.launches == fwd + 1
    assert tfa.qkv_rope_flash_backward.launches == bwd + 1
    assert torch.isfinite(qkv.grad.float()).all()
    assert qkv.grad[..., 2 * h * d:].abs().sum() > 0  # dv through the view


# (B, L, D, γ, x strided): the train shape; L = 333; B = 1; L shorter than
# one ring stage (8 rows); runs that cross many b boundaries (L = 7); the
# final layer's strided x at D = 2048 (partials in shared memory); D = 100
# (rows of 200 bytes: the masked loads); D = 520 (32 columns a lane)
ADALN_BWD_CASES = [(8, 528, 512, False, True), (8, 333, 512, True, False),
                   (1, 528, 512, True, True), (4, 3, 512, True, False),
                   (5, 7, 512, True, True), (2, 333, 2048, True, True),
                   (3, 37, 100, True, True), (2, 40, 520, False, False)]


@pytest.mark.parametrize("b,l,d,with_gamma,strided", ADALN_BWD_CASES)
def test_adaln_bwd_kernel_matches_twin(dev, b, l, d, with_gamma, strided):
    """dx, dshift, dscale, dγ of the CUDA backward against the twin, fp32
    inside on both sides: dx within one bf16 ulp (2^-7 relative) plus 1% of
    its scale for cancellation in dn − n·mean(n·dn); the column sums differ
    in summation order (bf16 outputs: one ulp; dγ fp32: 1e-4)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(b, l + 16, d, generator=gen, device=dev).bfloat16()
    x = x[:, 16:] if strided else x[:, :l].contiguous()
    mod = torch.randn(b, 9 * d, generator=gen, device=dev).bfloat16()
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    gamma = torch.randn(d, generator=gen, device=dev) if with_gamma else None
    g = torch.randn(b, l, d, generator=gen, device=dev).bfloat16()
    before = tad.adaln_rms_modulate_bwd.launches
    got = tad.adaln_rms_modulate_bwd(x, shift, scale, gamma, g)
    want = tad.adaln_rms_modulate_bwd_plain(x, shift, scale, gamma, g)
    torch.cuda.synchronize()
    assert tad.adaln_rms_modulate_bwd.launches == before + 1
    dx, dx_want = got[0].float(), want[0].float()
    assert torch.all((dx - dx_want).abs() <= 2 ** -7 * dx_want.abs()
                     + 1e-2 * dx_want.abs().max())
    for x_, y_ in zip(got[1:3], want[1:3]):
        assert x_.dtype == torch.bfloat16
        torch.testing.assert_close(x_.float(), y_.float(), rtol=2 ** -7,
                                   atol=1e-3 * y_.float().abs().max().item())
    if with_gamma:
        torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-3)
    else:
        assert got[3] is None


def _bwd_args(dev, gated, b=16, l=528, d=512):
    gen = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    mod, gamma = randn(b, 9 * d), torch.randn(d, generator=gen, device=dev)
    if gated:
        return (randn(b, l, d), randn(b, l, d), mod[:, 2 * d:3 * d],
                mod[:, d:2 * d], gamma, randn(b, l, d), randn(b, l, d))
    return randn(b, l, d), mod[:, :d], mod[:, d:2 * d], gamma, randn(b, l, d)


@pytest.mark.parametrize("gated", [False, True])
def test_adaln_bwd_kernel_is_deterministic(dev, gated):
    """50 launches give the same bits: the column sums add in a fixed
    order (CTAs, groups, b's), with no float atomics."""
    fn = tad.gated_residual_adaln_bwd if gated else tad.adaln_rms_modulate_bwd
    args = _bwd_args(dev, gated)
    first = fn(*args)
    for _ in range(50):
        again = fn(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("gated", [False, True])
def test_adaln_autograd_launches_one_backward_kernel(dev, gated):
    """The autograd path's backward is one kernel launch and nothing else
    on the device (after the first call, which zeroes the tickets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = [t.detach().clone().requires_grad_() for t in _bwd_args(dev, gated)]
    if gated:
        ins, cot = args[:5], (args[5].detach(), args[6].detach())
        ins = ins[:3] + [ins[3].detach().clone().requires_grad_()] + ins[3:]
        run = lambda: tad.gated_residual_adaln(*ins)  # noqa: E731
        counter = tad.gated_residual_adaln_bwd
    else:
        ins, cot = args[:4], (args[4].detach(),)
        run = lambda: (tad.adaln_rms_modulate(*ins),)  # noqa: E731
        counter = tad.adaln_rms_modulate_bwd
    torch.autograd.backward(run(), cot)  # warm-up: build, tickets
    for t in ins:  # no accumulation into earlier gradients below
        t.grad = None
    outs = run()
    torch.cuda.synchronize()
    before = counter.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.backward(outs, cot)
        torch.cuda.synchronize()
    assert counter.launches == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "adaln_bwd_kernel" in kernels[0], kernels


def test_adaln_bwd_smem_matches_the_kernel_layout(dev):
    """The wrapper sizes the kernel's shared memory as the kernel lays it
    out (`_bwd_smem` against `adaln_bwd_smem`)."""
    lib = tad._library()
    for d in (100, 512, 520, 2048, 8192):
        for t, td, gated in ((2, 2, 0), (4, 4, 0), (2, 4, 1), (4, 2, 1)):
            for has_gamma in (0, 1):
                for mode in (tad.C16, tad.C32, tad.SMEM, tad.MASKED):
                    assert tad._bwd_smem(mode, d, 8, 3, t, td, gated,
                                         has_gamma) == lib.adaln_bwd_smem(
                        gated, has_gamma, int(t == 2), int(td == 2), mode, d,
                        8, 3)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adamw_kernel_matches_twin(dev, moments):
    """One launch over leaves of the canonical shapes (and a 1-element
    leaf, a ragged one) against the twin leaf by leaf, three steps. The
    kernel rounds every operation on its own (no FMA contraction), as the
    JAX leaf math does; the twin on CUDA differs only where PyTorch divides
    by a scalar through its reciprocal (m/bc1, v/bc2): a few ulps of the
    update, whose size is the leaf's lr (within 1e-6·lr), plus an ulp of
    the weight. The moments take no division and agree to the bit."""
    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = [(1536, 512), (512,), (1,), (4608, 512), (16, 3), (2048, 512)]
    params = [torch.randn(s, generator=gen, device=dev) * 0.02 for s in shapes]
    twin = [p.clone() for p in params]
    mk = [torch.zeros_like(p, dtype=moments) for p in params]
    vk = [torch.zeros_like(p, dtype=moments) for p in params]
    mt, vt = [m.clone() for m in mk], [v.clone() for v in vk]
    lrs = [2 ** -6 * 32 / s[-1] for s in shapes]
    wds = [0.1 * s[-1] / 1024 for s in shapes]
    kernel = tfw.MultiTensorAdamW(params, mk, vk, lrs, wds, 0.95, 0.99, 1e-8)
    for step in range(3):
        grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        lr_t, bc1, bc2 = tfw.step_scalars(step, 0.5 + step / 8, 0.95, 0.99)
        before = tfw.MultiTensorAdamW.launches
        kernel(grads, lr_t, bc1, bc2)
        assert tfw.MultiTensorAdamW.launches == before + 1
        for i, g in enumerate(grads):
            tfw.adamw_leaf_update_plain(twin[i], mt[i], vt[i], g, lrs[i],
                                        wds[i], lr_t, bc1, bc2, 0.95, 0.99,
                                        1e-8)
    torch.cuda.synchronize()
    for a, b, lr in zip(params, twin, lrs):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-6 * lr)
    for a, b in zip(mk + vk, mt + vt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 2100, 2100, 4, 128),
                                          (1, 333, 2100, 2, 64),
                                          (2, 2064, 2064, 16, 128)])
def test_long_attention_kernels_match_twins(dev, b, lq, lk, h, d):
    """The long forward and backward kernels against their twins over
    pre-rotated bf16 inputs (q/k strided out of qkv), ragged lengths. The
    forward within one bf16 ulp of values of order 1 (the online softmax
    sums in another order), lse within 1e-3; the gradients within 2% of
    each one's largest magnitude, as the short backward."""
    hd = h * d
    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q = randn(b, lq, 3 * hd)[..., :hd]
    kv = randn(b, lk, 3 * hd)
    k, v = kv[..., hd:2 * hd], kv[..., 2 * hd:]
    scale = d ** -0.5
    before = tfa.long_attention_forward.launches
    o, lse = tfa.long_attention_forward(q, k, v, h, scale)
    po, plse = tfa.long_attention_plain(q, k, v, h, scale)
    torch.cuda.synchronize()
    assert tfa.long_attention_forward.launches == before + 1
    assert o.shape == (b, lq, hd) and lse.shape == (b, h, lq)
    assert (o.float() - po.float()).abs().max().item() < 2e-2
    assert (lse - plse).abs().max().item() < 1e-3
    do = randn(b, lq, hd)
    before = tfa.long_attention_backward.launches
    got = tfa.long_attention_backward(q, k, v, o, lse, do, h, scale)
    want = tfa.long_attention_bwd_plain(q, k, v, o, lse, do, h, scale)
    torch.cuda.synchronize()
    assert tfa.long_attention_backward.launches == before + 1
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        assert _rel_err(x, y) < 2e-2, name


def test_long_autograd_launches_both_kernels(dev):
    """`rope_flash_attention` past SHORT_MAX_KV: one long forward and one
    long backward launch, finite gradients for q, k and v."""
    h, d, l = 2, 128, 2064
    gen = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(1, l, 3 * h * d, generator=gen, device=dev).bfloat16()
    qkv.requires_grad_()
    ang = torch.arange(l * (d // 2), dtype=torch.float32, device=dev)
    ang = ang.reshape(l, d // 2) * 0.01
    hd = h * d
    fwd, bwd = (tfa.long_attention_forward.launches,
                tfa.long_attention_backward.launches)
    out = tfa.rope_flash_attention(qkv[..., :hd], qkv[..., hd:2 * hd],
                                   qkv[..., 2 * hd:], ang.cos(), ang.sin(), h)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert tfa.long_attention_forward.launches == fwd + 1
    assert tfa.long_attention_backward.launches == bwd + 1
    assert torch.isfinite(qkv.grad.float()).all()
    assert all(qkv.grad[..., i * hd:(i + 1) * hd].abs().sum() > 0
               for i in range(3))


# (B, L, D, γ, dtype of x, dtype of δ): the serve and train shapes; L = 333;
# B = 1; L shorter than one ring stage; runs across many b boundaries;
# D = 100 (the masked loads); fp32 rows; fp32 δ beside bf16 x
GR_CASES = [(2, 1040, 2048, False, torch.bfloat16, torch.bfloat16),
            (8, 528, 512, True, torch.bfloat16, torch.bfloat16),
            (3, 333, 512, False, torch.bfloat16, torch.bfloat16),
            (1, 528, 512, True, torch.bfloat16, torch.bfloat16),
            (4, 3, 512, True, torch.bfloat16, torch.bfloat16),
            (5, 7, 512, False, torch.bfloat16, torch.bfloat16),
            (3, 37, 100, True, torch.bfloat16, torch.bfloat16),
            (2, 100, 512, True, torch.float32, torch.float32),
            (2, 100, 512, False, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("b,l,d,with_gamma,dtype,ddtype", GR_CASES)
def test_gated_residual_kernels_match_twins(dev, b, l, d, with_gamma, dtype,
                                            ddtype):
    """Rows 13–14 against their twins, fp32 inside on both sides: x_new and
    y within one bf16 ulp (y + 1e-2 for the row-sum order, as row 3); dx
    and dδ one ulp + 1% of scale, the [B, D] sums one ulp + 0.1% of scale,
    dγ 1e-4, as row 12. x is a row slice and gate/shift/scale are column
    views of a 9-way modulation, as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    x = randn(b, l + 16, d)[:, 16:]
    delta, gx, gy = randn(b, l, d, dt=ddtype), randn(b, l, d), randn(b, l, d)
    mod = randn(b, 9 * d)
    gate, shift, scale = mod[:, 2 * d:3 * d], mod[:, :d], mod[:, d:2 * d]
    gamma = randn(d).float() if with_gamma else None
    before = tad.gated_residual_adaln.launches
    x_new, y = tad.gated_residual_adaln(x, delta, gate, shift, scale, gamma)
    want_new, want_y = tad.gated_residual_adaln_plain(x, delta, gate, shift,
                                                      scale, gamma)
    torch.cuda.synchronize()
    assert tad.gated_residual_adaln.launches == before + 1
    torch.testing.assert_close(x_new.float(), want_new.float(),
                               rtol=2 ** -7, atol=1e-6)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=2 ** -7,
                               atol=1e-2)
    before = tad.gated_residual_adaln_bwd.launches
    got = tad.gated_residual_adaln_bwd(want_new, delta, gate, scale, gamma,
                                       gx, gy)
    want = tad.gated_residual_adaln_bwd_plain(want_new, delta, gate, scale,
                                              gamma, gx, gy)
    torch.cuda.synchronize()
    assert tad.gated_residual_adaln_bwd.launches == before + 1
    for i, (a, w) in enumerate(zip(got, want)):
        if w is None:
            assert a is None
            continue
        a, w = a.float(), w.float()
        scale_ = w.abs().max().item()
        if i < 2:
            assert torch.all((a - w).abs() <= 2 ** -7 * w.abs()
                             + 1e-2 * scale_), i
        elif i < 5:
            torch.testing.assert_close(a, w, rtol=2 ** -7,
                                       atol=1e-3 * scale_)
        else:
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-3)


def test_gated_residual_autograd_launches_both_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    x, delta = (torch.randn(2, 100, 256, generator=gen, device=dev)
                .bfloat16().requires_grad_() for _ in "ab")
    mod = torch.randn(2, 9 * 256, generator=gen, device=dev).bfloat16()
    mod.requires_grad_()
    fwd, bwd = (tad.gated_residual_adaln.launches,
                tad.gated_residual_adaln_bwd.launches)
    x_new, y = tad.gated_residual_adaln(x, delta, mod[:, 512:768],
                                        mod[:, :256], mod[:, 256:512])
    y.float().square().sum().backward()  # x_new's cotangent is zero
    torch.cuda.synchronize()
    assert tad.gated_residual_adaln.launches == fwd + 1
    assert tad.gated_residual_adaln_bwd.launches == bwd + 1
    assert all(torch.isfinite(t.grad.float()).all() for t in (x, delta, mod))
    assert mod.grad[:, 768:].abs().sum() == 0  # outside gate/shift/scale


def _gelu_atol(s, factor, coeffs):
    """Four fp32 ulps of factor·(0.5 + Σ|c_i|·t^2i), t = min(|s|/R, 1):
    the polynomial's largest term (the kernels contract their Horner chains
    into FMAs and the CUDA backward sums the MLP's Φ + s·Φ' into one
    polynomial; the twin does neither)."""
    t2 = (s.abs() / tfg._POLY_R).clamp(max=1.0).square()
    terms = sum(abs(c) * t2 ** i for i, c in enumerate(coeffs))
    return 2.0 ** -22 * factor * (0.5 + terms)


@pytest.mark.parametrize("mode,shape,with_bias", [
    (tfg.BLOCK, (8, 528, 2048), True), (tfg.BLOCK, (3, 333, 320), True),
    (tfg.BLOCK, (64, 528, 512), True), (tfg.BLOCK, (4, 1040, 8192), True),
    (tfg.BLOCK, (3, 77, 100), True),
    (tfg.POLY, (2, 333, 512), True), (tfg.POLY, (2, 333, 512), False),
    (tfg.ERF, (2, 333, 512), True), (tfg.ERF, (2, 19, 96), False),
    (tfg.ERF, (2, 33, 333), True)])
def test_bias_gelu_kernels_match_twins(dev, mode, shape, with_bias):
    """Rows 15–16 against their twins on the same inputs: one ulp of the
    output plus four fp32 ulps of the fitted polynomial's largest term
    (bf16), or 2^-20 relative to the inputs' scale (fp32, where the
    kernels' exp2 and division round otherwise); dbias within the dx bound
    summed over the rows plus 1e-5. The shapes: the train shape's rows,
    the ragged (3, 333, 320), the tensor-parallel t = 4 columns
    [64, 528, 512], the XL width's 8192 columns (eight slabs of the
    backward), rows of 200 and 1332 bytes (the backward's masked loads; at
    F = 333 also its scalar sums). A second backward launch gives the same
    bits."""
    gen = torch.Generator(device=dev).manual_seed(12)
    dt = torch.float32 if mode == tfg.ERF else torch.bfloat16
    x = (torch.randn(*shape, generator=gen, device=dev) * 3).to(dt)
    bias = ((torch.randn(shape[-1], generator=gen, device=dev) * 0.5).to(dt)
            if with_bias else None)
    g = torch.randn(*shape, generator=gen, device=dev).to(dt)
    s = tfg._preact(x, bias, mode)
    before = (tfg.bias_gelu_forward.launches, tfg.bias_gelu_backward.launches)
    y = tfg.bias_gelu_forward(x, bias, mode)
    dx, db = tfg.bias_gelu_backward(x, bias, g, mode)
    want_y = tfg.bias_gelu_fwd_plain(x, bias, mode)
    want_dx, want_db = tfg.bias_gelu_bwd_plain(x, bias, g, mode)
    torch.cuda.synchronize()
    assert (tfg.bias_gelu_forward.launches,
            tfg.bias_gelu_backward.launches) == (before[0] + 1, before[1] + 1)
    if mode == tfg.ERF:
        ulp = 2.0 ** -20
        atol_y = ulp * s.abs() * (1 + s.abs())
        atol_dx = ulp * g.float().abs() * (1 + s.abs())
    else:
        ulp = 2.0 ** -7
        atol_y = _gelu_atol(s, s.abs(), tfg._PHI_C)
        coeffs = tfg._DPHI_C if mode == tfg.BLOCK else tfg._DGELU_C
        atol_dx = _gelu_atol(s, g.float().abs(), coeffs) * (
            1 + s.abs() / tfg._POLY_R)
    assert y.dtype == dx.dtype == dt
    assert torch.all((y.float() - want_y.float()).abs()
                     <= ulp * want_y.float().abs() + atol_y)
    assert torch.all((dx.float() - want_dx.float()).abs()
                     <= ulp * want_dx.float().abs() + atol_dx)
    if with_bias:
        col = (atol_dx + ulp * want_dx.float().abs()).reshape(-1, shape[-1])
        assert db.dtype == bias.dtype
        assert torch.all((db.float() - want_db.float()).abs()
                         <= col.sum(0) + 1e-5 * want_db.float().abs())
    else:
        assert db is None
    again = tfg.bias_gelu_backward(x, bias, g, mode)
    assert torch.equal(again[0], dx)
    assert db is None or torch.equal(again[1], db)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 528, 2048), (64, 528, 512),
                                   (16, 1040, 8192)])
def test_bias_gelu_backward_sums_exactly(dev, shape, bias_dtype):
    """The MLP's backward at the main path's shapes (the train step, its
    t = 4 columns, the XL in-backward step) on inputs where every number is
    exact: |x + bias| ≥ 5 (dg exactly 0 or 1), g of integers 1..7, so every
    dx and every fp32 partial sum of dbias is exact and dbias must equal
    the twin's bit for bit. A finish that drops or repeats a split, a group
    of splits or a row moves an fp32 dbias column by at least 1."""
    gen = torch.Generator(device=dev).manual_seed(17)

    def rand(*size):
        return torch.rand(*size, generator=gen, device=dev)

    sign = torch.where(rand(*shape) < 0.75, 1.0, -1.0)
    x = (sign * (6.0 + 2.0 * rand(*shape))).bfloat16()
    bias = (2.0 * rand(shape[-1]) - 1.0).to(bias_dtype)
    g = torch.randint(1, 8, shape, generator=gen, device=dev).bfloat16()
    dx, db = tfg.bias_gelu_backward(x, bias, g, tfg.BLOCK)
    want_dx, want_db = tfg.bias_gelu_bwd_plain(x, bias, g, tfg.BLOCK)
    assert db.dtype == bias_dtype
    assert torch.equal(dx, want_dx)
    assert torch.equal(db, want_db)


@pytest.mark.parametrize("mode", [tfg.BLOCK, tfg.POLY, tfg.ERF])
def test_bias_gelu_backward_keeps_the_twins_nan(dev, mode):
    """At s = ±∞ and NaN the backward gives NaN where the twin does (the
    MLP's s·Φ'(s) and the erf form's s·φ(s) are ±∞·0; POLY's own fit
    saturates to 0 / 1), in dx and in dbias, and the twin's values
    elsewhere."""
    dt = torch.float32 if mode == tfg.ERF else torch.bfloat16
    x = torch.tensor([math.inf, -math.inf, math.nan, 4.5, -4.5, 0.5, 1e4,
                      -1e4], device=dev).repeat(2, 5, 4).to(dt)  # [2, 5, 32]
    bias = torch.zeros(32, device=dev).to(dt)
    g = torch.ones_like(x)
    dx, db = tfg.bias_gelu_backward(x, bias, g, mode)
    want_dx, want_db = tfg.bias_gelu_bwd_plain(x, bias, g, mode)
    assert torch.equal(dx.isnan(), want_dx.isnan())
    assert torch.equal(db.isnan(), want_db.isnan())
    assert bool(dx.isnan()[..., 2::8].all())
    fin = ~want_dx.isnan()
    assert torch.allclose(dx[fin].float(), want_dx[fin].float(), rtol=2 ** -7,
                          atol=1e-5)


_ONE_GELU_BACKWARD = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as tfg

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(16)
h = torch.randn(64, 528, 512, generator=gen, device=dev).bfloat16()
bias = torch.randn(512, generator=gen, device=dev).bfloat16()
cot = torch.randn(64, 528, 512, generator=gen, device=dev).bfloat16()


def run():
    hh = h.clone().requires_grad_()
    bb = bias.clone().requires_grad_()
    return hh, bb, tfg.mlp_bias_gelu(hh, bb)


hh, bb, y = run()
y.backward(cot)  # warm-up: build, tickets
hh, bb, y = run()
torch.cuda.synchronize()
before = tfg.bias_gelu_backward.launches
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    y.backward(cot)
    torch.cuda.synchronize()
print(json.dumps({
    "launches": tfg.bias_gelu_backward.launches - before,
    "kernels": [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA],
    "dtypes": [str(hh.grad.dtype), str(bb.grad.dtype)]}))
"""


def test_bias_gelu_backward_is_one_kernel(dev):
    """The autograd path's backward is one launch of the CUDA kernel and
    nothing else on the device (no sum, no cast; after the first call,
    which zeroes the tickets), also on a bf16 bias. Profiled in a fresh
    interpreter: late in a pytest process that had profiled before and
    built kernels for minutes, the profiler kept a profile's host events
    and none of its device events."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", _ONE_GELU_BACKWARD, root],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["launches"] == 1
    kernels = got["kernels"]
    assert len(kernels) == 1 and "bias_gelu_bwd_kernel" in kernels[0], kernels
    assert got["dtypes"] == ["torch.bfloat16"] * 2


def test_gelu_bwd_smem_matches_the_kernel_layout(dev):
    """The wrapper sizes the backward's shared memory as the kernel lays it
    out (`_bwd_smem` against `bias_gelu_bwd_smem`)."""
    lib = tfg._library()
    for f in (96, 100, 320, 333, 512, 1024, 2048, 8192):
        for t_size in (2, 4):
            fc = tfg._bwd_plan(1024, f, t_size, 264).fc
            for bulk in (True, False):
                assert tfg._bwd_smem(bulk, fc, t_size) == \
                    lib.bias_gelu_bwd_smem(int(t_size == 2), int(bulk), fc)


def test_mlp_gelu_autograd_saturates_and_refuses(dev):
    """`mlp_bias_gelu` under autograd launches both kernels; at |h| = 1e4
    the gradient is exactly 1 or 0 (no NaN); what the kernels do not take
    raises."""
    h = torch.tensor([1e4, -1e4, 64.0, -64.0, 0.5], device=dev)
    h = h.repeat(1, 3, 8).bfloat16().requires_grad_()  # [1, 3, 40]
    bias = torch.zeros(40, device=dev, requires_grad=True)
    fwd, bwd = tfg.bias_gelu_forward.launches, tfg.bias_gelu_backward.launches
    y = tfg.mlp_bias_gelu(h, bias.bfloat16())
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert tfg.bias_gelu_forward.launches == fwd + 1
    assert tfg.bias_gelu_backward.launches == bwd + 1
    sat = h.detach().float().abs() > 10
    want = (h.detach().float() > 0).float()
    assert torch.equal(h.grad.float()[sat], want[sat])
    assert torch.isfinite(bias.grad).all()
    with pytest.raises(TypeError):  # fp16
        tfg.bias_gelu(h.detach().half())
    with pytest.raises(ValueError):  # not contiguous
        tfg.bias_gelu(h.detach().transpose(1, 2))
    with pytest.raises(ValueError):  # bias of another width
        tfg.bias_gelu(h.detach(), torch.zeros(8, device=dev).bfloat16())


def _ring_inputs(dev, gen, b, lq, lk, h, d, pad, q_row0=0, k_row0=0):
    """bf16 q [B, Lq, H·D] and k, v [B, Lk, H·D] strided out of qkv-laid-out
    tensors, the table rows of q's and k's chunks (slices of one table at
    row offsets `q_row0` and `k_row0`) and the chunk's kv-bias: 0, or
    −1e30 on the last `pad` kv rows."""
    hd = h * d

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q = randn(b, lq, 3 * hd)[..., :hd]
    kv = randn(b, lk, 3 * hd)
    k, v = kv[..., hd:2 * hd], kv[..., 2 * hd:]
    rows = max(q_row0 + lq, k_row0 + lk)
    ang = torch.arange(rows * (d // 2), dtype=torch.float32, device=dev)
    ang = ang.reshape(rows, d // 2) * 0.003
    cos, sin = ang.cos(), ang.sin()
    tabs = (cos[q_row0:q_row0 + lq], sin[q_row0:q_row0 + lq],
            cos[k_row0:k_row0 + lk], sin[k_row0:k_row0 + lk])
    kbias = torch.zeros(lk, device=dev)
    if pad:
        kbias[lk - pad:] = -1e30
    return q, k, v, tabs, kbias


@pytest.mark.parametrize("b,lq,lk,h,d,pad", [(2, 2064, 2064, 16, 128, 48),
                                             (2, 1040, 1040, 4, 128, 112),
                                             (2, 333, 2000, 4, 128, 7),
                                             (1, 100, 3000, 2, 64, 0),
                                             (2, 96, 160, 2, 128, 160)])
def test_ring_kernels_match_twins(dev, b, lq, lk, h, d, pad):
    """Rows 10–11 against their twins on bf16 inputs: separate q and k table
    rows (the k chunk's tables at another offset of the table), the kv-bias
    of a padded tail, ragged Lq ≠ Lk, kv past the short limit (forward up
    to 4096), and a chunk that is all padding (pad = Lk): its o is finite
    and its lse ≈ −1e30. o within two bf16 ulps of its largest value, the
    gradients as the short kernels'; the backward
    takes the forward's o and lse, which for a single chunk are the merged
    ones."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v, tabs, kbias = _ring_inputs(dev, gen, b, lq, lk, h, d, pad,
                                        q_row0=64, k_row0=3 * lq)
    scale = d ** -0.5
    o, lse = tfa.ring_attention_cuda(q, k, v, *tabs, kbias, h, scale)
    po, plse = tfa.ring_chunk_plain(q, k, v, *tabs, kbias, h, scale)
    torch.cuda.synchronize()
    assert o.shape == (b, lq, h * d) and lse.shape == (b, h, lq)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    # two bf16 ulps of the largest |o|: over thousands of keys |o| is
    # of order Lk^-1/2, so an absolute bound of 2e-2 would see nothing
    assert (o.float() - po.float()).abs().max().item() \
        <= 2 ** -6 * po.float().abs().max().item()
    if pad == lk:
        assert lse.max().item() < -1e29
        assert (lse / plse - 1).abs().max().item() < 1e-6
    else:
        assert (lse - plse).abs().max().item() < 1e-3
    if lk > tfa._RING_FULLK_MAX_BWD:
        return
    do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
    got = tfa.ring_attention_bwd_cuda(q, k, v, *tabs, kbias, o, lse, do, h,
                                      scale)
    want = tfa.ring_chunk_bwd_plain(q, k, v, *tabs, kbias, o, lse, do, h,
                                    scale)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        assert torch.isfinite(x.float()).all(), name
        if pad < lk:
            assert _rel_err(x, y) < 2e-2, name
        else:  # every kv row masked: p is 0 whatever the lse (≈ −1e30 here)
            assert not x.any(), name


@pytest.mark.parametrize("b,l,h,pad", [(2, 4112, 4, 16), (2, 2064, 4, 48),
                                       (1, 2100, 2, 52)])
def test_long_kernels_take_the_kv_bias(dev, b, l, h, pad):
    """Rows 6–7 with the kv-bias operand against their twins over
    pre-rotated q/k (the ring's fallback at chunk 4112, cp = 2, and the
    backward's at chunk 2064, cp = 4), counted apart from the no-bias
    launches."""
    gen = torch.Generator(device=dev).manual_seed(13)
    d = 128
    q, k, v, _, kbias = _ring_inputs(dev, gen, b, l, l, h, d, pad)
    scale = d ** -0.5
    before = (tfa.long_attention_forward.launches,
              tfa.long_attention_forward.bias_launches)
    o, lse = tfa.long_attention_forward(q, k, v, h, scale, kbias)
    po, plse = tfa.long_attention_plain(q, k, v, h, scale, kbias)
    torch.cuda.synchronize()
    assert (tfa.long_attention_forward.launches,
            tfa.long_attention_forward.bias_launches) == (before[0],
                                                          before[1] + 1)
    assert (o.float() - po.float()).abs().max().item() \
        < 2 ** -6 * po.float().abs().max().item() + 1e-3
    assert (lse - plse).abs().max().item() < 1e-3
    do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
    before = tfa.long_attention_backward.bias_launches
    got = tfa.long_attention_backward(q, k, v, o, lse, do, h, scale, kbias)
    want = tfa.long_attention_bwd_plain(q, k, v, o, lse, do, h, scale, kbias)
    torch.cuda.synchronize()
    assert tfa.long_attention_backward.bias_launches == before + 1
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(x, y) < 2e-2, name
    # the padded kv rows get no gradient
    assert not got[1][:, l - pad:].any() and not got[2][:, l - pad:].any()


def test_ring_dispatch_and_refusals(dev):
    """`ring_chunk_forward`/`_backward` launch row 10/11 up to their
    ceilings and the long kernels with the bias above; the ring wrappers
    refuse a missing bias, short tables and kv past their ceilings."""
    gen = torch.Generator(device=dev).manual_seed(14)
    h, d = 2, 128
    for lk, fwd, bwd in ((2048, "ring", "ring"), (2064, "ring", "long"),
                         (4112, "long", "long")):
        q, k, v, tabs, kbias = _ring_inputs(dev, gen, 1, 64, lk, h, d, 16)
        counts = (tfa.ring_chunk_forward.launches,
                  tfa.long_attention_forward.bias_launches,
                  tfa.ring_chunk_backward.launches,
                  tfa.long_attention_backward.bias_launches)
        o, lse = tfa.ring_chunk_forward(q, k, v, *tabs, kbias, h, d ** -0.5)
        tfa.ring_chunk_backward(q, k, v, *tabs, kbias, o, lse, o, h,
                                d ** -0.5)
        torch.cuda.synchronize()
        got = [a - b for a, b in zip(
            (tfa.ring_chunk_forward.launches,
             tfa.long_attention_forward.bias_launches,
             tfa.ring_chunk_backward.launches,
             tfa.long_attention_backward.bias_launches), counts)]
        assert got == [fwd == "ring", fwd == "long", bwd == "ring",
                       bwd == "long"], lk
    q, k, v, tabs, kbias = _ring_inputs(dev, gen, 1, 64, 64, h, d, 0)
    with pytest.raises(ValueError):  # the ring kernels take a bias row
        tfa.ring_attention_cuda(q, k, v, *tabs, None, h, 1.0)
    with pytest.raises(ValueError):  # k's table shorter than the chunk
        tfa.ring_attention_cuda(q, k, v, tabs[0], tabs[1], tabs[2][:32],
                                tabs[3][:32], kbias, h, 1.0)
    big = torch.zeros(1, tfa._RING_FULLK_MAX_FWD + 16, h * d, device=dev,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.ring_attention_cuda(q, big, big, tabs[0], tabs[1], tabs[0],
                                tabs[1], kbias, h, 1.0)


def _bwd_cases(dev, gen, kind):
    """(launch, twin) of one backward kernel on bf16 inputs at a ragged
    shape: rows 4–5 (short, with and without RoPE; `short-many` with more
    (b, h) than the card has SMs, where the blocks take their tickets (b, h)
    major), row 7 (long, with and without the kv-bias) and row 11 (ring)."""
    h, d = 2, 128
    scale = d ** -0.5
    if kind == "short-many":
        h = 4
        q, k, v, tabs, _ = _ring_inputs(dev, gen, 48, 333, 300, h, d, 0)
        o, lse = tfa.short_attention_cuda(q, k, v, tabs[0], tabs[1], h, scale)
        args = (q, k, v, tabs[0], tabs[1], o, lse, torch.randn_like(o), h,
                scale)
        return (lambda: tfa.short_attention_bwd_cuda(*args),
                lambda: tfa.short_attention_bwd_plain(*args))
    if kind in ("short-rope", "short-norope"):
        q, k, v, tabs, _ = _ring_inputs(dev, gen, 2, 333, 77, h, d, 0)
        cos, sin = (tabs[0], tabs[1]) if kind == "short-rope" else (None, None)
        o, lse = tfa.short_attention_cuda(q, k, v, cos, sin, h, scale)
        args = (q, k, v, cos, sin, o, lse, torch.randn_like(o), h, scale)
        return (lambda: tfa.short_attention_bwd_cuda(*args),
                lambda: tfa.short_attention_bwd_plain(*args))
    if kind in ("long", "long-bias"):
        q, k, v, _, kbias = _ring_inputs(dev, gen, 1, 2100, 2100, h, d, 52)
        kbias = kbias if kind == "long-bias" else None
        o, lse = tfa.long_attention_cuda(q, k, v, h, scale, kbias)
        args = (q, k, v, o, lse, torch.randn_like(o), h, scale, kbias)
        return (lambda: tfa.long_attention_bwd_cuda(*args),
                lambda: tfa.long_attention_bwd_plain(*args))
    q, k, v, tabs, kbias = _ring_inputs(dev, gen, 2, 1040, 1040, 4, d, 112,
                                        q_row0=64, k_row0=3120)
    o, lse = tfa.ring_attention_cuda(q, k, v, *tabs, kbias, 4, scale)
    args = (q, k, v, *tabs, kbias, o, lse, torch.randn_like(o), 4, scale)
    return (lambda: tfa.ring_attention_bwd_cuda(*args),
            lambda: tfa.ring_chunk_bwd_plain(*args))


@pytest.mark.parametrize("kind", ["short-rope", "short-norope", "short-many",
                                  "long", "long-bias", "ring"])
def test_backward_kernels_are_deterministic(dev, kind):
    """Two launches on the same inputs give the same bits in dq, dk and dv:
    the kv blocks add their dq partials in a fixed order. Both also agree
    with the twin within 2% of each gradient's largest magnitude."""
    gen = torch.Generator(device=dev).manual_seed(21)
    launch, twin = _bwd_cases(dev, gen, kind)
    first, second = launch(), launch()
    want = twin()
    torch.cuda.synchronize()
    for name, x, y, w in zip(("dq", "dk", "dv"), first, second, want):
        assert torch.equal(x, y), name
        assert _rel_err(x, w) < 2e-2, name


@pytest.mark.parametrize("lk", [333, 77])
def test_short_bwd_with_rope_at_ragged_kv(dev, lk):
    """Row 4's kernel with RoPE on k/v of their own length (Lq = 333
    against Lk = 333 and 77), both edges ragged against the 64-row q tiles
    and the 128-row kv blocks."""
    gen = torch.Generator(device=dev).manual_seed(22)
    h, d = 4, 128
    q, k, v, tabs, _ = _ring_inputs(dev, gen, 2, 333, lk, h, d, 0)
    rows = max(333, lk)
    ang = torch.arange(rows * (d // 2), dtype=torch.float32, device=dev)
    ang = ang.reshape(rows, d // 2) * 0.003
    cos, sin = ang.cos(), ang.sin()
    scale = d ** -0.5
    o, lse = tfa.short_attention_cuda(q, k, v, cos, sin, h, scale)
    args = (q, k, v, cos, sin, o, lse, torch.randn_like(o), h, scale)
    got = tfa.short_attention_bwd_cuda(*args)
    want = tfa.short_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape, name
        assert _rel_err(x, y) < 2e-2, name


def test_long_bwd_at_the_8208_tail(dev):
    """Row 7 (and row 9, the split-off tail) at L = 8208 = 64·128 + 16: the
    last kv block holds 16 rows, the last q tile 16."""
    gen = torch.Generator(device=dev).manual_seed(23)
    h, d, l = 4, 128, 8208
    q, k, v, _, _ = _ring_inputs(dev, gen, 1, l, l, h, d, 0)
    scale = d ** -0.5
    o, lse = tfa.long_attention_cuda(q, k, v, h, scale)
    args = (q, k, v, o, lse, torch.randn_like(o), h, scale)
    got = tfa.long_attention_bwd_cuda(*args)
    want = tfa.long_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(x, y) < 2e-2, name
        assert _rel_err(x[:, -16:], y[:, -16:]) < 2e-2, name + " tail"


def test_auto_dispatch_runs_a_head_dim_the_kernels_refuse(dev):
    """A depth-1 DiT with head_dim 32 (bf16) under "auto" runs its forward
    on the card through the plain composition, where it would raise in the
    kernels (the JAX "auto" rule)."""
    from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig
    from video_diffusion_speedrun_tpu_torch.models.dit import DiT

    cfg = DiTConfig(in_channels=4, hidden_size=64, depth=1, num_heads=2,
                    cross_attn_input_size=16, residual_v=True,
                    compute_dtype=torch.bfloat16, attention_impl="auto")
    model = DiT(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(1, 4, 2, 4, 4, generator=gen, device=dev)
    ctx = torch.randn(1, 3, 16, generator=gen, device=dev)
    before = (tfa.qkv_rope_flash_forward.launches,
              tfa.cross_flash_forward.launches)
    with torch.no_grad():
        out = model(x, ctx, torch.tensor([0.5], device=dev))
    torch.cuda.synchronize()
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    assert (tfa.qkv_rope_flash_forward.launches,
            tfa.cross_flash_forward.launches) == before


# (wrapper, B, H, Lq, Lk, D, padded kv rows) of the forward template:
# rows 1–2 (short, with and without RoPE), 6 (long, with the kv-bias as the
# ring's fallback) and 10 (ring) at the main path's shapes, then ragged
# edges against the 128-row q and kv tiles, Lq ≠ Lk on the ring, a ring
# chunk that is all padding, and D = 64
_FWD_CASES = [
    ("short-rope", 2, 16, 1040, 1040, 128, 0),
    ("short-rope", 64, 4, 528, 528, 128, 0),
    ("short-norope", 2, 16, 1040, 512, 128, 0),
    ("short-norope", 2, 16, 8208, 512, 128, 0),
    ("short-norope", 64, 4, 528, 512, 128, 0),
    ("long", 2, 16, 8208, 8208, 128, 0),
    ("long", 2, 4, 8208, 8208, 128, 0),
    ("long", 2, 16, 4112, 4112, 128, 16),
    ("ring", 2, 16, 2064, 2064, 128, 48),
    ("ring", 2, 4, 1040, 1040, 128, 112),
    ("short-rope", 2, 4, 333, 333, 128, 0),
    ("short-norope", 2, 4, 333, 77, 128, 0),
    ("short-norope", 1, 2, 2100, 333, 128, 0),
    ("long", 1, 2, 2100, 333, 128, 0),
    ("long", 2, 2, 333, 2100, 128, 5),
    ("ring", 2, 4, 2100, 333, 128, 7),
    ("ring", 2, 4, 333, 2000, 128, 0),
    ("ring", 2, 2, 333, 77, 128, 77),
    ("short-rope", 2, 4, 1040, 1040, 64, 0),
    ("short-norope", 2, 4, 333, 77, 64, 0),
    ("long", 2, 2, 2100, 333, 64, 9),
    ("ring", 1, 2, 100, 3000, 64, 0),
]


@pytest.mark.parametrize("kind,b,h,lq,lk,d,pad", _FWD_CASES)
def test_forward_template_matches_twins(dev, kind, b, h, lq, lk, d, pad):
    """The forward template (`csrc/attention_fwd.cuh`) through each entry
    against its twin on bf16 inputs: o within the kernels' limits (short:
    2e-2, about one bf16 ulp of values of order 1; long and ring: two bf16
    ulps of the largest |o|, which over thousands of keys is of order
    Lk^-1/2), lse within 1e-3; a chunk that is all padding keeps a finite
    o and lse ≈ −1e30. A second launch gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, tabs, kbias = _ring_inputs(dev, gen, b, lq, lk, h, d, pad,
                                        q_row0=16, k_row0=lq)
    scale = d ** -0.5
    if kind == "ring":
        args = (q, k, v, *tabs, kbias, h, scale)
        launch, twin = tfa.ring_attention_cuda, tfa.ring_chunk_plain
    elif kind == "long":
        args = (q, k, v, h, scale, kbias if pad else None)
        launch, twin = tfa.long_attention_cuda, tfa.long_attention_plain
    else:
        rope = kind == "short-rope"
        if rope:  # self-attention: one table for q and k
            rows = max(lq, lk)
            ang = torch.arange(rows * (d // 2), dtype=torch.float32,
                               device=dev).reshape(rows, d // 2) * 0.003
            cos, sin = ang.cos(), ang.sin()
        else:
            cos = sin = None
        args = (q, k, v, cos, sin, h, scale)
        launch, twin = tfa.short_attention_cuda, tfa.short_attention_plain
    o, lse = launch(*args)
    again = launch(*args)
    po, plse = twin(*args)
    torch.cuda.synchronize()
    assert o.shape == (b, lq, h * d) and lse.shape == (b, h, lq)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    err = (o.float() - po.float()).abs().max().item()
    if kind.startswith("short"):
        assert err < 2e-2
    else:
        assert err <= 2 ** -6 * po.float().abs().max().item()
    if pad == lk:
        assert lse.max().item() < -1e29
        assert (lse / plse - 1).abs().max().item() < 1e-6
    else:
        assert (lse - plse).abs().max().item() < 1e-3


# the factored weights of an XL block, [out, in] (width 2048, MLP 8192,
# context 4096): qkv; attn_proj, q_cross and cross_proj; adaLN_modulation.1;
# context_kv; mlp.0; mlp.2 — and a ragged shape (rows not a multiple of 8)
_XL_FACTORED = [(6144, 2048), (2048, 2048), (18432, 2048), (4096, 4096),
                (8192, 2048), (2048, 8192)]
_FACTORED_SHAPES = _XL_FACTORED + [(1000, 1030)]


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp in `dtype` of each |x| (x as fp32)."""
    bits = 7 if dtype == torch.bfloat16 else 23
    _, e = torch.frexp(x.abs().clamp(min=2.0 ** -100))
    return torch.exp2((e - 1 - bits).float())


def _factored_state(dev, gen, shapes, pdt, mdt):
    """Parameters, first moments and factors of `shapes`, the moments and
    factors away from 0 so that their EMAs are checked too."""
    from video_diffusion_speedrun_tpu_torch.train.optim import FNu

    def randn(s, scale, dt):
        return (torch.randn(s, generator=gen, device=dev) * scale).to(dt)

    ps = [randn(s, 0.02, pdt) for s in shapes]
    ms = [randn(s, 1e-3, mdt) for s in shapes]
    nus = [FNu(torch.rand(s[1], generator=gen, device=dev) * 1e-6,
               torch.rand(s[0], generator=gen, device=dev) * 1e-6)
           for s in shapes]
    return ps, ms, nus


def _hold_factored(ps, ms, nus, tp, tm, tnu, before, pdt, what):
    """The kernel's state against the twin's after one update from the same
    state: m bit-equal (no division, the same roundings); vr and vc within
    rtol 1e-6 (the sums of g² in another order); p within one ulp of p
    plus the ulps of the step that the twin moves where it divides by
    bc1 and bc2 through a reciprocal (one bf16 ulp of the delta, rounded to
    bf16 before the add; 8 fp32 ulps)."""
    for i in range(len(ps)):
        assert torch.equal(ms[i], tm[i]), (what, i)
        torch.testing.assert_close(nus[i].vr, tnu[i].vr, rtol=1e-6, atol=0)
        torch.testing.assert_close(nus[i].vc, tnu[i].vc, rtol=1e-6, atol=0)
        got, want = ps[i].float(), tp[i].float()
        delta = (want - before[i].float()).abs()
        tol = (_ulp(torch.maximum(got.abs(), want.abs()), pdt)
               + (1 if pdt == torch.bfloat16 else 8) * _ulp(delta, pdt))
        bad = (got - want).abs() > tol
        assert not bad.any(), (what, i, int(bad.sum()))


@pytest.mark.parametrize("pdt,mdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_factored_kernel_matches_twin(dev, pdt, mdt):
    """One group of the XL block's factored shapes and a ragged one: the
    kernel's two launches against `factored_leaf_update` leaf by leaf, 3
    steps, each from the kernel's state (`_hold_factored`'s limits)."""
    from video_diffusion_speedrun_tpu_torch.train.optim import (
        FNu,
        factored_leaf_update,
    )

    gen = torch.Generator(device=dev).manual_seed(41)
    shapes = _FACTORED_SHAPES
    b1, b2, eps = 0.95, 0.99, 1e-8
    ps, ms, nus = _factored_state(dev, gen, shapes, pdt, mdt)
    lrs = [2 ** -6 * 32 / s[1] for s in shapes]
    wds = [0.1 * s[1] / 1024 for s in shapes]
    kernel = tfw.FactoredAdamW(ps, ms, [n.vr for n in nus],
                               [n.vc for n in nus], shapes, lrs, wds, b1, b2,
                               eps)
    for step in range(3):
        before = [p.clone() for p in ps]
        tp, tm = [p.clone() for p in ps], [m.clone() for m in ms]
        tnu = [FNu(n.vr.clone(), n.vc.clone()) for n in nus]
        grads = [(torch.randn(s, generator=gen, device=dev) * 1e-3).to(pdt)
                 for s in shapes]
        lr_t, bc1, bc2 = tfw.step_scalars(step, 0.5 + step / 8, b1, b2)
        launches = tfw.FactoredAdamW.launches
        kernel(grads, lr_t, bc1, bc2)
        assert tfw.FactoredAdamW.launches == launches + 2
        for i, g in enumerate(grads):
            factored_leaf_update(tp[i], tm[i], tnu[i], g, lrs[i], wds[i],
                                 lr_t, bc1, bc2, b1, b2, eps, shapes[i])
        torch.cuda.synchronize()
        _hold_factored(ps, ms, nus, tp, tm, tnu, before, pdt, f"step {step}")


def test_factored_kernel_is_deterministic(dev):
    """Two wrappers on two copies of one state, fed the same gradients for
    2 steps, give the same bits in p, m and both factors: the sums finish
    in a fixed order, with no float atomics."""
    gen = torch.Generator(device=dev).manual_seed(42)
    shapes = [(18432, 2048), (2048, 8192), (1000, 1030)]
    bf = torch.bfloat16
    states, kernels = [], []
    ps, ms, nus = _factored_state(dev, gen, shapes, bf, bf)
    for copy in range(2):
        st = ([p.clone() for p in ps], [m.clone() for m in ms],
              [n.vr.clone() for n in nus], [n.vc.clone() for n in nus])
        states.append(st)
        kernels.append(tfw.FactoredAdamW(*st, shapes, [1e-3] * 3, [0.1] * 3,
                                         0.95, 0.99, 1e-8))
    for step in range(2):
        grads = [(torch.randn(s, generator=gen, device=dev) * 1e-3).to(bf)
                 for s in shapes]
        sc = tfw.step_scalars(step, 1.0, 0.95, 0.99)
        for kernel in kernels:
            kernel(grads, *sc)
    torch.cuda.synchronize()
    for a, b in zip(*states):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_factored_kernel_refuses_what_it_does_not_take(dev):
    """Non-contiguous parameters, mixed dtypes, moments or factors of the
    wrong shape, fp16, a CPU leaf among CUDA ones, and gradients of another
    dtype or shape raise before any launch."""
    gen = torch.Generator(device=dev).manual_seed(43)
    bf = torch.bfloat16
    (p,), (m,), (nu,) = _factored_state(dev, gen, [(64, 128)], bf, bf)

    def make(ps, ms, vrs, vcs):
        return tfw.FactoredAdamW(ps, ms, vrs, vcs, [(64, 128)] * len(ps),
                                 [1e-3] * len(ps), [0.0] * len(ps), 0.9, 0.99,
                                 1e-8)

    strided = torch.zeros(128, 64, dtype=bf, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        make([strided], [m], [nu.vr], [nu.vc])
    with pytest.raises(TypeError, match="one dtype"):
        make([p, p.float()], [m, m], [nu.vr] * 2, [nu.vc] * 2)
    with pytest.raises(ValueError, match="moments"):
        make([p], [m[:, :127].contiguous()], [nu.vr], [nu.vc])
    with pytest.raises(ValueError, match="factors"):
        make([p], [m], [nu.vc], [nu.vr])
    with pytest.raises(TypeError, match="fp32 or bf16"):
        make([p.half()], [m], [nu.vr], [nu.vc])
    with pytest.raises(TypeError, match="one dtype"):
        make([p, p.cpu()], [m, m], [nu.vr] * 2, [nu.vc] * 2)
    kernel = make([p], [m], [nu.vr], [nu.vc])
    launches = tfw.FactoredAdamW.launches
    sc = tfw.step_scalars(0, 1.0, 0.9, 0.99)
    for g in (torch.zeros_like(p, dtype=torch.float32),
              torch.zeros(64, 64, dtype=bf, device=dev)):
        with pytest.raises(ValueError, match="grads"):
            kernel([g], *sc)
    assert tfw.FactoredAdamW.launches == launches


@pytest.mark.parametrize("shape", [(2048, 2048), (1000, 1030)])
def test_factored_kernel_sums_over_row_shards(dev, shape):
    """The route of a sharded weight on one card: two row shards, each its
    own wrapper with a `sums` hook that adds the other shard's local sums
    of g² (a 2-rank all-reduce: two threads, one stream), so that the
    first launch stops at the local sums, the hooks add them,
    `factor_moments` finishes them and the second launch applies them.
    Against the whole weight's twin over 3 steps, each from the shards'
    state: the shards hold the same vr, and the limits of
    `_hold_factored` hold (factors within rtol 1e-6)."""
    import threading

    from video_diffusion_speedrun_tpu_torch.train.optim import (
        FNu,
        factored_leaf_update,
    )

    gen = torch.Generator(device=dev).manual_seed(44)
    bf, (n_out, n_in) = torch.bfloat16, shape
    b1, b2, eps, lr, wd = 0.95, 0.99, 1e-8, 1e-3, 0.1
    (p,), (m,), (nu,) = _factored_state(dev, gen, [shape], bf, bf)
    cut = [slice(0, n_out // 2), slice(n_out // 2, n_out)]
    shards = [(p[c].clone(), m[c].clone(), nu.vr.clone(), nu.vc[c].clone())
              for c in cut]
    barrier = threading.Barrier(2, timeout=120)
    box = [None, None]

    def hook(rank):
        def sums(t, dim):
            if dim != 0:  # the columns are not split
                return
            box[rank] = t.clone()
            barrier.wait()
            t.add_(box[1 - rank])
            barrier.wait()
        return sums

    kernels = [tfw.FactoredAdamW([s[0]], [s[1]], [s[2]], [s[3]], [shape],
                                 [lr], [wd], b1, b2, eps, sums=[hook(r)])
               for r, s in enumerate(shards)]
    for step in range(3):
        whole = [torch.cat([s[j] for s in shards]) for j in (0, 1, 3)]
        tp, tm = whole[0].clone(), whole[1].clone()
        tnu = FNu(shards[0][2].clone(), whole[2].clone())
        g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(bf)
        sc = tfw.step_scalars(step, 1.0, b1, b2)
        launches = tfw.FactoredAdamW.launches
        errors = []

        def run(r, _g=g, _sc=sc):
            try:
                kernels[r]([_g[cut[r]].contiguous()], *_sc)
            except Exception as e:  # surfaced below
                errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert tfw.FactoredAdamW.launches == launches + 4
        factored_leaf_update(tp, tm, tnu, g, lr, wd, *sc, b1, b2, eps, shape)
        torch.cuda.synchronize()
        assert torch.equal(shards[0][2], shards[1][2])
        got = FNu(shards[0][2], torch.cat([s[3] for s in shards]))
        _hold_factored([torch.cat([s[0] for s in shards])],
                       [torch.cat([s[1] for s in shards])], [got], [tp],
                       [tm], [tnu], [whole[0]], bf, f"step {step}")


# HunyuanVideo's MM-DiT kernels (`ops/fused_mmdit.py`)

@pytest.mark.parametrize("rows,n_img,ld", [(300, 250, 3 * 3072),
                                           (333, 333, 3 * 3072 + 12288),
                                           (77, 0, 3 * 3072)])
def test_qk_norm_rope_kernel_matches_twin(dev, rows, n_img, ld):
    """In place over the q/k columns of a [rows, ld] buffer (the double
    block's joint qkv, the single block's `linear1` output, text alone):
    within one bf16 ulp of the twin's values; v and the MLP columns
    untouched."""
    gen = torch.Generator(device=dev).manual_seed(21)
    buf = (torch.randn(rows, ld, generator=gen, device=dev) * 2).bfloat16()
    w = [(1 + 0.1 * torch.randn(128, generator=gen, device=dev)).bfloat16()
         for _ in range(4)]
    cos, sin = nd_rope_cos_sin((1, 10, 40), (16, 56, 56), 256.0, dev)
    want = fm.qk_norm_rope_plain(buf.clone(), n_img, 24, *w, cos, sin)
    before = fm.qk_norm_rope.launches
    got = fm.qk_norm_rope(buf.clone(), n_img, 24, *w, cos, sin)
    torch.cuda.synchronize()
    assert fm.qk_norm_rope.launches == before + 1
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= 2.0 ** -7 * want.float().abs() + 1e-6)
    assert torch.equal(got[:, 2 * 3072:], buf[:, 2 * 3072:])


@pytest.mark.parametrize("l,strided", [(1000, False), (333, True)])
def test_ln_modulate_kernel_matches_twin(dev, l, strided):
    gen = torch.Generator(device=dev).manual_seed(22)
    big = (torch.randn(1, l, 2 * 3072, generator=gen, device=dev) * 3 + 1
           ).bfloat16()
    x = big[..., :3072] if strided else big[..., :3072].contiguous()
    mod = torch.randn(1, 6 * 3072, generator=gen, device=dev).bfloat16()
    shift, scale = mod[:, :3072], mod[:, 3072:6144]
    before = fm.ln_modulate.launches
    got = fm.ln_modulate(x, shift, scale)
    want = fm.ln_modulate_plain(x, shift, scale)
    torch.cuda.synchronize()
    assert fm.ln_modulate.launches == before + 1
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= 2.0 ** -7 * want.float().abs() + 1e-3)


@pytest.mark.parametrize("n,f,with_bias,strided", [
    (1000, 12288, True, False), (333, 12288, False, True), (77, 100, True,
                                                             False)])
def test_gelu_tanh_kernel_matches_twin(dev, n, f, with_bias, strided):
    """Out of place, in place, and between strided views (the single
    block's MLP half of `linear1`'s output into the concatenation)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    src = (torch.randn(n, f + 64, generator=gen, device=dev) * 3).bfloat16()
    x = src[:, 64:] if strided else src[:, 64:].contiguous()
    bias = ((torch.randn(f, generator=gen, device=dev) * 0.5).bfloat16()
            if with_bias else None)
    want = fm.gelu_tanh_plain(x, bias)
    out = torch.zeros(n, f + 32, device=dev, dtype=torch.bfloat16)
    before = fm.gelu_tanh.launches
    got = fm.gelu_tanh(x, bias, out=out[:, 32:] if strided else None)
    torch.cuda.synchronize()
    assert fm.gelu_tanh.launches == before + 1
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= 2.0 ** -7 * want.float().abs() + 1e-5)
    if strided:
        assert torch.equal(out[:, :32], torch.zeros_like(out[:, :32]))


def test_hunyuan_video_on_the_card_meets_the_reference(dev):
    """A tiny MM-DiT (2 heads of 128, 2 + 2 blocks) in bf16 through its
    kernels against the float32 reference on the card: within bf16
    rounding (2% relative L2) at 11 of 16 valid text slots."""
    import os
    import sys

    from video_diffusion_speedrun_tpu_torch.core.config import (
        HunyuanVideoConfig,
    )
    from video_diffusion_speedrun_tpu_torch.models.hunyuan_video import (
        HunyuanVideo,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from benchmark.reference import hunyuan_video as ref
    from benchmark.reference.dit import Ops, fp32_matmuls

    fp32_matmuls()
    cfg = HunyuanVideoConfig(hidden_size=256, heads_num=2,
                             mm_double_blocks_depth=2,
                             mm_single_blocks_depth=2, text_states_dim=64,
                             text_states_dim_2=32, text_len=16)
    model = HunyuanVideo(cfg, device=dev, seed=5)
    c = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    sd = {k: v.float() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(1, 16, 3, 8, 8, generator=gen, device=dev).bfloat16()
    text = torch.randn(1, 16, 64, generator=gen, device=dev).bfloat16()
    vec2 = torch.randn(1, 32, generator=gen, device=dev).bfloat16()
    mask = (torch.arange(16, device=dev) < 11)[None]
    t, g = torch.tensor([870.0], device=dev), torch.tensor([6000.0],
                                                           device=dev)
    with torch.no_grad():
        got = model(x, t, model.condition(text, vec2, g, mask))
        want = ref.forward(Ops(), lambda grp: {
            k: v for k, v in sd.items() if ref.group_of(k) == grp}, c,
            x.float(), t, text.float(), mask, vec2.float(), g)
    gap = float((got.float() - want).norm() / want.norm())
    assert gap < 0.02, gap
