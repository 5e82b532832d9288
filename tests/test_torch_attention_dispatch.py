"""The port's attention dispatch (`models/dit.py:use_fused_attention`)
against JAX's rule (`video_diffusion_speedrun_tpu/models/dit.py:211-229`):
"auto" takes the CUDA kernels only for operands they accept (bf16, head_dim
64 or 128) and the plain composition otherwise; "fused" always takes the
fused ops, which raise on what the kernels refuse. Under context
parallelism (JAX's `cp_enabled`) a no-RoPE model and "plain" take the
gathered attention (JAX's XLA attention over the token-sharded axis);
"auto" takes the ring for CPU tensors (its twins) and CUDA tensors its
kernels accept, the gathered attention for the rest; "fused" takes the
ring and raises at once for CUDA tensors the kernels refuse.

The on-card case (a head_dim-32 DiT forward under "auto") is in
tests/test_torch_gpu_kernels.py.
"""

import pytest
import torch

from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig
from video_diffusion_speedrun_tpu_torch.models import dit as tdit
from video_diffusion_speedrun_tpu_torch.models.dit import (
    DiT,
    use_fused_attention,
)
from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("on_cuda", [True, False])
@pytest.mark.parametrize("impl", ["auto", "fused", "plain"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_dispatch_without_context_parallelism(head_dim, dtype, impl,
                                              on_cuda):
    takes = dtype == torch.bfloat16 and head_dim in (64, 128)
    want = impl == "fused" or (impl == "auto" and on_cuda and takes)
    assert use_fused_attention(impl, head_dim, dtype, on_cuda) is want


@pytest.mark.parametrize("impl", ["auto", "fused", "plain"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_dispatch_under_context_parallelism(head_dim, dtype, impl):
    """True: the ring (its twins for CPU tensors, its kernels for CUDA
    tensors); False: the gathered attention. JAX's table
    (`_use_fused_attention(cfg, l, cos, cp_enabled=True)`)."""
    takes = dtype == torch.bfloat16 and head_dim in (64, 128)
    for on_cuda in (False, True):
        # a no-RoPE model: the gathered attention on every dispatch
        assert use_fused_attention(impl, head_dim, dtype, on_cuda,
                                   context_parallel=True, rope=False) is False
    assert use_fused_attention(impl, head_dim, dtype, False,
                               context_parallel=True) is (impl != "plain")
    if impl == "fused" and not takes:
        with pytest.raises(ValueError, match="ring kernels take bf16"):
            use_fused_attention(impl, head_dim, dtype, True,
                                context_parallel=True)
    else:
        assert use_fused_attention(impl, head_dim, dtype, True,
                                   context_parallel=True) is (
            impl == "fused" or (impl == "auto" and takes))


def _tiny(impl: str, head_dim: int) -> DiT:
    cfg = DiTConfig(in_channels=4, hidden_size=2 * head_dim, depth=1,
                    num_heads=2, cross_attn_input_size=16, residual_v=True,
                    compute_dtype=torch.float32, attention_impl=impl)
    return DiT(cfg, device="cpu", seed=0)


def _inputs():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 2, 4, 4, generator=gen)
    ctx = torch.randn(1, 3, 16, generator=gen)
    return x, ctx, torch.tensor([0.5])


@pytest.mark.parametrize("head_dim", [32, 64])
def test_auto_takes_the_plain_composition_on_cpu(head_dim, monkeypatch):
    """On CPU tensors "auto" runs `dot_product_attention` (self and cross)
    and no fused op; "fused" runs the fused ops' twins, head_dim 32
    included, and agrees with it."""
    calls = {"plain": 0, "fused": 0}
    plain = tdit.dot_product_attention

    def count_plain(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    def count(fn):
        def wrapped(*a, **k):
            calls["fused"] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tdit, "dot_product_attention", count_plain)
    for name in ("qkv_rope_flash_attention", "cross_flash_attention"):
        monkeypatch.setattr(tdit, name, count(getattr(tdit, name)))
    x, ctx, ts = _inputs()
    with torch.no_grad():
        auto = _tiny("auto", head_dim)(x, ctx, ts)
        assert calls == {"plain": 2, "fused": 0}
        fused = _tiny("fused", head_dim)(x, ctx, ts)
        assert calls == {"plain": 2, "fused": 2}
    torch.testing.assert_close(fused, auto, atol=1e-4, rtol=1e-3)


def test_ring_of_refused_operands_raises_before_any_attention(monkeypatch):
    """Operands the ring kernels refuse, seen as CUDA tensors: under
    "fused" the DiT's CP forward raises once, up front, before any
    attention (as JAX's "pallas"); under "auto" every block takes the
    gathered attention and no ring runs."""
    seen, ran = [], []

    def fake(attention_impl, head_dim, dtype, on_cuda,
             context_parallel=False, rope=True):
        seen.append((head_dim, dtype, context_parallel))
        return use_fused_attention(attention_impl, head_dim, dtype, True,
                                   context_parallel, rope)

    monkeypatch.setattr(tdit, "use_fused_attention", fake)
    monkeypatch.setattr(tdit, "ring_flash_attention",
                        lambda *a, **k: ran.append("ring"))
    gather = tdit._gathered_attention
    monkeypatch.setattr(tdit, "_gathered_attention",
                        lambda *a, **k: ran.append("gathered") or gather(
                            *a, **k))
    x, ctx, ts = _inputs()
    with pytest.raises(ValueError, match="ring kernels take bf16"):
        _tiny("fused", 32)(x, ctx, ts, context_parallel=LocalRing(2))
    assert seen == [(32, torch.float32, True)] and ran == []
    with torch.no_grad():
        out = _tiny("auto", 32)(x, ctx, ts, context_parallel=LocalRing(2))
    assert ran == ["gathered"] and torch.isfinite(out).all()
