"""The factored-ν update of the optimizer-in-backward step on the CPU:
how `MupAdamW.update_group` splits a group into exact and factored leaves,
that CPU leaves keep the plain twin `factored_leaf_update`, and what the
CUDA wrapper `FactoredAdamW` refuses before it builds anything. The kernel
itself is held against the twin on the card (`test_torch_gpu_kernels.py`).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig
from video_diffusion_speedrun_tpu_torch.core.config import OptimizerConfig
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import _build
from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as tfw
from video_diffusion_speedrun_tpu_torch.train import optim

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=3, num_heads=2, cross_attn_input_size=32, residual_v=True,
            train_bias_and_rms=True)
# the demo DiT's widths: the XL configuration of the in-backward step
XL = dict(hidden_size=2048, depth=24, num_heads=16, residual_v=True)
DEFAULT_MIN = OptimizerConfig().nu_factored_min_size


def _opt(model, **kw):
    return optim.MupAdamW(model.named_parameters(), 0.01, 10,
                          OptimizerConfig(in_backward=True, nu_factored=True,
                                          **kw))


def test_factored_wrapper_imports_without_cuda():
    """A process with no card imports the wrapper and the optimizer and
    builds nothing: the kernel builds at its first use."""
    code = ("import video_diffusion_speedrun_tpu_torch.train.optim\n"
            "from video_diffusion_speedrun_tpu_torch.ops import _build\n"
            "from video_diffusion_speedrun_tpu_torch.ops import fused_adamw\n"
            "assert fused_adamw.FactoredAdamW.launches == 0\n"
            "assert not _build._libs\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]


@pytest.mark.parametrize("cfg,min_size,factored", [
    (TINY, 1, "every block weight"),
    (TINY, DEFAULT_MIN, "none"),
    (XL, DEFAULT_MIN, "every block weight"),
])
def test_group_parts_match_the_factored_flags(cfg, min_size, factored):
    """Each group's exact and factored positions (`parts`, what
    `update_group` hands to its two kernels) split the group and follow
    the per-leaf `factored` flag, which the shapes and the configuration
    decide: every 2-D block weight at `nu_factored_min_size` 1 and at the
    XL width by default (8 a block), none at the tiny width by default."""
    model = DiT(DiTConfig(**cfg), device="meta")
    opt = _opt(model, nu_factored_min_size=min_size)
    shapes = dict(model.named_parameters())
    for group, idx in opt.groups.items():
        exact, fac = opt.parts[group]
        assert sorted(exact + fac) == list(range(len(idx)))
        assert exact == sorted(exact) and fac == sorted(fac)
        assert [idx[k] for k in fac] == [i for i in idx if opt.factored[i]]
        names = [opt.names[idx[k]] for k in fac]
        if group == "rest" or factored == "none":
            assert names == []
        else:
            assert names == [n for n in (opt.names[i] for i in idx)
                             if shapes[n].dim() == 2]
            assert len(names) == 8 or cfg is TINY


def test_update_group_on_cpu_runs_the_twin(monkeypatch):
    """On CPU leaves `update_group` updates each factored leaf with
    `factored_leaf_update` and builds no wrapper; the kernel's launch
    count stays. Its exact leaves move as `adamw_leaf_update_plain` moves
    them."""
    model = DiT(DiTConfig(**TINY), device="cpu", seed=0)
    opt = _opt(model, nu_factored_min_size=1)
    opt.count = 3  # past the schedule's λ(0) = 0
    group = "blocks.1"
    idx = opt.groups[group]
    calls = []
    twin = optim.factored_leaf_update

    def spy(p, *a, **k):
        calls.append(p.data_ptr())
        return twin(p, *a, **k)

    monkeypatch.setattr(optim, "factored_leaf_update", spy)
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn(opt.params[i].shape, generator=gen) for i in idx]
    before = [opt.params[i].detach().clone() for i in idx]
    exact, fac = opt.parts[group]
    want = [before[k].clone() for k in exact]
    ms = [opt.m[idx[k]].clone() for k in exact]
    vs = [opt.v[idx[k]].clone() for k in exact]
    launches = tfw.FactoredAdamW.launches
    opt.update_group(group, grads)
    assert calls == [opt.params[idx[k]].data_ptr() for k in fac]
    assert opt._factored_kernels == {} and opt._group_kernels == {}
    assert tfw.FactoredAdamW.launches == launches
    sc = tfw.step_scalars(3, opt.lr_scale(), opt.cfg.beta1, opt.cfg.beta2)
    for j, k in enumerate(exact):
        i = idx[k]
        tfw.adamw_leaf_update_plain(want[j], ms[j], vs[j], grads[k],
                                    opt.lrs[i], opt.wds[i], *sc,
                                    opt.cfg.beta1, opt.cfg.beta2,
                                    opt.cfg.eps)
        assert torch.equal(opt.params[i].detach(), want[j])
    for k in fac:
        assert not torch.equal(opt.params[idx[k]].detach(), before[k])


def _leaf(shape=(8, 16), dtype=torch.float32):
    p = torch.zeros(shape, dtype=dtype)
    return p, torch.zeros_like(p), torch.zeros(shape[1:]), torch.zeros(
        shape[:1])


@pytest.mark.parametrize("case,error,match", [
    ("strided", ValueError, "contiguous"),
    ("mixed", TypeError, "one dtype"),
    ("moments", ValueError, "moments"),
    ("factors", ValueError, "factors"),
    ("fp16", TypeError, "fp32 or bf16"),
    ("1-D", ValueError, "2-D"),
    ("empty", ValueError, "empty"),
])
def test_factored_wrapper_refuses_before_building(case, error, match):
    """What the kernel does not take raises while the wrapper checks its
    leaves, before the kernel is built or launched."""
    p, m, vr, vc = _leaf()
    leaves = [[p], [m], [vr], [vc]]
    if case == "strided":
        leaves[0] = [torch.zeros(16, 8).t()]
    elif case == "mixed":
        leaves = [[p, p.bfloat16()], [m, m], [vr, vr], [vc, vc]]
    elif case == "moments":
        leaves[1] = [torch.zeros(8, 15)]
    elif case == "factors":
        leaves[2], leaves[3] = [vc], [vr]
    elif case == "fp16":
        leaves[0] = [p.half()]
    elif case == "1-D":
        leaves = [[torch.zeros(8)], [torch.zeros(8)], [vr], [vc]]
    elif case == "empty":
        leaves = [list(t) for t in zip(_leaf((0, 16)))]
    n = len(leaves[0])
    with pytest.raises(error, match=match):
        tfw.FactoredAdamW(*leaves, [(8, 16)] * n, [1e-3] * n, [0.0] * n,
                          0.9, 0.99, 1e-8)
    assert tfw._FACTORED_LIB not in _build._libs
