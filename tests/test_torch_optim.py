"""The port's optimizer pieces against the JAX package, on the CPU.

- AdamW: the twin `adamw_leaf_update_plain` against JAX `adamw_leaf_delta`
  and the Pallas `adamw_leaf_update` (interpret mode), over several steps
  so bc1 and bc2 move, with fp32 and bf16 moments: parameters at atol and
  rtol 1e-6, moments at rtol 1e-5, atol 1e-7 (as tests/test_fused_adamw.py:
  XLA may contract a·b + c into an fma where torch rounds twice).
- muP: the port's (lr, wd) of every parameter equals the JAX `mup_table`,
  carried across the name change by the weight converter itself.
- schedules: all three at warmup, mid-run and past the end.
The CUDA multi-tensor kernel is held against the twin in
tests/test_torch_gpu_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.core.config import (
    OptimizerConfig as JOptCfg,
)
from video_diffusion_speedrun_tpu.models.dit import init_dit
from video_diffusion_speedrun_tpu.ops.fused_adamw import adamw_leaf_update
from video_diffusion_speedrun_tpu.train.mup import mup_table as j_mup_table
from video_diffusion_speedrun_tpu.train.optim import adamw_leaf_delta
from video_diffusion_speedrun_tpu.train.schedules import (
    get_schedule as j_get_schedule,
)
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.core.config import (
    OptimizerConfig as TOptCfg,
)
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import fused_adamw as tfw
from video_diffusion_speedrun_tpu_torch.train.mup import mup_table
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.train.schedules import get_schedule

B1, B2, EPS = 0.95, 0.99, 1e-8


@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_adamw_twin_matches_jax_leaf_math(moments):
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[moments]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[moments]
    r = np.random.default_rng(0)
    shape = (64, 128)
    p0 = r.normal(size=shape).astype(np.float32)
    lr, wd = 1e-2, 0.1
    jp_ref = jp_kern = jnp.asarray(p0)
    jm_ref = jm_kern = jnp.zeros(shape, jdt)
    jv_ref = jv_kern = jnp.zeros(shape, jdt)
    tp = torch.from_numpy(p0.copy())
    tm = torch.zeros(shape, dtype=tdt)
    tv = torch.zeros(shape, dtype=tdt)
    for count in range(4):
        g = r.normal(size=shape).astype(np.float32)
        lr_t, bc1, bc2 = tfw.step_scalars(count, 0.25 + count / 4, B1, B2)
        # the JAX step's own fp32 bias corrections agree with the port's
        t = jnp.float32(count + 1)
        np.testing.assert_allclose([bc1, bc2], [1.0 - B1 ** t, 1.0 - B2 ** t],
                                   rtol=2e-7)
        js = [jnp.float32(x) for x in (lr_t, bc1, bc2)]
        delta, m2, v2 = adamw_leaf_delta(
            jnp.asarray(g), jm_ref, jv_ref, jp_ref, lr, wd, lr_t=js[0],
            bc1=js[1], bc2=js[2], b1=B1, b2=B2, eps=EPS)
        jp_ref, jm_ref, jv_ref = jp_ref + delta, m2.astype(jdt), v2.astype(jdt)
        jp_kern, jm_kern, jv_kern = adamw_leaf_update(
            jp_kern, jm_kern, jv_kern, jnp.asarray(g), lr, wd, *js, B1, B2,
            EPS)
        tfw.adamw_leaf_update_plain(tp, tm, tv, torch.from_numpy(g), lr, wd,
                                    lr_t, bc1, bc2, B1, B2, EPS)
        assert tm.dtype == tdt and tp.dtype == torch.float32
        for want_p, want_m, want_v in ((jp_ref, jm_ref, jv_ref),
                                       (jp_kern, jm_kern, jv_kern)):
            np.testing.assert_allclose(tp.numpy(), np.asarray(want_p),
                                       rtol=1e-6, atol=1e-6)
            for got, want in ((tm, want_m), (tv, want_v)):
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=1e-5, atol=1e-7)


TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, mlp_ratio=4.0, cross_attn_input_size=32)


@pytest.mark.parametrize("flags", [
    dict(residual_v=True, train_bias_and_rms=False),
    dict(residual_v=True, train_bias_and_rms=True),
    dict(residual_v=False, train_bias_and_rms=True),
])
def test_mup_table_matches_jax(flags):
    """Every port parameter gets the JAX leaf's (lr, wd): the JAX table is
    written into leaves of the parameters' shapes and carried into port
    names by `state_dict_from_jax_params`, the converter's own name map."""
    lr, wd = 2.0 ** -6, 0.1
    jcfg = JCfg(**TINY, **flags)
    tcfg = TCfg(**TINY, **flags)
    params = init_dit(jax.random.PRNGKey(0), jcfg)
    lr_tree, wd_tree, _ = j_mup_table(params, lr, wd, JOptCfg())
    model = DiT(tcfg, device="cpu")
    table = mup_table(model.named_parameters(), lr, wd, TOptCfg())
    for tree, key in ((lr_tree, "lr"), (wd_tree, "wd")):
        filled = jax.tree.map(
            lambda x, p: np.full(p.shape, x, np.float32), tree, params)
        want = state_dict_from_jax_params(filled, tcfg)
        assert sorted(want) == sorted(table)
        for name, t in want.items():
            assert t.min() == t.max(), name
            np.testing.assert_allclose(table[name][key], t.flatten()[0].item(),
                                       rtol=1e-6, err_msg=f"{name} {key}")
    # the rules that differ by name or layout between the two trees
    assert table["blocks.0.mlp.0.weight"]["lr"] == lr * 32 / 64
    assert table["blocks.0.mlp.2.weight"]["wd"] == wd * 256 / 1024
    assert table["patch_embed.patch_proj.weight"] == {
        "lr": lr * 0.01, "wd": 0.0, "shape": (64, 4, 2, 2, 2)}
    assert table["blocks.1.adaLN_modulation.1.weight"]["lr"] == lr * 0.1


@pytest.mark.parametrize("name", ["linear", "cosine", "constant"])
def test_schedules_match_jax(name):
    want_fn = j_get_schedule(name, 20, 100)
    got_fn = get_schedule(name, 20, 100)
    for step in (0, 1, 10, 19, 20, 21, 60, 99, 100, 101, 250):
        got = got_fn(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(want_fn(step)), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")


def test_mup_adamw_uses_the_count_before_the_step():
    """λ of update n is λ(n − 1 updates done), bc uses t = n, and a leaf
    with no gradient takes a zero one (only its decay moves it)."""
    model = DiT(TCfg(**TINY, residual_v=True), device="cpu")
    opt = MupAdamW(model.named_parameters(), 1e-2, 10,
                   TOptCfg(scheduler="linear", warmup_steps=2))
    assert opt.lr_scale() == 0.0  # first warmup step
    before = [p.detach().clone() for p in opt.params]
    opt.step([None] * len(opt.params))  # λ = 0: nothing moves
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    assert opt.count == 1 and opt.lr_scale() == 0.5
    grads = [torch.ones_like(p) for p in opt.params]
    opt.step(grads)
    moved = [not torch.equal(a, b) for a, b in zip(before, opt.params)]
    assert all(moved)
