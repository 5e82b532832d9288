"""The port's optimizer-in-backward step (`train/inloop.py`) against the
JAX package's `build_inloop_step`, and against the port's standard step,
on the CPU in fp32 at the sizes of `tests/test_inloop.py` (width 64,
depth 3, 2 heads).

Weights come from the JAX `init_dit` (the zero-initialised AdaLN and
output layers given seeded values, λ off 0.5) through the weight
converter. JAX's step draws its timesteps, noise and rope offsets from
`jax.random.split(rng, 4)` (`inloop.py:247`); the test draws them the
same way and injects them into the port, with caption dropout 0.

Tolerances are JAX's own (`tests/test_inloop.py`): the same math in
another summation order. Losses rtol 1e-5 over 3 steps, parameters and
first moments atol 2e-5 / rtol 1e-4; the factored ν losses rtol 1e-4
over 5 steps and its factors rtol 1e-5 after one step; factored against
exact within 0.05 over 20 steps; `grad_accum` 2 against 1 atol 1e-6 /
rtol 1e-5. bf16 parameters: the AdamW twin bit for bit against `p +
adamw_leaf_delta(...)`, and one step of the model within 2 bf16 ulps of
each parameter (the bf16 rounding of the delta and of the sum can each
fall the other way after a gradient summed in another order).
"""

import socket
import subprocess
import sys
from pathlib import Path

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
from video_diffusion_speedrun_tpu.models.rope import random_rope_offsets
from video_diffusion_speedrun_tpu.train.inloop import (
    FNu as JFNu,
    build_inloop_step,
)
from video_diffusion_speedrun_tpu.train.loss import sample_timesteps
from video_diffusion_speedrun_tpu.train.optim import adamw_leaf_delta
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.core.config import (
    MeshConfig,
    OptimizerConfig,
    TrainConfig,
)
from video_diffusion_speedrun_tpu_torch.models.convert import (
    _BLOCK_LINEAR,
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops.fused_adamw import (
    adamw_leaf_update_plain,
    step_scalars,
)
from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step
from video_diffusion_speedrun_tpu_torch.train.optim import FNu, MupAdamW
from video_diffusion_speedrun_tpu_torch.train.step import step_for, train_step

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import _torch_fsdp_workers as workers  # noqa: E402
import _torch_jax_mesh as jax_mesh  # noqa: E402

TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=3, num_heads=2, cross_attn_input_size=32, residual_v=True,
            train_bias_and_rms=True)
JCFG = JCfg(**TINY, attention_impl="xla", fused_adaln="off",
            compute_dtype=jnp.float32, scan_blocks=True, remat=False)
TCFG = TCfg(**TINY, attention_impl="plain", fused_adaln="off",
            compute_dtype=torch.float32, remat=False)
LR = 0.01
MAX_STEPS = 1000
# latent [B, 4, 4, 8, 8] → 2·4·4 + 16 = 48 tokens
LATENT = (4, 4, 8, 8)


def jax_params(seed=0, dtype=None):
    params = init_dit(jax.random.PRNGKey(seed), JCFG, 0.1)
    r = np.random.default_rng(seed + 1)
    for path in (("blocks", "adaLN_modulation"), ("final_modulation",),
                 ("final_proj",)):
        leaf = params
        for key in path:
            leaf = leaf[key]
        for name in ("weight", "bias"):
            leaf[name] = jnp.asarray(
                r.normal(size=leaf[name].shape).astype(np.float32) * 0.05)
    lam = params["blocks"]["lambda_param"]
    params["blocks"]["lambda_param"] = jnp.asarray(
        r.uniform(0.1, 0.9, lam.shape).astype(np.float32))
    if dtype is not None:
        params = jax.tree.map(lambda x: x.astype(dtype), params)
    return params


def to_port(tree, cfg=TCFG):
    return state_dict_from_jax_params(
        jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree), cfg)


def port_model(params, cfg=TCFG):
    model = DiT(cfg, device="cpu")
    model.load_state_dict({k: v.to(cfg.param_dtype)
                           for k, v in to_port(params, cfg).items()},
                          strict=True)
    return model


def data(b=2, seed=3):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, *LATENT)).astype(np.float32),
            r.normal(size=(b, 6, 32)).astype(np.float32))


def jax_draws(rng, b):
    """JAX's step's timesteps, noise and rope offsets for `rng`."""
    t_rng, noise_rng, _, rope_rng = jax.random.split(rng, 4)
    gt, gh, gw = LATENT[1] // 2, LATENT[2] // 2, LATENT[3] // 2
    return dict(
        timesteps=np.asarray(sample_timesteps(t_rng, b, 8.0)),
        noise=np.asarray(jax.random.normal(noise_rng, (b, *LATENT),
                                           jnp.float32)),
        rope_offsets=np.asarray(random_rope_offsets(
            rope_rng, gt, gh, gw, JCFG.rope_max_t, JCFG.rope_max_h,
            JCFG.rope_max_w)))


def optimizer_cfg(**kw):
    return dict(learning_rate=LR, scheduler="constant", warmup_steps=2, **kw)


def jax_run(params, steps, seeds, b=2, **kw):
    """`steps` JAX in-backward steps: (losses, params, opt state)."""
    nu_kw = {k: kw.pop(k) for k in ("nu_factored", "nu_factored_min_size",
                                    "grad_accum") if k in kw}
    init_opt, step_fn, _ = build_inloop_step(
        JCFG, JOptCfg(**optimizer_cfg(**kw)),
        jax.eval_shape(lambda: params), max_steps=MAX_STEPS,
        caption_dropout=0.0, **nu_kw)
    opt = init_opt(params)
    step = jax.jit(step_fn)
    lat, ctx = data(b)
    losses = []
    for k in range(steps):
        params, opt, loss, _ = step(params, opt, jnp.asarray(lat),
                                    jnp.asarray(ctx),
                                    jax.random.PRNGKey(seeds + k))
        losses.append(float(loss))
    return np.asarray(losses), params, opt


def port_setup(params, b=2, cfg=TCFG, grad_accum=1, **kw):
    model = port_model(params, cfg)
    tcfg = TrainConfig(model=cfg, batch_size=b, caption_dropout=0.0,
                       max_steps=MAX_STEPS, grad_accum=grad_accum,
                       optimizer=OptimizerConfig(
                           **optimizer_cfg(in_backward=True, **kw)))
    opt = MupAdamW(model.named_parameters(), LR, MAX_STEPS, tcfg.optimizer)
    return model, opt, tcfg


def port_run(params, steps, seeds, b=2, step=inloop_step, **kw):
    """`steps` port steps on JAX's draws: (losses, model, opt)."""
    model, opt, tcfg = port_setup(params, b, **kw)
    lat, ctx = data(b)
    losses = []
    for k in range(steps):
        batch = dict(latent=lat, context=ctx,
                     **jax_draws(jax.random.PRNGKey(seeds + k), b))
        m = step(model, opt, {k_: torch.from_numpy(np.asarray(v))
                              for k_, v in batch.items()}, None, tcfg)
        losses.append(float(m["loss"]))
    return np.asarray(losses), model, opt


def assert_tree_close(got: dict, want: dict, atol, rtol, what):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   w.float().numpy(), atol=atol, rtol=rtol,
                                   err_msg=f"{what} {name}")


def moments_of(opt, which="m"):
    return {n: t.detach() for n, t in zip(opt.names, getattr(opt, which))}


def test_inloop_matches_jax_inloop():
    """3 steps of exact ν: losses, parameters and μ against JAX."""
    params = jax_params()
    want_l, want_p, want_o = jax_run(params, 3, 100)
    got_l, model, opt = port_run(params, 3, 100)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert len(set(np.round(got_l, 6))) == 3  # the weights moved
    assert_tree_close(model.state_dict(), to_port(want_p), 2e-5, 1e-4,
                      "param")
    assert_tree_close(moments_of(opt), to_port(want_o.mu), 2e-5, 1e-4, "mu")


def test_inloop_matches_the_standard_step():
    """The port's in-backward step against its own standard step
    (`train_step`, the whole gradient then one update) on the same draws:
    the same math in another order."""
    params = jax_params()
    want_l, want_model, want_opt = port_run(params, 3, 100, step=train_step)
    got_l, model, opt = port_run(params, 3, 100)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert_tree_close(model.state_dict(), want_model.state_dict(), 2e-5,
                      1e-4, "param")
    assert_tree_close(moments_of(opt), moments_of(want_opt), 2e-5, 1e-4,
                      "mu")
    assert_tree_close(moments_of(opt, "v"), moments_of(want_opt, "v"), 2e-5,
                      1e-4, "nu")


def test_factored_nu_matches_jax():
    """`nu_factored_min_size=1`: every block weight factored; 5 steps of
    losses, and after one step the factors against JAX's (its vr [in]
    and vc [out] per block are the port's vr and vc of the [out, in]
    weight)."""
    params = jax_params()
    kw = dict(nu_factored=True, nu_factored_min_size=1)
    want_l, _, _ = jax_run(params, 5, 200, **kw)
    got_l, _, _ = port_run(params, 5, 200, **kw)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)

    _, _, want_o = jax_run(params, 1, 200, **kw)
    _, _, opt = port_run(params, 1, 200, **kw)
    jnu = want_o.nu["blocks"]
    module_of = {v: k for k, v in _BLOCK_LINEAR.items()}
    checked = 0
    for name, v, fac in zip(opt.names, opt.v, opt.factored):
        if not fac:
            continue
        _, i, module = name.split(".", 2)
        module, leaf = module.rsplit(".", 1)
        assert leaf == "weight" and isinstance(v, FNu)
        j = jnu
        for key in module_of[module]:
            j = j[key]
        j = j["weight"]
        assert isinstance(j, JFNu)
        for got, want in ((v.vr, j.vr[int(i)]), (v.vc, j.vc[int(i)])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
        checked += 1
    # every block linear: qkv, attn_proj, q_cross, context_kv, cross_proj,
    # fc1, fc2, the AdaLN modulation
    assert checked == TINY["depth"] * len(_BLOCK_LINEAR)


def test_factored_nu_tracks_exact_losses():
    """JAX's 20-step check (`test_inloop.py:88-119`): the factored run's
    losses fall and stay within 0.05 of the exact run's."""
    params = jax_params()
    exact, _, _ = port_run(params, 20, 100)
    fac, _, opt = port_run(params, 20, 100, nu_factored=True,
                           nu_factored_min_size=1)
    assert any(opt.factored)
    assert fac[-1] < fac[0]
    np.testing.assert_allclose(fac, exact, rtol=0.05, atol=0.05)


def test_grad_accum_chunks_give_the_full_batch_gradient():
    """grad_accum 2 chunks each block's backward along the batch: the same
    gradients, so the same 2-step trajectory as grad_accum 1."""
    params = jax_params()
    _, whole, _ = port_run(params, 2, 50, b=4)
    _, chunked, _ = port_run(params, 2, 50, b=4, grad_accum=2)
    assert_tree_close(chunked.state_dict(), whole.state_dict(), 1e-6, 1e-5,
                      "param")


@pytest.mark.parametrize("mdt", [jnp.float32, jnp.bfloat16])
def test_bf16_twin_follows_the_leaf_delta_order(mdt):
    """The AdamW twin on bf16 parameters and gradients is `p +
    adamw_leaf_delta(...)` bit for bit (wd·p, the delta and the sum each
    rounded to bf16), which rounding once (the Pallas body) is not."""
    r = np.random.default_rng(0)
    shape = (64, 96)
    p = jnp.asarray(r.normal(size=shape) * 0.05, jnp.bfloat16)
    g = jnp.asarray(r.normal(size=shape) * 1e-3, jnp.bfloat16)
    m = jnp.asarray(r.normal(size=shape) * 1e-3, mdt)
    v = jnp.asarray(np.abs(r.normal(size=shape)) * 1e-6, mdt)
    lr, wd = 2.0 ** -6 * 32 / 96, 0.1 * 96 / 1024
    lr_t, bc1, bc2 = step_scalars(3, 0.7, 0.95, 0.99)
    delta, m2, v2 = adamw_leaf_delta(
        g, m, v, p, lr, wd, lr_t=jnp.float32(lr_t), bc1=jnp.float32(bc1),
        bc2=jnp.float32(bc2), b1=0.95, b2=0.99, eps=1e-8)

    def t(x, dtype):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(dtype)

    tdt = torch.bfloat16 if mdt == jnp.bfloat16 else torch.float32
    tp, tg = t(p, torch.bfloat16), t(g, torch.bfloat16)
    tm, tv = t(m, tdt), t(v, tdt)
    adamw_leaf_update_plain(tp, tm, tv, tg, lr, wd, lr_t, bc1, bc2, 0.95,
                            0.99, 1e-8)
    assert torch.equal(tp, t(p + delta, torch.bfloat16))
    assert torch.equal(tm, t(m2.astype(mdt), tdt))
    assert torch.equal(tv, t(v2.astype(mdt), tdt))
    # the single rounding of the Pallas body gives other bits somewhere
    pf = t(p, torch.float32)
    direction = (t(m2, torch.float32) / bc1) / (
        (t(v2, torch.float32) / bc2).sqrt() + 1e-8)
    single = (pf - float(np.float32(lr) * np.float32(lr_t))
              * (direction + wd * pf)).bfloat16()
    assert not torch.equal(single, tp)


def test_bf16_parameters_step_matches_jax():
    """One in-backward step of the model with bf16 parameters and bf16
    moments (fp32 compute) against JAX's: each parameter within 2 bf16
    ulps of JAX's; μ within 2 ulps plus 1e-3 of its leaf's largest |μ|
    (μ is (1−β₁)·g: where g is summation noise — K's bias, ~1e-16 — or
    cancels, the two orders differ by more than ulps of the entry)."""
    params = jax_params(dtype=jnp.bfloat16)
    cfg = TCFG.replace(param_dtype=torch.bfloat16)
    jcfg_kw = dict(moments_dtype=jnp.bfloat16)
    _, want_p, want_o = jax_run(params, 1, 300, **jcfg_kw)
    model, opt, tcfg = port_setup(params, cfg=cfg,
                                  moments_dtype=torch.bfloat16)
    lat, ctx = data()
    batch = dict(latent=lat, context=ctx,
                 **jax_draws(jax.random.PRNGKey(300), 2))
    inloop_step(model, opt, {k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()}, None, tcfg)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    for got, want, floor in ((model.state_dict(), to_port(want_p, cfg), 0),
                             (moments_of(opt), to_port(want_o.mu, cfg),
                              1e-3)):
        for name, w in want.items():
            g = got[name].float()
            ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp(
                min=2.0 ** -126))) - 7)
            tol = 2 * ulp + floor * w.abs().max()
            assert ((g - w).abs() <= tol).all(), name


def test_block0_lambda_gets_a_zero_gradient():
    """C8: block 0's λ never mixes v0; its group update receives None (the
    optimizer's zero gradient, JAX's `jnp.where`), the others a value."""
    params = jax_params()
    model, opt, tcfg = port_setup(params)
    seen = {}
    update = opt.update_group

    def spy(group, grads):
        for i, g in zip(opt.groups[group], grads):
            seen[opt.names[i]] = g
        update(group, grads)

    opt.update_group = spy
    lat, ctx = data()
    batch = dict(latent=lat, context=ctx,
                 **jax_draws(jax.random.PRNGKey(1), 2))
    inloop_step(model, opt, {k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()}, None, tcfg)
    assert seen["blocks.0.lambda_param"] is None
    assert seen["blocks.1.lambda_param"] is not None
    assert opt.count == 1 and len(seen) == len(opt.names)


def test_factoring_is_decided_by_the_stacked_size():
    """At width 512, depth 24, JAX factors `attn_proj` (24 · 512² ≥ 2²⁰)
    though one block's matrix is 2¹⁸; biases, λ and the layers outside
    the blocks keep exact ν."""
    cfg = TCfg(hidden_size=512, depth=24, num_heads=4, residual_v=True,
               train_bias_and_rms=False)
    model = DiT(cfg, device="meta")
    opt = MupAdamW(model.named_parameters(), LR, 10, OptimizerConfig(
        in_backward=True, nu_factored=True))
    fac = dict(zip(opt.names, opt.factored))
    assert fac["blocks.3.attn_proj.weight"]
    assert fac["blocks.0.mlp.0.weight"]
    assert not fac["blocks.0.mlp.0.bias"]
    assert not fac["blocks.0.lambda_param"]
    assert not fac["final_modulation.1.weight"]
    assert not fac["time_embed.0.weight"]
    shallow = DiT(cfg.replace(depth=2), device="meta")
    opt = MupAdamW(shallow.named_parameters(), LR, 10, OptimizerConfig(
        in_backward=True, nu_factored=True))
    assert not dict(zip(opt.names, opt.factored))[
        "blocks.1.attn_proj.weight"]
    # the standard step ignores nu_factored, as JAX's does
    opt = MupAdamW(model.named_parameters(), LR, 10, OptimizerConfig(
        nu_factored=True))
    assert not any(opt.factored)


@pytest.mark.parametrize("kw,error,match", [
    (dict(mesh=MeshConfig(fsdp=1, context=2)), NotImplementedError,
     "context"),
    (dict(log_grad_norm=True), ValueError, "log_grad_norm"),
])
def test_step_builder_refuses_what_jax_refuses(kw, error, match):
    cfg = TrainConfig(model=TCFG, optimizer=OptimizerConfig(
        in_backward=True), **kw)
    with pytest.raises(error, match=match):
        step_for(cfg)
    # the standard step takes both
    assert step_for(TrainConfig(model=TCFG, **kw)) is train_step


# --------------------------------------------------------- fsdp 2, tensor 2


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inloop_world2(tmp_path_factory):
    """The in-backward runs in one process, then in 2 gloo processes at
    fsdp 2 and tensor 2 (`tests/_torch_fsdp_workers.py inloop`)."""
    tmp = tmp_path_factory.mktemp("inloop")
    _, data = jax_mesh.worker_inputs()
    np.savez(tmp / "in.npz", **data)
    want = workers.inloop_reference(
        {k: np.asarray(v) for k, v in data.items()}, str(tmp / "one"))
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_fsdp_workers.py"),
         "inloop", str(_port()), str(tmp / "in.npz"), str(tmp / "out.npz"),
         str(tmp / "ckpt")],
        capture_output=True, text=True, timeout=400, cwd=tmp)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), want


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(workers.INLOOP_RUNS))
def test_sharded_inloop_matches_one_process(inloop_world2, name):
    """fsdp 2 (FSDP2, gathered and reduce-scattered by the step) and
    tensor 2 (each block's heads and MLP columns split) against one
    process on the same global batches, at the limit of the sharded
    standard step (1e-5): losses, the step-1 gradients the optimizer
    received (whole), the parameters after the steps and the factors of
    a factored ν."""
    res, want = inloop_world2
    one = "one_fac" if name.endswith("_fac") else "one"
    np.testing.assert_allclose(res[f"inloop.{name}.losses"],
                               want[f"inloop.{one}.losses"], rtol=1e-5)
    for what in ("grads", "params", "factors"):
        got, ref = res[f"inloop.{name}.{what}"], want[f"inloop.{one}.{what}"]
        assert got.shape == ref.shape, what
        if ref.size:
            assert _rel(got, ref) < 1e-5, (what, _rel(got, ref))
    assert (res[f"inloop.{name}.factors"].size > 0) == name.endswith("_fac")


def test_sharded_inloop_resumes_bit_for_bit(inloop_world2):
    """A checkpoint of factored ν at fsdp 2 (DCP, the factors gathered
    whole) resumed by a fresh Trainer: the continuous run's losses,
    parameters, μ and factors, bit for bit; and in one process."""
    for res in inloop_world2:
        np.testing.assert_array_equal(res["resume.resumed.losses"],
                                      res["resume.continuous.losses"])
        np.testing.assert_array_equal(res["resume.resumed.state"],
                                      res["resume.continuous.state"])
