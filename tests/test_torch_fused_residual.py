"""The port's DiT with `fused_residual=True` against the JAX package, on the
CPU, in fp32.

With `fused_residual` the joins after self- and cross-attention go through
`gated_residual_adaln` (the next norm fused in) on both sides. Weights made
by the JAX `init_dit` (the zero-initialised AdaLN and output layers given
random values, λ off 0.5) move into the port through the weight converter;
inputs are numpy, seeded.

- forward: port "fused" against JAX "pallas" (Pallas in interpret mode),
  with and without cross-attention, for the three flag sets of
  tests/test_torch_dit.py; atol 2e-4, rtol 1e-3, as that file;
- training: a 3-step trajectory (remat on) against JAX
  `value_and_grad(rectified_flow_loss)` + `fused_apply`, at the tolerances
  of tests/test_torch_train_step.py: losses rtol 1e-4, parameters atol
  2e-5 and each leaf's relative L2 1e-4.
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
from video_diffusion_speedrun_tpu.models.dit import dit_forward, init_dit
from video_diffusion_speedrun_tpu.train.loss import (
    rectified_flow_loss as j_loss,
)
from video_diffusion_speedrun_tpu.train.optim import (
    build_optimizer,
    fused_apply,
)
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.core.config import (
    OptimizerConfig as TOptCfg,
)
from video_diffusion_speedrun_tpu_torch.core.config import TrainConfig
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as tad
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.train.step import train_step

TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, mlp_ratio=4.0, rope_order="reference",
            fused_residual=True)
FLAGS = {
    "trainable_rms": dict(residual_v=True, train_bias_and_rms=True),
    "demo_flags": dict(residual_v=True, train_bias_and_rms=False),
    "no_residual_v": dict(residual_v=False, train_bias_and_rms=True),
}
CROSS = {"cross": 32, "no_cross": None}
LR, STEPS, B = 2.0 ** -6, 3, 4


def configs(flags, cross, remat=False):
    kw = dict(TINY, **FLAGS[flags], cross_attn_input_size=CROSS[cross])
    jcfg = JCfg(**kw, attention_impl="pallas", fused_adaln="pallas",
                compute_dtype=jnp.float32, remat=remat)
    tcfg = TCfg(**kw, attention_impl="fused", fused_adaln="fused",
                compute_dtype=torch.float32, remat=remat)
    return jcfg, tcfg


def jax_params(jcfg, seed=0):
    params = init_dit(jax.random.PRNGKey(seed), jcfg, init_std_factor=0.5)
    r = np.random.default_rng(seed + 1)
    for path in (("blocks", "adaLN_modulation"), ("final_modulation",),
                 ("final_proj",)):
        leaf = params
        for key in path:
            leaf = leaf[key]
        for name in ("weight", "bias"):
            leaf[name] = jnp.asarray(
                r.normal(size=leaf[name].shape).astype(np.float32) * 0.05)
    if "lambda_param" in params["blocks"]:
        lam = params["blocks"]["lambda_param"]
        params["blocks"]["lambda_param"] = jnp.asarray(
            r.uniform(0.1, 0.9, lam.shape).astype(np.float32))
    return params


def port_model(tcfg, params):
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    return model


@pytest.mark.parametrize("cross", sorted(CROSS))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_forward_matches_dit_forward(flags, cross):
    jcfg, tcfg = configs(flags, cross)
    params = jax_params(jcfg)
    r = np.random.default_rng(7)
    x = r.normal(size=(2, 4, 4, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(2, 7, 32)).astype(np.float32)
    ts = np.asarray([0.3, 0.9], np.float32)
    off = np.asarray([1, 2, 3], np.int32)

    want = dit_forward(params, jcfg, jnp.asarray(x), jnp.asarray(ctx),
                       jnp.asarray(ts), rope_offsets=jnp.asarray(off))
    model = port_model(tcfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx),
                    torch.from_numpy(ts), rope_offsets=torch.from_numpy(off))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # not the zero init
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    assert tad.gated_residual_adaln.launches == 0  # CPU runs the twins


def batches(n, seed=5):
    r = np.random.default_rng(seed)
    return [dict(
        latent=r.normal(size=(B, 4, 5, 8, 8)).astype(np.float32),
        context=(r.normal(size=(B, 7, 32)) * 0.5).astype(np.float32),
        timesteps=r.uniform(0.02, 0.98, B).astype(np.float32),
        noise=r.normal(size=(B, 4, 4, 8, 8)).astype(np.float32),
        rope_offsets=r.integers(0, 5, 3).astype(np.int32)) for _ in range(n)]


def test_train_trajectory_matches_jax():
    jcfg, tcfg = configs("demo_flags", "cross", remat=True)
    params = jax_params(jcfg)
    data = batches(STEPS)
    ocfg = JOptCfg(learning_rate=LR, scheduler="linear", warmup_steps=2)
    tx, _, _, tx_args = build_optimizer(params, LR, STEPS, ocfg)

    def loss_fn(p, bt):
        loss, _ = j_loss(p, jcfg, bt["latent"], bt["context"],
                         jax.random.PRNGKey(0), timesteps=bt["timesteps"],
                         noise=bt["noise"], caption_dropout=0.0,
                         rope_offsets=bt["rope_offsets"])
        return loss

    @jax.jit
    def step(p, opt_state, bt):
        loss, grads = jax.value_and_grad(loss_fn)(p, bt)
        p, opt_state = fused_apply(tx_args, grads, opt_state, p)
        return p, opt_state, loss

    want_params, opt_state, want_losses = params, tx.init(params), []
    for bt in data:
        want_params, opt_state, loss = step(want_params, opt_state,
                                            jax.tree.map(jnp.asarray, bt))
        want_losses.append(float(loss))

    model = port_model(tcfg, params)
    cfg = TrainConfig(model=tcfg, batch_size=B, caption_dropout=0.0,
                      max_steps=STEPS,
                      optimizer=TOptCfg(learning_rate=LR, scheduler="linear",
                                        warmup_steps=2))
    opt = MupAdamW(model.named_parameters(), LR, STEPS, cfg.optimizer)
    got_losses = [float(train_step(model, opt, {
        k: torch.from_numpy(v) for k, v in bt.items()}, None, cfg)["loss"])
        for bt in data]

    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert len(set(np.round(got_losses, 6))) == STEPS  # the weights moved
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want_params),
                                      tcfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
        rel = ((g - w).norm() / w.norm().clamp(min=1e-12)).item()
        assert rel < 1e-4, (name, rel)
    assert tad.gated_residual_adaln_bwd.launches == 0
