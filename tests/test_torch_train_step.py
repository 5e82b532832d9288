"""The port's training path against the JAX package, on the CPU, in fp32.

Weights made by the JAX `init_dit` (the zero-initialised AdaLN and output
layers given random values, λ off 0.5) move into the port through the
weight converter. Inputs are numpy, seeded; timesteps, noise and rope
offsets are injected and caption dropout is 0, so both sides see the same
numbers.

- loss: `rectified_flow_loss` against JAX, loss and per-sample losses at
  rtol 1e-5, bins at rtol 1e-5 (fp32 MSE over the same outputs);
- train step: a 5-step loss trajectory and the final parameters against
  JAX `value_and_grad(rectified_flow_loss)` + `fused_apply` (with
  `accumulate_grads`' microbatch mean for grad_accum=2), remat on, for
  both dispatch pairings (port "fused" with JAX "pallas" in interpret
  mode, port "plain"/"off" with JAX "xla"/"off"). Losses at rtol 1e-4;
  parameters at atol 2e-5: Adam's first steps move a weight by about ±lr
  whatever the size of its gradient, so a gradient component near zero
  may take another sign in the other framework's summation order — the
  relative L2 of each leaf is held at 1e-4 as well;
- CUDA graphs: the rule that lets a step replay them, a pure predicate
  held here on CPU objects (the replay itself is held against the eager
  step on the card, tests/test_torch_gpu_step_graph.py); CPU steps never
  capture; the launch counters a replay credits;
- entry point: `python -m video_diffusion_speedrun_tpu_torch.train` takes
  3 steps on the CPU with a finite loss, also with the optimizer in the
  backward, factored ν and bf16 parameters; it refuses the card when none
  is present and what JAX's CLI refuses.
"""

import subprocess
import sys

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
from video_diffusion_speedrun_tpu_torch.train import __main__ as cli
from video_diffusion_speedrun_tpu_torch.train.loss import rectified_flow_loss
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.parallel.ring import LocalRing
from video_diffusion_speedrun_tpu_torch.train import step as tstep
from video_diffusion_speedrun_tpu_torch.train.step import train_step

TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, mlp_ratio=4.0, cross_attn_input_size=32,
            residual_v=True, train_bias_and_rms=False)
PAIRINGS = {
    "fused": (dict(attention_impl="fused", fused_adaln="fused"),
              dict(attention_impl="pallas", fused_adaln="pallas")),
    "plain": (dict(attention_impl="plain", fused_adaln="off"),
              dict(attention_impl="xla", fused_adaln="off")),
}
LR, STEPS, B = 2.0 ** -6, 5, 4
# latent [B, 4, 5, 8, 8]: 5 frames floor-crop to 4, L = 2·4·4 + 16 = 48
LATENT = (4, 5, 8, 8)


def configs(pairing):
    tkw, jkw = PAIRINGS[pairing]
    jcfg = JCfg(**TINY, **jkw, compute_dtype=jnp.float32, remat=True)
    tcfg = TCfg(**TINY, **tkw, compute_dtype=torch.float32, remat=True)
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
    lam = params["blocks"]["lambda_param"]
    params["blocks"]["lambda_param"] = jnp.asarray(
        r.uniform(0.1, 0.9, lam.shape).astype(np.float32))
    return params


def port_model(tcfg, params):
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    return model


def batches(n, seed=5):
    """n batches of numpy inputs: latent, context, timesteps, noise (of the
    cropped latent) and rope offsets."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(dict(
            latent=r.normal(size=(B, *LATENT)).astype(np.float32),
            context=(r.normal(size=(B, 7, 32)) * 0.5).astype(np.float32),
            timesteps=r.uniform(0.02, 0.98, B).astype(np.float32),
            noise=r.normal(size=(B, 4, 4, 8, 8)).astype(np.float32),
            rope_offsets=r.integers(0, 5, 3).astype(np.int32)))
    return out


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_loss_matches_jax(pairing):
    jcfg, tcfg = configs(pairing)
    params = jax_params(jcfg)
    (bt,) = batches(1)
    loss, aux = j_loss(params, jcfg, jnp.asarray(bt["latent"]),
                       jnp.asarray(bt["context"]), jax.random.PRNGKey(0),
                       timesteps=jnp.asarray(bt["timesteps"]),
                       noise=jnp.asarray(bt["noise"]), caption_dropout=0.0,
                       rope_offsets=jnp.asarray(bt["rope_offsets"]))
    model = port_model(tcfg, params)
    with torch.no_grad():
        tl, taux = rectified_flow_loss(
            model, torch.from_numpy(bt["latent"]),
            torch.from_numpy(bt["context"]), None, caption_dropout=0.0,
            timesteps=torch.from_numpy(bt["timesteps"]),
            noise=torch.from_numpy(bt["noise"]),
            rope_offsets=torch.from_numpy(bt["rope_offsets"]))
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    for key in ("loss_per_sample", "bin_sums", "bin_counts"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(aux[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert taux["bin_counts"].sum().item() == B


def jax_trajectory(jcfg, params, data, accum):
    ocfg = JOptCfg(learning_rate=LR, scheduler="linear", warmup_steps=2)
    tx, _, _, tx_args = build_optimizer(params, LR, STEPS, ocfg)
    opt_state = tx.init(params)

    def loss_fn(p, mb):
        loss, _ = j_loss(p, jcfg, mb["latent"], mb["context"],
                         jax.random.PRNGKey(0), timesteps=mb["timesteps"],
                         noise=mb["noise"], caption_dropout=0.0,
                         rope_offsets=mb["rope_offsets"])
        return loss

    @jax.jit
    def step(params, opt_state, bt):
        # `accumulate_grads`: sum of microbatch losses and grads, × 1/accum
        micro = B // accum
        loss_sum = jnp.zeros(())
        grad_sum = jax.tree.map(jnp.zeros_like, params)
        for i in range(accum):
            mb = {k: (v if k == "rope_offsets" else
                      v[i * micro:(i + 1) * micro]) for k, v in bt.items()}
            loss, grads = jax.value_and_grad(loss_fn)(params, mb)
            loss_sum = loss_sum + loss
            grad_sum = jax.tree.map(jnp.add, grad_sum, grads)
        grads = jax.tree.map(lambda g: g * (1.0 / accum), grad_sum)
        params, opt_state = fused_apply(tx_args, grads, opt_state, params)
        return params, opt_state, loss_sum * (1.0 / accum)

    losses = []
    for bt in data:
        params, opt_state, loss = step(params, opt_state,
                                       jax.tree.map(jnp.asarray, bt))
        losses.append(float(loss))
    return losses, params


def port_trajectory(tcfg, params, data, accum):
    model = port_model(tcfg, params)
    cfg = TrainConfig(model=tcfg, grad_accum=accum, batch_size=B,
                      caption_dropout=0.0, max_steps=STEPS,
                      optimizer=TOptCfg(learning_rate=LR, scheduler="linear",
                                        warmup_steps=2))
    opt = MupAdamW(model.named_parameters(), LR, STEPS, cfg.optimizer)
    losses = []
    for bt in data:
        m = train_step(model, opt, {k: torch.from_numpy(v)
                                    for k, v in bt.items()}, None, cfg)
        losses.append(float(m["loss"]))
    return losses, model


@pytest.mark.parametrize("pairing,accum", [("fused", 1), ("plain", 1),
                                           ("fused", 2)])
def test_train_trajectory_matches_jax(pairing, accum):
    jcfg, tcfg = configs(pairing)
    params = jax_params(jcfg)
    data = batches(STEPS)
    want_losses, want_params = jax_trajectory(jcfg, params, data, accum)
    got_losses, model = port_trajectory(tcfg, params, data, accum)
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


def test_block0_lambda_gets_a_zero_gradient():
    """Block 0 never mixes v0, so λ₀ is outside the graph; the optimizer
    gives it the zero gradient JAX's `jnp.where` gives it."""
    _, tcfg = configs("plain")
    model = DiT(tcfg.replace(remat=False), device="cpu")
    (bt,) = batches(1)
    loss, _ = rectified_flow_loss(
        model, torch.from_numpy(bt["latent"]),
        torch.from_numpy(bt["context"]), torch.Generator().manual_seed(0))
    loss.backward()
    assert model.blocks[0].lambda_param.grad is None
    assert model.blocks[1].lambda_param.grad is not None


def test_grad_norm_metric_is_the_global_norm():
    """`log_grad_norm` reports √Σg² over the step's gradients (before the
    update), as the JAX step's `optax.global_norm(grads)`."""
    _, tcfg = configs("plain")
    (bt,) = batches(1)
    batch = {k: torch.from_numpy(v) for k, v in bt.items()}
    cfg = TrainConfig(model=tcfg, batch_size=B, caption_dropout=0.0,
                      log_grad_norm=True)
    model = DiT(tcfg, device="cpu", seed=3)
    loss, _ = rectified_flow_loss(
        model, batch["latent"], batch["context"], None, caption_dropout=0.0,
        timesteps=batch["timesteps"], noise=batch["noise"],
        rope_offsets=batch["rope_offsets"])
    loss.backward()
    want = torch.sqrt(sum(p.grad.square().sum() for p in model.parameters()
                          if p.grad is not None))
    model.zero_grad(set_to_none=True)
    opt = MupAdamW(model.named_parameters(), LR, STEPS, cfg.optimizer)
    m = train_step(model, opt, batch, None, cfg)
    torch.testing.assert_close(m["grad_norm"], want, rtol=1e-5, atol=0)
    assert all(p.grad is None for p in model.parameters())


CUDA = torch.device("cuda", 0)  # a device object; no card is touched


@pytest.mark.parametrize("case,engages", [
    ("eligible", True), ("cpu", False), ("sharded", False),
    ("context ring", False), ("data group", False), ("grad_accum 2", False)])
def test_graph_engagement_rule(case, engages):
    """A step replays CUDA graphs only on a card, for a model no process
    shares, with no context ring, no data group and one microbatch."""
    _, tcfg = configs("plain")
    model = DiT(tcfg, device="cpu")
    cfg = TrainConfig(model=tcfg, batch_size=B,
                      grad_accum=2 if case == "grad_accum 2" else 1)
    if case == "sharded":
        model.sharding = object()
    got = tstep.graph_engages(
        torch.device("cpu") if case == "cpu" else CUDA, model, cfg,
        LocalRing(2) if case == "context ring" else None,
        object() if case == "data group" else None)
    assert got is engages


def test_graph_key_follows_shapes_and_draws():
    """The key of a step: equal for batches that differ only in their
    values, different for another shape, dtype, generator or dropout
    rate, None for a batch entry off the latent's device."""
    _, tcfg = configs("plain")
    model = DiT(tcfg, device="cpu")
    cfg = TrainConfig(model=tcfg, batch_size=B)
    gen = torch.Generator().manual_seed(0)
    a, b = ({k: torch.from_numpy(v) for k, v in bt.items()}
            for bt in batches(2))
    key = tstep.graph_key(model, a, gen, cfg)
    assert key == tstep.graph_key(model, b, gen, cfg)
    assert key != tstep.graph_key(model, dict(a, latent=a["latent"][:2]),
                                  gen, cfg)
    assert key != tstep.graph_key(
        model, dict(a, context=a["context"].double()), gen, cfg)
    assert key != tstep.graph_key(model, a, torch.Generator(), cfg)
    assert key != tstep.graph_key(
        model, a, gen, TrainConfig(model=tcfg, caption_dropout=0.5))
    assert tstep.graph_key(model, dict(a, tag="x"), gen, cfg) is None


def test_cpu_steps_never_capture():
    """On the CPU every step is the eager one: no graph is kept and the
    graph counters stay at 0."""
    jcfg, tcfg = configs("fused")
    model = port_model(tcfg, jax_params(jcfg))
    cfg = TrainConfig(model=tcfg, batch_size=B, caption_dropout=0.0)
    opt = MupAdamW(model.named_parameters(), LR, STEPS, cfg.optimizer)
    for bt in batches(3):
        m = train_step(model, opt, {k: torch.from_numpy(v)
                                    for k, v in bt.items()}, None, cfg)
        assert np.isfinite(float(m["loss"]))
    assert opt.step_graphs is None
    assert (train_step.captures, train_step.replays,
            train_step.eager_steps) == (0, 0, 0)


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_graph_gradients_equal_the_backward(pairing):
    """`loss_and_grads` (the body of the step's captures) gives the loss and
    every parameter's gradient bit for bit as `loss.backward()` leaves
    them, remat's recompute included, writes no `.grad`, and leaves the
    model's own parameters in place, also while an outside backward's
    graph is still alive."""
    jcfg, tcfg = configs(pairing)
    model = port_model(tcfg, jax_params(jcfg))
    cfg = TrainConfig(model=tcfg, batch_size=B, caption_dropout=0.0)
    opt = MupAdamW(model.named_parameters(), LR, STEPS, cfg.optimizer)
    a, b = ({k: torch.from_numpy(v) for k, v in bt.items()}
            for bt in batches(2))
    outside, _ = tstep._loss(model, a, None, cfg, None)
    outside.backward()  # `outside` keeps its graph's nodes alive
    model.zero_grad(set_to_none=True)
    loss, aux, grads = tstep.loss_and_grads(model, opt, b, None, cfg)
    assert all(p.grad is None for p in opt.params)
    assert all(x is y for x, y in zip(model.parameters(), opt.params))
    want, want_aux = tstep._loss(model, b, None, cfg, None)
    want.backward()
    assert torch.equal(loss, want.detach())
    assert torch.equal(aux["bin_sums"], want_aux["bin_sums"])
    for name, p, g in zip(opt.names, opt.params, grads):
        if p.grad is None:
            assert g is None, name
        else:
            assert g.is_contiguous() and torch.equal(g, p.grad), name


def test_launch_counters_are_found_and_credited():
    """`launch_counters` finds the fused ops' counters, the bias ones too;
    `credit_launches` adds to exactly the counters it names."""
    found = tstep.launch_counters()
    for owner, attr in ((tfa.qkv_rope_flash_forward, "launches"),
                        (tfa.long_attention_forward, "bias_launches"),
                        (tfa.cross_flash_backward, "launches")):
        assert found[(owner, attr)] == getattr(owner, attr)
    before = dict(found)
    tstep.credit_launches({(tfa.cross_flash_backward, "launches"): 3})
    try:
        after = tstep.launch_counters()
        assert {k: after[k] - before[k] for k in before
                if after[k] != before[k]} == {
            (tfa.cross_flash_backward, "launches"): 3}
    finally:
        tfa.cross_flash_backward.launches -= 3


ENTRY = [sys.executable, "-m", "video_diffusion_speedrun_tpu_torch.train"]
TINY_FLAGS = ["--max_steps", "3", "--batch_size", "2", "--model_width", "64",
              "--model_depth", "2", "--model_head_dim", "32",
              "--context_dim", "32", "--synthetic_rows", "8",
              "--log_every", "1", "--evaluate_every", "100"]


def test_entry_point_trains_on_cpu(tmp_path):
    out = subprocess.run(ENTRY + TINY_FLAGS + ["--device", "cpu",
                                               "--checkpoint_dir",
                                               str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.stderr.splitlines() if " loss " in line]
    assert len(losses) == 3 and np.all(np.isfinite(losses)), out.stderr
    # the evaluation after step 1 saved the train state
    assert (tmp_path / "diffusion_repa" / "1" / ".metadata").exists()


def test_entry_point_trains_in_backward_on_cpu(tmp_path):
    """The XL command's flags (`--optimizer_in_backward true --nu_factored
    true --param_dtype bf16 --moments_dtype bf16`) at the tiny size train
    3 steps to a finite loss. No block weight of width 64 reaches
    `nu_factored_min_size` (2²⁰ over the blocks), so ν stays exact here;
    tests/test_torch_inloop.py factors the tiny model with the size
    lowered."""
    out = cli.main(TINY_FLAGS + [
        "--device", "cpu", "--checkpoint_dir", str(tmp_path),
        "--optimizer_in_backward", "true", "--nu_factored", "true",
        "--param_dtype", "bf16", "--moments_dtype", "bf16"])
    assert out["train/step"] == 2 and np.isfinite(out["train/total_loss"])


def test_entry_point_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(TINY_FLAGS)


@pytest.mark.parametrize("flags,error,match", [
    # FSDP and tensor parallelism are ported: without a launcher a world
    # of one process cannot hold a mesh of 2 (tests/test_torch_fsdp.py
    # trains them under a torchrun-style environment)
    (["--mesh_fsdp", "2"], ValueError, "devices"),
    (["--mesh_tensor", "2"], ValueError, "devices"),
    # optimizer-in-backward is ported (tests/test_torch_inloop.py); what
    # JAX refuses with it stays refused: the context axis, and bf16
    # parameters without it (the factored ν does not change that)
    (["--param_dtype", "bf16", "--nu_factored", "true"], ValueError,
     "optimizer_in_backward"),
    (["--optimizer_in_backward", "true", "--mesh_context", "2"],
     NotImplementedError, "context"),
])
def test_entry_point_refuses_later_slices(flags, error, match):
    with pytest.raises(error, match=match):
        cli.main(TINY_FLAGS + ["--device", "cpu"] + flags)


def test_entry_point_refuses_bf16_masters():
    with pytest.raises(ValueError, match="optimizer_in_backward"):
        cli.main(TINY_FLAGS + ["--device", "cpu", "--param_dtype", "bf16"])
