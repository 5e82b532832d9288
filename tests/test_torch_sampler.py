"""The port's Euler+CFG sampler and its entry point, on the CPU.

The trajectory is compared with the JAX `euler_cfg_sample` on the same
weights (moved through `state_dict_from_jax_params`), the same injected
latents and context, at CFG 6.0 and 1.0; fp32, atol 2e-4, rtol 1e-3.
With RoPE jitter the JAX sampler draws one offset per Euler step from its
key; the test recovers those offsets from the key and feeds them to the
port's draws, and the trajectories agree within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.models.dit import init_dit
from video_diffusion_speedrun_tpu.models.rope import (
    random_rope_offsets as j_offsets,
)
from video_diffusion_speedrun_tpu.sampling import euler as jeuler
from video_diffusion_speedrun_tpu_torch import sample as tsample
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.core.config import SamplingConfig
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.sampling import euler as teuler

TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, cross_attn_input_size=32, residual_v=True,
            train_bias_and_rms=True)


def _models():
    jcfg = JCfg(**TINY, attention_impl="xla", fused_adaln="off",
                compute_dtype=jnp.float32)
    tcfg = TCfg(**TINY, attention_impl="plain", fused_adaln="off",
                compute_dtype=torch.float32)
    params = init_dit(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(1)
    params["final_proj"]["weight"] = jnp.asarray(
        r.normal(size=params["final_proj"]["weight"].shape) * 0.05, jnp.float32)
    blocks = params["blocks"]["adaLN_modulation"]
    blocks["weight"] = jnp.asarray(
        r.normal(size=blocks["weight"].shape) * 0.02, jnp.float32)
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    return params, jcfg, model


@pytest.mark.parametrize("n,alpha", [(7, 8.0), (50, 8.0), (3, 1.0)])
def test_schedule_matches_jax(n, alpha):
    t, dt = teuler.schedule(n, alpha)
    jt, jdt = jeuler.schedule(n, alpha)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-7)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), atol=1e-7)


@pytest.mark.parametrize("cfg_scale", [6.0, 1.0])
def test_trajectory_matches_jax(cfg_scale):
    params, jcfg, model = _models()
    r = np.random.default_rng(2)
    lat = r.normal(size=(1, 4, 4, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(1, 6, 32)).astype(np.float32)
    want = jeuler.euler_cfg_sample(params, jcfg, jnp.asarray(lat),
                                   jnp.asarray(ctx), num_steps=3,
                                   cfg_scale=cfg_scale)
    got = teuler.euler_cfg_sample(model, torch.from_numpy(lat),
                                  torch.from_numpy(ctx), num_steps=3,
                                  cfg_scale=cfg_scale)
    assert got.dtype == torch.float32
    assert np.abs(np.asarray(want) - lat).max() > 1e-2  # the latents moved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("cfg_scale", [6.0, 1.0])
def test_jittered_trajectory_matches_jax(monkeypatch, cfg_scale):
    """JAX splits its jitter key once per step and draws that step's
    offsets from the second half (`euler.py:88-105`); the port draws one
    `random_rope_offsets` per step from its generator, here fed JAX's."""
    params, jcfg, model = _models()
    r = np.random.default_rng(2)
    lat = r.normal(size=(1, 4, 4, 8, 8)).astype(np.float32)
    ctx = r.normal(size=(1, 6, 32)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jeuler.euler_cfg_sample(params, jcfg, jnp.asarray(lat),
                                   jnp.asarray(ctx), num_steps=3,
                                   cfg_scale=cfg_scale, rope_jitter_rng=key)
    drawn, jrng = [], key
    for _ in range(3):
        jrng, step_key = jax.random.split(jrng)
        drawn.append(np.asarray(j_offsets(step_key, 2, 4, 4)))
    assert len({tuple(o) for o in drawn}) == 3  # the jitter moves
    offsets = iter(drawn)
    calls = []

    def jax_draws(generator, *grid):
        calls.append(grid)
        return torch.from_numpy(next(offsets).astype(np.int64))

    monkeypatch.setattr(teuler, "random_rope_offsets", jax_draws)
    got = teuler.euler_cfg_sample(model, torch.from_numpy(lat),
                                  torch.from_numpy(ctx), num_steps=3,
                                  cfg_scale=cfg_scale,
                                  jitter=torch.Generator().manual_seed(0))
    assert calls == [(2, 4, 4, 128, 128, 128)] * 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)
    # the jitter moves the trajectory by more than ten times the port's
    # distance from JAX's, so the comparison sees the offsets
    plain = jeuler.euler_cfg_sample(params, jcfg, jnp.asarray(lat),
                                    jnp.asarray(ctx), num_steps=3,
                                    cfg_scale=cfg_scale)
    moved = np.abs(np.asarray(plain) - np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() < moved / 10


def test_jitter_comes_from_its_generator():
    """Jitter draws from the generator it is given (the same seed, the
    same latents bit for bit; another trajectory than no jitter); without
    one the trajectory is the unjittered one."""
    _, _, model = _models()
    sampling = SamplingConfig(inference_steps=2, height=64, width=64,
                              num_latent_frames=4, seed=3)
    ctx = torch.randn(1, 6, 32, generator=torch.Generator().manual_seed(1))

    def run(jitter_seed):
        jitter = (None if jitter_seed is None
                  else torch.Generator().manual_seed(jitter_seed))
        return teuler.generate_latents(model, ctx, sampling, jitter=jitter)

    plain, a, b = run(None), run(5), run(5)
    assert torch.equal(a, b)
    assert not torch.equal(a, plain)
    assert torch.equal(plain, teuler.generate_latents(model, ctx, sampling))


def test_generate_latents_shape_and_seed():
    _, _, model = _models()
    sampling = SamplingConfig(inference_steps=2, height=64, width=48,
                              num_latent_frames=4, seed=3)
    ctx = torch.zeros(1, 6, 32)
    a = teuler.generate_latents(model, ctx, sampling)
    b = teuler.generate_latents(model, ctx, sampling)
    assert a.shape == (1, 4, 4, 8, 6) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)


TINY_ARGS = ["--height", "32", "--width", "32", "--num_latent_frames", "4",
             "--inference_steps", "2", "--model_width", "64",
             "--model_depth", "2", "--model_head_dim", "32",
             "--context_dim", "32"]


def test_entry_point_runs_on_cpu(capsys, tmp_path):
    lat = tsample.main(TINY_ARGS + ["--device", "cpu", "--output",
                                    str(tmp_path)])
    assert lat.shape == (1, 16, 4, 4, 4)
    assert bool(torch.isfinite(lat).all())
    out = capsys.readouterr().out
    assert "latents (1, 16, 4, 4, 4), std" in out
    # the request goes on to the decoder: 4 latent frames → 13 frames
    assert "decoded 13 frames" in out and "wrote " + str(tmp_path) in out


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsample.main(TINY_ARGS)


def test_entry_point_accepts_steps_per_call_with_no_effect(tmp_path):
    """A JAX command line with `--steps_per_call` (JAX splits the
    trajectory into programs of that many steps) parses and samples the
    same latents."""
    assert tsample.parse_args(TINY_ARGS + ["--steps_per_call", "1"]
                              ).steps_per_call == 1
    base = TINY_ARGS + ["--device", "cpu", "--output", str(tmp_path)]
    torch.testing.assert_close(
        tsample.main(base + ["--steps_per_call", "1"]), tsample.main(base),
        rtol=0, atol=0)
