"""The port's DiT against the JAX `dit_forward`, on the CPU, in fp32.

Weights made by the JAX `init_dit` (with the zero-initialised AdaLN and
output layers given random values, else the output is exactly 0) move into
the port through `state_dict_from_jax_params`, which must equal the JAX
package's `params_to_torch_dit` key for key. The forward is compared for
the three flag sets of tests/test_reference_parity.py and for both dispatch
pairings: port "fused" with JAX "pallas" (Pallas in interpret mode), port
"plain"/"off" with JAX "xla"/"off". atol 2e-4, rtol 1e-3, as that file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.models.convert import params_to_torch_dit
from video_diffusion_speedrun_tpu.models.dit import dit_forward, init_dit
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT

TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=64,
            depth=2, num_heads=2, mlp_ratio=4.0, cross_attn_input_size=32,
            rope_order="reference")
FLAGS = {
    "trainable_rms": dict(residual_v=True, train_bias_and_rms=True),
    "demo_flags": dict(residual_v=True, train_bias_and_rms=False),
    "no_residual_v": dict(residual_v=False, train_bias_and_rms=True),
}
# port dispatch → JAX dispatch
PAIRINGS = {
    "fused": (dict(attention_impl="fused", fused_adaln="fused"),
              dict(attention_impl="pallas", fused_adaln="pallas")),
    "plain": (dict(attention_impl="plain", fused_adaln="off"),
              dict(attention_impl="xla", fused_adaln="off")),
}


def jax_params(jcfg, seed=0):
    """init_dit with the zero-init layers given small random values and
    the value-residual λ drawn per block."""
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
    if "lambda_param" in params["blocks"]:  # off the init's symmetric 0.5
        lam = params["blocks"]["lambda_param"]
        params["blocks"]["lambda_param"] = jnp.asarray(
            r.uniform(0.1, 0.9, lam.shape).astype(np.float32))
    return params


def port_model(tcfg, params):
    np_params = jax.tree.map(np.asarray, params)
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(np_params, tcfg),
                          strict=True)
    return model


def configs(flags, pairing):
    tkw, jkw = PAIRINGS[pairing]
    jcfg = JCfg(**TINY, **FLAGS[flags], **jkw, compute_dtype=jnp.float32,
                remat=False)
    tcfg = TCfg(**TINY, **FLAGS[flags], **tkw, compute_dtype=torch.float32)
    return jcfg, tcfg


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_weight_transfer_equals_params_to_torch_dit(flags):
    jcfg, tcfg = configs(flags, "plain")
    params = jax_params(jcfg)
    want = params_to_torch_dit(params, jcfg)
    got = state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    DiT(tcfg, device="cpu").load_state_dict(got, strict=True)


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_forward_matches_dit_forward(flags, pairing):
    jcfg, tcfg = configs(flags, pairing)
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


def test_init_matches_init_dit_structure():
    """The port's own init: zero AdaLN/final layers, λ = 0.5, weights
    within U(±factor/√fan_in), patch projection unscaled."""
    _, tcfg = configs("demo_flags", "plain")
    model = DiT(tcfg, device="cpu", init_std_factor=0.1)
    blk = model.blocks[0]
    assert not blk.adaLN_modulation[1].weight.any()
    assert not model.final_proj.weight.any()
    assert not model.final_modulation[1].bias.any()
    assert blk.lambda_param.item() == 0.5
    assert blk.qkv.weight.abs().max() <= 0.1 / 64 ** 0.5
    assert blk.qkv.bias is None  # train_bias_and_rms=False
    patch_bound = 1 / tcfg.patch_dim ** 0.5
    assert model.patch_embed.patch_proj.weight.abs().max() > 0.1 * patch_bound
    assert model.patch_embed.patch_proj.weight.abs().max() <= patch_bound


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs("demo_flags", "plain")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiT(tcfg)
