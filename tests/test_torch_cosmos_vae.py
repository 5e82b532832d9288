"""The port's Cosmos CV4x8x8 decoder, layer map and decode helpers against
the JAX package's, on the CPU.

Weights are drawn by the JAX `init_cosmos_decoder` at a tiny config with
CV4x8x8's up-sampling factorisation and carried over by
`cosmos_state_dict_from_jax_params`; latents come from numpy. fp32
throughout: the decoded video within atol 1e-4 of JAX's (the same convs
and attention summed in another order, through ~20 layers, before a tanh
whose values lie in [-1, 1]). Integer outputs (uint8 frames, the layer
map, the state-dict names and shapes) must be equal.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.models import cosmos_layer_map as jmap
from video_diffusion_speedrun_tpu.models import cosmos_vae as jvae
from video_diffusion_speedrun_tpu.sampling import decode as jdecode
from video_diffusion_speedrun_tpu_torch.models import cosmos_layer_map as tmap
from video_diffusion_speedrun_tpu_torch.models import cosmos_vae as tvae
from video_diffusion_speedrun_tpu_torch.models.convert import (
    cosmos_state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.sampling import decode as tdecode

SIZES = dict(z_channels=16, out_channels=3, channels=8,
             channels_mult=(1, 2, 2), num_res_blocks=1, norm_groups=4)
JCFG = jvae.CosmosDecoderConfig(**SIZES, compute_dtype=jnp.float32)
TCFG = tvae.CosmosDecoderConfig(**SIZES, compute_dtype=torch.float32)
ATOL = 1e-4
FIXTURE = Path(__file__).parent / "fixtures" / "cosmos_decoder_layer_map.json"


def _pair(jcfg=JCFG, tcfg=TCFG, seed=0):
    params = jax.tree.map(np.asarray,
                          jvae.init_cosmos_decoder(jax.random.PRNGKey(seed),
                                                   jcfg))
    # norms away from the identity, so that a misplaced scale shows
    r = np.random.default_rng(seed + 5)
    for path, _ in list(tmap.flatten(params)):
        if path.endswith(".scale") or path.endswith(".bias") and (
                "norm" in path):
            node = params
            keys = path.split(".")
            for k in keys[:-1]:
                node = node[int(k)] if isinstance(node, list) else node[k]
            node[keys[-1]] = r.uniform(0.5, 1.5, node[keys[-1]].shape
                                       ).astype(np.float32) \
                if keys[-1] == "scale" else r.normal(
                    0, 0.1, node[keys[-1]].shape).astype(np.float32)
    model = tvae.CosmosDecoder(tcfg, device="cpu")
    model.load_state_dict(cosmos_state_dict_from_jax_params(params, tcfg),
                          strict=True)
    return params, model


def _latent(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("t,attn", [(3, True), (2, False), (1, True)])
def test_cosmos_decode_matches_jax(t, attn):
    jcfg = dataclasses.replace(JCFG, attn_bottleneck=attn)
    tcfg = dataclasses.replace(TCFG, attn_bottleneck=attn)
    params, model = _pair(jcfg, tcfg)
    lat = _latent((2, 16, t, 4, 3))
    want = np.asarray(jvae.cosmos_decode(params, jcfg, jnp.asarray(lat)))
    got = tvae.cosmos_decode(model, torch.from_numpy(lat))
    assert got.shape == want.shape == (2, 3, 4 * (t - 1) + 1, 32, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 0.1  # not a saturated or dead output


@pytest.mark.parametrize("t,chunk,context", [(7, 2, 2), (5, 4, 2), (4, 4, 2)])
def test_decode_video_chunks_match_jax(t, chunk, context):
    params, model = _pair()
    lat = _latent((16, t, 4, 4), seed=t)
    want = np.asarray(jvae.decode_video(params, JCFG, jnp.asarray(lat),
                                        chunk_frames=chunk,
                                        context_frames=context))
    got = tvae.decode_video(model, torch.from_numpy(lat), chunk_frames=chunk,
                            context_frames=context)
    assert got.shape == want.shape == (3, 4 * (t - 1) + 1, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_decoder_is_causal():
    """Output frame f depends only on latent frames ≤ ceil(f / 4): changing
    the last latent frame leaves every earlier output frame unchanged."""
    _, model = _pair()
    lat = torch.from_numpy(_latent((1, 16, 4, 4, 4)))
    base = model(lat)
    moved = lat.clone()
    moved[:, :, -1] += 3.0
    out = model(moved)
    torch.testing.assert_close(out[:, :, :9], base[:, :, :9], rtol=0, atol=0)
    assert (out[:, :, 9:] - base[:, :, 9:]).abs().max() > 1e-3


def test_state_dict_matches_the_pinned_layer_map():
    """At the default config the port's state-dict names and shapes are the
    Cosmos-Tokenizer ones of the fixture; the port's map equals it and the
    JAX map."""
    pinned = json.loads(FIXTURE.read_text())
    cfg = tvae.CosmosDecoderConfig()
    assert tmap.expected_map(cfg) == pinned
    assert tmap.expected_map(cfg) == jmap.expected_map()
    model = tvae.CosmosDecoder(cfg, device="meta")
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    want = {e["torch"]: e["torch_shape"] for e in pinned.values()}
    assert got == want


def test_npz_loader_reads_the_converter_format(tmp_path):
    params, model = _pair(seed=3)
    np.savez(tmp_path / "dec.npz", **dict(tmap.flatten(params)))
    sd = tvae.load_decoder_params(str(tmp_path / "dec.npz"), TCFG)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    # the JAX loader reads the same file into the same tree
    jp = jvae.load_decoder_params(str(tmp_path / "dec.npz"), JCFG)
    for path, leaf in tmap.flatten(jax.tree.map(np.asarray, jp)):
        np.testing.assert_array_equal(dict(tmap.flatten(params))[path], leaf)
    flat = dict(tmap.flatten(params))
    flat.pop("conv_in.w")
    np.savez(tmp_path / "short.npz", **flat)
    with pytest.raises(KeyError, match="conv_in.w"):
        tvae.load_decoder_params(str(tmp_path / "short.npz"), TCFG)


def test_decode_helpers_match_jax(tmp_path):
    video = np.random.default_rng(2).uniform(-1.2, 1.2, (3, 5, 6, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(tdecode.unclamp_video(video),
                                  jdecode.unclamp_video(video))
    frames = tdecode.to_frames(video)
    np.testing.assert_array_equal(frames, jdecode.to_frames(video))
    assert frames.shape == (5, 6, 4, 3) and frames.dtype == np.uint8
    # a tensor is converted where it lies, to the same bytes
    np.testing.assert_array_equal(
        tdecode.to_frames(torch.from_numpy(video).bfloat16()),
        jdecode.to_frames(torch.from_numpy(video).bfloat16().float().numpy()))
    np.testing.assert_array_equal(tdecode.to_frames(torch.from_numpy(video)),
                                  frames)
    out = tdecode.save_video(video, str(tmp_path), "clip")
    if out.endswith(".mp4"):  # an h264 encoder is installed here
        assert Path(out).stat().st_size > 0
    else:
        np.testing.assert_array_equal(np.load(Path(out) / "video.npy"),
                                      frames)


def test_save_latents_to_video_writes_the_chunked_decode(tmp_path,
                                                         monkeypatch):
    """With no imageio (as on the card machine) the frames land in
    `<name>/video.npy`: the chunked decode's frames."""
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *a, **k):
        if name == "imageio":
            raise ImportError("no imageio")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    _, model = _pair()
    lat = torch.from_numpy(_latent((16, 6, 4, 4)))
    out = tdecode.save_latents_to_video(lat, model, str(tmp_path), "v")
    assert out == str(tmp_path / "v")
    assert sorted(p.name for p in Path(out).iterdir()) == ["video.npy"]
    want = tdecode.to_frames(tvae.decode_video(model, lat, chunk_frames=4)
                             .numpy())
    np.testing.assert_array_equal(np.load(Path(out) / "video.npy"), want)


def test_group_norm_is_jax_per_frame_group_norm():
    """The port's `F.group_norm` over [B·T, C, H, W] against the JAX
    `group_norm` (fp32 moments over a [B, g, c/g, T, H·W] view): fp32
    within 2e-6 (the same moments summed in another order)."""
    r = np.random.default_rng(3)
    x = (r.standard_normal((2, 16, 3, 5, 4)) * 3 + 1).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = r.normal(0, 0.1, 16).astype(np.float32)
    want = jvae.group_norm({"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)}, jnp.asarray(x), 4)
    got = tvae.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), 4)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
