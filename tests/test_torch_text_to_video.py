"""The whole text-to-video request on the CPU: the port's prompt encoding →
Euler+CFG sampling → chunked Cosmos decode against the JAX package's on
the same weights, and the sampler CLI and the streamlit demo's model
set-up end to end.

Weights are drawn by the JAX inits (T5, DiT, decoder) and carried over by
the port's converters; the prompt goes through both packages' byte
tokenizers; the initial noise is injected. fp32 throughout: the decoded
video within atol 2e-4 of JAX's (the request's three stages, each summed
in another order — the sampler tests' 2e-4 on the latents — before a
decoder whose output lies in [-1, 1]).
"""

import ast
import builtins
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.models import cosmos_vae as jvae
from video_diffusion_speedrun_tpu.models.dit import init_dit
from video_diffusion_speedrun_tpu.sampling import euler as jeuler
from video_diffusion_speedrun_tpu.text import encoder as jenc
from video_diffusion_speedrun_tpu.text import t5 as jt5
from video_diffusion_speedrun_tpu_torch import sample as tsample
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.core.config import SamplingConfig
from video_diffusion_speedrun_tpu_torch.models import cosmos_layer_map as tmap
from video_diffusion_speedrun_tpu_torch.models import cosmos_vae as tvae
from video_diffusion_speedrun_tpu_torch.models.convert import (
    cosmos_state_dict_from_jax_params,
    state_dict_from_jax_params,
    t5_state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.sampling import app as tapp
from video_diffusion_speedrun_tpu_torch.sampling import euler as teuler
from video_diffusion_speedrun_tpu_torch.sampling.decode import to_frames
from video_diffusion_speedrun_tpu_torch.text import encoder as tenc
from video_diffusion_speedrun_tpu_torch.text import t5 as tt5
from video_diffusion_speedrun_tpu_torch.train import checkpoint as tckpt

CTX = 32
T5_SIZES = dict(vocab_size=300, d_model=CTX, d_kv=8, d_ff=64, num_layers=2,
                num_heads=4)
DIT = dict(in_channels=16, patch_size=2, time_patch_size=2, hidden_size=64,
           depth=2, num_heads=2, cross_attn_input_size=CTX, residual_v=True,
           train_bias_and_rms=False)
DEC = dict(z_channels=16, out_channels=3, channels=8,
           channels_mult=(1, 2, 2), num_res_blocks=1, norm_groups=4)
PROMPT = "a golden retriever running on a beach"
MAX_LEN = 24


def _jax_request_parts():
    t5cfg = jt5.T5Config(**T5_SIZES, compute_dtype=jnp.float32)
    dcfg = JCfg(**DIT, attention_impl="xla", fused_adaln="off",
                compute_dtype=jnp.float32)
    vcfg = jvae.CosmosDecoderConfig(**DEC, compute_dtype=jnp.float32)
    t5 = jax.tree.map(np.asarray, jt5.init_t5(jax.random.PRNGKey(0), t5cfg))
    dit = jax.tree.map(np.asarray, init_dit(jax.random.PRNGKey(1), dcfg))
    r = np.random.default_rng(2)  # the zero-initialised layers, seeded
    dit["final_proj"]["weight"] = (r.normal(
        size=dit["final_proj"]["weight"].shape) * 0.05).astype(np.float32)
    ada = dit["blocks"]["adaLN_modulation"]
    ada["weight"] = (r.normal(size=ada["weight"].shape) * 0.02).astype(
        np.float32)
    dec = jax.tree.map(np.asarray,
                       jvae.init_cosmos_decoder(jax.random.PRNGKey(3), vcfg))
    return (t5cfg, t5), (dcfg, dit), (vcfg, dec)


def test_whole_request_matches_jax():
    (t5cfg, t5), (dcfg, dit), (vcfg, dec) = _jax_request_parts()
    r = np.random.default_rng(5)
    noise = r.standard_normal((1, 16, 6, 4, 4)).astype(np.float32)

    jpe = jenc.PromptEncoder(t5, t5cfg, jenc.ByteFallbackTokenizer(),
                             max_length=MAX_LEN)
    jctx = jpe([PROMPT], return_index=-1)
    jlat = jeuler.euler_cfg_sample(dit, dcfg, jnp.asarray(noise), jctx,
                                   num_steps=3, cfg_scale=6.0)
    want = np.asarray(jvae.decode_video(dec, vcfg, jlat[0], chunk_frames=4))

    t5m = tt5.T5Encoder(tt5.T5Config(**T5_SIZES,
                                     compute_dtype=torch.float32),
                        device="cpu")
    t5m.load_state_dict(t5_state_dict_from_jax_params(t5))
    tpe = tenc.PromptEncoder(t5m, tenc.ByteFallbackTokenizer(),
                             max_length=MAX_LEN)
    tcfg = TCfg(**DIT, attention_impl="plain", fused_adaln="off",
                compute_dtype=torch.float32)
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(dit, tcfg))
    vtcfg = tvae.CosmosDecoderConfig(**DEC, compute_dtype=torch.float32)
    decoder = tvae.CosmosDecoder(vtcfg, device="cpu")
    decoder.load_state_dict(cosmos_state_dict_from_jax_params(dec, vtcfg))

    ctx = tpe([PROMPT], return_index=-1)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=2e-5,
                               rtol=2e-5)
    lat = teuler.euler_cfg_sample(model, torch.from_numpy(noise), ctx,
                                  num_steps=3, cfg_scale=6.0)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=2e-4,
                               rtol=1e-3)
    assert np.abs(np.asarray(jlat) - noise).max() > 1e-2
    got = tvae.decode_video(decoder, lat[0], chunk_frames=4)
    assert got.shape == want.shape == (3, 21, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


TINY = ["--height", "32", "--width", "32", "--num_latent_frames", "4",
        "--inference_steps", "2", "--model_width", "64", "--model_depth",
        "2", "--model_head_dim", "32", "--context_dim", "32", "--device",
        "cpu"]


@pytest.fixture
def no_imageio(monkeypatch):
    """The card machine has no imageio: the writer falls back to .npy."""
    real_import = builtins.__import__

    def guarded(name, *a, **k):
        if name == "imageio":
            raise ImportError("no imageio")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guarded)


def _port_checkpoint(tmp_path) -> str:
    """A port checkpoint of the sampler's tiny demo DiT (its zero-init
    layers given values), saved as the Trainer saves."""
    cfg = tsample.demo_config(64, 2, 32, 32)
    model = DiT(cfg, device="cpu", init_std_factor=0.1, seed=0)
    with torch.no_grad():
        for blk in model.blocks:
            blk.adaLN_modulation[1].weight.normal_(0, 0.02)
        model.final_proj.weight.normal_(0, 0.05)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt" / "run"))
    mgr.save(7, {"model": model.state_dict(),
                 tckpt.STEP_KEY: torch.tensor([7])})
    return mgr.directory, model


def test_cli_writes_the_video_on_cpu(tmp_path, no_imageio, capsys):
    """checkpoint → smoke T5 → sampling → decode → `<name>/video.npy`: the
    frames of the decoded request, 13 of 32×32 for 4 latent frames."""
    run, model = _port_checkpoint(tmp_path)
    report = {}
    lat = tsample.main(TINY + ["--prompt", PROMPT, "--checkpoint", run,
                               "--smoke_encoder", "--output",
                               str(tmp_path / "out"), "--name", "clip"],
                       report)
    out = capsys.readouterr().out
    assert "smoke encoder: tiny" in out and "RANDOM Cosmos" in out
    assert report["context"].shape == (1, 512, 32)
    assert report["path"] == str(tmp_path / "out" / "clip")
    frames = np.load(Path(report["path"]) / "video.npy")
    assert frames.shape == (13, 32, 32, 3) and frames.dtype == np.uint8
    video = report["video"]
    assert video.shape == (3, 13, 32, 32)
    assert float(video.float().abs().max()) <= 1.0
    np.testing.assert_array_equal(frames, to_frames(video.float().numpy()))
    # the checkpoint's weights were sampled, not a random init
    ctx = report["context"]
    sampling = SamplingConfig(inference_steps=2, height=32, width=32,
                              num_latent_frames=4, seed=42)
    torch.testing.assert_close(lat, teuler.generate_latents(model, ctx,
                                                            sampling),
                               rtol=0, atol=0)
    # a mismatched width fails at the restore, with the model config named
    with pytest.raises(ValueError, match="model config"):
        tsample.main(TINY + ["--model_width", "128", "--checkpoint", run,
                             "--smoke_encoder", "--prompt", "x"])


def test_cli_takes_a_reference_checkpoint_with_its_rope_order(tmp_path,
                                                              capsys):
    _, model = _port_checkpoint(tmp_path)
    pt = tmp_path / "ref.pt"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, pt)
    with pytest.raises(ValueError, match="--prompt"):
        tsample.main(TINY + ["--checkpoint", str(pt), "--smoke_encoder",
                             "--output", str(tmp_path)])
    assert "rope_order='reference'" in capsys.readouterr().out


def test_app_init_models_with_a_stub_streamlit(tmp_path, monkeypatch,
                                               no_imageio):
    """The demo's model set-up without streamlit's UI: random decoder
    weights raise the page's warning; a checkpoint and a decoder .npz
    load; `generate` writes the request's frames."""
    warnings = []
    stub = types.ModuleType("streamlit")
    stub.warning = warnings.append
    monkeypatch.setitem(sys.modules, "streamlit", stub)
    mcfg = tsample.demo_config(64, 2, 32, 32)
    dcfg = tvae.CosmosDecoderConfig(**DEC)
    model, encoder, decoder = tapp.init_models("", "", device="cpu",
                                               model_cfg=mcfg,
                                               decoder_cfg=dcfg)
    assert encoder is None and len(warnings) == 1
    run, trained = _port_checkpoint(tmp_path)
    npz = tmp_path / "dec.npz"
    params = jvae.init_cosmos_decoder(
        jax.random.PRNGKey(4), jvae.CosmosDecoderConfig(**DEC))
    np.savez(npz, **dict(tmap.flatten(jax.tree.map(np.asarray, params))))
    # no T5 weights here: the demo's encoder is the tiny random one
    tiny = tenc.smoke_encoder("tiny", 32, "cpu")
    monkeypatch.setattr(tenc, "load_encoder", lambda device: tiny)
    models = tapp.init_models(run, str(npz), device="cpu", model_cfg=mcfg,
                              decoder_cfg=dcfg)
    assert len(warnings) == 1 and models[1] is not None
    for k, v in trained.state_dict().items():
        assert torch.equal(models[0].state_dict()[k], v), k
    sampling = SamplingConfig(inference_steps=2, height=32, width=32,
                              num_latent_frames=4)
    path = tapp.generate(models, PROMPT, sampling, str(tmp_path / "o"), "a")
    assert np.load(Path(path) / "video.npy").shape == (13, 32, 32, 3)


def test_optional_packages_are_imported_inside_functions():
    """transformers, imageio and streamlit are not on the card machine (or
    not always here): the port imports them only inside the functions that
    use them, never when a module is imported."""
    pkg = Path(__file__).resolve().parent.parent / \
        "video_diffusion_speedrun_tpu_torch"
    optional = ("transformers", "imageio", "streamlit")
    bad, inside = [], 0
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        nested = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in optional:
                    if id(node) in nested:
                        inside += 1
                    else:
                        bad.append(f"{path.name}: {n}")
    assert not bad, bad
    assert inside >= 5  # load_encoder (2), save_video (2), app (2)


def test_cli_over_a_ring_decodes_on_rank_0_alone(tmp_path):
    """`--mesh_context 2` over gloo: both ranks sample the same latents
    (their tokens split over a `DistRing`), and rank 0 alone decodes and
    writes the video, as JAX gathers to one device before the decode."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "sample.npz"
    root = Path(__file__).resolve().parent.parent
    run = subprocess.run(
        [sys.executable, str(root / "tests" / "test_torch_t2v_workers.py"),
         "sample", str(port), str(out)],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert run.returncode == 0, run.stderr[-4000:]
    r0, r1 = (dict(np.load(f"{out}.rank{r}.npz")) for r in (0, 1))
    np.testing.assert_array_equal(r0["latents"], r1["latents"])
    assert str(r0["path"]) == str(tmp_path / "rank0" / "test")
    assert str(r1["path"]) == ""
    assert np.load(Path(str(r0["path"])) / "video.npy").shape == (
        13, 32, 32, 3)
    assert not (tmp_path / "rank1").exists()
