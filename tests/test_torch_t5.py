"""The port's T5 encoder and prompt encoder against the JAX package's, on
the CPU.

Weights are drawn by the JAX `init_t5` and carried over by
`t5_state_dict_from_jax_params`; token ids come from numpy. fp32
throughout: every hidden state within atol = rtol = 2e-5 of JAX's (the
same products summed in another order, through 3 layers of values of
order 1–10). The relative-position buckets and the byte tokenizer's ids
are integers and must be equal. The HF-named state dict of a tiny
transformers `T5EncoderModel` loads with `load_state_dict` and gives
transformers' own hidden states within 2e-4 (its attention sums in
another order and applies the norm's scale in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.text import encoder as jenc
from video_diffusion_speedrun_tpu.text import t5 as jt5
from video_diffusion_speedrun_tpu_torch.models.convert import (
    t5_state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.text import encoder as tenc
from video_diffusion_speedrun_tpu_torch.text import t5 as tt5

SIZES = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=128, num_layers=3,
             num_heads=4)
JCFG = jt5.T5Config(**SIZES, compute_dtype=jnp.float32)
TCFG = tt5.T5Config(**SIZES, compute_dtype=torch.float32)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pair():
    params = jt5.init_t5(jax.random.PRNGKey(0), JCFG)
    # non-trivial norm scales, so that a misplaced scale shows
    r = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, params)
    params["final_ln"] = r.uniform(0.5, 1.5, SIZES["d_model"]).astype(
        np.float32)
    for blk in params["blocks"]:
        blk["ln1"] = r.uniform(0.5, 1.5, SIZES["d_model"]).astype(np.float32)
        blk["ln2"] = r.uniform(0.5, 1.5, SIZES["d_model"]).astype(np.float32)
    model = tt5.T5Encoder(TCFG, device="cpu")
    model.load_state_dict(t5_state_dict_from_jax_params(params), strict=True)
    return params, model.eval()


def _ids(b=2, l=24):
    return np.random.default_rng(1).integers(0, SIZES["vocab_size"], (b, l))


def test_every_hidden_state_matches_jax(pair):
    params, model = pair
    ids = _ids()
    want = jt5.t5_encode(params, JCFG, jnp.asarray(ids))
    with torch.no_grad():
        got = model.hidden_states(torch.from_numpy(ids))
    assert len(got) == len(want) == SIZES["num_layers"] + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_original_t5_relu_feed_forward_matches_jax():
    """`feed_forward_proj="relu"` (the original T5's `wi`)."""
    jcfg = jt5.T5Config(**SIZES, feed_forward_proj="relu",
                        compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jt5.init_t5(jax.random.PRNGKey(2), jcfg))
    model = tt5.T5Encoder(tt5.T5Config(**SIZES, feed_forward_proj="relu",
                                       compute_dtype=torch.float32),
                          device="cpu")
    model.load_state_dict(t5_state_dict_from_jax_params(params), strict=True)
    ids = _ids()
    want = jt5.encode(params, jcfg, jnp.asarray(ids), -2)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(ids), -2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("return_index", [-1, -2, -3])
def test_encode_at_return_index_matches_jax(pair, return_index):
    params, model = pair
    ids = _ids()
    want = jt5.encode(params, JCFG, jnp.asarray(ids), return_index)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(ids), return_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qlen,klen,buckets,dist", [
    (512, 512, 32, 128), (37, 90, 32, 128), (64, 64, 16, 20)])
def test_relative_position_buckets_match_jax(qlen, klen, buckets, dist):
    want = jt5.relative_position_buckets(qlen, klen, buckets, dist)
    got = tt5.relative_position_buckets(qlen, klen, buckets, dist)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_byte_tokenizer_matches_jax():
    prompts = ["a tranquil mountain range", "", "é" * 40, "x" * 100]
    want = jenc.ByteFallbackTokenizer()(prompts, max_length=32)["input_ids"]
    got = tenc.ByteFallbackTokenizer()(prompts, max_length=32)["input_ids"]
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == 1 and got[3, 31] == 1  # EOS, truncated at 31 bytes


@pytest.mark.parametrize("return_index", [-1, -2])
def test_prompt_encoder_matches_jax(pair, return_index):
    params, model = pair
    jpe = jenc.PromptEncoder(params, JCFG, jenc.ByteFallbackTokenizer(),
                             max_length=40)
    tpe = tenc.PromptEncoder(model, tenc.ByteFallbackTokenizer(),
                             max_length=40)
    prompts = ["a dog on a beach", "timelapse of clouds"]
    np.testing.assert_array_equal(tpe.tokenize(prompts),
                                  jpe.tokenize(prompts))
    want = jpe(prompts, return_index=return_index)
    got = tpe(prompts, return_index=return_index)
    assert got.shape == (2, 40, SIZES["d_model"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ids = _ids(1, 40) % 256
    np.testing.assert_allclose(
        tpe.encode_ids(ids, return_index).numpy(),
        np.asarray(jpe.encode_ids(ids, return_index)), **TOL)
    emb = tenc.precompute_embeddings(tpe, prompts * 3, return_index,
                                     batch_size=4)
    assert emb.shape == (6, 40, SIZES["d_model"]) and emb.dtype == np.float32
    np.testing.assert_allclose(emb[4:], got.numpy(), rtol=0, atol=0)


def test_hf_state_dict_loads_by_name():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=SIZES["vocab_size"], d_model=64, d_kv=16, d_ff=128,
        num_layers=3, num_heads=4, feed_forward_proj="gated-gelu",
        dropout_rate=0.0)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(hf_cfg).eval()
    model = tt5.T5Encoder(TCFG, device="cpu")
    model.load_state_dict(tt5.convert_torch_t5(hf.state_dict(), TCFG),
                          strict=True)
    assert set(model.state_dict()) == set(hf.state_dict())
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        want = hf(ids, output_hidden_states=True).hidden_states
        got = model.hidden_states(ids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)


def test_random_init_and_load_encoder_fallback():
    cfg = tt5.T5Config(**SIZES, compute_dtype=torch.bfloat16)
    enc = tenc.load_encoder("/nonexistent/flux", cfg, allow_random_init=True,
                            device="cpu")
    assert isinstance(enc.tokenizer, tenc.ByteFallbackTokenizer)
    assert enc.model.shared.weight.dtype == torch.bfloat16
    out = enc(["hello"], return_index=-1)
    assert out.shape == (1, 512, 64) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    with pytest.raises(RuntimeError, match="allow_random_init"):
        tenc.load_encoder("/nonexistent/flux", cfg, device="cpu")
    # a mesh shards the encoder over its fsdp axis (2 processes:
    # tests/test_torch_fsdp.py); at fsdp 1 that changes nothing

    class OneCard:  # every axis of size 1
        mesh_dim_names = ("replica", "fsdp", "context", "tensor")

        def size(self, dim):
            return 1

    same = tenc.PromptEncoder(enc.model, enc.tokenizer, mesh=OneCard())
    torch.testing.assert_close(same(["hello"], return_index=-1), out,
                               rtol=0, atol=0)


def test_xxl_config_counts_and_meta_build():
    cfg = tt5.T5Config.xxl()
    model = tt5.T5Encoder(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == 4_762_310_656
    assert (cfg.d_model, cfg.num_layers, cfg.num_heads) == (4096, 24, 64)


def test_trainer_conditions_on_caption_encodings(pair):
    """With a prompt encoder the Trainer's train batches carry the T5
    encoding (at `t5_return_index`) of their rows' captions — the JAX
    encoder's on the JAX dataset's captions, row for row."""
    from video_diffusion_speedrun_tpu.data.synthetic import (
        SyntheticLatentDataset as JDataset,
    )
    from video_diffusion_speedrun_tpu_torch.core.config import (
        DataConfig,
        DiTConfig,
        TrainConfig,
    )
    from video_diffusion_speedrun_tpu_torch.data.loader import ShardedSampler
    from video_diffusion_speedrun_tpu_torch.train.loop import Trainer

    params, model = pair
    jpe = jenc.PromptEncoder(params, JCFG, jenc.ByteFallbackTokenizer(),
                             max_length=16)
    tpe = tenc.PromptEncoder(model, tenc.ByteFallbackTokenizer(),
                             max_length=16)
    mcfg = DiTConfig(in_channels=4, hidden_size=32, depth=1, num_heads=1,
                     cross_attn_input_size=SIZES["d_model"])
    cfg = TrainConfig(model=mcfg, batch_size=3, t5_return_index=-2,
                      data=DataConfig(synthetic_rows=9,
                                      synthetic_shape=(4, 2, 4, 4)))
    trainer = Trainer(cfg, device="cpu", prompt_encoder=tpe)
    order = ShardedSampler(9, 3, seed=0).epoch(0)
    jds = JDataset(num_rows=9, latent_shape=(4, 2, 4, 4), seed=0)
    for idx, batch in zip(order, trainer.batches("train")):
        captions = [jds[int(i)]["caption"] for i in idx]
        want = jpe(captions, return_index=-2)
        assert set(batch) == {"latent", "context"}
        np.testing.assert_allclose(batch["context"].numpy(),
                                   np.asarray(want), **TOL)


def test_train_cli_use_t5_runs_with_a_smoke_encoder(tmp_path):
    from video_diffusion_speedrun_tpu_torch.train.__main__ import main as cli

    flags = ["--device", "cpu", "--max_steps", "2", "--batch_size", "2",
             "--model_width", "64", "--model_depth", "1", "--model_head_dim",
             "32", "--context_dim", "32", "--synthetic_rows", "4",
             "--log_every", "1", "--checkpoint_dir", str(tmp_path),
             "--use_t5", "true", "--return_index", "-2"]
    out = cli(flags + ["--smoke_encoder"])
    assert np.isfinite(out["train/total_loss"])
    with pytest.raises(ValueError, match="--use_t5"):
        cli(flags[:-4] + ["--smoke_encoder", "xxl"])
    # without local weights --use_t5 raises, as the JAX CLI does
    with pytest.raises(RuntimeError, match="T5 weights unavailable"):
        cli(flags)
