"""The port's long path as a whole against the JAX package, on the CPU.

- DiT: depth 2, width 128 (2 heads of 64) at L = 2064 = 16 registers +
  8·16·16 tokens, above SHORT_MAX_KV: the port's "fused" ops (self-attention
  through the long path's twins) against JAX `dit_forward` and
  `value_and_grad(rectified_flow_loss)` with attention_impl="pallas"
  (Pallas in interpret mode, self-attention through the split-prefix path).
  Weights go across through `state_dict_from_jax_params`; timesteps, noise
  and rope offsets are injected. fp32: the forward at atol 2e-4 / rtol 1e-3
  as tests/test_torch_dit.py, the loss at rtol 1e-5, each gradient leaf
  within 1e-4 of its largest magnitude (sums over 2·2064 tokens in another
  order).
- Variable-length synthetic data: `t_choices` rows equal JAX's bit for bit;
  both shape-bucketing collates emit JAX's batches (shapes and rows) in
  JAX's order; the Trainer's batch stream follows the coordinated schedule.
- The train CLI with `--synthetic_t_choices 5,9,17` trains on all three
  shapes (L = 528, 1040, 2064) on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DiTConfig as JCfg
from video_diffusion_speedrun_tpu.data.loader import (
    CoordinatedShapeBucketingCollate as JCoordinated,
)
from video_diffusion_speedrun_tpu.data.loader import (
    ShapeBucketingCollate as JBucketing,
)
from video_diffusion_speedrun_tpu.data.loader import (
    ShardedSampler as JSampler,
)
from video_diffusion_speedrun_tpu.data.synthetic import (
    SyntheticLatentDataset as JDataset,
)
from video_diffusion_speedrun_tpu.models.dit import dit_forward, init_dit
from video_diffusion_speedrun_tpu.train.loss import (
    rectified_flow_loss as j_loss,
)
from video_diffusion_speedrun_tpu_torch.core.config import DataConfig
from video_diffusion_speedrun_tpu_torch.core.config import DiTConfig as TCfg
from video_diffusion_speedrun_tpu_torch.core.config import TrainConfig
from video_diffusion_speedrun_tpu_torch.data.loader import (
    CoordinatedShapeBucketingCollate,
    DataLoader,
    ShapeBucketingCollate,
    ShardedSampler,
)
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
)
from video_diffusion_speedrun_tpu_torch.models.convert import (
    state_dict_from_jax_params,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.ops import fused_attention as tfa
from video_diffusion_speedrun_tpu_torch.train import __main__ as cli
from video_diffusion_speedrun_tpu_torch.train import loop as tloop
from video_diffusion_speedrun_tpu_torch.train.loss import rectified_flow_loss

TINY = dict(in_channels=4, patch_size=2, time_patch_size=2, hidden_size=128,
            depth=2, num_heads=2, mlp_ratio=4.0, cross_attn_input_size=32,
            residual_v=True, train_bias_and_rms=False)
# [B, C, T, H, W]: 16 frames → 8 time patches, 32×32 → 16×16: L = 2064
LATENT = (2, 4, 16, 32, 32)


def _setup():
    jcfg = JCfg(**TINY, attention_impl="pallas", fused_adaln="pallas",
                compute_dtype=jnp.float32, remat=False)
    tcfg = TCfg(**TINY, attention_impl="fused", fused_adaln="fused",
                compute_dtype=torch.float32, remat=False)
    params = init_dit(jax.random.PRNGKey(0), jcfg, init_std_factor=0.5)
    r = np.random.default_rng(1)
    for path in (("blocks", "adaLN_modulation"), ("final_modulation",),
                 ("final_proj",)):
        leaf = params
        for key in path:
            leaf = leaf[key]
        for name in ("weight", "bias"):
            leaf[name] = jnp.asarray(
                r.normal(size=leaf[name].shape).astype(np.float32) * 0.05)
    model = DiT(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg), strict=True)
    b = LATENT[0]
    data = dict(latent=r.normal(size=LATENT).astype(np.float32),
                context=(r.normal(size=(b, 7, 32)) * 0.5).astype(np.float32),
                timesteps=np.asarray([0.3, 0.8], np.float32),
                noise=r.normal(size=LATENT).astype(np.float32),
                rope_offsets=np.asarray([1, 2, 3], np.int32))
    return jcfg, params, model, data


def test_dit_at_2064_matches_jax():
    jcfg, params, model, data = _setup()
    l = (LATENT[2] // 2) * (LATENT[3] // 2) * (LATENT[4] // 2) + 16
    assert l == 2064 and tfa._split_prefix(l, l, tfa.DEFAULT_BLOCK) == 16
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    td = {k: torch.from_numpy(v) for k, v in data.items()}

    want = dit_forward(params, jcfg, jd["latent"], jd["context"],
                       jd["timesteps"], rope_offsets=jd["rope_offsets"])
    with torch.no_grad():
        got = model(td["latent"], td["context"], td["timesteps"],
                    rope_offsets=td["rope_offsets"])
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)

    def loss_fn(p):
        loss, _ = j_loss(p, jcfg, jd["latent"], jd["context"],
                         jax.random.PRNGKey(0), timesteps=jd["timesteps"],
                         noise=jd["noise"], caption_dropout=0.0,
                         rope_offsets=jd["rope_offsets"])
        return loss

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    forward_launches = tfa.long_attention_forward.launches
    loss, _ = rectified_flow_loss(
        model, td["latent"], td["context"], None, caption_dropout=0.0,
        timesteps=td["timesteps"], noise=td["noise"],
        rope_offsets=td["rope_offsets"])
    loss.backward()
    assert tfa.long_attention_forward.launches == forward_launches == 0
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads),
                                      model.cfg)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("t_choices", [(5, 9, 17), (5, 5, 9), ()])
def test_t_choices_rows_match_jax(t_choices):
    ours, theirs = (cls(num_rows=12, latent_shape=(16, 5, 8, 8), seed=3,
                        t_choices=t_choices)
                    for cls in (SyntheticLatentDataset, JDataset))
    assert ours.latent_shapes() == theirs.latent_shapes()
    for idx in range(12):
        a, b = ours[idx], theirs[idx]
        assert a["latent"].shape == b["latent"].shape
        np.testing.assert_array_equal(a["latent"], b["latent"])
        assert a["caption"] == b["caption"]


def _stream(collate, ds, sampler, epochs=2):
    """JAX DataLoader order: each sampler batch's rows through the collate,
    None (no full bucket) emitting nothing."""
    out = []
    for e in range(epochs):
        for idx in sampler.epoch(e):
            batch = collate([ds[int(i)] for i in idx])
            if batch is not None:
                out.append(batch)
    return out


@pytest.mark.parametrize("kind", ["coordinated", "opportunistic"])
def test_bucketing_collates_match_jax(kind):
    """The same rows, seed and batch size give JAX's batches: shapes in
    JAX's order and the same rows in each."""
    ds = SyntheticLatentDataset(num_rows=60, latent_shape=(2, 5, 4, 4),
                                t_choices=(5, 9, 17, 5))
    batch = 4

    def make(port):
        if kind == "coordinated":
            cls = CoordinatedShapeBucketingCollate if port else JCoordinated
            return cls(batch, ds.latent_shapes(), seed=101)
        return (ShapeBucketingCollate if port else JBucketing)(batch)

    want = _stream(make(False), ds, JSampler(len(ds), batch, 0, 1, seed=2))
    got = list(DataLoader(ds, ShardedSampler(len(ds), batch, seed=2),
                          make(True), num_epochs=2))
    assert len(got) == len(want) > 10
    assert [b["latent"].shape for b in got] == \
        [b["latent"].shape for b in want]
    assert len({b["latent"].shape for b in got}) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["latent"], b["latent"])


def test_trainer_buckets_as_jax():
    """With bucket_by_shape the Trainer's train batches follow JAX's
    coordinated schedule (seed shuffle_seed + 101) over its sampler; the
    test split keeps one shape."""
    data = DataConfig(synthetic_rows=24, synthetic_shape=(2, 5, 4, 4),
                      synthetic_t_choices=(5, 9), bucket_by_shape=True,
                      test_rows=6, context_dim=8)
    model = TCfg(in_channels=2, hidden_size=16, depth=1, num_heads=1,
                 cross_attn_input_size=8)
    trainer = tloop.Trainer(TrainConfig(model=model, data=data, batch_size=3,
                                        num_epochs=2), device="cpu")
    got = [b["latent"].shape[2] for b in trainer.batches("train")]
    jds = JDataset(num_rows=24, latent_shape=(2, 5, 4, 4), t_choices=(5, 9))
    want = _stream(JCoordinated(3, jds.latent_shapes(), seed=101), jds,
                   JSampler(24, 3, 0, 1, seed=0))
    assert got == [b["latent"].shape[2] for b in want] and set(got) == {5, 9}
    assert {b["latent"].shape[2] for b in trainer.batches("test")} == {5}


def test_entry_point_trains_on_three_lengths(monkeypatch, tmp_path):
    """`--synthetic_t_choices 5,9,17` on the CPU: steps on latents of 5, 9
    and 17 frames (L = 528, 1040 and 2064), finite losses."""
    seen = []
    step = tloop.train_step

    def spy(model, opt, batch, gen, cfg, *parallel):
        seen.append(tuple(batch["latent"].shape))
        return step(model, opt, batch, gen, cfg, *parallel)

    monkeypatch.setattr(tloop, "train_step", spy)
    out = cli.main(["--device", "cpu", "--max_steps", "6", "--batch_size",
                    "2", "--model_width", "64", "--model_depth", "1",
                    "--model_head_dim", "32", "--context_dim", "32",
                    "--synthetic_rows", "24", "--log_every", "1",
                    "--evaluate_every", "100", "--synthetic_t_choices",
                    "5,9,17", "--checkpoint_dir", str(tmp_path)])
    assert {s[2] for s in seen} == {5, 9, 17}, seen
    assert all(s[0] == 2 for s in seen) and len(seen) == 6
    assert np.isfinite(out["train/total_loss"])
