"""The port's metrics, logging and profiling against the JAX package, on
the CPU.

- A 3-step run of the train CLI on the Cosmos-OpenVid fixture with
  precomputed embeddings writes `metrics.jsonl` whose train and test
  records carry exactly the keys of the JAX Trainer's records
  (`_log_train_metrics`, `evaluate`, called on stand-ins); a wandb stand-in
  module receives the same records, under `--project_name`.
- `StepTimer` gives JAX's means on the same clock readings;
  `MetricsLogger` without wandb importable warns and still writes.
- `capture_fixtures` writes step 0's latent, context and the timesteps the
  step drew.
- `train_mfu` is the FLOP model over the card's peak.
"""

import json
import logging
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.train.loop import Trainer as JTrainer
from video_diffusion_speedrun_tpu.utils import logging as jlogging
from video_diffusion_speedrun_tpu_torch.core.config import (
    DataConfig,
    DiTConfig,
    OptimizerConfig,
    TrainConfig,
)
from video_diffusion_speedrun_tpu_torch.data import embeddings as temb
from video_diffusion_speedrun_tpu_torch.data.fixture import write_fixture
from video_diffusion_speedrun_tpu_torch.train import loop as tloop
from video_diffusion_speedrun_tpu_torch.train.__main__ import main as cli
from video_diffusion_speedrun_tpu_torch.train.loss import sample_timesteps
from video_diffusion_speedrun_tpu_torch.utils import logging as tlogging
from video_diffusion_speedrun_tpu_torch.utils import profiling
from video_diffusion_speedrun_tpu_torch.utils.flops import (
    dit_train_flops,
    mfu,
)

TOKENS, DIM = 6, 32


@pytest.fixture
def real(tmp_path):
    """A 96-row parquet fixture (8 train, 40 test rows of [16, 2, 8, 8])
    and fp16 shards of random context for both splits."""
    fx = str(tmp_path / "fixture.parquet")
    write_fixture(fx, rows=96, frames=(2,), height=8, width=8)
    rng = np.random.default_rng(2)
    for split, rows in (("train", 8), ("test", 40)):
        d = tmp_path / "emb" / split
        d.mkdir(parents=True)
        np.save(d / "shard_000000000.npy", rng.standard_normal(
            (rows, TOKENS, DIM)).astype(np.float16))
        temb.write_manifest(str(d), split, -8, {0: rows})
    return fx, str(tmp_path / "emb"), str(tmp_path / "cache")


class _Records:
    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append(dict(metrics))


def _jax_keys():
    """The keys of JAX's train records (with and without the mean step
    time) and of its test record."""
    sink = _Records()
    stub = SimpleNamespace(cfg=SimpleNamespace(max_steps=3), metrics=sink,
                           logger=logging.getLogger("jax-stub"))
    m = {"loss": 1.0, "lr_scale": 0.5, "bin_sums": np.ones(10),
         "bin_counts": np.ones(10)}
    train = [set(JTrainer._log_train_metrics(stub, m, step, avg))
             for step, avg in ((1, 12.5), (2, None))]

    def loader(split):
        yield {"latent": np.zeros(1)}

    stub = SimpleNamespace(
        cfg=SimpleNamespace(seed=0, eval_batches=1), _loader=loader,
        state=SimpleNamespace(params=None),
        eval_step=lambda params, batch, rng: m)
    test = set(JTrainer.evaluate(stub, 1))
    return train, test


def test_cli_metrics_have_the_jax_keys(real, tmp_path, monkeypatch):
    fx, emb, cache = real
    calls = []
    wandb = types.ModuleType("wandb")
    wandb.init = lambda **kw: calls.append(("init", kw))
    wandb.log = lambda metrics, step: calls.append(("log", dict(metrics),
                                                    step))
    wandb.finish = lambda: calls.append(("finish",))
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    out = cli(["--device", "cpu", "--dataset", "cosmos_openvid",
               "--hf_name", fx, "--cache_dir", cache, "--embeddings_dir",
               emb, "--max_steps", "3", "--batch_size", "4",
               "--model_width", "64", "--model_depth", "2",
               "--model_head_dim", "32", "--context_dim", str(DIM),
               "--log_every", "1", "--evaluate_every", "2", "--wandb",
               "true", "--project_name", "proj", "--run_name", "r",
               "--checkpoint_dir", str(tmp_path / "ck"), "--scan_blocks",
               "false"])
    assert np.isfinite(out["train/diffusion_loss"])
    lines = (tmp_path / "ck" / "r" / "metrics.jsonl").read_text()
    records = [json.loads(line) for line in lines.splitlines()]
    train_keys, test_keys = _jax_keys()
    train = [r for r in records if "train/step" in r]
    test = [r for r in records if "test/total_loss" in r]
    assert [r["train/step"] for r in train] == [0, 1, 2]
    assert [r["step"] for r in test] == [1, 3]
    for r in train:
        assert set(r) - {"step", "time"} in train_keys
    assert set(train[1]) - {"step", "time"} == train_keys[0]  # with mean
    for r in test:
        assert set(r) - {"step", "time"} == test_keys
        assert r["test/diffusion_loss"] == r["test/total_loss"]
    assert calls[0][0] == "init" and calls[0][1]["project"] == "proj"
    assert calls[0][1]["name"] == "r" and calls[-1] == ("finish",)
    logged = [(c[1], c[2]) for c in calls if c[0] == "log"]
    assert logged == [({k: v for k, v in r.items()
                        if k not in ("step", "time")}, r["step"])
                      for r in records]


def test_step_timer_matches_jax(monkeypatch):
    readings = np.cumsum(np.arange(1, 40) * 0.01).tolist()
    outs = []
    for module in (jlogging, tlogging):
        ticks = iter(readings)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(every=4)
        outs.append([timer.tick() for _ in range(13)])
    assert outs[0] == outs[1]
    assert [x is not None for x in outs[1]].count(True) == 3


def test_metrics_without_wandb_and_the_logger(tmp_path, monkeypatch,
                                              caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    with caplog.at_level(logging.WARNING):
        sink = tlogging.MetricsLogger("p", "r", {}, str(tmp_path / "out"),
                                      use_wandb=True)
    assert "wandb unavailable" in caplog.text and sink.wandb is None
    sink.log({"a": torch.tensor(1.5), "b": "x"}, 3)
    sink.finish()
    sink.log({"a": 2}, 4)  # a later record reopens the file to append
    sink.finish()
    recs = [json.loads(line) for line in
            (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["a"]) for r in recs] == [(3, 1.5), (4, 2)]
    assert tlogging.is_main_process()
    logger = tlogging.make_logger("video_diffusion_speedrun_tpu_torch.x")
    with caplog.at_level(logging.INFO):
        logger.info("reaches the root handlers")
    assert "reaches the root handlers" in caplog.text


def test_capture_fixtures_writes_the_step_inputs(real, tmp_path,
                                                 monkeypatch):
    fx, emb, cache = real
    monkeypatch.chdir(tmp_path)
    model = DiTConfig(in_channels=16, hidden_size=64, depth=1, num_heads=2,
                      cross_attn_input_size=DIM,
                      compute_dtype=torch.float32, attention_impl="plain",
                      fused_adaln="off")
    cfg = TrainConfig(
        model=model, data=DataConfig(
            dataset="cosmos_openvid", hf_name=fx, cache_dir=cache,
            embeddings_dir=emb, caption_tokens=TOKENS, context_dim=DIM),
        batch_size=4, max_steps=1, evaluate_every=100, capture_fixtures=True,
        optimizer=OptimizerConfig(learning_rate=0.01),
        checkpoint_dir=str(tmp_path / "ck"))
    trainer = tloop.Trainer(cfg, device="cpu")
    first = next(trainer.batches("train"))
    trainer.train()
    out = tmp_path / "test_data"
    np.testing.assert_array_equal(np.load(out / "vae_latent_0.npy"),
                                  first["latent"].float().numpy())
    np.testing.assert_array_equal(np.load(out / "caption_encoded_0.npy"),
                                  first["context"].numpy())
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    np.testing.assert_array_equal(
        np.load(out / "timesteps_0.npy"),
        sample_timesteps(gen, 4, cfg.time_shift_alpha).numpy())


def test_train_mfu():
    cfg = DiTConfig(hidden_size=512, depth=24, num_heads=4)
    name = "NVIDIA H100 80GB HBM3"
    assert profiling.train_mfu(cfg, 64, 5, 32, 32, 0.25, name) == \
        mfu(dit_train_flops(cfg, 64, 5, 32, 32), 0.25, name)
