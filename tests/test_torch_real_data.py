"""The port's real-data stream against the JAX package, on the CPU.

- `DataLoader` over the Cosmos-OpenVid fixture with precomputed
  embeddings yields JAX's `DataLoader`'s batches in JAX's order, latents,
  contexts (the port's fp16, widened) and captions bit for bit, with the
  default collate (one
  shape), the one-process bucketing collate (mixed lengths, bf16 tensors
  carried across calls) and the coordinated one (synthetic rows of mixed
  lengths, fp32 numpy).
- `skip_batches` yields the continuous stream's tail; with the default
  collate the skipped rows are never read.
- A producer's error reaches the consumer; leaving a stream early leaves
  no loader or staging thread alive.
- The Trainer's train and test streams (precomputed context, widened to
  fp32 on the device, or the random smoke context) equal JAX's
  `Trainer._loader` bit for bit; with neither, both raise RuntimeError.
- A run resumed from a checkpoint on the real data equals the continuous
  run bit for bit (losses, parameters, moments, generator).
"""

import dataclasses
import threading
import time
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.core.config import DataConfig as JData
from video_diffusion_speedrun_tpu.core.config import MeshConfig as JMesh
from video_diffusion_speedrun_tpu.core.config import TrainConfig as JTrain
from video_diffusion_speedrun_tpu.data import embeddings as jemb
from video_diffusion_speedrun_tpu.data import loader as jloader
from video_diffusion_speedrun_tpu.data.dataset import (
    LatentDataset as JLatentDataset,
)
from video_diffusion_speedrun_tpu.data.synthetic import (
    SyntheticLatentDataset as JSynthetic,
)
from video_diffusion_speedrun_tpu.parallel.mesh import build_mesh
from video_diffusion_speedrun_tpu.train.loop import Trainer as JTrainer
from video_diffusion_speedrun_tpu_torch.core.config import (
    DataConfig,
    DiTConfig,
    OptimizerConfig,
    TrainConfig,
)
from video_diffusion_speedrun_tpu_torch.data import embeddings as temb
from video_diffusion_speedrun_tpu_torch.data import loader as tloader
from video_diffusion_speedrun_tpu_torch.data.dataset import LatentDataset
from video_diffusion_speedrun_tpu_torch.data.fixture import write_fixture
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
)
from video_diffusion_speedrun_tpu_torch.train import loop as tloop

TOKENS, DIM = 6, 32


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """Two parquet fixtures (one latent shape; mixed 2 and 3 frames) of
    128 rows (24 train, 40 test), with fp16 shards for both splits."""
    root = tmp_path_factory.mktemp("real")
    out = {"root": root, "cache": str(root / "cache")}
    for name, frames in (("one", (2,)), ("mixed", (2, 3))):
        out[name] = str(root / f"{name}.parquet")
        write_fixture(out[name], rows=128, frames=frames, height=8, width=8)
    rng = np.random.default_rng(5)
    for split, rows in (("train", 24), ("test", 40)):
        d = root / "emb" / split
        d.mkdir(parents=True)
        shards = {}
        for lo in range(0, rows, 16):
            n = min(16, rows - lo)
            np.save(d / f"shard_{lo:09d}.npy", rng.standard_normal(
                (n, TOKENS, DIM)).astype(np.float16))
            shards[lo] = n
        temb.write_manifest(str(d), split, -8, shards)
    out["emb"] = str(root / "emb")
    return out


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_same_batches(got, want, widen=False):
    """Batch for batch equal bits; `widen`: the port's fp16 context as
    fp32 (exact)."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            if key == "caption":
                assert a[key] == b[key]
                continue
            val = a[key]
            if widen and key == "context":
                assert val.dtype == torch.float16
                val = val.float()
            np.testing.assert_array_equal(_bits(val), _bits(b[key]))


def _datasets(real, kind):
    if kind == "coordinated":
        shape = dict(num_rows=24, latent_shape=(16, 2, 8, 8),
                     t_choices=(2, 3, 2))
        bases = (SyntheticLatentDataset(**shape), JSynthetic(**shape))
    else:
        fx = real["one" if kind == "default" else "mixed"]
        bases = (LatentDataset("train", real["cache"], fx),
                 JLatentDataset("train", real["cache"], fx))
    emb = real["emb"] + "/train"
    return (temb.PrecomputedEmbeddingJoin(bases[0], emb, "train"),
            jemb.PrecomputedEmbeddingJoin(bases[1], emb, "train"))


def _collates(kind, ds, batch):
    if kind == "default":
        return tloader.default_collate, jloader.default_collate
    if kind == "bucketing":
        return (tloader.ShapeBucketingCollate(batch),
                jloader.ShapeBucketingCollate(batch))
    return (tloader.CoordinatedShapeBucketingCollate(
        batch, ds.latent_shapes(), seed=101),
        jloader.CoordinatedShapeBucketingCollate(
            batch, ds.latent_shapes(), seed=101))


@pytest.mark.parametrize("kind", ["default", "bucketing", "coordinated"])
def test_loader_yields_jax_batches(real, kind):
    ours, theirs = _datasets(real, kind)
    batch = 4
    mine, jaxs = _collates(kind, ours, batch)
    got = list(tloader.DataLoader(
        ours, tloader.ShardedSampler(len(ours), batch, seed=3), mine,
        num_workers=3, num_epochs=3))
    want = list(jloader.DataLoader(
        theirs, jloader.ShardedSampler(len(theirs), batch, 0, 1, seed=3),
        jaxs, num_workers=3, num_epochs=3))
    _assert_same_batches(got, want, widen=True)
    shapes = {tuple(b["latent"].shape) for b in got}
    assert len(shapes) == (1 if kind == "default" else 2)
    if kind != "coordinated":
        assert got[0]["latent"].dtype == torch.bfloat16
    assert got[0]["context"].shape == (batch, TOKENS, DIM)


class _Counting:
    def __init__(self, base):
        self.base, self.reads = base, 0

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        self.reads += 1
        return self.base[idx]


@pytest.mark.parametrize("kind", ["default", "bucketing"])
def test_skip_batches_resumes_the_stream(real, kind):
    ours, _ = _datasets(real, kind)
    sampler = tloader.ShardedSampler(len(ours), 4, seed=1)

    def stream(skip, ds):
        return list(tloader.DataLoader(ds, sampler, _collates(kind, ds, 4)[0],
                                       num_workers=2, num_epochs=3,
                                       skip_batches=skip))

    whole = stream(0, ours)
    counting = _Counting(ours)
    tail = stream(5, counting)
    _assert_same_batches(tail, whole[5:])
    if kind == "default":  # the 5 skipped batches were never read
        assert counting.reads == 4 * len(tail)


def _live(prefix="vds-"):
    return [t for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def _wait_gone(timeout=6.0):
    deadline = time.monotonic() + timeout
    while _live() and time.monotonic() < deadline:
        time.sleep(0.05)
    return _live()


def test_producer_error_reaches_the_consumer_and_threads_end(real):
    ours, _ = _datasets(real, "default")

    class Poison:
        def __len__(self):
            return len(ours)

        def __getitem__(self, idx):
            if idx == 7:
                raise OSError("unreadable row 7")
            return ours[idx]

    sampler = tloader.ShardedSampler(len(ours), 8, shuffle=False)
    stream = tloader.device_batches(
        iter(tloader.DataLoader(Poison(), sampler, num_epochs=1)), "cpu")
    with pytest.raises(OSError, match="unreadable row 7"):
        list(stream)
    assert not _wait_gone()


def test_leaving_a_stream_early_ends_its_threads(real):
    ours, _ = _datasets(real, "default")
    sampler = tloader.ShardedSampler(len(ours), 8, seed=0)
    loader = tloader.DataLoader(ours, sampler, num_workers=4, prefetch=2)
    stream = tloader.device_batches(
        tloader.replica_rows(iter(loader), 0, 8), "cpu", depth=2)
    first = next(stream)
    time.sleep(0.2)  # both threads are blocked on full queues
    assert {t.name for t in _live()} >= {"vds-loader", "vds-stage"}
    stream.close()
    assert not _live()  # close() waited for them
    assert first["latent"].shape == (8, 16, 2, 8, 8)


MODEL = DiTConfig(in_channels=16, hidden_size=64, depth=2, num_heads=2,
                  cross_attn_input_size=DIM, residual_v=True,
                  train_bias_and_rms=True, compute_dtype=torch.float32,
                  attention_impl="plain", fused_adaln="off")


def _cfg(real, tmp_path, source, **kw):
    data = dict(dataset="cosmos_openvid", hf_name=real["one"],
                cache_dir=real["cache"], caption_tokens=TOKENS,
                context_dim=DIM, num_workers=2)
    if source == "precomputed":
        data["embeddings_dir"] = real["emb"]
    elif source == "random":
        data["allow_random_context"] = True
    return TrainConfig(model=MODEL, data=DataConfig(**data), batch_size=8,
                       max_steps=4, evaluate_every=3, eval_batches=1,
                       log_every=1, num_epochs=4,
                       optimizer=OptimizerConfig(learning_rate=0.01,
                                                 warmup_steps=2),
                       checkpoint_dir=str(tmp_path / "ckpt"), **kw)


def _jax_stream(cfg, split, step=0):
    """JAX's `Trainer._loader` on the same data, without building the
    model: the attributes that `_loader` and `_encode_stream` read."""
    d = cfg.data
    jcfg = JTrain(mesh=JMesh(replica=1, fsdp=-1), data=JData(
        dataset=d.dataset, hf_name=d.hf_name, cache_dir=d.cache_dir,
        caption_tokens=d.caption_tokens, context_dim=d.context_dim,
        num_workers=d.num_workers, embeddings_dir=d.embeddings_dir,
        allow_random_context=d.allow_random_context),
        batch_size=cfg.batch_size, num_epochs=cfg.num_epochs, seed=cfg.seed)
    trainer = object.__new__(JTrainer)
    trainer.cfg, trainer.prompt_encoder = jcfg, None
    trainer.device_context = False
    trainer.mesh = build_mesh(jcfg.mesh)
    trainer.logger = tloop.logger
    trainer.state = type("State", (), {"step": step})()
    return trainer._loader(split)


@pytest.mark.parametrize("source", ["precomputed", "random"])
def test_trainer_streams_match_jax(real, tmp_path, source):
    """Train (3 batches, from step 0 and resumed at step 2) and test
    streams: the device batches the Trainer yields are JAX's."""
    cfg = _cfg(real, tmp_path, source)
    trainer = tloop.Trainer(cfg, device="cpu")
    for split, step, n in (("train", 0, 3), ("train", 2, 3), ("test", 0, 1)):
        trainer.step = step
        stream = trainer.batches(split)
        got = [next(stream) for _ in range(n)]
        stream.close()
        jax_stream = _jax_stream(cfg, split, step)
        want = [{k: np.asarray(v) for k, v in next(jax_stream).items()
                 if k != "caption"} for _ in range(n)]
        jax_stream.close()
        _assert_same_batches(got, want)
        assert got[0]["latent"].shape[0] == 8
    assert not _wait_gone()


def test_no_context_source_raises_as_jax(real, tmp_path):
    cfg = _cfg(real, tmp_path, "none")
    with pytest.raises(RuntimeError, match="no context source"):
        next(tloop.Trainer(cfg, device="cpu").batches("train"))
    with pytest.raises(RuntimeError, match="no context source"):
        next(_jax_stream(cfg, "train"))


def _perturb(model):
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        lins = [blk.adaLN_modulation[1] for blk in model.blocks]
        for lin in lins + [model.final_modulation[1], model.final_proj]:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             * 0.05)


@pytest.mark.parametrize("source", ["precomputed", "random"])
def test_resume_on_real_data_equals_the_continuous_run(real, tmp_path,
                                                       source):
    def trainer(name, **kw):
        t = tloop.Trainer(dataclasses.replace(
            _cfg(real, tmp_path / name, source), **kw), device="cpu")
        if "load_checkpoint" not in kw:
            _perturb(t.model)
        return t

    whole = trainer("whole")
    whole.train()
    first = trainer("first")
    first.train(until=2)
    path = first.save_checkpoint()
    resumed = trainer("again", load_checkpoint=str(Path(path).parent))
    assert resumed.step == 2
    resumed.train()

    def losses(t):
        return [r["train/total_loss"] for r in t.history]

    assert losses(whole) == losses(first) + losses(resumed)
    assert len(losses(whole)) == 4
    for a, b in zip([*whole.model.parameters(), *whole.opt.m, *whole.opt.v],
                    [*resumed.model.parameters(), *resumed.opt.m,
                     *resumed.opt.v]):
        assert torch.equal(a, b)
    assert torch.equal(whole.generator.get_state(),
                       resumed.generator.get_state())
