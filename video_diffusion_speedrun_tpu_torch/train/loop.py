"""Training loop (port of `train/loop.py`).

Each step is `train/step.py:train_step` (on one card with no mesh and
no accumulation its forward and backward replay as CUDA graphs from a
batch shape's second step on), or with `optimizer.in_backward`
the optimizer-in-backward step of `train/inloop.py` (JAX's
`_build_inloop_branch`): same batches, draws and metrics; its factored
second moment goes into the checkpoint under "vr"/"vc", whole.

Keeps the JAX loop's semantics: an epoch × step loop bounded by
`max_steps`; metrics every `log_every` steps, read back one log interval
late so the host never stalls the card to print (`loop.py:410-418`), with
the mean step time of each interval (`StepTimer`); evaluation with a
fixed-seed generator on `eval_batches` batches of the test split, then a
checkpoint of the full train state (`train/checkpoint.py`,
`checkpoint_dir/run_name/<step>/`), when `step % evaluate_every == 1`;
timestep-decile loss bins. Records go to `history` and, on rank 0, to
`checkpoint_dir/run_name/metrics.jsonl` (and wandb) under the JAX keys.

Data (`loop.py:98-241`): the synthetic rows (train seeded 0, with
`synthetic_t_choices` of mixed lengths; test seeded 1) or the
Cosmos-OpenVid latents (`data/dataset.py`, `hf_name` a hub name or a local
parquet), read by the threaded `DataLoader` and staged to the device on a
thread of their own. A batch's context comes from, in this order: the
precomputed embeddings of `embeddings_dir/<split>` (or a flat
`embeddings_dir`) joined onto its rows; the `prompt_encoder` (the CLI's
`--use_t5`) on its captions, encoded every step as the reference does;
for synthetic rows, a draw on the device inside the step; with
`allow_random_context`, 0.05·N(0, 1) from numpy seeded by (seed + 17,
batch index); else a `RuntimeError`. Precomputed context crosses to the
device in fp16 and is widened to JAX's fp32 there. With
`bucket_by_shape` mixed lengths go through the coordinated
shape-bucketing collate where the dataset declares its shapes, else the
one-process `ShapeBucketingCollate` (`loop.py:163-178`).

`load_checkpoint` resumes a port checkpoint: parameters, moments, the
update count, the step and the training generator's state come back, and
the train stream skips exactly the restored step's batches (through the
collate, so a bucketing collate's state is the continuous run's; the
random context follows its batch index), so the resumed run computes what
the continuous run computes. A reference checkpoint loads weights only
(`loop.py:243-265`).

Across processes (started by `torchrun`: NCCL on `cuda:{LOCAL_RANK}`,
gloo with `--device cpu`) the Trainer builds the mesh of `cfg.mesh`
(`parallel/mesh.py`) and places the DiT on it (`parallel/fsdp.py`:
FSDP2 over fsdp, HSDP with replicas, DTensors over tensor) before the
optimizer sees its parameters. The data shards are the (replica, fsdp)
ranks: with the default collate each reads only its own rows of every
global batch (`ShardedSampler(shard, num_shards)`); the bucketing collates
cannot split a batch, so there every process draws the global batch and
keeps its shard's rows (`replica_rows`). The tensor and context ranks of
one data shard keep the same rows; a context ring splits their tokens
(`DistRing`). Generators are seeded per data shard, so the ranks of a
ring and of a tensor group draw the same timesteps, noise and context,
and data shards draw their own. Rank 0 logs. A `LocalRing` (all ranks of
a ring in one process) is taken only when the caller passes it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from video_diffusion_speedrun_tpu_torch.core.config import (
    TrainConfig,
    resolve_device,
)
from video_diffusion_speedrun_tpu_torch.data.loader import (
    CoordinatedShapeBucketingCollate,
    DataLoader,
    ShapeBucketingCollate,
    ShardedSampler,
    default_collate,
    device_batches,
    replica_rows,
)
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
    synthetic_context,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    all_reduce_,
)
from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
    checkpoint_state,
    gathered_factor,
    load_full_state,
    local_factor,
    restore_state,
    shard_model,
    strided_templates,
)
from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing
from video_diffusion_speedrun_tpu_torch.train.checkpoint import (
    STEP_KEY,
    CheckpointManager,
    is_torch_reference_checkpoint,
    load_reference_checkpoint,
    split_checkpoint_path,
)
from video_diffusion_speedrun_tpu_torch.train.optim import FNu, MupAdamW
from video_diffusion_speedrun_tpu_torch.train.inloop import inloop_step
from video_diffusion_speedrun_tpu_torch.train.step import (
    eval_step,
    step_for,
    train_step,
)
from video_diffusion_speedrun_tpu_torch.utils.logging import (
    MetricsLogger,
    StepTimer,
)

logger = logging.getLogger("video_diffusion_speedrun_tpu_torch.train")

# the seed of data shard r's generators is shard 0's seed + r·this
REPLICA_SEED_STRIDE = 1_000_003


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda",
                 context_parallel=None, prompt_encoder=None):
        # refuse what JAX's optimizer-in-backward branch refuses, before
        # anything is built
        step_for(cfg)
        self.cfg = cfg
        self.prompt_encoder = prompt_encoder
        self.device = pmesh.init_distributed(resolve_device(device))
        self.mesh = pmesh.build_mesh(cfg.mesh, self.device.type)
        group = pmesh.context_group(self.mesh)
        if group is not None and context_parallel is not None:
            raise ValueError("the mesh has a context axis; pass no ring")
        self.context_parallel = (context_parallel if group is None
                                 else DistRing(group))
        self.data_group = pmesh.data_group(self.mesh)
        self.data_rank = pmesh.data_rank(self.mesh)
        self.main = pmesh.global_rank() == 0
        self.model = DiT(cfg.model, device=self.device,
                         init_std_factor=cfg.init_std_factor, seed=cfg.seed)
        self.sharding = shard_model(self.model, self.mesh)
        if prompt_encoder is not None and self.mesh is not None:
            prompt_encoder.shard(self.mesh)
        self.opt = MupAdamW(self.model.named_parameters(),
                            cfg.optimizer.learning_rate, cfg.max_steps,
                            cfg.optimizer, sharding=self.sharding)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self._log("param_count: %.2fM", self.n_params / 1e6)
        # synthetic rows with no other context source get theirs drawn on
        # the device inside the step
        self.device_context = (cfg.data.dataset == "synthetic"
                               and prompt_encoder is None
                               and cfg.data.embeddings_dir is None)
        # split → dataset, built on first use
        self.datasets: Dict[str, object] = {}
        self.step = 0
        # the stream every training draw comes from, saved with the state
        self.generator = self._generator(cfg.seed + 1)
        # every logged train record, in order
        self.history: List[Dict[str, float]] = []
        run_dir = os.path.join(cfg.checkpoint_dir, cfg.run_name)
        self.ckpt = CheckpointManager(run_dir)
        if cfg.load_checkpoint is not None:
            self._load_checkpoint(cfg.load_checkpoint)
        self.metrics = MetricsLogger(
            project=cfg.project_name, run_name=cfg.run_name,
            config=dataclasses.asdict(cfg), out_dir=run_dir,
            use_wandb=cfg.wandb)

    def _log(self, *args) -> None:
        if self.main:
            logger.info(*args)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            seed + REPLICA_SEED_STRIDE * self.data_rank)

    def dataset(self, split: str):
        """The split's rows (`loop.py:98-130`), built on first use: the
        synthetic rows or the Cosmos-OpenVid latents, with the precomputed
        embeddings of `embeddings_dir/<split>` (else of a flat
        `embeddings_dir`, whose manifest must name the split) joined on."""
        if split in self.datasets:
            return self.datasets[split]
        dcfg = self.cfg.data
        if dcfg.dataset == "synthetic":
            train = split == "train"
            ds = SyntheticLatentDataset(
                num_rows=dcfg.synthetic_rows if train else dcfg.test_rows,
                latent_shape=dcfg.synthetic_shape, seed=0 if train else 1,
                t_choices=dcfg.synthetic_t_choices if train else ())
        else:
            from video_diffusion_speedrun_tpu_torch.data.dataset import (
                LatentDataset,
            )

            ds = LatentDataset(split=split, cache_dir=dcfg.cache_dir,
                               hf_name=dcfg.hf_name)
        if dcfg.embeddings_dir is not None:
            from video_diffusion_speedrun_tpu_torch.data.embeddings import (
                PrecomputedEmbeddingJoin,
            )

            split_dir = os.path.join(dcfg.embeddings_dir, split)
            emb_dir = (split_dir if os.path.isdir(split_dir)
                       else dcfg.embeddings_dir)
            ds = PrecomputedEmbeddingJoin(ds, emb_dir, expected_split=split)
        self.datasets[split] = ds
        return ds

    def _random_context(self, batches: Iterator[Dict], start: int,
                        rows: Optional[tuple] = None) -> Iterator[Dict]:
        """Batches without a context source get JAX's smoke context
        (`loop.py:_encode_stream`): 0.05·N(0, 1) from numpy seeded by
        (seed + 17, batch index), so a resumed run draws the continuous
        run's; without `allow_random_context` that raises. `rows` (first
        row, global batch): the batches hold these rows of the global
        batch, whose draw is sliced."""
        warned = False
        dcfg = self.cfg.data
        for index, batch in enumerate(batches, start=start):
            if ("context" not in batch and self.prompt_encoder is None
                    and not self.device_context):
                if not dcfg.allow_random_context:
                    raise RuntimeError(
                        "no context source: rows carry no embeddings and "
                        "no prompt encoder is configured. Pass use_t5 / "
                        "precomputed embeddings, or set "
                        "data.allow_random_context=True for a smoke run.")
                if not warned:
                    logger.warning("allow_random_context: training against "
                                   "random context embeddings (smoke only)")
                    warned = True
                rng = np.random.default_rng((self.cfg.seed + 17, index))
                n = batch["latent"].shape[0]
                lo, total = rows or (0, n)
                batch["context"] = synthetic_context(
                    rng, total, dcfg.caption_tokens,
                    dcfg.context_dim)[lo:lo + n]
            yield batch

    def batches(self, split: str) -> Iterator[Dict[str, torch.Tensor]]:
        """This replica's rows of the split's global batches as device
        tensors, epoch after epoch; the train split from the batch after
        the restored step on. Rows without a context get the prompt
        encoder's encoding of their captions, the smoke context, or none
        (drawn on the device in the step); captions are dropped."""
        dcfg = self.cfg.data
        ds = self.dataset(split)
        batch = self.cfg.batch_size
        if split != "train" and batch > len(ds):
            # the test split is 40 rows; clamp the global batch to the
            # largest multiple of the data shards (replica × fsdp) that it
            # fills, as JAX's `_loader` (`train/loop.py:132-157`)
            shards = pmesh.data_shards(self.mesh)
            batch = (len(ds) // shards) * shards
            if batch == 0:
                raise ValueError(
                    f"test split ({len(ds)} rows) cannot fill one batch "
                    f"slice per data shard ({shards} shards)")
            self._log("eval batch clamped %d -> %d (test split has %d rows)",
                      self.cfg.batch_size, batch, len(ds))
        local = pmesh.local_batch_slice(self.mesh, batch)
        shuffle = split == "train"
        if dcfg.bucket_by_shape:
            # a bucketing collate sees whole global batches; each data
            # shard keeps its rows of what it emits
            sampler = ShardedSampler(len(ds), batch, dcfg.shuffle_seed,
                                     shuffle=shuffle)
            shapes = getattr(ds, "latent_shapes", lambda: None)()
            collate = (ShapeBucketingCollate(batch) if shapes is None else
                       CoordinatedShapeBucketingCollate(
                           batch, shapes, seed=dcfg.shuffle_seed + 101))
        else:
            # each data shard reads only its rows of every global batch
            sampler = ShardedSampler(
                len(ds), local, dcfg.shuffle_seed, shuffle=shuffle,
                shard=self.data_rank, num_shards=pmesh.data_shards(self.mesh))
            collate = default_collate
        skip = self.step if split == "train" else 0
        loader = DataLoader(
            ds, sampler, collate, num_workers=dcfg.num_workers,
            prefetch=dcfg.prefetch,
            num_epochs=self.cfg.num_epochs if split == "train" else 1,
            skip_batches=skip)
        if dcfg.bucket_by_shape:
            rows = replica_rows(self._random_context(iter(loader), skip),
                                self.data_rank, local)
        else:
            rows = self._random_context(iter(loader), skip,
                                        (self.data_rank * local, batch))
        stream = device_batches(rows, self.device, dcfg.prefetch)
        try:
            for batch in stream:
                ctx = batch.get("context")
                if ctx is not None and ctx.dtype == torch.float16:
                    # precomputed rows cross to the device in the shards'
                    # fp16; widened here, they are JAX's fp32 batch
                    batch["context"] = ctx.float()
                if "context" not in batch and self.prompt_encoder is not None:
                    batch["context"] = self.prompt_encoder(
                        batch["caption"],
                        return_index=self.cfg.t5_return_index)
                yield {k: v for k, v in batch.items()
                       if isinstance(v, torch.Tensor)}
        finally:
            # an abandoned stream (eval_batches, max_steps) joins its
            # threads now, not at garbage collection
            stream.close()

    def evaluate(self) -> Dict[str, float]:
        """Mean test loss and per-decile losses, with a fixed-seed
        generator (the reference's seeded eval)."""
        gen = self._generator(self.cfg.seed + 1000)
        losses, sums, counts = [], 0.0, 0.0
        stream = self.batches("test")
        try:
            for idx, batch in enumerate(stream):
                m = eval_step(self.model, batch, gen, self.cfg,
                              self.context_parallel)
                losses.append(m["loss"])
                sums = sums + m["bin_sums"]
                counts = counts + m["bin_counts"]
                if idx + 1 >= self.cfg.eval_batches:
                    break
        finally:
            stream.close()
        loss = torch.stack(losses).mean()
        all_reduce_([loss], self.data_group, mean=True)
        all_reduce_([sums, counts], self.data_group)
        bins = (sums / counts.clamp(min=1)).tolist()
        out = {"test/total_loss": float(loss),
               "test/diffusion_loss": float(loss)}
        out.update({f"test_binning/{k}": bins[k] for k in range(10)})
        return out

    def _record(self, m: Dict, step: int,
                avg_ms: Optional[float]) -> Dict[str, float]:
        """The train record of `step` under the JAX keys
        (`loop.py:344-369`), logged and kept in `history`."""
        loss = float(m["loss"])
        rec = {"train/diffusion_loss": loss, "train/total_loss": loss,
               "train/learning_rate_scale": float(m["lr_scale"]),
               "train/step": step}
        if "grad_norm" in m:
            rec["train/grad_norm"] = float(m["grad_norm"])
        bins = (m["bin_sums"] / m["bin_counts"].clamp(min=1)).tolist()
        rec.update({f"train_binning/{k}": bins[k] for k in range(10)})
        if avg_ms is not None:
            rec["train/avg_step_ms"] = avg_ms
        self.metrics.log(rec, step)
        self._log("step %d/%d loss %.4f%s", step, self.cfg.max_steps, loss,
                  f" avg_step {avg_ms:.1f}ms" if avg_ms else "")
        self.history.append(rec)
        return rec

    def _capture_fixtures(self, batch: Dict, m: Dict, step: int) -> None:
        """The reference's CAPTURE_INPUT (`loop.py:328-342`): the step's
        latent, context and drawn timesteps as fp32 `.npy` in
        `test_data/`."""
        os.makedirs("test_data", exist_ok=True)
        np.save(f"test_data/vae_latent_{step}.npy",
                batch["latent"].float().cpu().numpy())
        if "context" in batch:
            np.save(f"test_data/caption_encoded_{step}.npy",
                    batch["context"].float().cpu().numpy())
        np.save(f"test_data/timesteps_{step}.npy",
                m["timesteps"].float().cpu().numpy())

    # ----------------------------------------------------------- checkpoints

    def train_state(self) -> Dict:
        """What a checkpoint holds, as DCP's nested dict of tensors: the
        model's state dict, the moments and update count, the step, and
        this data shard's training generator state. Its tensors are the
        live ones (sharded: DTensors; or, for the counts and the generator,
        their values), so a load into it restores in place. A factored ν
        (`FNu`) goes under "vr" and "vc" in place of "v"."""
        opt = self.opt
        optim = {"count": torch.tensor([opt.count]),
                 "m": dict(zip(opt.names, opt.m)),
                 "v": {n: v for n, v in zip(opt.names, opt.v)
                       if not isinstance(v, FNu)}}
        if any(opt.factored):
            for k in ("vr", "vc"):
                optim[k] = {n: getattr(v, k) for n, v in zip(opt.names, opt.v)
                            if isinstance(v, FNu)}
        return {
            "model": self.model.state_dict(),
            "optim": optim,
            STEP_KEY: torch.tensor([self.step]),
            f"rng.{self.data_rank}": self.generator.get_state(),
        }

    # the weight dim each factor of a factored ν is indexed by
    _FACTOR_DIM = {"vr": 1, "vc": 0}

    def _checkpoint_view(self, state: Dict, saving: bool) -> Dict:
        """`state` with its model and moment dicts as DCP saves them
        (`checkpoint_state`) or loads them (`strided_templates`); the
        factors of a factored ν go whole (gathered to save, empty whole
        templates to load, copied back by `_restore_factors`)."""
        fill = checkpoint_state if saving else strided_templates
        view = dict(state)
        view["model"] = fill(state["model"], self.sharding)
        view["optim"] = dict(state["optim"])
        for k in ("m", "v"):
            view["optim"][k] = fill(state["optim"][k], self.sharding)
        for k, dim in self._FACTOR_DIM.items():
            if k not in state["optim"]:
                continue
            view["optim"][k] = {
                n: (gathered_factor(self.sharding, n, t, dim) if saving
                    else torch.empty(self.opt.params[self.opt.names.index(
                        n)].shape[dim], dtype=t.dtype, device=t.device))
                for n, t in state["optim"][k].items()}
        return view

    def _restore_factors(self, live: Dict, loaded: Dict) -> None:
        with torch.no_grad():
            for k, dim in self._FACTOR_DIM.items():
                for n, t in live["optim"].get(k, {}).items():
                    t.copy_(local_factor(self.sharding, n,
                                         loaded["optim"][k][n], dim))

    def save_checkpoint(self) -> str:
        """Save the full train state at the current step (every rank takes
        part); returns the step directory."""
        t0 = time.perf_counter()
        path = self.ckpt.save(
            self.step, self._checkpoint_view(self.train_state(), True))
        self._log("saved checkpoint %s (%.2f s)", path,
                  time.perf_counter() - t0)
        return path

    def _load_checkpoint(self, path: str) -> None:
        if is_torch_reference_checkpoint(path):
            # the reference checkpoint holds weights only
            if self.cfg.model.rope_order != "reference":
                logger.warning(
                    "loading a torch reference checkpoint into a model with "
                    "rope_order=%r — reference weights assume the (t,h,w) "
                    "RoPE order; set model.rope_order='reference' to match",
                    self.cfg.model.rope_order)
            load_full_state(self.model,
                            load_reference_checkpoint(path, self.cfg.model))
            self._log("loaded torch reference checkpoint from %s", path)
            return
        root, step = split_checkpoint_path(path)
        live = self.train_state()
        rng_key = f"rng.{self.data_rank}"
        state = self._checkpoint_view(live, False)
        mgr = CheckpointManager(root)
        step = mgr.latest_step() if step is None else step
        if not mgr.holds(step, rng_key):
            # saved over fewer data shards: this shard's generator starts
            # from its seed
            logger.warning("checkpoint %s step %s has no %s; that "
                           "generator starts from its seed", root, step,
                           rng_key)
            del state[rng_key]
        t0 = time.perf_counter()
        step = mgr.restore(step, state)
        restore_state(live["model"], state["model"], self.sharding)
        for k in ("m", "v"):
            restore_state(live["optim"][k], state["optim"][k], self.sharding)
        self._restore_factors(live, state)
        self.opt.refresh()
        self.opt.count = int(state["optim"]["count"])
        self.step = int(state[STEP_KEY])
        if rng_key in state:
            self.generator.set_state(state[rng_key])
        self._log("restored full train state from %s step %d (%.2f s)",
                  root, step, time.perf_counter() - t0)

    # ----------------------------------------------------------------- train

    def train(self, until: Optional[int] = None) -> Dict[str, float]:
        """Train to `max_steps` (or stop once the step reaches `until`; the
        schedule still ends at `max_steps`); returns the last logged record
        merged with the last evaluation."""
        cfg = self.cfg
        stop = cfg.max_steps if until is None else min(until, cfg.max_steps)
        timer = StepTimer(every=cfg.log_every)
        last: Dict[str, float] = {}
        pending = None  # (metrics, step) read back one interval late
        t_start = time.perf_counter()
        stream = self.batches("train")
        try:
            for batch in stream:
                if self.step >= stop:
                    break
                step = (inloop_step if cfg.optimizer.in_backward
                        else train_step)
                m = step(self.model, self.opt, batch, self.generator, cfg,
                         self.context_parallel, self.data_group)
                if cfg.capture_fixtures and self.step == 0 and self.main:
                    self._capture_fixtures(batch, m, self.step)
                if self.step % cfg.log_every == 0:
                    avg_ms = timer.tick() if self.step else None
                    if pending is not None:
                        last.update(self._record(*pending, avg_ms))
                    pending = (m, self.step)
                else:
                    timer.tick()
                self.step += 1
                if self.step % cfg.evaluate_every == 1:
                    ev = self.evaluate()
                    self.metrics.log(ev, self.step)
                    self._log("eval @%d: %.4f", self.step,
                              ev["test/total_loss"])
                    self.save_checkpoint()
                    last.update(ev)
        finally:
            stream.close()
        if pending is not None:
            last.update(self._record(*pending, None))
        self.metrics.finish()
        self._log("trained to step %d in %.1f s", self.step,
                  time.perf_counter() - t_start)
        return last
