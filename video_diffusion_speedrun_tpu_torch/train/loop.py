"""Training loop (port of `train/loop.py`).

Keeps the JAX loop's semantics: an epoch × step loop bounded by
`max_steps`; metrics every `log_every` steps, read back one log interval
late so the host never stalls the card to print (`loop.py:410-418`);
evaluation with a fixed-seed generator on `eval_batches` batches of the
test split, then a checkpoint of the full train state
(`train/checkpoint.py`, `checkpoint_dir/run_name/<step>/`), when
`step % evaluate_every == 1`; timestep-decile loss bins.
Synthetic data only: train rows seeded 0 (with `synthetic_t_choices`, of
mixed lengths), test rows seeded 1. The context is drawn on the device
inside the step, or, with a `prompt_encoder` (the CLI's `--use_t5`), it
is the T5 encoding of each batch's captions at `t5_return_index`, encoded
every step as the reference does. With `bucket_by_shape` both splits go
through the coordinated shape-bucketing collate, as
`loop.py:100-110,164-180` of the JAX package.

`load_checkpoint` resumes a port checkpoint: parameters, moments, the
update count, the step and the training generator's state come back, and
the train stream skips exactly the restored step's batches (through the
collate, so a bucketing collate's state is the continuous run's), so the
resumed run computes what the continuous run computes. A reference
checkpoint loads weights only (`loop.py:243-265`).

Across processes (started by `torchrun`: NCCL on `cuda:{LOCAL_RANK}`,
gloo with `--device cpu`) the Trainer builds the mesh of `cfg.mesh`
(`parallel/mesh.py`). Every process draws the same global batch and keeps
its replica's `local_batch_slice` of the rows; the ranks of one context
ring keep the same rows and split their tokens (`DistRing`). Generators
are seeded per replica, so the ranks of a ring draw the same timesteps,
noise and context and replicas draw their own. Rank 0 logs. A `LocalRing`
(all ranks of a ring in one process) is taken only when the caller passes
it.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from video_diffusion_speedrun_tpu_torch.core.config import (
    TrainConfig,
    resolve_device,
)
from video_diffusion_speedrun_tpu_torch.data.loader import (
    CoordinatedShapeBucketingCollate,
    ShapeBucketingCollate,
    ShardedSampler,
    default_collate,
    device_batches,
    host_batches,
    replica_rows,
)
from video_diffusion_speedrun_tpu_torch.data.synthetic import (
    SyntheticLatentDataset,
)
from video_diffusion_speedrun_tpu_torch.models.dit import DiT
from video_diffusion_speedrun_tpu_torch.parallel import mesh as pmesh
from video_diffusion_speedrun_tpu_torch.parallel.collectives import (
    all_reduce_,
)
from video_diffusion_speedrun_tpu_torch.parallel.ring import DistRing
from video_diffusion_speedrun_tpu_torch.train.checkpoint import (
    STEP_KEY,
    CheckpointManager,
    is_torch_reference_checkpoint,
    load_reference_checkpoint,
    split_checkpoint_path,
)
from video_diffusion_speedrun_tpu_torch.train.optim import MupAdamW
from video_diffusion_speedrun_tpu_torch.train.step import eval_step, train_step

logger = logging.getLogger("video_diffusion_speedrun_tpu_torch.train")

# the seed of replica r's generators is the replica-0 seed + r·this
REPLICA_SEED_STRIDE = 1_000_003


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda",
                 context_parallel=None, prompt_encoder=None):
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
        self.opt = MupAdamW(self.model.named_parameters(),
                            cfg.optimizer.learning_rate, cfg.max_steps,
                            cfg.optimizer)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self._log("param_count: %.2fM", self.n_params / 1e6)
        dcfg = cfg.data
        self.datasets = {
            split: SyntheticLatentDataset(
                num_rows=rows, latent_shape=dcfg.synthetic_shape, seed=seed,
                t_choices=dcfg.synthetic_t_choices if split == "train" else ())
            for split, rows, seed in (("train", dcfg.synthetic_rows, 0),
                                      ("test", dcfg.test_rows, 1))}
        self.step = 0
        # the stream every training draw comes from, saved with the state
        self.generator = self._generator(cfg.seed + 1)
        # every logged train record, in order
        self.history: List[Dict[str, float]] = []
        self.ckpt = CheckpointManager(
            os.path.join(cfg.checkpoint_dir, cfg.run_name))
        if cfg.load_checkpoint is not None:
            self._load_checkpoint(cfg.load_checkpoint)

    def _log(self, *args) -> None:
        if self.main:
            logger.info(*args)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            seed + REPLICA_SEED_STRIDE * self.data_rank)

    def batches(self, split: str) -> Iterator[Dict[str, torch.Tensor]]:
        """This replica's rows of the split's global batches as device
        tensors, epoch after epoch; the train split from the batch after
        the restored step on. With a prompt encoder the captions become the
        `context`; without one they are dropped (the context is drawn on
        the device)."""
        ds = self.datasets[split]
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
        sampler = ShardedSampler(len(ds), batch, self.cfg.data.shuffle_seed,
                                 shuffle=split == "train")
        epochs = self.cfg.num_epochs if split == "train" else 1
        collate = default_collate
        if self.cfg.data.bucket_by_shape:
            shapes = getattr(ds, "latent_shapes", lambda: None)()
            collate = (ShapeBucketingCollate(batch) if shapes is None else
                       CoordinatedShapeBucketingCollate(
                           batch, shapes,
                           seed=self.cfg.data.shuffle_seed + 101))
        local = pmesh.local_batch_slice(self.mesh, batch)
        skip = self.step if split == "train" else 0
        rows = replica_rows(host_batches(ds, sampler, epochs, collate, skip),
                            self.data_rank, local)
        for batch in device_batches(rows, self.device):
            if self.prompt_encoder is not None:
                batch["context"] = self.prompt_encoder(
                    batch["caption"], return_index=self.cfg.t5_return_index)
            yield {k: v for k, v in batch.items()
                   if isinstance(v, torch.Tensor)}

    def evaluate(self) -> Dict[str, float]:
        """Mean test loss and per-decile losses, with a fixed-seed
        generator (the reference's seeded eval)."""
        gen = self._generator(self.cfg.seed + 1000)
        losses, sums, counts = [], 0.0, 0.0
        for idx, batch in enumerate(self.batches("test")):
            m = eval_step(self.model, batch, gen, self.cfg,
                          self.context_parallel)
            losses.append(m["loss"])
            sums = sums + m["bin_sums"]
            counts = counts + m["bin_counts"]
            if idx + 1 >= self.cfg.eval_batches:
                break
        loss = torch.stack(losses).mean()
        all_reduce_([loss], self.data_group, mean=True)
        all_reduce_([sums, counts], self.data_group)
        bins = (sums / counts.clamp(min=1)).tolist()
        out = {"test/total_loss": float(loss)}
        out.update({f"test_binning/{k}": bins[k] for k in range(10)})
        return out

    def _record(self, m: Dict, step: int,
                avg_ms: Optional[float]) -> Dict[str, float]:
        bins = (m["bin_sums"] / m["bin_counts"].clamp(min=1)).tolist()
        rec = {"train/step": step, "train/total_loss": float(m["loss"]),
               "train/learning_rate_scale": float(m["lr_scale"])}
        if "grad_norm" in m:
            rec["train/grad_norm"] = float(m["grad_norm"])
        rec.update({f"train_binning/{k}": bins[k] for k in range(10)})
        if avg_ms is not None:
            rec["train/avg_step_ms"] = avg_ms
        self._log("step %d/%d loss %.4f%s", step, self.cfg.max_steps,
                  rec["train/total_loss"],
                  f" avg_step {avg_ms:.1f}ms" if avg_ms else "")
        self.history.append(rec)
        return rec

    # ----------------------------------------------------------- checkpoints

    def train_state(self) -> Dict:
        """What a checkpoint holds, as DCP's nested dict of tensors: the
        model's state dict, the moments and update count, the step, and
        this replica's training generator state. Its tensors are the live
        ones (or, for the counts and the generator, their values), so a
        load into it restores in place."""
        opt = self.opt
        return {
            "model": self.model.state_dict(),
            "optim": {"count": torch.tensor([opt.count]),
                      "m": dict(zip(opt.names, opt.m)),
                      "v": dict(zip(opt.names, opt.v))},
            STEP_KEY: torch.tensor([self.step]),
            f"rng.{self.data_rank}": self.generator.get_state(),
        }

    def save_checkpoint(self) -> str:
        """Save the full train state at the current step (every rank takes
        part); returns the step directory."""
        t0 = time.perf_counter()
        path = self.ckpt.save(self.step, self.train_state())
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
            self.model.load_state_dict(
                load_reference_checkpoint(path, self.cfg.model))
            self._log("loaded torch reference checkpoint from %s", path)
            return
        root, step = split_checkpoint_path(path)
        state = self.train_state()
        t0 = time.perf_counter()
        step = CheckpointManager(root).restore(step, state)
        self.opt.count = int(state["optim"]["count"])
        self.step = int(state[STEP_KEY])
        self.generator.set_state(state[f"rng.{self.data_rank}"])
        self._log("restored full train state from %s step %d (%.2f s)",
                  root, step, time.perf_counter() - t0)

    # ----------------------------------------------------------------- train

    def train(self, until: Optional[int] = None) -> Dict[str, float]:
        """Train to `max_steps` (or stop once the step reaches `until`; the
        schedule still ends at `max_steps`); returns the last logged record
        merged with the last evaluation."""
        cfg = self.cfg
        stop = cfg.max_steps if until is None else min(until, cfg.max_steps)
        last: Dict[str, float] = {}
        pending = None  # (metrics, step) read back one interval late
        t_tick, ticks = time.perf_counter(), 0
        for batch in self.batches("train"):
            if self.step >= stop:
                break
            m = train_step(self.model, self.opt, batch, self.generator, cfg,
                           self.context_parallel, self.data_group)
            ticks += 1
            if self.step % cfg.log_every == 0:
                now = time.perf_counter()
                avg_ms = 1e3 * (now - t_tick) / ticks if self.step else None
                t_tick, ticks = now, 0
                if pending is not None:
                    last.update(self._record(*pending, avg_ms))
                pending = (m, self.step)
            self.step += 1
            if self.step % cfg.evaluate_every == 1:
                ev = self.evaluate()
                self._log("eval @%d: %.4f", self.step, ev["test/total_loss"])
                self.save_checkpoint()
                last.update(ev)
        if pending is not None:
            last.update(self._record(*pending, None))
        return last
