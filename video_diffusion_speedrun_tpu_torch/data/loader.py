"""Host-side batches for one process (port of part of `data/loader.py`).

`ShardedSampler.epoch` (its one-process case) and `default_collate` keep
the JAX row order (`loader.py:33-82`): epoch e is
`default_rng(seed + e).permutation`, truncated to whole batches. For
mixed-length clips, `ShapeBucketingCollate` and
`CoordinatedShapeBucketingCollate` (`loader.py:84-176`) turn each sampler
batch into at most one shape-uniform batch, carrying the rest; with the
same seed they emit the JAX package's batch shapes in its order.
`device_batches` copies each collated batch from pinned host memory with
`non_blocking=True` (the JAX `device_prefetch`), so the copy queues behind
the running step. Worker threads come with the real-data loader.
Across data-parallel replicas every process draws the same global batches
and `replica_rows` keeps its replica's rows (`local_batch_slice`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


class ShardedSampler:
    """Deterministic index stream of one process (the JAX sampler with one
    shard)."""

    def __init__(self, num_rows: int, batch: int, seed: int = 0,
                 shuffle: bool = True):
        self.num_rows = num_rows
        self.batch = batch
        self.seed = seed
        self.shuffle = shuffle
        self.rows_per_epoch = (num_rows // batch) * batch
        if self.rows_per_epoch == 0:
            raise ValueError(
                f"dataset ({num_rows}) smaller than one batch ({batch})")

    def epoch(self, e: int) -> np.ndarray:
        """Indices of epoch e: [steps, batch]."""
        if self.shuffle:
            order = np.random.default_rng(self.seed + e).permutation(
                self.num_rows)
        else:
            order = np.arange(self.num_rows)
        return order[: self.rows_per_epoch].reshape(-1, self.batch)


def default_collate(rows: Sequence[Dict]) -> Dict[str, Any]:
    """Stack arrays, keep everything else (captions) as lists."""
    out: Dict[str, Any] = {}
    for key, val in rows[0].items():
        if isinstance(val, np.ndarray):
            out[key] = np.stack([r[key] for r in rows])
        else:
            out[key] = [r[key] for r in rows]
    return out


class ShapeBucketingCollate:
    """Rows bucketed by latent shape: each call adds its rows and emits one
    full batch from the fullest ready bucket, or None (`loader.py:84-108`)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._buckets: Dict[tuple, list] = {}

    def __call__(self, rows: Sequence[Dict]) -> Optional[Dict[str, Any]]:
        for r in rows:
            self._buckets.setdefault(tuple(r["latent"].shape), []).append(r)
        ready = [k for k, v in self._buckets.items()
                 if len(v) >= self.batch_size]
        if not ready:
            return None
        key = max(ready, key=lambda k: len(self._buckets[k]))
        batch_rows = self._buckets[key][: self.batch_size]
        self._buckets[key] = self._buckets[key][self.batch_size:]
        return default_collate(batch_rows)


class CoordinatedShapeBucketingCollate:
    """Bucketing that follows a seeded shape schedule
    (`loader.py:110-176`): shape s_t is drawn with the shapes' declared
    multiplicities as weights (a shape listed twice is drawn twice as
    often), and the call emits only when the scheduled shape's bucket is
    full, then draws the next. Every process that shares the seed emits the
    same shape at every step (one process here)."""

    def __init__(self, batch_size: int, shapes, seed: int = 0):
        self.batch_size = batch_size
        weight: Dict[tuple, float] = {}
        for shp in shapes:
            weight[tuple(shp)] = weight.get(tuple(shp), 0.0) + 1.0
        self.shapes = sorted(weight)
        self.probs = np.asarray([weight[s] for s in self.shapes], np.float64)
        self.probs /= self.probs.sum()
        self._rng = np.random.default_rng(seed)
        self._target = None
        self._buckets: Dict[tuple, list] = {}

    def _draw(self) -> tuple:
        return self.shapes[int(self._rng.choice(len(self.shapes),
                                                p=self.probs))]

    def __call__(self, rows: Sequence[Dict]) -> Optional[Dict[str, Any]]:
        for r in rows:
            shape = tuple(r["latent"].shape)
            if shape not in self.shapes:
                raise ValueError(f"row shape {shape} not in the declared "
                                 f"shape set {self.shapes}")
            self._buckets.setdefault(shape, []).append(r)
        if self._target is None:
            self._target = self._draw()
        bucket = self._buckets.get(self._target, [])
        if len(bucket) < self.batch_size:
            return None
        batch_rows = bucket[: self.batch_size]
        self._buckets[self._target] = bucket[self.batch_size:]
        self._target = self._draw()
        return default_collate(batch_rows)


def host_batches(dataset, sampler: ShardedSampler, num_epochs: int,
                 collate: Callable = default_collate, skip: int = 0
                 ) -> Iterator[Dict[str, Any]]:
    """Collated numpy batches, epoch after epoch; a collate that returns
    None (no full bucket yet) emits nothing for that sampler batch. The
    first `skip` batches are not emitted (a resumed run's fast-forward,
    `DataLoader.skip_batches` of the JAX loader): with the stateless
    default collate their rows are never read; a bucketing collate is fed
    and its batches discarded, so its state is the continuous run's."""
    for e in range(num_epochs):
        for idx in sampler.epoch(e):
            if skip and collate is default_collate:
                skip -= 1
                continue
            batch = collate([dataset[int(i)] for i in idx])
            if batch is None:
                continue
            if skip:
                skip -= 1
                continue
            yield batch


def device_batches(batches: Iterator[Dict[str, Any]], device
                   ) -> Iterator[Dict[str, Any]]:
    """Arrays to `device` tensors (pinned, non-blocking on CUDA); other
    values pass through."""
    device = torch.device(device)
    pin = device.type == "cuda"
    for batch in batches:
        out = {}
        for key, val in batch.items():
            if isinstance(val, np.ndarray):
                t = torch.from_numpy(val)
                if pin:
                    t = t.pin_memory()
                val = t.to(device, non_blocking=pin)
            out[key] = val
        yield out


def replica_rows(batches: Iterator[Dict[str, Any]], rank: int, local: int
                 ) -> Iterator[Dict[str, Any]]:
    """Rows [rank·local, (rank+1)·local) of each global batch: arrays and
    lists alike; one replica (local = the batch) keeps them all."""
    lo, hi = rank * local, (rank + 1) * local
    for batch in batches:
        yield {k: v[lo:hi] for k, v in batch.items()}
