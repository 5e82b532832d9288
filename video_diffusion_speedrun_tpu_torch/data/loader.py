"""Host-side batches for one process (port of part of `data/loader.py`).

`ShardedSampler.epoch` (its one-process case) and `default_collate` keep
the JAX row order (`loader.py:33-82`): epoch e is
`default_rng(seed + e).permutation`, truncated to whole batches. `device_batches`
copies each collated batch from pinned host memory with `non_blocking=True`
(the JAX `device_prefetch`), so the copy queues behind the running step.
Worker threads and shape bucketing come with the real-data loader.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence

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


def host_batches(dataset, sampler: ShardedSampler,
                 num_epochs: int) -> Iterator[Dict[str, Any]]:
    """Collated numpy batches, epoch after epoch."""
    for e in range(num_epochs):
        for idx in sampler.epoch(e):
            yield default_collate([dataset[int(i)] for i in idx])


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
