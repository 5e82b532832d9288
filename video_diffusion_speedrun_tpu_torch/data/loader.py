"""Host-side batches for one process (port of `data/loader.py`).

`ShardedSampler.epoch` and `default_collate` keep the JAX row order
(`loader.py:33-82`): epoch e is `default_rng(seed + e).permutation`,
truncated to whole global batches (`num_shards` × `batch`), of which shard
`shard` takes its slice of each. For
mixed-length clips, `ShapeBucketingCollate` and
`CoordinatedShapeBucketingCollate` (`loader.py:84-176`) turn each sampler
batch into at most one shape-uniform batch, carrying the rest; with the
same seed they emit the JAX package's batch shapes in its order. The
collates stack numpy arrays (synthetic rows) and torch tensors (the
dataset's bf16 latents, precomputed context) alike.

`DataLoader` (`loader.py:179-288`) reads and collates on a look-ahead
thread with a pool of `num_workers` row readers, `prefetch` batches
ahead; `device_batches` (the JAX `device_prefetch`) moves them to the
device on a staging thread: from pinned memory with non-blocking copies
on a stream of its own, which the consumer's stream waits for, so the
copy of batch n+1 runs under step n. A producer's error is raised in the
consumer; closing a stream (or leaving its loop) stops its thread and
waits for it at most 5 s. Across data shards each process reads its own
rows through `ShardedSampler(shard, num_shards)` with the default collate;
a bucketing collate cannot split a batch, so there every process draws the
same global batches and `replica_rows` keeps its shard's rows
(`local_batch_slice`).
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


class ShardedSampler:
    """Deterministic index stream of data shard `shard` of `num_shards`
    (the JAX sampler): `batch` rows per shard of each global batch of
    `batch · num_shards`."""

    def __init__(self, num_rows: int, batch: int, seed: int = 0,
                 shuffle: bool = True, *, shard: int = 0,
                 num_shards: int = 1):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range [0, {num_shards})")
        self.num_rows = num_rows
        self.batch = batch
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.shuffle = shuffle
        step = batch * num_shards
        self.rows_per_epoch = (num_rows // step) * step
        if self.rows_per_epoch == 0:
            raise ValueError(
                f"dataset ({num_rows}) smaller than one global batch "
                f"({step})")

    def epoch(self, e: int) -> np.ndarray:
        """This shard's indices of epoch e: [steps, batch]."""
        if self.shuffle:
            order = np.random.default_rng(self.seed + e).permutation(
                self.num_rows)
        else:
            order = np.arange(self.num_rows)
        order = order[: self.rows_per_epoch]
        batches = order.reshape(-1, self.batch * self.num_shards)
        lo = self.shard * self.batch
        return batches[:, lo: lo + self.batch]


def default_collate(rows: Sequence[Dict]) -> Dict[str, Any]:
    """Stack arrays and tensors, keep everything else (captions) as
    lists."""
    out: Dict[str, Any] = {}
    for key, val in rows[0].items():
        vals = [r[key] for r in rows]
        if isinstance(val, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(val, torch.Tensor):
            out[key] = torch.stack(vals)
        else:
            out[key] = vals
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


class _Fault:
    """A producer thread's exception, carried to the consumer and raised
    there, so that a dataset, collate or copy error fails the loop instead
    of ending the stream like an epoch boundary."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()  # end of a stream (a collate may return None itself)
_WIND_DOWN_S = 5.0  # longest wait for a producer thread at close


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put `item` unless `stop` is set first; whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _threaded(source: Iterator, depth: int, name: str,
              fn: Optional[Callable] = None) -> Iterator:
    """`fn` of the items of `source` (or the items), made on a thread of
    their own `depth` items ahead. The thread closes the source when the
    stream ends, fails or is closed; closing waits for the thread at most
    5 s (one stuck in a read is abandoned, as a daemon)."""
    source = iter(source)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def run():
        payload = _END
        try:
            for item in source:
                if fn is not None:
                    item = fn(item)
                if not _put(q, item, stop):
                    return
        except BaseException as exc:  # raised again by the consumer
            # only a teardown race (consumer gone, interpreter exiting)
            # is swallowed
            if not stop.is_set() and not sys.is_finalizing():
                payload = _Fault(exc)
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()
            _put(q, payload, stop)

    thread = threading.Thread(target=run, name=name, daemon=True)
    thread.start()
    monotonic = time.monotonic  # kept alive for a close at exit
    try:
        while True:
            item = q.get()
            if isinstance(item, _Fault):
                raise item.exc
            if item is _END:
                return
            yield item
    finally:
        stop.set()
        deadline = monotonic() + _WIND_DOWN_S
        while thread.is_alive() and monotonic() < deadline:
            while True:  # free a producer blocked in put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=0.2)


class DataLoader:
    """Threaded look-ahead loader over (dataset, sampler): epochs of
    collated batches, `num_workers` threads reading the rows of a batch,
    `prefetch` batches ready ahead of the consumer.

    `skip_batches` (a resumed run): the stream starts where a continuous
    run would be after that many batches. With the default collate (one
    sampler batch, one batch) the skipped rows are never read; a bucketing
    collate is fed and its batches discarded, so its state is the
    continuous run's."""

    def __init__(self, dataset, sampler: ShardedSampler,
                 collate: Callable = default_collate, num_workers: int = 4,
                 prefetch: int = 2, num_epochs: Optional[int] = None,
                 skip_batches: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.num_epochs = num_epochs
        self.skip_batches = skip_batches

    def _epochs(self) -> Iterator[int]:
        e = 0
        while self.num_epochs is None or e < self.num_epochs:
            yield e
            e += 1

    def _batches(self) -> Iterator[Dict[str, Any]]:
        index_skip = self.collate is default_collate
        to_skip = self.skip_batches
        with ThreadPoolExecutor(self.num_workers,
                                thread_name_prefix="vds-rows") as pool:
            for e in self._epochs():
                for idx in self.sampler.epoch(e):
                    if to_skip and index_skip:
                        to_skip -= 1
                        continue
                    batch = self.collate(list(pool.map(
                        self.dataset.__getitem__, (int(i) for i in idx))))
                    if batch is None:
                        continue
                    if to_skip:
                        to_skip -= 1
                        continue
                    yield batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return _threaded(self._batches(), self.prefetch, "vds-loader")


def _to_device(batch: Dict[str, Any], device: torch.device, stream):
    """(the batch with its arrays and tensors on `device`, the event after
    their copies on `stream`, or None without a stream)."""
    out = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(val)
        if isinstance(val, torch.Tensor) and stream is not None:
            with torch.cuda.stream(stream):
                val = val.pin_memory().to(device, non_blocking=True)
        elif isinstance(val, torch.Tensor):
            val = val.to(device)
        out[key] = val
    if stream is None:
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


def device_batches(batches: Iterator[Dict[str, Any]], device,
                   depth: int = 2) -> Iterator[Dict[str, Any]]:
    """Arrays and tensors of each batch to `device`, other values passed
    through, staged on a thread `depth` batches ahead. On a CUDA device
    the copies run from pinned memory on a stream of their own; each
    batch's tensors are handed to the consumer's current stream, which
    waits for them."""
    device = torch.device(device)
    stream = (torch.cuda.Stream(device) if device.type == "cuda" else None)
    staged = _threaded(batches, depth, "vds-stage",
                       lambda b: _to_device(b, device, stream))
    try:
        for out, event in staged:
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for val in out.values():
                    if isinstance(val, torch.Tensor):
                        val.record_stream(current)
            yield out
    finally:
        staged.close()


def replica_rows(batches: Iterator[Dict[str, Any]], rank: int, local: int
                 ) -> Iterator[Dict[str, Any]]:
    """Rows [rank·local, (rank+1)·local) of each global batch: arrays and
    lists alike; one replica (local = the batch) keeps them all."""
    lo, hi = rank * local, (rank + 1) * local
    for batch in batches:
        yield {k: v[lo:hi] for k, v in batch.items()}
