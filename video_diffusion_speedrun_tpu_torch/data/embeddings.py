"""Precomputed T5 context joined onto dataset rows (port of
`data/embeddings.py`).

`data/precompute.py` (or the JAX package's `scripts/precompute_embeddings.py`)
encodes a split's captions once and writes raw `shard_{row_start:09d}.npy`
files ([n, tokens, dim] fp16) and a `manifest.json` naming the split, the
T5 hidden state and the rows each shard covers. `PrecomputedEmbeddingJoin`
adds each row's `context` from them, keyed by the row's index in its
split: the "precomputed" source of the Trainer's context, in place of a
T5 encode every step. The layout is the JAX package's, so shards written by
either package join in the other.

Shards are opened with `np.load(mmap_mode="r")`, so a row read touches
that row's pages only; an LRU under a lock bounds the open maps (file
descriptors), the page cache does the caching. The manifest's split must
be the split being served: a flat directory never joins one split's
embeddings onto the other's rows. Rows keep the shards' fp16, which the
Trainer widens to fp32 on the device: JAX's join widens on the host
(`embeddings.py:172`), the same values at twice the host bytes (8 MB a
row of 512 × 4096), which put the loader behind the train step on an
H100 (`PERF.md` §6).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1


def write_manifest(emb_dir: str, split: str, return_index: int,
                   new_shards: Dict[int, int]) -> dict:
    """Create or merge the manifest (atomic replace). `new_shards` maps
    row_start → rows; an existing manifest must agree on split and
    return_index (a resumed or multi-range precompute appends to it)."""
    path = os.path.join(emb_dir, MANIFEST_NAME)
    manifest = {"format": MANIFEST_FORMAT, "split": split,
                "return_index": return_index, "shards": {}}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
        for key in ("split", "return_index"):
            if existing.get(key) != manifest[key]:
                raise ValueError(
                    f"{path}: existing manifest has {key}="
                    f"{existing.get(key)!r}, refusing to mix with "
                    f"{manifest[key]!r} — use a fresh --out dir")
        manifest["shards"] = dict(existing.get("shards", {}))
    for start, rows in new_shards.items():
        manifest["shards"][str(int(start))] = int(rows)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return manifest


class PrecomputedEmbeddingJoin:
    """Dataset wrapper: row idx → the base row with `context`, fp16
    [tokens, dim], from the shards. Indices are the base split's, so
    `expected_split` is checked against the manifest."""

    def __init__(self, base, emb_dir: str,
                 expected_split: Optional[str] = None,
                 cache_shards: int = 8):
        self.base = base
        self.emb_dir = emb_dir
        manifest_path = os.path.join(emb_dir, MANIFEST_NAME)
        if not os.path.exists(manifest_path):
            legacy = ([n for n in os.listdir(emb_dir) if n.endswith(".npz")]
                      if os.path.isdir(emb_dir) else [])
            hint = (" (found legacy compressed .npz shards — re-run the "
                    "precompute, which writes raw .npy shards + "
                    "manifest.json)" if legacy else "")
            raise FileNotFoundError(
                f"no {MANIFEST_NAME} with shard_*.npy embedding shards in "
                f"{emb_dir} — run `python -m "
                "video_diffusion_speedrun_tpu_torch.data.precompute` first"
                + hint)
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"{manifest_path}: unsupported format "
                f"{manifest.get('format')!r} (expected {MANIFEST_FORMAT})")
        if (expected_split is not None
                and manifest.get("split") != expected_split):
            raise ValueError(
                f"{manifest_path} was precomputed for split="
                f"{manifest.get('split')!r} but this loader serves split="
                f"{expected_split!r} — row indices would join the wrong "
                "captions' embeddings. Precompute each split into its own "
                f"subdir (<embeddings_dir>/{expected_split}).")
        self.split = manifest.get("split")
        shards = {int(k): int(v) for k, v in manifest["shards"].items()}
        if not shards:
            raise FileNotFoundError(
                f"{manifest_path} lists no shards — the precompute wrote "
                "nothing")
        starts: List[int] = sorted(shards)
        self._starts = np.asarray(starts, np.int64)
        self._rows = np.asarray([shards[s] for s in starts], np.int64)
        self._cache: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self._cache_shards = max(1, cache_shards)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.base)

    def _load_shard(self, start: int, rows: int) -> np.ndarray:
        with self._lock:
            if start in self._cache:
                self._cache.move_to_end(start)
                return self._cache[start]
        path = os.path.join(self.emb_dir, f"shard_{start:09d}.npy")
        emb = np.load(path, mmap_mode="r")
        if emb.shape[0] != rows:
            raise ValueError(f"{path}: holds {emb.shape[0]} rows but the "
                             f"manifest declares {rows}")
        with self._lock:
            self._cache[start] = emb
            self._cache.move_to_end(start)
            while len(self._cache) > self._cache_shards:
                self._cache.popitem(last=False)
        return emb

    def _lookup(self, idx: int) -> torch.Tensor:
        pos = int(np.searchsorted(self._starts, idx, side="right")) - 1
        if pos < 0:
            raise KeyError(f"row {idx} precedes the first embedding shard "
                           f"(starts at {int(self._starts[0])})")
        start, rows = int(self._starts[pos]), int(self._rows[pos])
        if idx - start >= rows:
            raise KeyError(
                f"row {idx} not covered: shard_{start:09d}.npy holds rows "
                f"[{start}, {start + rows}) and the next shard starts "
                "later — re-run the precompute for the gap")
        emb = self._load_shard(start, rows)
        # one copy, detached from the map
        return torch.from_numpy(np.array(emb[idx - start]))

    def __getitem__(self, idx: int) -> Dict:
        row = self.base[int(idx)]
        row["context"] = self._lookup(int(idx))
        return row

    def latent_shapes(self):
        """The base dataset's shape declaration (coordinated bucketing)."""
        fn = getattr(self.base, "latent_shapes", None)
        return fn() if fn is not None else None
