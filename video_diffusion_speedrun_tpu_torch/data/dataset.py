"""The Cosmos-OpenVid latent dataset (port of `data/dataset.py`).

`fal/cosmos-openvid-1m`: rows of `serialized_latent` (torch.save bytes of
a bf16 Cosmos latent [C, T, H, W]) and `caption`. The split arithmetic
pins the dataset's 1,979,810 rows: the first half, of which the last 40
rows are the test split and the rest the train split. `hf_name` may be a
local parquet file or directory of the same columns (`data/fixture.py`):
the same arithmetic then applies to its own row count. Nothing is
downloaded unless `hf_name` names a hub dataset.
"""

from __future__ import annotations

import os
from typing import Dict

from video_diffusion_speedrun_tpu_torch.data.serialization import load_tensor


def split_rows(split: str, total: int, test_rows: int) -> range:
    """The rows of `split` among `total`: train [0, half − test), test
    [half − test, half), half = total // 2."""
    half = total // 2
    test = min(test_rows, half)
    if split == "train":
        rows = range(0, half - test)
    elif split == "test":
        rows = range(half - test, half)
    else:
        raise ValueError(f"unknown split: {split}")
    if len(rows) == 0:
        raise ValueError(f"split {split!r} is empty: dataset has {total} "
                         f"rows (half={half}, test={test})")
    return rows


class LatentDataset:
    """Rows {"latent": bf16 tensor [C, T, H, W], "caption": str}."""

    TOTAL_ROWS = 1_979_810
    TEST_ROWS = 40

    def __init__(self, split: str = "train", cache_dir: str = "./cache",
                 hf_name: str = "fal/cosmos-openvid-1m"):
        from datasets import load_dataset  # heavy: imported on use

        local_fixture = os.path.exists(hf_name)
        if local_fixture:
            files = ([hf_name] if not os.path.isdir(hf_name) else sorted(
                os.path.join(hf_name, f) for f in os.listdir(hf_name)
                if f.endswith(".parquet")))
            base = load_dataset("parquet", data_files=files, split="train",
                                cache_dir=cache_dir)
        else:
            base = load_dataset(hf_name, split="train", cache_dir=cache_dir)
            # the split boundary is pinned, not len(base): split-local row
            # indices key the precomputed embeddings and the eval window,
            # so a changed upstream row count must not move it silently
            if len(base) != self.TOTAL_ROWS:
                raise ValueError(
                    f"{hf_name} has {len(base)} rows but the reference "
                    f"split arithmetic pins {self.TOTAL_ROWS} — the dataset "
                    "changed upstream, or a partial mirror is cached. "
                    "Refusing to shift the train/test boundary silently; "
                    "point hf_name at a local fixture to use dynamic "
                    "splitting.")
        total = len(base) if local_fixture else self.TOTAL_ROWS
        self.dataset = base.select(split_rows(split, total, self.TEST_ROWS))

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict:
        item = self.dataset[int(idx)]
        return {"latent": load_tensor(item["serialized_latent"]),
                "caption": item["caption"]}
