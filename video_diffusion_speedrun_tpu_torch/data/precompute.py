"""Offline T5 embeddings of a split's captions (port of
`scripts/precompute_embeddings.py`).

Encodes the captions once and writes raw `shard_{start:09d}.npy` files
(fp16 [rows, 512, d_model]) and `manifest.json` (split, hidden state,
coverage; updated after every shard, so an interrupted run stays
loadable), which the train CLI's `--embeddings_dir` joins onto the rows
(`data/embeddings.py`) instead of encoding every step. Runs on the card
unless `--device cpu`.

    python -m video_diffusion_speedrun_tpu_torch.data.precompute \\
        --split train --return_index -8 --hf_name fixture.parquet \\
        --out embeddings/train

`--smoke_encoder` (a tiny T5, d_model 64) or `--smoke_encoder xxl` (the
T5-XXL config) runs with RANDOM weights and the byte-fallback tokenizer:
the pipeline without the FLUX.1-dev weights; the embeddings are garbage.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

# d_model of the tiny smoke T5 (the JAX script's)
TINY_D_MODEL = 64


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    add("--split", choices=["train", "test"], default="test")
    add("--return_index", type=int, default=-8)
    add("--batch_size", type=int, default=64)
    add("--rows_per_shard", type=int, default=8192)
    add("--start", type=int, default=0)
    add("--limit", type=int, default=None)
    add("--out", required=True)
    add("--cache_dir", default="./cache")
    add("--hf_name", default="fal/cosmos-openvid-1m",
        help="HF dataset name, or a local parquet fixture (data/fixture.py)")
    add("--smoke_encoder", nargs="?", const="tiny", choices=["tiny", "xxl"],
        default=None,
        help="a RANDOM-INIT T5 (tiny, or the XXL config) and the "
             "byte-fallback tokenizer; embeddings are garbage")
    add("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Writes the shards; returns their paths."""
    from video_diffusion_speedrun_tpu_torch.core.config import (
        resolve_device,
    )
    from video_diffusion_speedrun_tpu_torch.data.dataset import LatentDataset
    from video_diffusion_speedrun_tpu_torch.data.embeddings import (
        write_manifest,
    )
    from video_diffusion_speedrun_tpu_torch.text import encoder as tenc
    from video_diffusion_speedrun_tpu_torch.text.t5 import T5Config

    args = parse_args(argv)
    device = resolve_device(args.device)
    ds = LatentDataset(split=args.split, cache_dir=args.cache_dir,
                       hf_name=args.hf_name)
    if args.smoke_encoder is None:
        encoder = tenc.load_encoder(device=device)
    else:
        width = (T5Config.xxl().d_model if args.smoke_encoder == "xxl"
                 else TINY_D_MODEL)
        encoder = tenc.smoke_encoder(args.smoke_encoder, width, device)
    os.makedirs(args.out, exist_ok=True)
    end = len(ds) if args.limit is None else min(len(ds),
                                                 args.start + args.limit)
    paths = []
    for lo in range(args.start, end, args.rows_per_shard):
        hi = min(lo + args.rows_per_shard, end)
        captions = [ds.dataset[i]["caption"] for i in range(lo, hi)]
        emb = tenc.precompute_embeddings(encoder, captions,
                                         return_index=args.return_index,
                                         batch_size=args.batch_size)
        path = os.path.join(args.out, f"shard_{lo:09d}.npy")
        np.save(path, emb.astype(np.float16))
        write_manifest(args.out, args.split, args.return_index, {lo: hi - lo})
        print(f"wrote {path} [{lo}, {hi})")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
