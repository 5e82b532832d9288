"""A local parquet of Cosmos-shaped rows, for runs of the real-data path
without the dataset (port of `scripts/make_data_fixture.py`).

The columns are `fal/cosmos-openvid-1m`'s: `serialized_latent`, the
torch.save bytes of a bf16 latent [C, T, H, W], and `caption`. Row i
draws its latent from one `np.random.default_rng(seed)` stream with
T = frames[i mod len(frames)], as the JAX script does, so both write the
same rows for one seed. The split arithmetic applies to the fixture's row
count: 256 rows give 88 train and 40 test rows.

    python -m video_diffusion_speedrun_tpu_torch.data.fixture \\
        --out fixture.parquet --rows 256
"""

from __future__ import annotations

import argparse
import io
from typing import List, Optional, Sequence

import numpy as np
import torch


def fixture_columns(rows: int, channels: int = 16,
                    frames: Sequence[int] = (5,), height: int = 32,
                    width: int = 32, seed: int = 0):
    """(latent blobs, captions) of the fixture's rows."""
    rng = np.random.default_rng(seed)
    blobs: List[bytes] = []
    captions: List[str] = []
    for i in range(rows):
        t = frames[i % len(frames)]
        lat = rng.standard_normal((channels, t, height, width))
        buf = io.BytesIO()
        torch.save(torch.from_numpy(lat).to(torch.bfloat16), buf)
        blobs.append(buf.getvalue())
        captions.append(f"fixture clip {i} ({t} latent frames)")
    return blobs, captions


def write_fixture(out: str, rows: int = 256, channels: int = 16,
                  frames: Sequence[int] = (5,), height: int = 32,
                  width: int = 32, seed: int = 0) -> None:
    """Write the fixture's rows to the parquet file `out`."""
    import datasets  # heavy: imported on use

    blobs, captions = fixture_columns(rows, channels, frames, height, width,
                                      seed)
    datasets.Dataset.from_dict(
        {"serialized_latent": blobs, "caption": captions}).to_parquet(out)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="output .parquet path")
    p.add_argument("--rows", type=int, default=256)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--frames", default="5",
                   help="comma-separated latent T values cycled across rows "
                        "(mixed values exercise shape bucketing)")
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    frames = [int(t) for t in args.frames.split(",") if t]
    write_fixture(args.out, args.rows, args.channels, frames, args.height,
                  args.width, args.seed)
    print(f"wrote {args.rows} rows to {args.out} (T in {frames})")


if __name__ == "__main__":
    main()
