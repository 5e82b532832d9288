"""Decoded-video post-processing and writing (port of `sampling/decode.py`).

[-1, 1] → uint8 (`unclamp_video`), [C, T, H, W] → [T, H, W, C], a 30 fps
h264 mp4 through imageio when it and an encoder are installed; otherwise
the frames as `<name>/video.npy`, plus PNGs when imageio can write them.
`imageio` is imported only inside `save_video`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from video_diffusion_speedrun_tpu_torch.models.cosmos_vae import (
    CosmosDecoder,
    decode_video,
)

logger = logging.getLogger(__name__)

_UINT8_MAX = 255.0


def unclamp_video(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float → uint8 [0, 255]."""
    v = (np.asarray(video, np.float32) + 1.0) / 2.0
    v = np.clip(v, 0.0, 1.0)
    return (v * _UINT8_MAX + 0.5).astype(np.uint8)


def to_frames(video_cthw) -> np.ndarray:
    """[C, T, H, W] → [T, H, W, C] uint8 on the host. A torch tensor is
    converted where it lies, with `unclamp_video`'s fp32 operations (the
    same bytes), and only the uint8 frames are copied to the host."""
    if isinstance(video_cthw, torch.Tensor):
        v = (video_cthw.float().permute(1, 2, 3, 0) + 1.0) / 2.0
        v = v.clamp(0.0, 1.0)
        # contiguous before the copy: a strided array would make np.save
        # walk it element by element
        return (v * _UINT8_MAX + 0.5).to(torch.uint8).contiguous().cpu(
        ).numpy()
    return unclamp_video(np.transpose(video_cthw, (1, 2, 3, 0)))


def save_video(video_cthw, path: str, name: str, fps: int = 30) -> str:
    """Write `<path>/<name>.mp4` if an h264 encoder exists, else
    `<path>/<name>/video.npy` (+ PNG frames where imageio is installed).
    `video_cthw`: a numpy array or a torch tensor. Returns the mp4 file or
    the frames directory."""
    os.makedirs(path, exist_ok=True)
    frames = to_frames(video_cthw)
    mp4_path = os.path.join(path, f"{name}.mp4")
    try:
        import imageio

        imageio.mimsave(mp4_path, list(frames), fps=fps, codec="h264")
        return mp4_path
    except Exception as e:  # no imageio, or no h264 encoder behind it
        logger.warning("mp4 encode unavailable (%s); writing frames", e)
    frame_dir = os.path.join(path, name)
    os.makedirs(frame_dir, exist_ok=True)
    np.save(os.path.join(frame_dir, "video.npy"), frames)
    try:
        import imageio

        for i, frame in enumerate(frames):
            imageio.imwrite(os.path.join(frame_dir, f"{i:05d}.png"), frame)
    except Exception as e:  # the PNGs are optional beside video.npy
        logger.warning("PNG frames not written (%s)", e)
    return frame_dir


def save_latents_to_video(latents: torch.Tensor, decoder: CosmosDecoder,
                          path: str, name: str, fps: int = 30,
                          chunk_frames: Optional[int] = 4,
                          context_frames: int = 2) -> str:
    """Decode [16, T, h, w] latents in causal temporal chunks (so long,
    high-resolution videos fit in memory; see `decode_video`), then write
    them with `save_video`."""
    video = decode_video(decoder, latents, chunk_frames=chunk_frames,
                         context_frames=context_frames)
    return save_video(video, path, name, fps)
