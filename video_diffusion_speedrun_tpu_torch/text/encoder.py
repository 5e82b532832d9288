"""Prompt encoding: tokenizer + frozen T5 (port of `text/encoder.py`).

Tokenization pads or truncates to a fixed 512 tokens with no attention
mask (the reference's `encode_prompt_with_t5`, where pads are attended).
Weights come from a local transformers checkpoint (nothing is
downloaded), or from a random init when the caller allows it — smoke runs
only, logged loudly, with the byte-fallback tokenizer when no
sentencepiece tokenizer is cached. `transformers` is imported only inside
`load_encoder`: the card machine does not have it.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from video_diffusion_speedrun_tpu_torch.core.config import resolve_device
from video_diffusion_speedrun_tpu_torch.text.t5 import (
    T5Config,
    T5Encoder,
    convert_torch_t5,
    init_t5,
)

logger = logging.getLogger(__name__)

MAX_SEQUENCE_LENGTH = 512  # the reference's default


class ByteFallbackTokenizer:
    """Deterministic offline stand-in when no sentencepiece checkpoint is
    cached: UTF-8 bytes → ids 3 + byte (T5's special ids: 0 pad, 1 EOS,
    2 unk), EOS-terminated, padded and truncated to `max_length`.
    Semantically garbage: `load_encoder` installs it only beside a
    random-init encoder. Takes the HF tokenizer's call signature."""

    def __call__(self, prompts: Sequence[str], padding=None, max_length=512,
                 truncation=True, return_tensors="np"):
        ids = np.zeros((len(prompts), max_length), np.int64)
        for row, text in enumerate(prompts):
            bs = list(text.encode("utf-8"))[: max_length - 1]
            ids[row, : len(bs)] = np.asarray(bs, np.int64) + 3
            ids[row, len(bs)] = 1  # EOS
        return {"input_ids": ids}


class PromptEncoder:
    """A frozen `T5Encoder` and its tokenizer. Calls run under
    `torch.no_grad` on the encoder's device and return the compute dtype.
    With a `mesh` (or after `shard(mesh)`) the encoder is sharded over its
    fsdp axis (`parallel/fsdp.py:shard_encoder`), so T5-XXL does not keep
    a whole copy on every card; the encodings are the unsharded ones."""

    def __init__(self, model: T5Encoder, tokenizer=None,
                 max_length: int = MAX_SEQUENCE_LENGTH, mesh=None):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.max_length = max_length
        self._device = model.shared.weight.device
        if mesh is not None:
            self.shard(mesh)

    def shard(self, mesh) -> None:
        """Shard the encoder over `mesh`'s fsdp axis (a no-op at size 1)."""
        from video_diffusion_speedrun_tpu_torch.parallel.fsdp import (
            shard_encoder,
        )

        shard_encoder(self.model, mesh)

    @property
    def device(self) -> torch.device:
        return self._device

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError(
                "no tokenizer loaded; pass pre-tokenized ids or install a "
                "local tokenizer checkpoint")
        out = self.tokenizer(
            list(prompts), padding="max_length", max_length=self.max_length,
            truncation=True, return_tensors="np")
        return np.asarray(out["input_ids"]).astype(np.int32)

    def __call__(self, prompts: Sequence[str],
                 return_index: int = -1) -> torch.Tensor:
        """[len(prompts), max_length, d_model] embeddings."""
        return self.encode_ids(self.tokenize(prompts), return_index)

    @torch.no_grad()
    def encode_ids(self, input_ids, return_index: int = -1) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        # through the module call: a sharded encoder gathers its weights
        # in its hooks
        return self.model(ids, return_index)


def load_encoder(text_encoder_path: str = "black-forest-labs/FLUX.1-dev",
                 cfg: Optional[T5Config] = None,
                 allow_random_init: bool = False, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None
                 ) -> PromptEncoder:
    """The frozen prompt encoder from local HF caches (`tokenizer_2`,
    `text_encoder_2` of FLUX.1-dev), built in `dtype` on `device`. Without
    weights it raises, unless `allow_random_init`: then the encoder is
    drawn from `generator` and, with no tokenizer cached, the byte-fallback
    tokenizer stands in."""
    cfg = cfg or T5Config.xxl()
    device = resolve_device(device)
    tokenizer = None
    model = None
    try:
        from transformers import T5TokenizerFast

        tokenizer = T5TokenizerFast.from_pretrained(
            text_encoder_path, subfolder="tokenizer_2", local_files_only=True)
    except Exception as e:  # no transformers, offline or no cache
        logger.warning("tokenizer unavailable (%s); tokenize() will fail", e)

    try:
        from transformers import T5EncoderModel

        hf = T5EncoderModel.from_pretrained(
            text_encoder_path, subfolder="text_encoder_2", torch_dtype=dtype,
            local_files_only=True)
        model = T5Encoder(cfg, device="meta", dtype=dtype)
        model.load_state_dict(convert_torch_t5(hf.state_dict(), cfg),
                              assign=True)
        model = model.to(device).eval().requires_grad_(False)
        del hf
    except Exception as e:
        if not allow_random_init:
            raise RuntimeError(
                f"T5 weights unavailable ({e}); pass allow_random_init=True "
                "for smoke-testing without weights") from e
        logger.warning("T5 weights unavailable (%s); RANDOM INIT (smoke "
                       "only)", e)
        model = init_t5(cfg, device=device, dtype=dtype, generator=generator)

    if tokenizer is None and allow_random_init:
        logger.warning("no tokenizer cached; using the byte-fallback "
                       "tokenizer (smoke only — ids are NOT sentencepiece)")
        tokenizer = ByteFallbackTokenizer()
    return PromptEncoder(model, tokenizer)


def smoke_encoder(kind: str, context_dim: int, device="cuda",
                  dtype: torch.dtype = torch.bfloat16,
                  seed: int = 0) -> PromptEncoder:
    """A RANDOM-INIT encoder with the byte-fallback tokenizer (when no
    tokenizer is cached), for runs without the weights: "tiny" (2 layers
    of d_model = `context_dim`, as the JAX `sample.py --smoke_encoder`) or
    "xxl" (`T5Config.xxl()`, whose d_model must be `context_dim`).
    Embeddings are garbage; logged loudly."""
    if kind == "tiny":
        cfg = T5Config(d_model=context_dim, d_kv=16, d_ff=128, num_layers=2,
                       num_heads=4)
    elif kind == "xxl":
        cfg = T5Config.xxl()
        if cfg.d_model != context_dim:
            raise ValueError(f"T5-XXL gives {cfg.d_model}-wide context; the "
                             f"model takes {context_dim}")
    else:
        raise ValueError(f"unknown smoke encoder: {kind}")
    logger.warning("smoke encoder: %s T5 with RANDOM weights (embeddings "
                   "are garbage — pipeline exercise only)", kind)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return load_encoder(cfg=cfg, allow_random_init=True, device=device,
                        dtype=dtype, generator=gen)


def precompute_embeddings(encoder: PromptEncoder, prompts: Sequence[str],
                          return_index: int = -1,
                          batch_size: int = 64) -> np.ndarray:
    """Offline embedding precompute: fp32 [len(prompts), max_length,
    d_model] on the host."""
    chunks = []
    for i in range(0, len(prompts), batch_size):
        emb = encoder(prompts[i: i + batch_size], return_index=return_index)
        chunks.append(emb.float().cpu().numpy())
    return np.concatenate(chunks, axis=0)
