"""muP AdamW leaf update (port of `ops/fused_adamw.py`).

Replaces the Pallas `adamw_leaf_update` (`ops/fused_adamw.py:66`, kernel
`_kernel` `:34`). The JAX package launches it once per leaf (opt-in); here
one launch of the hand-written multi-tensor kernel
`csrc/adamw_multi_tensor.cu` updates every leaf of a CUDA parameter list,
in place (what `input_output_aliases` does on the TPU). CPU leaves run the
plain twin `adamw_leaf_update_plain`, the exact leaf math of the JAX
`adamw_leaf_delta` (`train/optim.py:30-47`).

Parameters and their gradients are fp32 or bf16 (the JAX kernel is
generic over the parameter dtype), the moments fp32 or bf16. At bf16 the
kernel and the twin follow the rounding order of `p +
adamw_leaf_delta(...)`, the update of the optimizer-in-backward step
(`train/inloop.py:99-102`): wd·p in bf16 (JAX's weak-typed wd takes p's
dtype), the delta rounded to bf16, then the sum rounded again. The Pallas
body rounds once (`ops/fused_adamw.py:50-51`); at fp32 both orders give
the same bits.

`MultiTensorAdamW` holds the device tables the kernel reads: (p, m, v)
pointers, sizes and the per-leaf muP (lr, wd), plus the chunk table that
splits the leaves over blocks; all built once, so a caller whose leaves
may move (a checkpoint load) builds a new one (`train/optim.py`).
Gradient pointers change every step (autograd allocates fresh gradients)
and go up with lr_t, bc1 and bc2 as two small host-to-device copies that
need no host sync. The leaves may be the local shards of sharded
parameters (FSDP2 keeps each one contiguous in storage of its own); a
gradient that is a view at an unaligned offset of a larger buffer (FSDP2's
reduce-scatter output) is copied to an aligned one first.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from video_diffusion_speedrun_tpu_torch.ops import _build

_LIB = "adamw_multi_tensor"


def apply_direction(p: torch.Tensor, direction: torch.Tensor, lr: float,
                    wd: float, lr_t: float) -> None:
    """p ← p + (−(lr·lr_t)·(direction + wd·p)), in place, in the rounding
    order of `p + adamw_leaf_delta(...)`: at fp32 in fp32; at bf16 wd·p
    rounds to bf16 (with wd rounded to bf16 first), the delta rounds to
    bf16 and the sum rounds again."""
    neg_lr = -float(np.float32(lr) * np.float32(lr_t))
    pf = p.float()
    if p.dtype == torch.float32:
        p.copy_(pf + neg_lr * (direction + wd * pf))
        return
    wd_p = float(torch.tensor(wd, dtype=p.dtype))
    delta = (neg_lr * (direction + (pf * wd_p).to(p.dtype).float())).to(
        p.dtype)
    p.copy_(pf + delta.float())


def adamw_leaf_update_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor, lr: float, wd: float, lr_t: float,
                            bc1: float, bc2: float, b1: float, b2: float,
                            eps: float) -> None:
    """The kernel's plain twin for one leaf, in place: moment math in fp32,
    direction (m/bc1)/(√(v/bc2)+eps), p += −(lr·lr_t)·(direction + wd·p)
    in p's dtype (`apply_direction`), moments cast to their storage dtype.
    The scalars are fp32 values (see `step_scalars`)."""
    gf = g.float()
    m2 = b1 * m.float() + (1.0 - b1) * gf
    v2 = b2 * v.float() + (1.0 - b2) * gf.square()
    direction = (m2 / bc1) / ((v2 / bc2).sqrt() + eps)
    apply_direction(p, direction, lr, wd, lr_t)
    m.copy_(m2)
    v.copy_(v2)


def step_scalars(count: int, lr_t: float, b1: float, b2: float):
    """(lr_t, bc1, bc2) for the update after `count` earlier ones, each
    rounded to fp32 as the JAX step computes them: bc = 1 − b^(count+1)."""
    f32 = np.float32
    t = f32(count + 1)
    return (float(f32(lr_t)), float(f32(1.0) - f32(b1) ** t),
            float(f32(1.0) - f32(b2) ** t))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy of it in fresh (aligned) storage."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    out.copy_(t)
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    fn = lib.adamw_multi_tensor
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 7 + [i, f, f, f, f, f, i, i, p]
        fn.restype = ctypes.c_int
        lib.adamw_multi_tensor_chunk.restype = ctypes.c_longlong
    return lib


class MultiTensorAdamW:
    """One launch of `csrc/adamw_multi_tensor.cu` over a fixed list of CUDA
    leaves: fp32 or bf16 parameters (all alike) with fp32 or bf16 moments
    of the same shape, all contiguous. Raises on anything the kernel does
    not take."""

    def __init__(self, params: Sequence[torch.Tensor],
                 moments_m: Sequence[torch.Tensor],
                 moments_v: Sequence[torch.Tensor], lrs: Sequence[float],
                 wds: Sequence[float], b1: float, b2: float, eps: float):
        dev = params[0].device
        pdt, mdt = params[0].dtype, moments_m[0].dtype
        for dt, what in ((pdt, "parameters"), (mdt, "moments")):
            if dt not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{what} must be fp32 or bf16, got {dt}")
        for p, m, v in zip(params, moments_m, moments_v):
            if p.device != dev or p.dtype != pdt:
                raise TypeError("the AdamW kernel takes parameters of one "
                                f"dtype on one device, got {p.dtype} on "
                                f"{p.device}")
            for t in (p, m, v):
                if not t.is_contiguous() or t.data_ptr() % 16:
                    raise ValueError("leaves must be contiguous and 16-byte "
                                     "aligned")
            if m.dtype != mdt or v.dtype != mdt or m.shape != p.shape \
                    or v.shape != p.shape:
                raise ValueError("moments must match their parameter")
        lib = _library()
        chunk = lib.adamw_multi_tensor_chunk()
        numel = [p.numel() for p in params]
        chunk_leaf, chunk_start = [], []
        for i, n in enumerate(numel):
            starts = range(0, n, chunk)
            chunk_leaf += [i] * len(starts)
            chunk_start += list(starts)

        def dev_tensor(values, dtype):
            return torch.tensor(values, dtype=dtype).to(dev)

        self.device = dev
        self.n_leaves = len(params)
        self.n_chunks = len(chunk_leaf)
        self.dtype = pdt
        self.moments_bf16 = mdt == torch.bfloat16
        if pdt == torch.bfloat16:  # wd·p is a bf16 product
            wds = [float(torch.tensor(wd, dtype=pdt)) for wd in wds]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.leaf_ptrs = dev_tensor(
            [t.data_ptr() for trio in zip(params, moments_m, moments_v)
             for t in trio], torch.int64)
        self.numel = dev_tensor(numel, torch.int64)
        self.hyper = dev_tensor([x for pair in zip(lrs, wds) for x in pair],
                                torch.float32)
        self.chunk_leaf = dev_tensor(chunk_leaf, torch.int32)
        self.chunk_start = dev_tensor(chunk_start, torch.int64)

    def __call__(self, grads: Sequence[torch.Tensor], lr_t: float, bc1: float,
                 bc2: float) -> None:
        """Update every leaf in place from `grads` (in the parameters'
        dtype, one per leaf, in the order the leaves were given)."""
        if len(grads) != self.n_leaves:
            raise ValueError(f"{len(grads)} grads for {self.n_leaves} leaves")
        for g in grads:
            if g.device != self.device or g.dtype != self.dtype:
                raise ValueError(f"grads must be {self.dtype} on "
                                 f"{self.device}")
        grads = [_aligned(g) for g in grads]
        # pinned host buffers from the caching host allocator: it keeps a
        # buffer until its copy has run, so the copies need no sync
        g_ptrs = torch.tensor([g.data_ptr() for g in grads], dtype=torch.int64,
                              pin_memory=True).to(self.device,
                                                  non_blocking=True)
        scalars = torch.tensor([lr_t, bc1, bc2], dtype=torch.float32,
                               pin_memory=True).to(self.device,
                                                   non_blocking=True)
        def f32(x: float) -> float:
            return float(np.float32(x))

        lib = _library()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = lib.adamw_multi_tensor(
                self.leaf_ptrs.data_ptr(), g_ptrs.data_ptr(),
                self.numel.data_ptr(), self.hyper.data_ptr(),
                self.chunk_leaf.data_ptr(), self.chunk_start.data_ptr(),
                scalars.data_ptr(), self.n_chunks, f32(self.b1),
                f32(1.0 - self.b1), f32(self.b2), f32(1.0 - self.b2),
                f32(self.eps), int(self.dtype == torch.bfloat16),
                int(self.moments_bf16), stream)
        _build.check(_LIB, err)
        MultiTensorAdamW.launches += 1
        if self.dtype == torch.bfloat16:
            MultiTensorAdamW.bf16_launches += 1

    launches = 0  # kernel launches, over every instance
    bf16_launches = 0  # of which on bf16 parameters
