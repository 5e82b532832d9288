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

`FactoredAdamW` is the factored-ν update of the optimizer-in-backward
step (`train/inloop.py`): the [out, in] block weights whose ν is
Adafactor's rank-1 pair of factors. It replaces no Pallas kernel (JAX's
factored branch, `inloop.py:88-98`, is XLA work); its plain twin is
`train/optim.py:factored_leaf_update`, and `factor_moments` is the factors'
arithmetic that both, and the wrapper where the factors' sums cross ranks,
share. Its two launches of `csrc/factored_adamw.cu` update every factored
leaf of one group: the row and column sums of g², then m and p.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from video_diffusion_speedrun_tpu_torch.ops import _build

_LIB = "adamw_multi_tensor"
_FACTORED_LIB = "factored_adamw"


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


def factor_moments(vr: torch.Tensor, vc: torch.Tensor, row: torch.Tensor,
                   col: torch.Tensor, b2: float, shape: Tuple[int, int],
                   sums=None):
    """(vr2, vc2, denom) of JAX's factored branch (`inloop.py:88-98`) for
    this rank's shard of a torch [out, in] weight of whole `shape`, from the
    factors and the local sums of g² over out (`row` [in]) and over in
    (`col` [out]). `sums(t, dim)` sums in place a partial sum over the ranks
    that split weight dim `dim` (None: no rank does)."""
    n_out, n_in = shape
    if sums is not None:
        sums(row, 0)
        sums(col, 1)
    vr2 = b2 * vr + (1.0 - b2) * (row / n_out)
    vc2 = b2 * vc + (1.0 - b2) * (col / n_in)
    total = vr2.sum().reshape(1)
    if sums is not None:
        sums(total, 1)
    return vr2, vc2, (total / n_in).clamp(min=1e-30)


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


def _factored_library() -> ctypes.CDLL:
    lib = _build.load(_FACTORED_LIB)
    if lib.factored_adamw_sums.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.factored_adamw_sums.argtypes = ([p] * 4 + [i, ll] + [p] * 3
                                            + [i, f, f, i, i, p])
        lib.factored_adamw_apply.argtypes = ([p] * 4 + [i, ll] + [p] * 3
                                             + [i, f, f, f, i, i, p])
        lib.factored_adamw_sums.restype = ctypes.c_int
        lib.factored_adamw_apply.restype = ctypes.c_int
        lib.factored_adamw_geometry.argtypes = [i]
        lib.factored_adamw_geometry.restype = ll
    return lib


def _upload(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small device tensor of `values`, copied from pinned memory with
    no host sync (the caching host allocator keeps the buffer until its
    copy has run)."""
    return torch.tensor(values, dtype=dtype, pin_memory=True).to(
        device, non_blocking=True)


class FactoredAdamW:
    """Two launches of `csrc/factored_adamw.cu` over a fixed list of CUDA
    [out, in] leaves with a factored ν: fp32 or bf16 parameters (all
    alike), first moments of their shape (fp32 or bf16, all alike), fp32
    factors vr [in] and vc [out], all contiguous and 16-byte aligned.
    `shapes` are the whole weights' (out, in), whose dims divide the sums;
    `sums` one hook a leaf (None: no rank splits it), as `factor_moments`
    takes. Without hooks the first launch finishes the factors itself;
    with any, it stops at the local sums, which `factor_moments` finishes
    between the launches. Raises on anything the kernel does not take."""

    def __init__(self, params: Sequence[torch.Tensor],
                 moments_m: Sequence[torch.Tensor],
                 factors_r: Sequence[torch.Tensor],
                 factors_c: Sequence[torch.Tensor],
                 shapes: Sequence[Tuple[int, int]], lrs: Sequence[float],
                 wds: Sequence[float], b1: float, b2: float, eps: float,
                 sums: Optional[Sequence] = None):
        dev = params[0].device
        pdt, mdt = params[0].dtype, moments_m[0].dtype
        for dt, what in ((pdt, "parameters"), (mdt, "moments")):
            if dt not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{what} must be fp32 or bf16, got {dt}")
        self.sums = list(sums) if sums is not None else [None] * len(params)
        self.partial = any(s is not None for s in self.sums)
        for p, m, vr, vc in zip(params, moments_m, factors_r, factors_c):
            if p.device != dev or p.dtype != pdt:
                raise TypeError("the factored kernel takes parameters of one "
                                f"dtype on one device, got {p.dtype} on "
                                f"{p.device}")
            if p.dim() != 2:
                raise ValueError(f"factored leaves are 2-D, got {p.shape}")
            if m.dtype != mdt or m.shape != p.shape:
                raise ValueError("moments must match their parameter")
            if vr.dtype != torch.float32 or vc.dtype != torch.float32 \
                    or vr.shape != p.shape[1:] or vc.shape != p.shape[:1]:
                raise ValueError("factors must be fp32 [in] and [out]")
            for t in (p, m, vr, vc):
                if t.device != dev or not t.is_contiguous() \
                        or t.data_ptr() % 16:
                    raise ValueError("leaves must be contiguous and 16-byte "
                                     "aligned on one device")
            if p.numel() == 0 and not self.partial:
                raise ValueError("an empty leaf is only a shard's")
        lib = _factored_library()
        rows, cols = (lib.factored_adamw_geometry(0),
                      lib.factored_adamw_geometry(1))
        offs, dims = [], []
        size = tickets = tiles = 0
        for p in params:
            n_out, n_in = p.shape
            n_rb, n_cb = _build.cdiv(n_out, rows), _build.cdiv(n_in, cols)
            offs.append([size, size + n_rb * n_in])
            size += n_rb * n_in + n_cb * n_out
            dims.append([n_out, n_in, n_rb, n_cb, tickets, tiles])
            tickets += n_cb + n_rb + 1
            tiles += n_rb * n_cb
        self.local_sums = size  # the local row and col sums of each leaf
        for k, p in enumerate(params):
            if self.partial:
                offs[k] += [size, size + p.shape[1]]
                size += sum(p.shape)
            else:
                offs[k] += [0, 0]
        self.denom = size
        self.ws_size = size + len(params)
        if pdt == torch.bfloat16:  # wd·p is a bf16 product
            wds = [float(torch.tensor(wd, dtype=pdt)) for wd in wds]

        def dev_tensor(values, dtype):
            return torch.tensor(values, dtype=dtype).to(dev)

        self.device, self.dtype = dev, pdt
        self.moments_bf16 = mdt == torch.bfloat16
        self.n_leaves, self.n_tiles = len(params), tiles
        self.shapes = [tuple(s) for s in shapes]
        self.local_shapes = [p.shape for p in params]
        self.vr, self.vc = list(factors_r), list(factors_c)
        self.offs = offs
        self.b1, self.b2, self.eps = b1, b2, eps
        self.tables = (
            dev_tensor([t.data_ptr() for q in zip(params, moments_m,
                                                  factors_r, factors_c)
                        for t in q], torch.int64),
            dev_tensor(offs, torch.int64), dev_tensor(dims, torch.int32),
            dev_tensor([[lr, wd, float(s[0]), float(s[1])]
                        for lr, wd, s in zip(lrs, wds, shapes)],
                       torch.float32))
        # zero between launches: each finisher resets its own
        self.tickets = torch.zeros(tickets, dtype=torch.int32, device=dev)

    def __call__(self, grads: Sequence[torch.Tensor], lr_t: float, bc1: float,
                 bc2: float) -> None:
        """Update every leaf and its factors in place from `grads` (in the
        parameters' dtype and shape, one per leaf, in order)."""
        if len(grads) != self.n_leaves:
            raise ValueError(f"{len(grads)} grads for {self.n_leaves} leaves")
        for g, shape in zip(grads, self.local_shapes):
            if g.device != self.device or g.dtype != self.dtype \
                    or g.shape != shape:
                raise ValueError(f"grads must be {self.dtype} on "
                                 f"{self.device} in their leaf's shape")
        grads = [_aligned(g) for g in grads]
        g_ptrs = _upload([g.data_ptr() for g in grads], torch.int64,
                         self.device)
        scalars = _upload([lr_t, bc1, bc2], torch.float32, self.device)
        ws = torch.empty(self.ws_size, dtype=torch.float32,
                         device=self.device)

        def f32(x: float) -> float:
            return float(np.float32(x))

        lib = _factored_library()
        tables = [t.data_ptr() for t in self.tables]
        bf16 = int(self.dtype == torch.bfloat16)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            if self.partial:  # an empty shard's sums are 0
                ws[self.local_sums:self.denom].zero_()
            if self.n_tiles:
                _build.check(_FACTORED_LIB, lib.factored_adamw_sums(
                    *tables, self.n_leaves, self.denom, g_ptrs.data_ptr(),
                    ws.data_ptr(), self.tickets.data_ptr(), self.n_tiles,
                    f32(self.b2), f32(1.0 - self.b2), int(self.partial), bf16,
                    stream))
            if self.partial:
                self._finish(ws)
            if self.n_tiles:
                _build.check(_FACTORED_LIB, lib.factored_adamw_apply(
                    *tables, self.n_leaves, self.denom, g_ptrs.data_ptr(),
                    ws.data_ptr(), scalars.data_ptr(), self.n_tiles,
                    f32(self.b1), f32(1.0 - self.b1), f32(self.eps), bf16,
                    int(self.moments_bf16), stream))
                FactoredAdamW.launches += 2

    def _finish(self, ws: torch.Tensor) -> None:
        """The factors and denom from the local sums that the first launch
        left in `ws`, summed over the ranks by each leaf's hook."""
        for k, (vr, vc, shape, sums) in enumerate(zip(
                self.vr, self.vc, self.shapes, self.sums)):
            ro, co = self.offs[k][2:]
            vr2, vc2, denom = factor_moments(
                vr, vc, ws[ro:ro + vr.numel()], ws[co:co + vc.numel()],
                self.b2, shape, sums)
            vr.copy_(vr2)
            vc.copy_(vc2)
            ws[self.denom + k:self.denom + k + 1].copy_(denom)

    launches = 0  # kernel launches, over every instance
