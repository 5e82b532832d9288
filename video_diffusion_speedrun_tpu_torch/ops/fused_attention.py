"""Fused RoPE + flash attention over the flat [B, L, H·D] layout.

Port of `ops/fused_attention.py`: the short, long and ring (context-
parallel) paths.

Short path (kv ≤ SHORT_MAX_KV): `_forward_short_qkv` (self-attention, q/k
read from the fused qkv projection, RoPE in the kernel) and `_forward_short`
(RoPE off: cross-attention), with their backward `_backward_short_qkv` /
`_backward_short`. On a CUDA tensor they launch the hand-written kernels
`csrc/short_attention_fwd.cu` and `csrc/short_attention_bwd.cu`; on a CPU
tensor they run the plain twins `short_attention_plain` and
`short_attention_bwd_plain`, which keep the kernels' rounding points.

Long path (kv > SHORT_MAX_KV): `_forward` and `_backward` on the
pre-rotated arity the JAX package takes there (`_preroted_flash`): q and k
rotate once per layer (`rotate_flat`, plain torch as the JAX XLA pass), then
`csrc/long_attention_fwd.cu` and `csrc/long_attention_bwd.cu` (twins
`long_attention_plain` and `long_attention_bwd_plain`) attend over the whole
kv in one launch, the ragged last kv tile masked. Where JAX splits off a
thin prefix because L does not tile into its 1024-row blocks
(`_split_prefix`: 8208 = 16 registers + 8·1024) and folds it back in with
`_forward_tail` / `_backward_tail`, the H100 kernels stream every kv
column, the prefix included, through one online softmax in 128-row tiles.
`split_attention_plain` and `split_attention_bwd_plain` keep JAX's split
decomposition in plain torch, to hold the one launch against it.

The public entries are `torch.autograd.Function`s and dispatch as JAX does:
`qkv_rope_flash_attention` (short), `rope_flash_attention` and
`norope_flash_attention` (short when ceil(Lk/128)·128 ≤ SHORT_MAX_KV, else
long), `cross_flash_attention` (short only; it raises past it). On a CUDA
tensor each launches its kernel or raises; on a CPU tensor it runs the twin.

Ring path (context parallelism, `cp_rope_flash_attention`): the token
axis is split into cp chunks of ⌈L/(cp·16)⌉·16 rows, padded at the tail and
masked there by an additive fp32 kv-bias (0 / −1e30). `_RingFlash` runs cp
ring steps: each rank's q attends the kv chunk at hand
(`ring_chunk_forward`: `csrc/ring_attention_fwd.cu` up to
_RING_FULLK_MAX_FWD kv rows, else the long kernel with the bias; twin
`ring_chunk_plain`), merges it into the running result (`online_merge`),
and hands its chunk on (`ring.shift`, `parallel/ring.py`). The backward
runs the ring again from the merged o and lse (`ring_chunk_backward`:
`csrc/ring_attention_bwd.cu` up to _RING_FULLK_MAX_BWD, else the long
backward with the bias; twin `ring_chunk_bwd_plain`); dk/dv travel with
their chunk in fp32 and come home after one last shift.

Head h of q, k and v lives in columns [h·D, (h+1)·D). The self-attention
entry reads q at column h·D and k at column (H+h)·D of qkv through strides;
the cross entry reads k/v as strided column views of the (2, h, d)-laid-out
context projection. Neither copies a slice.

Outputs kept across a checkpoint's recompute (the remat policies "attn"
and "dots_attn"; JAX names o and lse with `_name_attn_residuals`,
:57-68, and saves them by name): `keep_attention_contexts` gives the
`context_fn` pair of one `torch.utils.checkpoint` call. Under the first
(the checkpointed forward) each Function records its (o, lse) in call
order; under the second (the recompute in the backward) each hands them
back in the same order and launches nothing (for the ring: no chunk
kernel, merge or shift). Everything else a Function saves is recomputed,
`_LongFlash`'s rotated q and k included. A replay whose record is missing
or belongs to another Function or shape raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from video_diffusion_speedrun_tpu_torch.ops import _build

# the JAX package's short-path limit on the kv length; longer kv takes the
# long path
SHORT_MAX_KV = 2048
_LOG2E = 1.4426950408889634  # the softmax runs in the exp2 domain
_LIB = "short_attention_fwd"
_LIB_BWD = "short_attention_bwd"
_LIB_LONG = "long_attention_fwd"
_LIB_LONG_BWD = "long_attention_bwd"
_LIB_RING = "ring_attention_fwd"
_LIB_RING_BWD = "ring_attention_bwd"

# the JAX long path's tiling, which decides where it splits off a prefix
DEFAULT_BLOCK = 1024  # DEFAULT_BLOCK_Q == DEFAULT_BLOCK_K
_SPLIT_MAX_PFX = 768
_ALIGN = 16
_TAIL_MAX = 128
_MAX_DQ_PARTIALS = 16
# ring chunks with more kv rows than these take the long kernels with the
# kv-bias (`_RING_FULLK_MAX_FWD` / `_BWD`, fused_attention.py:1181-1182).
# On the TPU they are a VMEM limit (the whole chunk's k/v, and the fp32
# dk/dv scratch, stay resident); the H100 kernels stream kv and have no
# such limit, but the ceilings decide where the port rounds as the long
# path instead of the ring kernels, so they stay JAX's (unifying them is an
# option: the ROADMAP note on the ring ceilings)
_RING_FULLK_MAX_FWD = 4096
_RING_FULLK_MAX_BWD = SHORT_MAX_KV
# q rows of the backward kernel's tiles and kv rows of its blocks (BM, BN of
# `csrc/attention_bwd.cuh`), which size its scratch
_BWD_BQ = 64
_BWD_BN = 128
_NEG_INF = -1e30  # the kv-bias of padded ring rows, as JAX's
# q rows per chunk of the long twins: a [B, H, rows, Lk] fp32 logits tile
# at a time (1 GB at B=2, H=16, Lk=8208) instead of the whole [Lq, Lk]
_TWIN_ROWS = 1024


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """y = [x1·c + x2·s, −x1·s + x2·c] over the last dim, fp32 in and out."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos + x2 * sin, -x1 * sin + x2 * cos], dim=-1)


def _rope_rotate_t(x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """The transpose (= inverse) rotation, dy → dx, fp32 in and out."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rotate_flat(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                num_heads: int, transpose: bool = False) -> torch.Tensor:
    """`_rotate_flat`: RoPE over the flat [B, L, H·D] layout (head h's pair
    halves at columns [h·D, h·D + D/2) and [h·D + D/2, (h+1)·D)); cos/sin
    [L, D/2]. fp32 math on the input, rounded back to its dtype. With
    `transpose` the inverse rotation, which takes dq/dk back."""
    b, l, hd = x.shape
    d = hd // num_heads
    xr = x.reshape(b, l, num_heads, 2, d // 2).float()
    x1, x2 = xr[:, :, :, 0], xr[:, :, :, 1]
    c, s = cos[None, :l, None, :], sin[None, :l, None, :]
    if transpose:
        y1, y2 = x1 * c - x2 * s, x1 * s + x2 * c
    else:
        y1, y2 = x1 * c + x2 * s, -x1 * s + x2 * c
    return torch.stack([y1, y2], dim=3).reshape(b, l, hd).to(x.dtype)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, H·D] → [B, H, L, D] fp32."""
    b, l, hd = t.shape
    return t.reshape(b, l, h, hd // h).transpose(1, 2).float()


def _flat(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, D] → [B, L, H·D] in `dtype`."""
    b, h, l, d = t.shape
    return t.to(dtype).transpose(1, 2).reshape(b, l, h * d)


def ring_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cos_q: Optional[torch.Tensor],
                     sin_q: Optional[torch.Tensor],
                     cos_k: Optional[torch.Tensor],
                     sin_k: Optional[torch.Tensor],
                     kbias: Optional[torch.Tensor], num_heads: int,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' plain twin (`_ring_fwd_kernel`, and
    `_fwd_short_kernel` with one table and no bias). q [B, Lq, H·D], k/v
    [B, Lk, H·D] (strided views allowed); q rotates by cos_q/sin_q
    [≥ Lq, D/2] and k by cos_k/sin_k [≥ Lk, D/2] (None: no RoPE); kbias
    [Lk] fp32 joins the logits (None: no bias).

    Returns o [B, Lq, H·D] in v's dtype and the exp2-domain lse [B, H, Lq]
    fp32. q and k rotate in fp32, q takes scale·log2e, both round to v's
    dtype; logits and the row sum are fp32, p rounds to v's dtype for PV. A
    row whose every logit carries the −1e30 bias gets lse ≈ −1e30 and a
    finite o."""
    lq, lk = q.shape[1], k.shape[1]
    h = num_heads
    dt = v.dtype
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    if cos_q is not None:
        qh = _rope_rotate(qh, cos_q[:lq], sin_q[:lq])
        kh = _rope_rotate(kh, cos_k[:lk], sin_k[:lk])
    qh = (qh * (scale * _LOG2E)).to(dt).float()
    kh = kh.to(dt).float()
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if kbias is not None:
        s = s + kbias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(dt).float(), vh)
    return _flat(acc / l, dt), (m + torch.log2(l)).squeeze(-1)


def short_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cos: Optional[torch.Tensor],
                          sin: Optional[torch.Tensor], num_heads: int,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The short kernel's plain twin: `ring_chunk_plain` with one table
    cos/sin [L, D/2] for q and k (None: no RoPE) and no bias."""
    return ring_chunk_plain(q, k, v, cos, sin, cos, sin, None, num_heads,
                            scale)


def ring_chunk_bwd_plain(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias, o, lse,
                         do, num_heads: int, scale: float):
    """The backward kernels' plain twin (`_ring_bwd_kernel`, and
    `_bwd_short_kernel` with one table and no bias): (dq, dk, dv) in the
    dtypes of q, k and v, from o [B, Lq, H·D] and the exp2-domain lse
    [B, H, Lq] — on the ring the MERGED ones — and the output gradient do.
    Rotated q and k round to v's dtype as qs = q·scale·log2e, qd = q·scale,
    kc = k, kd = k·scale; p = exp2(qs·kcᵀ + bias − lse) and δ = rowsum(do ⊙
    o) stay fp32, p rounds for dv = pᵀ·do, ds = p·(dp − δ) rounds for
    dq = ds·kd and dk = dsᵀ·qd, which rotate back by R_qᵀ and R_kᵀ in fp32."""
    lq, lk = q.shape[1], k.shape[1]
    h = num_heads
    dt = v.dtype
    qh, kh, vh, doh = (_heads(t, h) for t in (q, k, v, do))
    if cos_q is not None:
        qh = _rope_rotate(qh, cos_q[:lq], sin_q[:lq])
        kh = _rope_rotate(kh, cos_k[:lk], sin_k[:lk])
    qs = (qh * (scale * _LOG2E)).to(dt).float()
    qd = (qh * scale).to(dt).float()
    kc = kh.to(dt).float()
    kd = (kh * scale).to(dt).float()
    delta = (doh * _heads(o, h)).sum(dim=-1, keepdim=True)
    s = torch.matmul(qs, kc.transpose(-1, -2))
    if kbias is not None:
        s = s + kbias
    p = torch.exp2(s - lse[..., None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, kd)
    dk = torch.matmul(ds.transpose(-1, -2), qd)
    if cos_q is not None:
        dq = _rope_rotate_t(dq, cos_q[:lq], sin_q[:lq])
        dk = _rope_rotate_t(dk, cos_k[:lk], sin_k[:lk])
    return _flat(dq, q.dtype), _flat(dk, k.dtype), _flat(dv, dt)


def short_attention_bwd_plain(q, k, v, cos, sin, o, lse, do, num_heads: int,
                              scale: float):
    """The short backward kernel's plain twin: `ring_chunk_bwd_plain` with
    one table for q and k (None: no RoPE) and no bias."""
    return ring_chunk_bwd_plain(q, k, v, cos, sin, cos, sin, None, o, lse, do,
                                num_heads, scale)


def long_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float,
                         kbias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The long forward kernel's plain twin over PRE-ROTATED q [B, Lq, H·D]
    and k/v [B, Lk, H·D] (strided views allowed), any lengths. Returns o in
    v's dtype and the exp2-domain lse [B, H, Lq] fp32.

    The long path's rounding points (`_fwd_kernel`, fused_attention.py:
    210-213), which differ from the short path's: the logits are
    dot(q, k) of the inputs as they come, in fp32, THEN × scale·log2e (the
    short kernels fold scale·log2e into q before rounding it, so the two
    differ by about an ulp of the logits in bf16); the fp32 kv-bias row
    [Lk] (the ring's padded tail) joins the scaled logits; p rounds to v's
    dtype for PV, the row sum stays fp32. Runs over chunks of q rows, so the
    logits of L = 8208 never exist whole."""
    h = num_heads
    dt = v.dtype
    kh, vh = _heads(k, h), _heads(v, h)
    os_, lses = [], []
    for i in range(0, q.shape[1], _TWIN_ROWS):
        qh = _heads(q[:, i:i + _TWIN_ROWS], h)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * (scale * _LOG2E)
        if kbias is not None:
            s = s + kbias
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.matmul(p.to(dt).float(), vh)
        os_.append(_flat(acc / l, dt))
        lses.append((m + torch.log2(l)).squeeze(-1))
    return torch.cat(os_, dim=1), torch.cat(lses, dim=2)


def long_attention_bwd_plain(q, k, v, o, lse, do, num_heads: int,
                             scale: float,
                             kbias: Optional[torch.Tensor] = None):
    """The long backward kernel's plain twin: (dq, dk, dv) over PRE-ROTATED
    q and k, with dq and dk IN ROPED SPACE (the caller rotates them back),
    in the dtypes of q, k and v. The rounding points of `_bwd_dkv_kernel` /
    `_bwd_dq_kernel` (`:409-413`): qs = q·scale·log2e, qd = q·scale, kc = k,
    kd = k·scale, each rounded to v's dtype; p and δ = rowsum(do ⊙ o) in
    fp32; p rounds for dv = pᵀ·do, ds = p·(dp − δ) rounds for dq = ds·kd and
    dk = dsᵀ·qd. dq accumulates in fp32 over all of kv and rounds once (the
    JAX kernel stores per-kv-block dq partials in the input dtype and sums
    them). kbias [Lk] joins the logits before exp2. Runs over chunks of q
    rows, as the forward twin."""
    h = num_heads
    dt = v.dtype
    kh, vh = _heads(k, h), _heads(v, h)
    kc = kh.to(dt).float()
    kd = (kh * scale).to(dt).float()
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    dqs = []
    for i in range(0, q.shape[1], _TWIN_ROWS):
        rows = slice(i, i + _TWIN_ROWS)
        qh, doh = _heads(q[:, rows], h), _heads(do[:, rows], h)
        qs = (qh * (scale * _LOG2E)).to(dt).float()
        qd = (qh * scale).to(dt).float()
        delta = (doh * _heads(o[:, rows], h)).sum(dim=-1, keepdim=True)
        s = torch.matmul(qs, kc.transpose(-1, -2))
        if kbias is not None:
            s = s + kbias
        p = torch.exp2(s - lse[:, :, rows, None])
        dv += torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
        dp = torch.matmul(doh, vh.transpose(-1, -2))
        ds = (p * (dp - delta)).to(dt).float()
        dqs.append(_flat(torch.matmul(ds, kd), q.dtype))
        dk += torch.matmul(ds.transpose(-1, -2), qd)
    return torch.cat(dqs, dim=1), _flat(dk, k.dtype), _flat(dv, dt)


def _split_prefix(lq: int, lk: int, block: int) -> int:
    """`_split_prefix`: the prefix width r > 0 where JAX's split-prefix path
    engages — self-attention, a 16-aligned thin remainder r = L mod block,
    and a bulk of at least 2 full blocks."""
    if lq != lk:
        return 0
    r = lq % block
    if r == 0 or r % _ALIGN != 0 or r > _SPLIT_MAX_PFX:
        return 0
    if lq - r < 2 * block:
        return 0
    return r


def _use_tail(n_pfx: int, bulk: int, block: int) -> bool:
    """`_use_tail`: JAX folds thin prefixes (≤ _TAIL_MAX rows) into the
    bulk kernels when the dq-partials buffer stays small. Its dtype clause
    (bf16 only: fp32 blocks blow the TPU's VMEM budget) is a TPU limit that
    JAX's own CPU tests lift in interpret mode, so it takes no q here."""
    return n_pfx <= _TAIL_MAX and bulk // block <= _MAX_DQ_PARTIALS


def online_merge(o1, lse1, o2, lse2, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
    """`_online_merge` (fused_attention.py:1290) and the merge of
    `_tail_merge_kernel`: the exact combination of two normalised partial
    attentions o [B, L, H·D] with exp2-domain lse [B, H, L], in fp32, o
    rounded to `dtype` (default o1's). Two lse of −1e30 (a padded row that
    saw only padding) merge to a finite −1e30."""
    h = num_heads
    dtype = o1.dtype if dtype is None else dtype
    m = torch.maximum(lse1, lse2)
    w1, w2 = torch.exp2(lse1 - m)[..., None], torch.exp2(lse2 - m)[..., None]
    o = (w1 * _heads(o1, h) + w2 * _heads(o2, h)) / (w1 + w2)
    return _flat(o, dtype), m + torch.log2(w1 + w2).squeeze(-1)


def split_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float, n_pfx: int,
                          block: int = DEFAULT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's split-prefix forward over PRE-ROTATED q/k, in plain torch: the
    bulk rows attend over the bulk kv (the forward twin), then the n_pfx
    prefix columns merge in; the prefix rows attend over the whole kv.
    Where `_use_tail` holds (`_split_fwd_roped` + `_forward_tail`) the
    prefix columns take `_tail_merge_kernel`'s rounding — q·scale·log2e
    rounded before the product — and merge unrounded; otherwise
    (`_split_fwd`) they are one more long forward whose bf16 output
    `_online_merge` combines. Returns (o, lse) as `long_attention_plain`."""
    h = num_heads
    dt = v.dtype
    qp, qm = q[:, :n_pfx], q[:, n_pfx:]
    kp, km = k[:, :n_pfx], k[:, n_pfx:]
    vp, vm = v[:, :n_pfx], v[:, n_pfx:]
    o1, lse1 = long_attention_plain(qm, km, vm, h, scale)
    if _use_tail(n_pfx, qm.shape[1], block):
        qs = (_heads(qm, h) * (scale * _LOG2E)).to(dt).float()
        st = torch.matmul(qs, _heads(kp, h).transpose(-1, -2))
        m0 = st.amax(dim=-1, keepdim=True)
        p0 = torch.exp2(st - m0)
        l0 = p0.sum(dim=-1, keepdim=True)
        o2 = _flat(torch.matmul(p0.to(dt).float(), _heads(vp, h)) / l0,
                   torch.float32)
        lse2 = (m0 + torch.log2(l0)).squeeze(-1)
    else:
        o2, lse2 = long_attention_plain(qm, kp, vp, h, scale)
    o_m, lse_m = online_merge(o1, lse1, o2, lse2, h, dt)
    o_p, lse_p = long_attention_plain(qp, k, v, h, scale)
    return torch.cat([o_p, o_m], dim=1), torch.cat([lse_p, lse_m], dim=2)


def split_attention_bwd_plain(q, k, v, o, lse, do, num_heads: int,
                              scale: float, n_pfx: int):
    """JAX's split-prefix backward (`_split_bwd_roped` + `_backward_tail`)
    in plain torch, over PRE-ROTATED q/k; dq and dk in roped space. Each q
    range takes the global (merged) o and lse of its rows, so the bulk
    rows' backward over [prefix ⊕ bulk] kv gives their exact dq with the
    prefix columns' terms and their dk/dv part for both kv ranges (the
    prefix terms of `_bwd_dkv_kernel_tail`); the prefix rows' backward over
    the whole kv gives the rest. The two dk/dv parts round to k's and v's
    dtype each and sum in fp32, as JAX sums them."""
    n = n_pfx
    dq_p, dk_p, dv_p = long_attention_bwd_plain(
        q[:, :n], k, v, o[:, :n], lse[:, :, :n], do[:, :n], num_heads, scale)
    dq_m, dk_m, dv_m = long_attention_bwd_plain(
        q[:, n:], k, v, o[:, n:], lse[:, :, n:], do[:, n:], num_heads, scale)
    dk = (dk_p.float() + dk_m.float()).to(k.dtype)
    dv = (dv_p.float() + dv_m.float()).to(v.dtype)
    return torch.cat([dq_p, dq_m], dim=1), dk, dv


def _library(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_F = ctypes.c_float


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if t.dim() != 3 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be [B, L, H·D] with unit column stride")
    if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides and start must allow 16-byte loads")


def _check_qkv(q, k, v, num_heads: int) -> None:
    """What every attention kernel refuses: head_dim other than 64/128,
    mismatched k/v, non-bf16 or misaligned operands."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    if d not in (64, 128) or d * num_heads != hd:
        raise ValueError(f"the CUDA attention kernels take head_dim 64 or "
                         f"128, got {hd}/{num_heads}")
    if k.shape != (b, lk, hd) or v.shape != (b, lk, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)


def _check_table(name: str, t: torch.Tensor, rows: int, d: int,
                 device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or not t.is_contiguous() or t.dim() != 2 or t.shape[0] < rows
            or t.shape[1] != d // 2):
        raise ValueError(f"{name} must be contiguous fp32 "
                         f"[>= {rows}, {d // 2}] on {device}")


def _check_kbias(kbias: Optional[torch.Tensor], lk: int, device) -> None:
    if kbias is not None and (
            kbias.device != device or kbias.dtype != torch.float32
            or not kbias.is_contiguous() or tuple(kbias.shape) != (lk,)):
        raise ValueError(f"kbias must be contiguous fp32 [{lk}] on {device}")


def _check_shapes(q, k, v, cos, sin, num_heads: int) -> None:
    """What the short kernels refuse: that of `_check_qkv`, kv beyond the
    short path, and malformed RoPE tables."""
    _check_qkv(q, k, v, num_heads)
    lq, lk = q.shape[1], k.shape[1]
    d = q.shape[-1] // num_heads
    if lk > SHORT_MAX_KV:
        raise ValueError(
            f"kv length {lk} exceeds the short kernels' {SHORT_MAX_KV}; "
            "longer kv takes the long kernels (long_attention_cuda)")
    if cos is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            _check_table(name, t, max(lq, lk), d, q.device)


def short_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: Optional[torch.Tensor],
                         sin: Optional[torch.Tensor], num_heads: int,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/short_attention_fwd.cu`; same contract as the twin.
    Raises on anything the kernel does not take."""
    _check_shapes(q, k, v, cos, sin, num_heads)
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    rope = cos is not None
    o = torch.empty((b, lq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device)
    # k rotated once by the kernel's first launch, streamed by the second
    k_rot = torch.empty((b, lk, hd), dtype=k.dtype, device=k.device) \
        if rope else None
    lib = _library(_LIB, "short_attention_fwd",
                   [_P] * 8 + [_I] * 5 + [_LL] * 6 + [_F, _I, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            cos.data_ptr() if rope else None, sin.data_ptr() if rope else None,
            k_rot.data_ptr() if rope else None, o.data_ptr(), lse.data_ptr(),
            b, num_heads, lq, lk, d, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), scale * _LOG2E, int(rope),
            stream)
    _build.check(_LIB, err)
    return o, lse


def ring_attention_cuda(q, k, v, cos_q, sin_q, cos_k, sin_k,
                        kbias: torch.Tensor, num_heads: int, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/ring_attention_fwd.cu` (row 10); same contract as
    `ring_chunk_plain` with RoPE and the bias. kv up to _RING_FULLK_MAX_FWD
    rows. Raises on anything the kernel does not take."""
    _check_qkv(q, k, v, num_heads)
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    if lk > _RING_FULLK_MAX_FWD:
        raise ValueError(f"kv length {lk} exceeds the ring kernel's "
                         f"{_RING_FULLK_MAX_FWD}; the long kernel takes it")
    for name, t, rows in (("cos_q", cos_q, lq), ("sin_q", sin_q, lq),
                          ("cos_k", cos_k, lk), ("sin_k", sin_k, lk)):
        _check_table(name, t, rows, d, q.device)
    if kbias is None:
        raise ValueError("the ring kernel takes a kv-bias row")
    _check_kbias(kbias, lk, q.device)
    o = torch.empty((b, lq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device)
    k_rot = torch.empty((b, lk, hd), dtype=k.dtype, device=k.device)
    lib = _library(_LIB_RING, "ring_attention_fwd",
                   [_P] * 11 + [_I] * 5 + [_LL] * 6 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ring_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_q.data_ptr(),
            sin_q.data_ptr(), cos_k.data_ptr(), sin_k.data_ptr(),
            kbias.data_ptr(), k_rot.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, num_heads, lq, lk, d, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), scale * _LOG2E, stream)
    _build.check(_LIB_RING, err)
    return o, lse


def long_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, scale: float,
                        kbias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/long_attention_fwd.cu` over pre-rotated q/k, any
    lengths, with the kv-bias row [Lk] or without (None); same contract as
    `long_attention_plain`. Raises on anything the kernel does not take."""
    _check_qkv(q, k, v, num_heads)
    b, lq, hd = q.shape
    lk = k.shape[1]
    _check_kbias(kbias, lk, q.device)
    o = torch.empty((b, lq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device)
    lib = _library(_LIB_LONG, "long_attention_fwd",
                   [_P] * 6 + [_I] * 5 + [_LL] * 6 + [_F, _P])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.long_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kbias is None else kbias.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, num_heads, lq, lk, hd // num_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), scale * _LOG2E, stream)
    _build.check(_LIB_LONG, err)
    return o, lse


def qkv_rope_flash_forward(qkv: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           num_heads: int, scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE self-attention reading q/k from the fused projection qkv
    [B, L, 3·H·D] (feature layout (k, h, d)); v [B, L, H·D] is passed apart
    because the caller may have value-residual-mixed it. cos/sin [L, D/2].
    Returns (o [B, L, H·D], lse [B, H, L] fp32, exp2 domain)."""
    hd = qkv.shape[-1] // 3
    q, k = qkv[..., :hd], qkv[..., hd:2 * hd]
    scale = (hd // num_heads) ** -0.5 if scale is None else scale
    cos, sin = cos.float(), sin.float()
    if not qkv.is_cuda:
        return short_attention_plain(q, k, v, cos, sin, num_heads, scale)
    out = short_attention_cuda(q, k, v, cos, sin, num_heads, scale)
    qkv_rope_flash_forward.launches += 1
    return out


qkv_rope_flash_forward.launches = 0


def cross_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention without RoPE: q [B, Lq, H·D] against k/v [B, Lk, H·D]
    (the context's K/V, or q/k of a no-RoPE model). Returns (o, lse)."""
    scale = (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale
    if not q.is_cuda:
        return short_attention_plain(q, k, v, None, None, num_heads, scale)
    out = short_attention_cuda(q, k, v, None, None, num_heads, scale)
    cross_flash_forward.launches += 1
    return out


cross_flash_forward.launches = 0


def long_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: float,
                           kbias: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The long forward over pre-rotated q/k (with the ring's kv-bias row,
    or None): the kernel on CUDA tensors, the twin on CPU tensors. Returns
    (o, lse). Launches with a bias count apart, in `.bias_launches`."""
    if not q.is_cuda:
        return long_attention_plain(q, k, v, num_heads, scale, kbias)
    out = long_attention_cuda(q, k, v, num_heads, scale, kbias)
    if kbias is None:
        long_attention_forward.launches += 1
    else:
        long_attention_forward.bias_launches += 1
    return out


long_attention_forward.launches = 0
long_attention_forward.bias_launches = 0


def ring_chunk_forward(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias,
                       num_heads: int, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring step's partial attention (`_ring_chunk_fwd`, :1185): q
    [B, Lq, H·D] rotated by cos_q/sin_q against the kv chunk k/v
    [B, Lk, H·D], k rotated by cos_k/sin_k, the chunk's kv-bias [Lk].
    Returns (o, lse [B, H, Lq]). Up to _RING_FULLK_MAX_FWD kv rows the ring
    kernel (`ring_attention_cuda`, or its twin on CPU tensors); above, as
    JAX, q and k rotate once and the long kernel attends with the bias."""
    if k.shape[1] > _RING_FULLK_MAX_FWD:
        q_r = rotate_flat(q, cos_q, sin_q, num_heads)
        k_r = rotate_flat(k, cos_k, sin_k, num_heads)
        return long_attention_forward(q_r, k_r, v, num_heads, scale, kbias)
    if not q.is_cuda:
        return ring_chunk_plain(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias,
                                num_heads, scale)
    out = ring_attention_cuda(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias,
                              num_heads, scale)
    ring_chunk_forward.launches += 1
    return out


ring_chunk_forward.launches = 0


def _bwd_splits(n_blocks: int, n_q_tiles: int, n_sm: int) -> int:
    """Blocks per 128-row kv block of the backward kernel, each taking a
    share of the q tiles: the split with the fewest rounds of the card's
    SMs (one block each) times tiles per block (+1 for a block's fixed
    cost), 1 where the kv blocks alone fill the card. At most 8."""
    best, best_cost = 1, None
    for z in range(1, min(8, n_q_tiles) + 1):
        cost = _build.cdiv(n_blocks * z, n_sm) * (_build.cdiv(n_q_tiles, z) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = z, cost
    return best


def _bwd_buffers(q, k, v, o, lse, do, num_heads: int,
                 dq: Optional[torch.Tensor], dk: Optional[torch.Tensor]):
    """Checks what both backward kernels take beyond q/k/v (o, do, lse and
    given dq/dk views) and allocates the outputs and the scratch. Returns
    (do, dq, dk, dv, scratch pointers, the 16 strides)."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    dev = q.device
    do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        _check_operand(name, t, dev)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q")
    if lse.shape != (b, num_heads, lq) or not lse.is_contiguous() \
            or lse.dtype != torch.float32:
        raise ValueError("lse must be contiguous fp32 [B, H, Lq]")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if dq is None else dq
    dk = torch.empty_like(k, memory_format=torch.contiguous_format) \
        if dk is None else dk
    dv = torch.empty((b, lk, hd), dtype=v.dtype, device=dev)
    for name, t, ref in (("dq", dq, q), ("dk", dk, k)):
        _check_operand(name, t, dev)
        if t.shape != ref.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match")
    # qs, qd [B, H, Lq, D] and kc, kd [B, H, Lk, D] bf16; δ and lse rows
    # [B·H, 2, Lq padded to whole q tiles] and the dq accumulator (its
    # tiles of 64 q rows) fp32; the ticket and the turn counters of the dq
    # adds, one per (b, h, q tile) (zeroed by the launch)
    nq = _build.cdiv(lq, _BWD_BQ)
    scratch = [torch.empty((b, num_heads, n, d), dtype=torch.bfloat16,
                           device=dev) for n in (lq, lq, lk, lk)]
    scratch.append(torch.empty((b * num_heads, 2, nq * _BWD_BQ),
                               dtype=torch.float32, device=dev))
    scratch.append(torch.empty((b * num_heads, nq * _BWD_BQ, d),
                               dtype=torch.float32, device=dev))
    scratch.append(torch.empty(1 + b * num_heads * nq, dtype=torch.int32,
                               device=dev))
    # where the kv blocks leave SMs idle, each kv block's q tiles are split
    # over `splits` blocks, whose dk, dv partials [splits, 2, B·H, Lk, D]
    # fp32 a last kernel sums in order
    splits = _bwd_splits(_build.cdiv(lk, _BWD_BN) * b * num_heads, nq,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
    scratch.append(torch.empty((splits, 2, b * num_heads, lk, d),
                               dtype=torch.float32, device=dev)
                   if splits > 1 else None)
    strides = (ctypes.c_longlong * 16)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:2]))
    return do, dq, dk, dv, scratch, splits, strides


def _scratch_args(scratch, splits: int):
    """The scratch pointers and the split count, in the order the backward
    entry points take them (the dk/dv partials, or None, then splits)."""
    return [None if t is None else t.data_ptr() for t in scratch] + [splits]


def short_attention_bwd_cuda(q, k, v, cos, sin, o, lse, do, num_heads: int,
                             scale: float, dq: Optional[torch.Tensor] = None,
                             dk: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch `csrc/short_attention_bwd.cu`; same contract as the twin.
    dq/dk may be given as [B, L, H·D] views with unit column stride (the
    column slices of one d(qkv) buffer); dv is allocated contiguous.
    Raises on anything the kernel does not take."""
    _check_shapes(q, k, v, cos, sin, num_heads)
    do, dq, dk, dv, scratch, splits, strides = _bwd_buffers(q, k, v, o, lse, do,
                                                    num_heads, dq, dk)
    rope = cos is not None
    lib = _library(_LIB_BWD, "short_attention_bwd",
                   [_P] * 16 + [_I] + [_P] * 3 + [_I] * 5
                   + [_STRIDES, _F, _F, _I, _P])
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.short_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), cos.data_ptr() if rope else None,
            sin.data_ptr() if rope else None,
            *_scratch_args(scratch, splits), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), q.shape[0], num_heads, q.shape[1], k.shape[1],
            q.shape[-1] // num_heads, strides, scale, scale * _LOG2E,
            int(rope), stream)
    _build.check(_LIB_BWD, err)
    return dq, dk, dv


def ring_attention_bwd_cuda(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias, o,
                            lse, do, num_heads: int, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch `csrc/ring_attention_bwd.cu` (row 11); same contract as
    `ring_chunk_bwd_plain` with RoPE and the bias, from the merged o and
    lse. kv up to _RING_FULLK_MAX_BWD rows. Raises on anything the kernel
    does not take."""
    _check_qkv(q, k, v, num_heads)
    lq, lk = q.shape[1], k.shape[1]
    d = q.shape[-1] // num_heads
    if lk > _RING_FULLK_MAX_BWD:
        raise ValueError(f"kv length {lk} exceeds the ring backward's "
                         f"{_RING_FULLK_MAX_BWD}; the long kernel takes it")
    for name, t, rows in (("cos_q", cos_q, lq), ("sin_q", sin_q, lq),
                          ("cos_k", cos_k, lk), ("sin_k", sin_k, lk)):
        _check_table(name, t, rows, d, q.device)
    if kbias is None:
        raise ValueError("the ring kernel takes a kv-bias row")
    _check_kbias(kbias, lk, q.device)
    do, dq, dk, dv, scratch, splits, strides = _bwd_buffers(q, k, v, o, lse, do,
                                                    num_heads, None, None)
    lib = _library(_LIB_RING_BWD, "ring_attention_bwd",
                   [_P] * 19 + [_I] + [_P] * 3 + [_I] * 5
                   + [_STRIDES, _F, _F, _P])
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ring_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(),
            cos_k.data_ptr(), sin_k.data_ptr(), kbias.data_ptr(),
            *_scratch_args(scratch, splits), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), q.shape[0], num_heads, lq, lk, d, strides, scale,
            scale * _LOG2E, stream)
    _build.check(_LIB_RING_BWD, err)
    return dq, dk, dv


def long_attention_bwd_cuda(q, k, v, o, lse, do, num_heads: int,
                            scale: float,
                            kbias: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch `csrc/long_attention_bwd.cu` over pre-rotated q/k, any
    lengths, with the kv-bias row [Lk] or without (None); same contract as
    `long_attention_bwd_plain` (dq, dk in roped space). Raises on anything
    the kernel does not take."""
    _check_qkv(q, k, v, num_heads)
    _check_kbias(kbias, k.shape[1], q.device)
    do, dq, dk, dv, scratch, splits, strides = _bwd_buffers(q, k, v, o, lse, do,
                                                    num_heads, None, None)
    lib = _library(_LIB_LONG_BWD, "long_attention_bwd",
                   [_P] * 15 + [_I] + [_P] * 3 + [_I] * 5
                   + [_STRIDES, _F, _F, _P])
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.long_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if kbias is None else kbias.data_ptr(),
            *_scratch_args(scratch, splits),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.shape[0],
            num_heads, q.shape[1], k.shape[1], q.shape[-1] // num_heads,
            strides, scale, scale * _LOG2E, stream)
    _build.check(_LIB_LONG_BWD, err)
    return dq, dk, dv


def qkv_rope_flash_backward(qkv, v, cos, sin, o, lse, do, num_heads: int,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `qkv_rope_flash_forward`: d(qkv) [B, L, 3·H·D] with its
    v columns zero, and dv for the separately passed v (as the JAX
    `_qkv_rope_flash_bwd`, `ops/fused_attention.py:952-957`). On CUDA the
    kernel writes dq and dk straight into the column slices of d(qkv)."""
    hd = qkv.shape[-1] // 3
    q, k = qkv[..., :hd], qkv[..., hd:2 * hd]
    if not qkv.is_cuda:
        dq, dk, dv = short_attention_bwd_plain(q, k, v, cos, sin, o, lse, do,
                                               num_heads, scale)
        return torch.cat([dq, dk, torch.zeros_like(dq)], dim=-1), dv
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    dqkv[..., 2 * hd:].zero_()
    _, _, dv = short_attention_bwd_cuda(q, k, v, cos, sin, o, lse, do,
                                        num_heads, scale, dq=dqkv[..., :hd],
                                        dk=dqkv[..., hd:2 * hd])
    qkv_rope_flash_backward.launches += 1
    return dqkv, dv


qkv_rope_flash_backward.launches = 0


def cross_flash_backward(q, k, v, o, lse, do, num_heads: int, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `cross_flash_forward`."""
    if not q.is_cuda:
        return short_attention_bwd_plain(q, k, v, None, None, o, lse, do,
                                         num_heads, scale)
    out = short_attention_bwd_cuda(q, k, v, None, None, o, lse, do,
                                   num_heads, scale)
    cross_flash_backward.launches += 1
    return out


cross_flash_backward.launches = 0


def long_attention_backward(q, k, v, o, lse, do, num_heads: int,
                            scale: float,
                            kbias: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Gradients (dq, dk in roped space, dv) of `long_attention_forward`;
    bias launches counted apart, in `.bias_launches`."""
    if not q.is_cuda:
        return long_attention_bwd_plain(q, k, v, o, lse, do, num_heads,
                                        scale, kbias)
    out = long_attention_bwd_cuda(q, k, v, o, lse, do, num_heads, scale,
                                  kbias)
    if kbias is None:
        long_attention_backward.launches += 1
    else:
        long_attention_backward.bias_launches += 1
    return out


long_attention_backward.launches = 0
long_attention_backward.bias_launches = 0


def ring_chunk_backward(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias, o, lse,
                        do, num_heads: int, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring step's (dq, dk, dv) (`_ring_chunk_bwd`, :1235) from the
    merged o and lse [B, H, Lq] of q's rows. Up to _RING_FULLK_MAX_BWD kv
    rows the ring kernel (`ring_attention_bwd_cuda`, or its twin on CPU
    tensors); above, as JAX, the long backward with the bias over q and k
    rotated once, dq and dk rotated back by the transpose."""
    if k.shape[1] > _RING_FULLK_MAX_BWD:
        q_r = rotate_flat(q, cos_q, sin_q, num_heads)
        k_r = rotate_flat(k, cos_k, sin_k, num_heads)
        dq, dk, dv = long_attention_backward(q_r, k_r, v, o, lse, do,
                                             num_heads, scale, kbias)
        return (rotate_flat(dq, cos_q, sin_q, num_heads, transpose=True),
                rotate_flat(dk, cos_k, sin_k, num_heads, transpose=True), dv)
    if not q.is_cuda:
        return ring_chunk_bwd_plain(q, k, v, cos_q, sin_q, cos_k, sin_k,
                                    kbias, o, lse, do, num_heads, scale)
    out = ring_attention_bwd_cuda(q, k, v, cos_q, sin_q, cos_k, sin_k, kbias,
                                  o, lse, do, num_heads, scale)
    ring_chunk_backward.launches += 1
    return out


ring_chunk_backward.launches = 0


class _Kept:
    """The (o, lse) of the attention forwards of one checkpointed call, in
    call order, each under its Function's key; `cursor`: the next one a
    replay hands back."""

    def __init__(self):
        self.entries: List[Tuple[tuple, torch.Tensor, torch.Tensor]] = []
        self.cursor = 0


class _KeepMode:
    """Records into `kept` (the checkpointed forward) or replays from it
    (the recompute) while entered, on this thread: the recompute runs on
    the thread that runs the backward."""

    _local = threading.local()

    def __init__(self, kept: _Kept, replay: bool):
        self.kept, self.replay = kept, replay

    @classmethod
    def active(cls) -> Optional["_KeepMode"]:
        stack = getattr(cls._local, "stack", None)
        return stack[-1] if stack else None

    def __enter__(self):
        if self.replay:  # each recompute replays from the first
            self.kept.cursor = 0
        self._local.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc):
        # early stop ends a recompute with records left over: not an error
        self._local.stack.pop()
        return False


def keep_attention_contexts():
    """The `context_fn` pair of one `torch.utils.checkpoint` call that
    keeps the attention outputs (o, lse) of the checkpointed forward and
    hands them to the recompute, which then launches no attention forward
    (JAX `save_only_these_names("attn_out", "attn_lse")`)."""
    kept = _Kept()
    return _KeepMode(kept, replay=False), _KeepMode(kept, replay=True)


def _kept_or_run(key: tuple, run) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run()` → (o, lse), recorded under `key` inside a keeping forward;
    inside a replay the recorded pair, with no launch. Raises when the
    replay's record is missing or is another key's."""
    mode = _KeepMode.active()
    if mode is None:
        return run()
    kept = mode.kept
    if not mode.replay:
        o, lse = run()
        kept.entries.append((key, o.detach(), lse.detach()))
        return o, lse
    i = kept.cursor
    if i >= len(kept.entries):
        raise RuntimeError(
            f"attention replay: no kept output for forward {i} {key} of the "
            f"recompute ({len(kept.entries)} kept by the checkpointed "
            "forward)")
    want, o, lse = kept.entries[i]
    if want != key:
        raise RuntimeError(f"attention replay out of order: forward {i} of "
                           f"the recompute is {key}, the kept one {want}")
    kept.cursor = i + 1
    return o.detach(), lse.detach()


class _QKVRopeFlash(torch.autograd.Function):
    """The JAX `_qkv_rope_flash` custom_vjp: saves (qkv, v, cos, sin, o,
    lse) and differentiates qkv and v."""

    @staticmethod
    def forward(ctx, qkv, v, cos, sin, num_heads, scale):
        o, lse = _kept_or_run(
            ("qkv_rope", tuple(v.shape), num_heads),
            lambda: qkv_rope_flash_forward(qkv, v, cos, sin, num_heads,
                                           scale))
        ctx.save_for_backward(qkv, v, cos, sin, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, v, cos, sin, o, lse = ctx.saved_tensors
        dqkv, dv = qkv_rope_flash_backward(qkv, v, cos, sin, o, lse, do,
                                           ctx.num_heads, ctx.scale)
        return dqkv, dv, None, None, None, None


class _CrossFlash(torch.autograd.Function):
    """The JAX `_rope_flash` custom_vjp with RoPE off (the short path of
    `cross_flash_attention`): differentiates q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        o, lse = _kept_or_run(
            ("cross", tuple(q.shape), tuple(k.shape), num_heads),
            lambda: cross_flash_forward(q, k, v, num_heads, scale))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = cross_flash_backward(q, k, v, o, lse, do, ctx.num_heads,
                                          ctx.scale)
        return dq, dk, dv, None, None


class _LongFlash(torch.autograd.Function):
    """The JAX `_preroted_flash` custom_vjp: q and k rotate once
    (`rotate_flat`; cos None: no RoPE), the long kernel attends, and the
    ROTATED q_r, k_r are saved with v, o and lse, so the backward reuses
    them and rotates dq/dk back with the transpose."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, num_heads, scale):
        rope = cos is not None
        q_r = rotate_flat(q, cos, sin, num_heads) if rope else q
        k_r = rotate_flat(k, cos, sin, num_heads) if rope else k
        o, lse = _kept_or_run(
            ("long", tuple(q.shape), tuple(k.shape), num_heads),
            lambda: long_attention_forward(q_r, k_r, v, num_heads, scale))
        ctx.save_for_backward(q_r, k_r, v, o, lse, cos, sin)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q_r, k_r, v, o, lse, cos, sin = ctx.saved_tensors
        h = ctx.num_heads
        dq, dk, dv = long_attention_backward(q_r, k_r, v, o, lse, do, h,
                                             ctx.scale)
        if cos is not None:
            dq = rotate_flat(dq, cos, sin, h, transpose=True)
            dk = rotate_flat(dk, cos, sin, h, transpose=True)
        return dq, dk, dv, None, None, None, None


def _short_kv(lk: int) -> bool:
    """The JAX dispatch rule: kv padded to 128 rows fits the short path."""
    return -(-lk // 128) * 128 <= SHORT_MAX_KV


def qkv_rope_flash_attention(qkv: torch.Tensor, v: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """Differentiable self-attention output of `qkv_rope_flash_forward`."""
    scale = (qkv.shape[-1] // (3 * num_heads)) ** -0.5
    return _QKVRopeFlash.apply(qkv, v, cos.float(), sin.float(), num_heads,
                               scale)


def rope_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """RoPE self-attention over flat q, k, v [B, L, H·D], cos/sin [L, D/2]
    (`rope_flash_attention`, fused_attention.py:1896). Short kv takes the
    short kernel (q and k gathered into one qkv-laid-out buffer, the
    layout that kernel reads); longer kv the long path, pre-rotated."""
    cos, sin = cos.float(), sin.float()
    if _short_kv(k.shape[1]):
        return qkv_rope_flash_attention(torch.cat([q, k, v], dim=-1), v,
                                        cos, sin, num_heads)
    scale = (q.shape[-1] // num_heads) ** -0.5
    return _LongFlash.apply(q, k, v, cos, sin, num_heads, scale)


def norope_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Self-attention without RoPE (`norope_flash_attention`, :1936): the
    short kernel with RoPE off, or the long path with no rotation."""
    scale = (q.shape[-1] // num_heads) ** -0.5
    if _short_kv(k.shape[1]):
        return _CrossFlash.apply(q, k, v, num_heads, scale)
    return _LongFlash.apply(q, k, v, None, None, num_heads, scale)


def cross_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Differentiable cross-attention output of `cross_flash_forward`; the
    context's kv must fit the short path, as in JAX (`:1979-1983`)."""
    if not _short_kv(k.shape[1]):
        raise ValueError(f"cross_flash_attention: kv length {k.shape[1]} "
                         f"exceeds short-path limit {SHORT_MAX_KV}")
    scale = (q.shape[-1] // num_heads) ** -0.5
    return _CrossFlash.apply(q, k, v, num_heads, scale)


def ring_layout(length: int, cp: int) -> Tuple[int, int]:
    """(chunk, padded length) of a context-parallel split of `length`
    tokens over cp ranks: chunk = ⌈length/(cp·16)⌉·16 (fused_attention.py:
    2025-2026), padded length cp·chunk."""
    chunk = -(-length // (cp * _ALIGN)) * _ALIGN
    return chunk, chunk * cp


def ring_kbias(length: int, padded: int, device) -> torch.Tensor:
    """The fp32 kv-bias [padded] of the ring: 0 on the `length` real tokens,
    −1e30 on the padded tail (:2032)."""
    pos = torch.arange(padded, device=device)
    return torch.where(pos < length, 0.0, _NEG_INF).to(torch.float32)


def _ring_tables(cos, sin, kbias, chunk: int, i: int, j: int):
    """The table rows of rank i's q chunk and of kv chunk j, and chunk j's
    bias: contiguous slices of the full padded tables."""
    q_rows, k_rows = slice(i * chunk, (i + 1) * chunk), slice(
        j * chunk, (j + 1) * chunk)
    return (cos[q_rows], sin[q_rows], cos[k_rows], sin[k_rows],
            kbias[k_rows])


def _ring_forward(q, k, v, cos, sin, kbias, num_heads: int, scale: float,
                  ring) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward ring of `_RingFlash`: the merged (o, lse) of the ring's
    local q rows."""
    cp = ring.size
    chunk = cos.shape[0] // cp
    qs = ring.split(q)
    carry = list(zip(ring.split(k), ring.split(v)))
    outs: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * len(qs)
    for r in range(cp):
        for i, rank in enumerate(ring.ranks):
            tabs = _ring_tables(cos, sin, kbias, chunk, rank, (rank - r) % cp)
            part = ring_chunk_forward(qs[i], *carry[i], *tabs, num_heads,
                                      scale)
            outs[i] = part if outs[i] is None else online_merge(
                *outs[i], *part, num_heads)
        if r < cp - 1:
            carry = ring.shift(carry)
    return (ring.join([o for o, _ in outs]),
            ring.join([lse for _, lse in outs], dim=2))


class _RingFlash(torch.autograd.Function):
    """The JAX `_ring_attention` custom_vjp (:1314-1370) over a ring
    (`parallel/ring.py`). q, k, v are the ring's local tensors of the
    padded token axis (`ring.split` cuts them into the chunks of the ranks
    this process holds); cos/sin [lp, D/2] and kbias [lp] cover the whole
    padded axis on every rank, so each rank slices the rows of the chunk at
    hand, j = (rank − r) mod cp at ring step r, instead of receiving them
    with k/v. The forward runs cp ring steps, merging each chunk's partial
    into the running (o, lse), and saves the merged ones; the backward runs
    the ring again: dq accumulates in fp32 at home, the fp32 dk/dv travel
    with their chunk and come home after one last shift. A replay of kept
    outputs skips the whole forward ring."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, kbias, num_heads, scale, ring):
        o, lse = _kept_or_run(
            ("ring", tuple(q.shape), ring.size, num_heads),
            lambda: _ring_forward(q, k, v, cos, sin, kbias, num_heads, scale,
                                  ring))
        ctx.save_for_backward(q, k, v, cos, sin, kbias, o, lse)
        ctx.num_heads, ctx.scale, ctx.ring = num_heads, scale, ring
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin, kbias, o, lse = ctx.saved_tensors
        h, scale, ring = ctx.num_heads, ctx.scale, ctx.ring
        cp = ring.size
        chunk = cos.shape[0] // cp
        qs, os_ = ring.split(q), ring.split(o)
        # made contiguous once, not by each of the cp backward launches
        dos = [t.contiguous() for t in ring.split(do)]
        lses = [t.contiguous() for t in ring.split(lse, dim=2)]
        dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in qs]
        carry = [(kc, vc, torch.zeros(kc.shape, dtype=torch.float32,
                                      device=kc.device),
                  torch.zeros(vc.shape, dtype=torch.float32,
                              device=vc.device))
                 for kc, vc in zip(ring.split(k), ring.split(v))]
        for r in range(cp):
            for i, rank in enumerate(ring.ranks):
                kc, vc, dkc, dvc = carry[i]
                tabs = _ring_tables(cos, sin, kbias, chunk, rank,
                                    (rank - r) % cp)
                dq_r, dk_r, dv_r = ring_chunk_backward(
                    qs[i], kc, vc, *tabs, os_[i], lses[i], dos[i], h, scale)
                dq[i] += dq_r.float()
                carry[i] = (kc, vc, dkc + dk_r.float(), dvc + dv_r.float())
            if r < cp - 1:
                carry = ring.shift(carry)
        # the chunks sit one hop short of home after cp − 1 shifts
        home = ring.shift([(dkc, dvc) for _, _, dkc, dvc in carry])
        return (ring.join(dq).to(q.dtype),
                ring.join([dk for dk, _ in home]).to(k.dtype),
                ring.join([dv for _, dv in home]).to(v.dtype),
                None, None, None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         kbias: torch.Tensor, num_heads: int, ring,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable ring attention over tokens already laid out for the
    ring: q, k, v [B, n·chunk, H·D] are the ring's local tensors (all cp
    chunks for `LocalRing`, this rank's for `DistRing`), cos/sin [lp, D/2]
    and kbias [lp] (`ring_kbias`) the whole padded axis. The DiT calls this
    with its tokens padded once per forward."""
    scale = (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale
    return _RingFlash.apply(q, k, v, cos.float(), sin.float(), kbias,
                            num_heads, scale, ring)


def cp_rope_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor,
                            num_heads: int, ring,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Context-parallel RoPE attention (`cp_rope_flash_attention`, :1992)
    over whole-sequence q, k, v [B, L, H·D] and cos/sin [L, D/2]: pads the
    token axis to lp = cp·chunk, masks the tail with the kv-bias, keeps the
    ring's local chunks, runs `ring_flash_attention`, gathers the chunks
    back (`ring.gather`; its backward keeps this rank's rows) and drops the
    pad. Returns [B, L, H·D]."""
    lq = q.shape[1]
    _, lp = ring_layout(lq, ring.size)
    kbias = ring_kbias(lq, lp, q.device)

    def pad(t):
        return F.pad(t, (0, 0, 0, lp - lq))

    cos, sin = pad(cos.float()), pad(sin.float())
    o = ring_flash_attention(*(ring.local(pad(t)) for t in (q, k, v)), cos,
                             sin, kbias, num_heads, ring, scale)
    return ring.gather(o)[:, :lq]
