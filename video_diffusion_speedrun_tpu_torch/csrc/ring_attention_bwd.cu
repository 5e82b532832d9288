// Ring-chunk attention backward (context parallelism), for Hopper (sm_90a).
//
// Replaces the Pallas function `_ring_chunk_bwd`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:1235, kernel
// `_ring_bwd_kernel` :1129): one ring step's dq, dk and dv, this rank's q
// rows against one kv chunk that came around the ring, from the MERGED
// (global) o and lse of those rows — so the chunk's p = exp2(s − lse) is
// its exact share of the softmax and the partial gradients sum to the
// full ones. The caller adds dq over the ring steps and carries dk/dv in
// fp32 with the chunk, home after one last shift.
//
// What it computes (per (b, h)), with `_ring_bwd_kernel`'s rounding points:
// q rotated by the local rows' tables and k by the chunk's, in fp32;
// qs = bf16(q·scale·log2e), qd = bf16(q·scale), kc = bf16(k),
// kd = bf16(k·scale); s = qs·kcᵀ + bias (fp32 kv row, 0 or −1e30);
// p = exp2(s − lse); δ = rowsum(do ⊙ o) of the merged o; dv = bf16(p)ᵀ·do;
// ds = bf16(p·(do·vᵀ − δ)); dq = ds·kd rotated back by R_qᵀ, dk = dsᵀ·qd
// rotated back by R_kᵀ, stored bf16.
//
// What bounds it on the card: 10·B·H·Lq·Lk·D useful tensor flops against a
// few bytes per element of q, k, v, o, do: compute-bound at the train chunk
// (B=2, H=4, 1040 × 1040). The design is the shared one-pass backward of
// `attention_bwd.cuh` (a prologue that rotates and rounds q and k once, one
// block per 128 kv rows that keeps dk/dv in registers and adds its dq
// partials in kv-block order, deterministic), instantiated with ROPE on,
// separate q and k tables and the BIAS row. The TPU kernel carries dk/dv in
// VMEM across its q grid and so holds the whole chunk, which caps it at
// 2048 kv rows (`_RING_FULLK_MAX_BWD`, a VMEM limit); here nothing is sized
// by Lk, and the 2048 is only the dispatch rule that keeps the port's
// fallback points (the long backward with the bias) where JAX has them.

#include "attention_bwd.cuh"

// q [B, Lq, H·D], k/v [B, Lk, H·D], o/do [B, Lq, H·D] bf16 with unit column
// stride; `strides` holds 16 int64: the (batch, row) strides in elements of
// q, k, v, o, do, dq, dk, dv in that order. lse [B, H, Lq] fp32 (exp2
// domain, merged over the ring). cos_q/sin_q [Lq, D/2] and cos_k/sin_k
// [Lk, D/2] fp32 contiguous (slices of the full tables); kbias [Lk] fp32.
// Scratch: qs/qd [B, H, Lq, D] and kc/kd [B, H, Lk, D] bf16, rows
// [B·H, 2, Lqp] (δ, lse) and dq_acc [B·H, Lqp, D] fp32, sync
// 1 + B·H·⌈Lq/64⌉ int32 (Lqp = ⌈Lq/64⌉·64); with splits > 1,
// dkv_part [splits][2][B·H, Lk, D] fp32.
// Outputs dq, dk, dv bf16 with unit column stride. q_mul = scale·log2e.
// Returns the cudaError_t of the launches.
extern "C" int ring_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, const void* cos_q,
                                  const void* sin_q, const void* cos_k,
                                  const void* sin_k, const void* kbias,
                                  void* qs, void* qd, void* kc, void* kd,
                                  void* rows, void* dq_acc, void* sync,
                                  void* dkv_part, int splits, void* dq,
                                  void* dk, void* dv, int B, int H,
                                  int Lq, int Lk, int D,
                                  const long long* strides, float scale,
                                  float q_mul, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD)                                                         \
  if (D == DD)                                                                 \
  return static_cast<int>(launch_attention_bwd<DD, true, true>(                \
      q, k, v, o, dout, lse, cos_q, sin_q, cos_k, sin_k, kbias, qs, qd, kc,    \
      kd, rows, dq_acc, sync, dkv_part, splits, dq, dk, dv, B, H, Lq, Lk,      \
      strides, scale, q_mul, s))
  VDS_LAUNCH(128);
  VDS_LAUNCH(64);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ring_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
