// Short-path attention backward, with or without RoPE, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_short_kernel`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:982), reached from
// `_backward_short_qkv` (:873, RoPE self-attention, q/k read from the fused
// qkv projection) and `_backward_short` (:1042, RoPE off: cross-attention).
// One template, ROPE on or off, serves both.
//
// What it computes, what bounds it and how the prologue, the one-pass
// kernel and the dq epilogue are laid out: `attention_bwd.cuh`, which holds
// them and which `long_attention_bwd.cu` and `ring_attention_bwd.cu` share.
// This file is the entry point for the short path: ROPE on (self-attention,
// q/k strided out of qkv, one table for both) or off (cross-attention), no
// kv-bias, kv ≤ SHORT_MAX_KV as the dispatch gives it.

#include "attention_bwd.cuh"

// q [B, Lq, H·D], k/v [B, Lk, H·D], o/do [B, Lq, H·D] bf16 with unit column
// stride; `strides` holds 16 int64: the (batch, row) strides in elements of
// q, k, v, o, do, dq, dk, dv in that order. lse [B, H, Lq] fp32 (exp2
// domain, from the forward). With rope != 0, cos/sin [max(Lq, Lk), D/2]
// fp32 contiguous. Scratch: qs/qd [B, H, Lq, D] and kc/kd [B, H, Lk, D]
// bf16, rows [B·H, 2, Lqp] (δ, lse) and dq_acc [B·H, Lqp, D] fp32, sync
// 1 + B·H·⌈Lq/64⌉ int32 (Lqp = ⌈Lq/64⌉·64); with splits > 1,
// dkv_part [splits][2][B·H, Lk, D] fp32 (splits: blocks per kv block, each
// taking a share of the q tiles). Outputs dq, dk, dv bf16 with unit column
// stride. q_mul = scale·log2e. Returns the cudaError_t of the launches.
extern "C" int short_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, const void* cos_t,
                                   const void* sin_t, void* qs, void* qd,
                                   void* kc, void* kd, void* rows,
                                   void* dq_acc, void* sync,
                                   void* dkv_part, int splits, void* dq,
                                   void* dk, void* dv, int B, int H, int Lq,
                                   int Lk, int D, const long long* strides,
                                   float scale, float q_mul, int rope,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD, RR)                                                   \
  if (D == DD && (rope != 0) == RR)                                          \
  return static_cast<int>(launch_attention_bwd<DD, RR, false>(               \
      q, k, v, o, dout, lse, cos_t, sin_t, cos_t, sin_t, nullptr, qs, qd,    \
      kc, kd, rows, dq_acc, sync, dkv_part, splits, dq, dk, dv, B, H, Lq,    \
      Lk, strides, scale, q_mul, s))
  VDS_LAUNCH(128, true);
  VDS_LAUNCH(128, false);
  VDS_LAUNCH(64, true);
  VDS_LAUNCH(64, false);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* short_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
