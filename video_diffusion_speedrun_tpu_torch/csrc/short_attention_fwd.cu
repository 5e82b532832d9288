// Short-path attention forward with RoPE, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_short_kernel`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:732), reached from
// `_forward_short_qkv` (:813, RoPE self-attention reading q/k from the fused
// qkv projection) and `_forward_short` (:757, RoPE off: cross-attention).
//
// What it computes, what bounds it and how the kernel is laid out:
// `attention_fwd.cuh`, which holds it and which the ring path's
// `ring_attention_fwd.cu` shares. This file is the entry point for the
// short path: ROPE on (self-attention, q/k strided out of qkv, one table
// for both) or off (cross-attention), no kv-bias, kv ≤ SHORT_MAX_KV as the
// dispatch gives it.

#include "attention_fwd.cuh"

// q [B, Lq, H·D], k/v [B, Lk, H·D] bf16 with unit column stride and the
// given batch/row strides (in elements). With rope != 0: cos/sin
// [max(Lq, Lk), D/2] fp32 contiguous, and k_rot a [B, Lk, H·D] bf16 scratch
// for the rotated k. o [B, Lq, H·D] bf16 and lse [B, H, Lq] fp32
// contiguous. q_mul = scale·log2e. Returns the cudaError_t of the launches.
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* cos_t, const void* sin_t,
                                   void* k_rot, void* o, void* lse, int B,
                                   int H, int Lq, int Lk, int D,
                                   long long q_sb, long long q_sl,
                                   long long k_sb, long long k_sl,
                                   long long v_sb, long long v_sl,
                                   float q_mul, int rope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD, RR)                                                   \
  if (D == DD && (rope != 0) == RR)                                          \
  return static_cast<int>(launch_attention_fwd<DD, RR ? Q_ROPE : Q_SCALE,   \
                                                false>(                      \
      q, k, v, cos_t, sin_t, cos_t, sin_t, nullptr, k_rot, o, lse, B, H, Lq, \
      Lk, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, q_mul, s))
  VDS_LAUNCH(128, true);
  VDS_LAUNCH(128, false);
  VDS_LAUNCH(64, true);
  VDS_LAUNCH(64, false);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* short_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
