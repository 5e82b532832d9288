// Long-path attention backward over pre-rotated q/k, for Hopper (sm_90a).
//
// Replaces the Pallas function `_backward`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:534) on the arities
// the port takes: q and k arrive rotated (`_preroted_flash`, :1812 —
// kernels `_bwd_dkv_kernel_noro` (:363) and `_bwd_dq_kernel_noro` (:466),
// body `_bwd_dkv_kernel` (:376-452) and `_bwd_dq_kernel` (:477-526)), with
// or without the additive kv-bias row (`has_bias`, :417-418, 507-508), which
// the ring path's fallback for chunks above 2048 kv rows passes
// (`_ring_chunk_bwd`, :1240-1245). dq and dk come out in ROPED space; the
// caller rotates them back (`_rotate_flat`, transpose).
//
// In the same launch it computes what the TPU splits off at lengths such
// as 8208 = 16 + 8·1024 that do not tile into its 1024-row blocks:
// `_backward_tail` (:1596, `_bwd_dkv_kernel_tail` :1511) adds the 16
// prefix columns' terms to the bulk's dq and emits the prefix rows' dk/dv.
// Here every 128-row kv block, the ragged last one masked, owns its dk/dv
// rows and adds its dq partial to every q tile; p comes from the global lse
// either way, so the split's terms are all there.
//
// The long backward rounds exactly as the short one (qs = bf16(q·scale·
// log2e), qd = bf16(q·scale), kc = k, kd = bf16(k·scale), p and δ fp32,
// p and ds rounded for the products), so the two share the one-pass
// backward of `attention_bwd.cuh`, instantiated here with ROPE off and
// BIAS off or on: it holds nothing sized by L and takes any length. What
// differs from the TPU design is the dq reduction: the TPU stores one dq
// partial per kv block in the input dtype and sums them outside; here the
// partials add in fp32, in kv-block order, and dq rounds once.

#include "attention_bwd.cuh"

// q [B, Lq, H·D], k/v [B, Lk, H·D] pre-rotated, o/do [B, Lq, H·D] bf16 with
// unit column stride; `strides` holds 16 int64: the (batch, row) strides in
// elements of q, k, v, o, do, dq, dk, dv in that order. lse [B, H, Lq] fp32
// (exp2 domain, from the forward). kbias [Lk] fp32 added to the logits, or
// null for none. Scratch: qs/qd [B, H, Lq, D] and kc/kd [B, H, Lk, D] bf16,
// rows [B·H, 2, Lqp] (δ, lse) and dq_acc [B·H, Lqp, D] fp32, sync
// 1 + B·H·⌈Lq/64⌉ int32 (Lqp = ⌈Lq/64⌉·64); with splits > 1,
// dkv_part [splits][2][B·H, Lk, D] fp32 (splits: blocks per kv block, each
// taking a share of the q tiles). Outputs dq, dk (roped space), dv bf16 with
// unit column stride. q_mul = scale·log2e. Returns the cudaError_t of the
// launches.
extern "C" int long_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, const void* kbias,
                                  void* qs, void* qd, void* kc, void* kd,
                                  void* rows, void* dq_acc, void* sync,
                                  void* dkv_part, int splits, void* dq,
                                  void* dk, void* dv, int B, int H,
                                  int Lq, int Lk, int D,
                                  const long long* strides, float scale,
                                  float q_mul, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD, BB)                                                    \
  if (D == DD && (kbias != nullptr) == BB)                                    \
  return static_cast<int>(launch_attention_bwd<DD, false, BB>(                \
      q, k, v, o, dout, lse, nullptr, nullptr, nullptr, nullptr, kbias, qs,   \
      qd, kc, kd, rows, dq_acc, sync, dkv_part, splits, dq, dk, dv, B, H, Lq, \
      Lk, strides, scale, q_mul, s))
  VDS_LAUNCH(128, false);
  VDS_LAUNCH(128, true);
  VDS_LAUNCH(64, false);
  VDS_LAUNCH(64, true);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* long_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
