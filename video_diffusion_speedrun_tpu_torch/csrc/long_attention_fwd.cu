// Long-path attention forward over pre-rotated q/k, for Hopper (sm_90a).
//
// Replaces the Pallas function `_forward`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:251) on the arities
// the port takes: q and k arrive rotated (`_rotate_flat`, :85; the long
// path's `_preroted_flash`, :1812 — kernels `_fwd_kernel_noro` (:124) and
// `_fwd_kernel_noro2` (:135), body `_fwd_kernel` (:188-248)), with or
// without the additive kv-bias row (`has_bias`, :214-215, 296-302), which
// the ring path's fallback for chunks above 4096 kv rows passes
// (`_ring_chunk_fwd`, :1189-1193). The bias joins the scaled logits before
// the ragged-tile mask, as on the TPU.
//
// In the same launch it computes what the TPU splits off at lengths such
// as 8208 = 16 + 8·1024 that do not tile into its 1024-row blocks:
// `_forward_tail` (:1468) folds the 16 prefix kv columns into the bulk's
// online softmax with `_tail_merge_kernel` (:1435). Here kv streams in
// 128-row tiles and the ragged last tile is masked, so the prefix columns
// are part of the same online-softmax sweep, for every q row.
//
// The long path rounds differently from the short kernels: s = dot(q, k)
// of the bf16 inputs, accumulated in fp32, THEN × scale·log2e (:210-213);
// the short kernels fold scale·log2e into q before rounding it. So this
// file instantiates the forward of `attention_fwd.cuh` with Q_PRE: q, k and
// v all arrive by TMA from their strided layouts, the logits take the
// factor after the product. What bounds it (~4,000 flops a byte at
// L = 8208: the tensor cores) and how the kernel is laid out: that header.

#include "attention_fwd.cuh"

// q [B, Lq, H·D], k/v [B, Lk, H·D] bf16, q and k already rotated, with unit
// column stride and the given batch/row strides (in elements); any Lq, Lk.
// kbias [Lk] fp32 added to the scaled logits, or null for none. o
// [B, Lq, H·D] bf16 and lse [B, H, Lq] fp32 contiguous. s_mul =
// scale·log2e, applied to the fp32 logits. Returns the cudaError_t of the
// launch.
extern "C" int long_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* kbias, void* o, void* lse,
                                  int B, int H, int Lq, int Lk, int D,
                                  long long q_sb, long long q_sl,
                                  long long k_sb, long long k_sl,
                                  long long v_sb, long long v_sl, float s_mul,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD, BB)                                                  \
  if (D == DD && (kbias != nullptr) == BB)                                  \
  return static_cast<int>(launch_attention_fwd<DD, Q_PRE, BB>(             \
      q, k, v, nullptr, nullptr, nullptr, nullptr, kbias, nullptr, o, lse, B, \
      H, Lq, Lk, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, s_mul, s))
  VDS_LAUNCH(128, false);
  VDS_LAUNCH(128, true);
  VDS_LAUNCH(64, false);
  VDS_LAUNCH(64, true);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* long_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
