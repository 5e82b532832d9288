// Ring-chunk attention forward (context parallelism), for Hopper (sm_90a).
//
// Replaces the Pallas function `_ring_chunk_fwd`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:1185, kernel
// `_ring_fwd_kernel` :1109): one ring step's partial attention, this
// rank's q rows against one kv chunk that came around the ring. It returns
// the chunk's normalised o and exp2-domain lse; the caller merges them
// into the running result (`online_merge`).
//
// What it computes (per (b, h)): q rotated by the local rows' tables
// (cos_q, sin_q), k by the chunk's (cos_k, sin_k); q·scale·log2e rounded to
// bf16, k rounded; fp32 logits plus the chunk's fp32 kv-bias row (0 on real
// tokens, −1e30 on the padded tail); p = exp2(s − m) rounded for PV. A
// chunk that is all padding gives lse ≈ −1e30 and a finite o, as the TPU
// kernel's comment (:1125) requires.
//
// What bounds it on the card: 4·B·H·Lq·Lk·D tensor flops against
// ~2·B·(2Lq + 2Lk)·H·D bytes, ~500 flops a byte at the serve chunk
// (B=2, H=16, 2064 × 2064): compute-bound, as the short kernel.
//
// The design: the short path's kernel (`attention_fwd.cuh`, ROPE on) with
// two changes that the TPU kernel has: the k rotation prologue reads the
// chunk's table rows and the q tile the local rows', and a BIAS flag adds
// the kv row to the logits before the ragged mask. The TPU holds the whole
// chunk's k/v in VMEM and so stops at 4096 kv rows (`_RING_FULLK_MAX_FWD`,
// a VMEM limit); this kernel streams kv tiles through shared memory and
// holds nothing sized by Lk, so its 4096 is only the dispatch rule that
// keeps the port's fallback points (the long kernel with the bias) where
// JAX has them.

#include "attention_fwd.cuh"

// q [B, Lq, H·D], k/v [B, Lk, H·D] bf16 with unit column stride and the
// given batch/row strides (in elements). cos_q/sin_q [Lq, D/2] and
// cos_k/sin_k [Lk, D/2] fp32 contiguous (slices of the full tables);
// kbias [Lk] fp32; k_rot a [B, Lk, H·D] bf16 scratch for the rotated k.
// o [B, Lq, H·D] bf16 and lse [B, H, Lq] fp32 contiguous. q_mul =
// scale·log2e. Returns the cudaError_t of the launches.
extern "C" int ring_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* cos_q, const void* sin_q,
                                  const void* cos_k, const void* sin_k,
                                  const void* kbias, void* k_rot, void* o,
                                  void* lse, int B, int H, int Lq, int Lk,
                                  int D, long long q_sb, long long q_sl,
                                  long long k_sb, long long k_sl,
                                  long long v_sb, long long v_sl, float q_mul,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD)                                                        \
  if (D == DD)                                                                \
  return static_cast<int>(launch_attention_fwd<DD, Q_ROPE, true>(             \
      q, k, v, cos_q, sin_q, cos_k, sin_k, kbias, k_rot, o, lse, B, H, Lq,    \
      Lk, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, q_mul, s))
  VDS_LAUNCH(128);
  VDS_LAUNCH(64);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ring_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
