// Per-head RMSNorm of q and k, then the RoPE rotation of the video rows, in
// place, for HunyuanVideo's MM-DiT blocks (Hopper, sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no such model. It takes
// the place of `rotate_flat` (ops/fused_attention.py) on this model's path:
// the long attention kernel (`csrc/long_attention_fwd.cu`) reads q and k
// pre-rotated, and here they arrive from one launch that reads the q and k
// columns of the qkv projection (the double block's joint [video; text]
// rows, or the single block's `linear1` output) and writes them back
// normalised and rotated. Published (Tencent's `hyvideo/modules/
// models.py`): q, k ← RMSNorm_head(q), RMSNorm_head(k) with an affine
// weight over the head dim, eps 1e-6; then the rows of the video tokens are
// rotated by +θ in interleaved pairs (`apply_rotary_emb`), the text rows
// not at all. The weights of rows below `n_img` (video) and of the rest
// (text) are passed apart: the double block has one pair each, the single
// block passes the same pair twice. fp32 inside, rounded once to bf16.
//
// What bounds it: bytes. Each element of q and k is read once and written
// once (455 MB at 18,520 rows of 2 × 3072) with ~8 fp32 flops, plus the
// cos/sin rows of the video tokens (2 × 256 B a row). The design is the
// plain one: 16 threads own one head of one row, each 8 bf16 (one 16-byte
// load and store, neighbouring threads on neighbouring addresses), the
// sum of squares over the head reduced by four shuffles inside the
// 16-lane group, the cos/sin of a thread's 4 pairs one float4 each.

#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int HEAD_DIM = 128;
constexpr int VEC = 8;                  // bf16 a thread: one 16-byte access
constexpr int LANES = HEAD_DIM / VEC;   // threads a head
constexpr int THREADS = 256;

__device__ __forceinline__ void unpack(const uint4& raw, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(THREADS)
    qk_norm_rope_kernel(__nv_bfloat16* __restrict__ buf, long long ld,
                        int rows, int n_img, int heads,
                        const __nv_bfloat16* __restrict__ wq_img,
                        const __nv_bfloat16* __restrict__ wk_img,
                        const __nv_bfloat16* __restrict__ wq_txt,
                        const __nv_bfloat16* __restrict__ wk_txt,
                        const float* __restrict__ cos_tab,
                        const float* __restrict__ sin_tab, float eps) {
  const long long per_row = 2LL * heads * LANES;  // q heads, then k heads
  const long long id = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
  // per_row is a multiple of 16, so a 16-lane group is wholly in or out
  if (id >= per_row * rows) return;
  const int row = static_cast<int>(id / per_row);
  const int c = static_cast<int>(id - per_row * row);
  const bool is_k = c / LANES >= heads;
  const int lane = c % LANES;
  const bool img = row < n_img;

  __nv_bfloat16* p = buf + ld * row + static_cast<long long>(c) * VEC;
  float x[VEC];
  unpack(*reinterpret_cast<const uint4*>(p), x);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) ss += x[i] * x[i];
  const unsigned group = 0xffffu << (threadIdx.x & 16);
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    ss += __shfl_xor_sync(group, ss, off);
  const float r = rsqrtf(ss * (1.f / HEAD_DIM) + eps);

  const __nv_bfloat16* w = is_k ? (img ? wk_img : wk_txt)
                                : (img ? wq_img : wq_txt);
  float wf[VEC];
  unpack(*reinterpret_cast<const uint4*>(w + lane * VEC), wf);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = x[i] * r * wf[i];

  if (img) {
    const long long t = static_cast<long long>(row) * (HEAD_DIM / 2) +
                        lane * (VEC / 2);
    const float4 c4 = *reinterpret_cast<const float4*>(cos_tab + t);
    const float4 s4 = *reinterpret_cast<const float4*>(sin_tab + t);
    const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
    const float sn[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const float a = x[2 * j], b = x[2 * j + 1];
      x[2 * j] = a * cs[j] - b * sn[j];
      x[2 * j + 1] = b * cs[j] + a * sn[j];
    }
  }

  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = out;
}

}  // namespace

// buf bf16 [rows, ld] (unit column stride, 16-byte aligned, ld a multiple
// of 8): q in columns [0, H·128), k in [H·128, 2·H·128), both rewritten in
// place. Rows below n_img are normalised with wq_img / wk_img and rotated
// by cos_tab / sin_tab fp32 [n_img, 64] (contiguous); the rest with
// wq_txt / wk_txt, unrotated. Weights bf16 [128]. Returns the cudaError_t
// of the launch.
extern "C" int qk_norm_rope(void* buf, long long ld, int rows, int n_img,
                            int heads, int head_dim, const void* wq_img,
                            const void* wk_img, const void* wq_txt,
                            const void* wk_txt, const void* cos_tab,
                            const void* sin_tab, float eps, void* stream) {
  if (head_dim != HEAD_DIM || rows < 0 || n_img < 0 || n_img > rows ||
      heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const long long threads = 2LL * heads * LANES * rows;
  const unsigned blocks =
      static_cast<unsigned>((threads + THREADS - 1) / THREADS);
  qk_norm_rope_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(buf), ld, rows, n_img, heads,
      static_cast<const __nv_bfloat16*>(wq_img),
      static_cast<const __nv_bfloat16*>(wk_img),
      static_cast<const __nv_bfloat16*>(wq_txt),
      static_cast<const __nv_bfloat16*>(wk_txt),
      static_cast<const float*>(cos_tab),
      static_cast<const float*>(sin_tab), eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qk_norm_rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
