// muP AdamW update over every parameter leaf in one launch (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of `adamw_leaf_update`
// (video_diffusion_speedrun_tpu/ops/fused_adamw.py:34, :66), which the JAX
// package launches once per leaf. Per element, in fp32 whatever the moment
// storage type (the leaf math of `adamw_leaf_delta`, train/optim.py:30-47):
//   m ← b1·m + (1−b1)·g,  v ← b2·v + (1−b2)·g²,
//   p ← p + (−(lr·lr_t))·((m/bc1)/(√(v/bc2)+eps) + wd·p)
// with the per-leaf muP (lr, wd). Every operation rounds on its own
// (__fmul_rn, __fadd_rn, ...), so no FMA contraction departs from the
// plain version's rounding.
//
// Parameters (and their gradients) are fp32 or bf16, as the JAX kernel is
// generic over the parameter dtype. At bf16 the update follows the order
// of `p + adamw_leaf_delta(...)`, which the optimizer-in-backward step
// computes (train/inloop.py:99-102): wd·p rounds to bf16 (the weak-typed
// scalar takes p's dtype, so the table holds wd rounded to bf16), the
// delta −(lr·lr_t)·(dir + wd·p) rounds to bf16, and p + delta rounds
// again. At fp32 that order gives the same bits as the one above.
//
// What bounds it on the card: 16 bytes read and 12 written per fp32
// parameter (fp32 moments) and ~15 flops, so it is bandwidth-bound; at the
// 248M-parameter DiT one step moves ~7 GB. The design streams each element
// once with 16-byte loads, and puts all leaves into ONE launch: a chunk
// table (leaf, start) built once when the optimizer is made assigns each
// block 16,384 elements of one leaf, so ~300 leaves of 1 to 1M elements
// cost one launch instead of one each (JAX measured per-leaf launches net
// slower than XLA's fusion, train/optim.py:130-132); the optimizer-in-
// backward step launches it once per group of leaves (a block, or the
// layers around the blocks). lr_t, bc1 and bc2 come from a device tensor,
// so a step needs no host sync. p, m and v update in
// place, as `input_output_aliases` does on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 16384;  // elements per block, a multiple of 4

__device__ __forceinline__ float load1(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load4(const float* p, long long i, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p + i);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, long long i, const float* x) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, const float* x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p + i) = u;
}

struct Consts {
  float b1, omb1, b2, omb2, eps;
};

// one element: m, v and p in fp32 registers, updated in place; BF16P: p is
// a bf16 value, and wd·p and the delta round to bf16 (the store rounds p)
template <bool BF16P>
__device__ __forceinline__ void update(float& p, float& m, float& v, float g,
                                       float neg_lr, float wd, float bc1,
                                       float bc2, const Consts& k) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float dir = __fdiv_rn(__fdiv_rn(m, bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps));
  if (BF16P) {
    const float wdp = round_bf16(__fmul_rn(wd, p));  // exact, then rounded
    p = __fadd_rn(p, round_bf16(__fmul_rn(neg_lr, __fadd_rn(dir, wdp))));
  } else {
    p = __fadd_rn(p, __fmul_rn(neg_lr, __fadd_rn(dir, __fmul_rn(wd, p))));
  }
}

// leaf_ptrs [n_leaves, 3] (p, m, v), g_ptrs [n_leaves], numel [n_leaves],
// hyper [n_leaves, 2] (lr, wd), chunk_leaf/chunk_start [n_chunks],
// scalars [3] (lr_t, bc1, bc2) — all device arrays.
template <typename PT, typename MT>
__global__ void __launch_bounds__(THREADS)
    adamw_multi_tensor_kernel(const long long* __restrict__ leaf_ptrs,
                              const long long* __restrict__ g_ptrs,
                              const long long* __restrict__ numel,
                              const float* __restrict__ hyper,
                              const int* __restrict__ chunk_leaf,
                              const long long* __restrict__ chunk_start,
                              const float* __restrict__ scalars, Consts k) {
  const int leaf = chunk_leaf[blockIdx.x];
  const long long start = chunk_start[blockIdx.x];
  const long long n = numel[leaf];
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  constexpr bool BF16P = sizeof(PT) == 2;
  PT* p = reinterpret_cast<PT*>(leaf_ptrs[3 * leaf]);
  MT* m = reinterpret_cast<MT*>(leaf_ptrs[3 * leaf + 1]);
  MT* v = reinterpret_cast<MT*>(leaf_ptrs[3 * leaf + 2]);
  const PT* g = reinterpret_cast<const PT*>(g_ptrs[leaf]);
  const float neg_lr = -__fmul_rn(hyper[2 * leaf], scalars[0]);
  const float wd = hyper[2 * leaf + 1];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];

  // 4 elements a thread per step while a whole group of 4 fits
  const long long vec_end = start + ((end - start) & ~3LL);
  for (long long i = start + 4LL * threadIdx.x; i < vec_end; i += 4LL * THREADS) {
    float pp[4], mm[4], vv[4], gg[4];
    load4(p, i, pp);
    load4(m, i, mm);
    load4(v, i, vv);
    load4(g, i, gg);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      update<BF16P>(pp[e], mm[e], vv[e], gg[e], neg_lr, wd, bc1, bc2, k);
    store4(p, i, pp);
    store4(m, i, mm);
    store4(v, i, vv);
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += THREADS) {
    float pp = load1(p, i), mm = load1(m, i), vv = load1(v, i);
    update<BF16P>(pp, mm, vv, load1(g, i), neg_lr, wd, bc1, bc2, k);
    store1(p, i, pp);
    store1(m, i, mm);
    store1(v, i, vv);
  }
}

}  // namespace

extern "C" long long adamw_multi_tensor_chunk() { return CHUNK; }

// One launch over n_chunks chunks; params_bf16 selects bf16 parameters and
// gradients (wd in the table already rounded to bf16), moments_bf16 the
// bf16 moment storage (math stays fp32). b1/omb1/b2/omb2/eps are the fp32
// roundings of b1, 1−b1, b2, 1−b2 and eps. Every leaf's p, m, v and g must
// be 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int adamw_multi_tensor(const void* leaf_ptrs, const void* g_ptrs,
                                  const void* numel, const void* hyper,
                                  const void* chunk_leaf,
                                  const void* chunk_start, const void* scalars,
                                  int n_chunks, float b1, float omb1, float b2,
                                  float omb2, float eps, int params_bf16,
                                  int moments_bf16, void* stream) {
  const Consts k{b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const long long*>(leaf_ptrs);
  const auto* gp = static_cast<const long long*>(g_ptrs);
  const auto* ne = static_cast<const long long*>(numel);
  const auto* hy = static_cast<const float*>(hyper);
  const auto* cl = static_cast<const int*>(chunk_leaf);
  const auto* cs = static_cast<const long long*>(chunk_start);
  const auto* sc = static_cast<const float*>(scalars);
  using bf16 = __nv_bfloat16;
  if (params_bf16 && moments_bf16)
    adamw_multi_tensor_kernel<bf16, bf16><<<n_chunks, THREADS, 0, s>>>(
        lp, gp, ne, hy, cl, cs, sc, k);
  else if (params_bf16)
    adamw_multi_tensor_kernel<bf16, float><<<n_chunks, THREADS, 0, s>>>(
        lp, gp, ne, hy, cl, cs, sc, k);
  else if (moments_bf16)
    adamw_multi_tensor_kernel<float, bf16><<<n_chunks, THREADS, 0, s>>>(
        lp, gp, ne, hy, cl, cs, sc, k);
  else
    adamw_multi_tensor_kernel<float, float><<<n_chunks, THREADS, 0, s>>>(
        lp, gp, ne, hy, cl, cs, sc, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adamw_multi_tensor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
