// Device and host helpers shared by the kernels for Hopper (sm_90a): bf16
// packing and the fp32 RoPE rotation over 8 pairs; the warpgroup tensor
// instruction (wgmma) with its shared-memory descriptors; mbarriers, TMA and
// bulk loads, named barriers and fences; the host-side encoding of TMA maps
// (the attention kernels, `attention_fwd.cuh` and `attention_bwd.cuh`); and
// what the column-sum kernels (`adaln_bwd.cu`, `bias_gelu_bwd.cu`) share:
// dtype-generic loads and stores, 16-byte shared loads, the ticket and the
// ordered sums that finish a sum across CTAs inside one launch.
// Header-only; every device function is inlined into its kernel.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a → low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  return u;
}

// In fp32: (x1, x2) ← (x1·c + x2·s, −x1·s + x2·c) over 8 pairs with
// cosines c and sines s.
__device__ __forceinline__ void rotate8_cs(float* x1, float* x2,
                                           const float* c, const float* s) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float y1 = x1[i] * c[i] + x2[i] * s[i];
    const float y2 = -x1[i] * s[i] + x2[i] * c[i];
    x1[i] = y1;
    x2[i] = y2;
  }
}

// The same over 8 pairs whose cos/sin start at cs/sn.
__device__ __forceinline__ void rotate8(float* x1, float* x2, const float* cs,
                                        const float* sn) {
  const float4 c0 = reinterpret_cast<const float4*>(cs)[0];
  const float4 c1 = reinterpret_cast<const float4*>(cs)[1];
  const float4 s0 = reinterpret_cast<const float4*>(sn)[0];
  const float4 s1 = reinterpret_cast<const float4*>(sn)[1];
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  rotate8_cs(x1, x2, c, s);
}

// The high word of every wgmma descriptor here: stride 1024 bytes between
// 8-row groups, 128-byte swizzle.
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

// The low word of the descriptor of the operand `off` bytes into shared
// memory from the 1024-aligned base, with leading byte offset `lbo`
// (K-major: unused, 16; MN-major: the stride of 64-element groups along
// M/N); a k-step of 16 elements adds 32 bytes (K-major) or 16 rows
// (MN-major) to off. Added to base >> 4.
__host__ __device__ constexpr uint32_t desc_lo(uint32_t off, uint32_t lbo) {
  return (off >> 4) | ((lbo >> 4) << 16);
}

// Operand lists of the accumulator: n floats d[b .. b + n).
#define VDS_D8(b)                                                   \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),       \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define VDS_D32(b) VDS_D8(b), VDS_D8(b + 8), VDS_D8(b + 16), VDS_D8(b + 24)
#define VDS_D64(b) VDS_D32(b), VDS_D32(b + 32)

// wgmma.mma_async m64nNk16, bf16 × bf16 → fp32, one warpgroup: d[N/2] per
// thread (rows 16·warp + g and + 8, columns 8i + 2t and + 1 in
// d[4i .. 4i + 3], the m16n8k16 accumulator layout repeated over N/8).
// ss: A and B from shared memory; rs: A from registers (each warp's 16 rows
// as an m16n8k16 A fragment). An operand in shared memory is given by the
// low word of its descriptor (desc_lo); the high word, the same for every
// operand here, is joined inside the asm, so a descriptor occupies no
// registers between k-steps. TA / TB = 1: MN-major. scale_d = 0
// overwrites d, 1 accumulates.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint32_t a_lo,
                                             uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
      "setp.ne.b32 p, %19, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}"
      ", da, db, p, 1, 1, %20, %21;\n}\n"
      : VDS_D8(0), VDS_D8(8)
      : "r"(a_lo), "r"(b_lo), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint32_t a_lo,
                                              uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", da, db, p, 1, 1, %68, %69;\n}\n"
      : VDS_D64(0)
      : "r"(a_lo), "r"(b_lo), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint32_t a_lo,
                                             uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", da, db, p, 1, 1, %36, %37;\n}\n"
      : VDS_D32(0)
      : "r"(a_lo), "r"(b_lo), "r"(kDescHi), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%36, %37};\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, db, p, 1, 1, %39;\n}\n"
      : VDS_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo),
        "r"(kDescHi), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint32_t b_lo, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%68, %69};\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, db, p, 1, 1, %71;\n}\n"
      : VDS_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo),
        "r"(kDescHi), "r"(scale_d), "n"(TB));
}

#undef VDS_D64
#undef VDS_D32
#undef VDS_D8

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Whether a wait that started at t0 has spun for about 10 s: that long can
// only be a fault, and a hung card is worse.
__device__ __forceinline__ bool stuck(long long t0) {
  return clock64() - t0 > 20000000000ll;
}

// Traps (the launch fails with an error) once a wait is stuck.
__device__ __forceinline__ void check_stuck(long long t0) {
  if (stuck(t0)) asm volatile("trap;\n");
}

// Waits for the completion of the barrier's phase of this parity. A stuck
// wait traps with TRAP, else gives up (the launch then ends with wrong
// values, which every check against the twin catches). The consumer
// warpgroups must not trap: a trap in their code holds ptxas to the
// launch's 168 registers a thread, not setmaxnreg's 240, and it then
// spills the accumulators every tile and serialises every wgmma.
template <bool TRAP>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (stuck(t0)) {
      if (TRAP) asm volatile("trap;\n");
      return;
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA tile loads of a 3-D / 4-D tensor map into shared memory, completing
// on `bar`; coordinates innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous global → shared copy of `bytes` (a multiple of 16, both
// ends 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these accumulator
// registers across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory accesses by 32-bit address. The consumers form their
// addresses from a base reloaded every tile, so that the compiler cannot
// hoist every per-thread address out of the loop into a register.
__device__ __forceinline__ void sts_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void sts_f2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y)
               : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

// Acquire load / release store of a counter in global memory.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are
// still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Signals named barrier `id` without waiting on it (the other side waits
// with named_sync on the same id and thread count).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map of a bf16 tensor with unit inner stride: dims and box innermost
// first, strides (in elements) of dims 1 .. rank−1; 128-byte swizzle, the
// box's inner 64 elements one swizzle row; out-of-bounds reads give zeros.
inline cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int rank,
                            const long long* dims, const long long* strides,
                            const int* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], es[4];
  for (int i = 0; i < rank; ++i) {
    gd[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    es[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i)
    gs[i] = static_cast<cuuint64_t>(strides[i]) * sizeof(bf16);
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gd,
      gs, bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the column-sum kernels' helpers (csrc/adaln_bwd.cu, csrc/bias_gelu_bwd.cu)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ld_any(const void* p, long long i,
                                        int is_bf16) {
  return is_bf16 ? to_f(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_any(void* p, long long i, float v,
                                       int is_bf16) {
  if (is_bf16)
    from_f(static_cast<bf16*>(p) + i, v);
  else
    static_cast<float*>(p)[i] = v;
}

// Thread 0 of a CTA, after a barrier behind the CTA's writes of its share:
// one ticket of *t; whether it was the last of last + 1. The fence before
// the atomic releases the whole CTA's share (fences are cumulative over
// what the barrier ordered before them), the fence after it acquires the
// others' shares for the reads after the next barrier: the pattern of a
// cooperative-groups grid barrier. One thread fences, so the others do
// not wait for their stores of dx to drain.
__device__ __forceinline__ int take_ticket(int* t, int last) {
  __threadfence();
  const int prev = atomicAdd(t, 1);
  __threadfence();
  return prev == last;
}

// out(e, Σ_{k<n} src[k·stride + e]) for the elements e < m of this thread
// (one of nt), each sum a left fold in k order read from L2, so the bits do
// not depend on how the loads are grouped. Where m, the stride and src
// allow 16-byte vectors, a thread takes 4 adjacent elements a vector, 16
// vectors in flight; else 4 elements nt apart, 8 terms of each in flight.
template <typename F>
__device__ __forceinline__ void ordered_sums(const float* src, int stride,
                                             int n, int m, int nt, F&& out) {
  if (m % 4 == 0 && stride % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int K = 16;
    for (int e = 4 * threadIdx.x; e < m; e += 4 * nt) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < n; k += K) {
        float4 t[K];
#pragma unroll
        for (int q = 0; q < K; ++q)
          t[q] = k + q < n
                     ? __ldcg(reinterpret_cast<const float4*>(
                           src + static_cast<size_t>(k + q) * stride + e))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (k + q < n) {
            v.x += t[q].x;
            v.y += t[q].y;
            v.z += t[q].z;
            v.w += t[q].w;
          }
        }
      }
      out(e, v.x);
      out(e + 1, v.y);
      out(e + 2, v.z);
      out(e + 3, v.w);
    }
    return;
  }
  constexpr int E = 4, K = 8;
  for (int e0 = threadIdx.x; e0 < m; e0 += E * nt) {
    float v[E];
#pragma unroll
    for (int u = 0; u < E; ++u) v[u] = 0.f;
    for (int k = 0; k < n; k += K) {
      float t[E][K];
#pragma unroll
      for (int u = 0; u < E; ++u)
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int e = e0 + u * nt;
          t[u][q] = e < m && k + q < n
                        ? __ldcg(src + static_cast<size_t>(k + q) * stride + e)
                        : 0.f;
        }
#pragma unroll
      for (int u = 0; u < E; ++u)
#pragma unroll
        for (int q = 0; q < K; ++q)
          if (k + q < n) v[u] += t[u][q];
    }
#pragma unroll
    for (int u = 0; u < E; ++u)
      if (e0 + u * nt < m) out(e0 + u * nt, v[u]);
  }
}

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// 16 bytes of shared memory into registers, in program order with the
// mbarrier waits around them (a plain 16-byte read may be split into four
// 4-byte ones, with bank conflicts).
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}

// 16 bytes of T as fp32 (bf16: 8 values, fp32: 4)
__device__ __forceinline__ void unpack(const uint4& w, bf16*, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(u[q] << 16);
    f[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& w, float*, float* f) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// A barrier of the nw consumer warps (a producer warp after them takes no
// part).
__device__ __forceinline__ void cbar(int nw) { named_sync(1, nw * 32); }

}  // namespace
