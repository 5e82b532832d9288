// Bias + GELU backward for Hopper (sm_90a): row 16 as one kernel.
//
// Replaces the Pallas function `_backward`
// (video_diffusion_speedrun_tpu/ops/fused_gelu.py:184). Per element of x
// [N, F] (the pre-bias input the forward saved) and the output gradient g,
// in fp32, with s the pre-activation:
//   BLOCK (the DiT MLP's epilogue): s = x + bias in x's dtype; dg =
//     Φ_poly(s) + s·Φ_poly'(s), 0 / 1 outside |s| < R (Φ_poly' selected to 0
//     there before it meets s or g); dbias sums dx ROUNDED to x's dtype.
//   POLY (`bias_gelu` on bf16): s = x + bias in fp32; dg = gelu'_poly(s).
//   ERF (`bias_gelu` on fp32): dg = Φ(s) + s·φ(s), Φ by the A&S 7.1.26 erf.
//   dx = g·dg rounded to x's dtype; POLY and ERF sum the unrounded dx;
//   dbias leaves in the bias's dtype.
//
// What bounds it on the card: bytes. It must read x and g and write dx once
// (415 MB at [64, 528, 2048] bf16: 124 µs at 3.35 TB/s), at ~40 fp32
// operations an element as the twin writes them. Written so, the consumers'
// instructions (two of them conversions an element) set the pace, not the
// copies; the arithmetic has to run under the copies, so an element costs
// fewer instructions here:
// - BLOCK's Φ_poly + s·Φ_poly' is one odd polynomial, t = s/R: 0.5 +
//   t·Σ (2i+2)·c_i·t^2i (s·Φ_poly'(s) = t·Σ (2i+1)·c_i·t^2i), one Horner
//   chain and one saturation instead of two. It rounds otherwise than the
//   twin's two chains, within the same bound; at s = ±∞ it gives NaN, as
//   the twin's s·Φ_poly'(s) = ±∞·0 does.
// - x + bias in bf16 is one packed `add.rn.bf16x2` of two values (the
//   fp32 sum rounded to bf16 is the correctly rounded sum: 24 ≥ 2·8 + 2
//   bits), not a fp32 add and a conversion each.
// - dx is rounded once, by the packing for its 16-byte store; BLOCK's
//   dbias sums those packed values.
// The design:
// - A persistent grid of occupancy × SMs CTAs. The F columns are cut into
//   at least two slabs of at most 2 KB of a row (1024 bf16 or 512 fp32
//   columns; at most one 16-byte chunk a consumer thread), the N rows into
//   `splits` runs that differ by at most one row (the plan of
//   `fused_gelu._bwd_plan`: split k starts at k·base + min(k, rem)); CTA c
//   takes slab c mod slabs of split c / slabs, so neighbouring CTAs read
//   the slabs of the same rows.
// - A ring of STAGES stages in shared memory, each holding RPT·ng rows of
//   the slab of x and of g (16 KB of each). A producer warp fills a stage
//   with one `cp.async.bulk` a row of each input (one for the stage where
//   the slab is the whole row), completing on the stage's full mbarrier, as
//   soon as the consumer warps have released it on its empty mbarrier: the
//   next stages of both inputs are in flight under this one's arithmetic.
// - Consumer thread t owns one 16-byte chunk of the slab (chunk t mod tpr,
//   tpr the slab's chunks) in row group t / tpr (ng = nt / tpr groups). It
//   takes rows rg, rg + ng, ... of every stage, RPT of them, their shared
//   loads (`ld.shared.v4`: no bank conflicts) issued before their
//   arithmetic, dx leaving with 16-byte stores; its chunk's dbias sums stay
//   in registers for the whole run.
// - dbias, finished in the launch and deterministic: at the end of its run
//   a CTA adds its row groups' sums in group order (through shared memory)
//   into its split's fp32 row of the workspace [splits, F], then takes a
//   ticket of its group of `group` splits of the slab (`take_ticket`:
//   release before, acquire after); the group's last CTA adds the group's
//   rows in split order (`ordered_sums`). Where the slab has more than one
//   group, that CTA writes the group's sum and takes a ticket of the slab,
//   and the last one adds the group sums in order. The last finisher
//   writes dbias in the bias's dtype, rounded once. Every finisher resets
//   its ticket to 0, so the int32 tickets (zeroed once per device and
//   stream by the wrapper) are 0 between launches; launches on one stream
//   run in order. Every CTA ends at about the same time, so the finish is
//   a tail after the copies: one CTA alone would read all splits·F partials
//   (0.5 MB at [64, 528, 512], 2 MB at [64, 528, 2048]). Slabs cut that by
//   their count (each slab's finish runs on its own CTA), groups of about
//   √splits (the plan's `group`) make both levels read ~√splits rows, and
//   the sums read 16-byte vectors where F is a multiple of 4
//   (`ordered_sums`). No float atomics: two launches give the same bits,
//   and a call is this one launch.
// - Rows whose width or address rules out 16-byte bulk copies (F·bytes not
//   a multiple of 16, an unaligned view) go through the MASKED
//   instantiation: the same plan, arithmetic and sums, its loads from
//   global memory, each column checked against F.
// Why CUDA and not Triton, where the forward stays: the copies have to be
// issued ahead of the arithmetic, and the last part of the sum needs a
// release/acquire ticket between CTAs inside the launch. Triton leaves both
// to its compiler: its kernel waited on each tile's loads in program order
// (one 8-warp program an SM at [64, 528, 512]: 48% of the bound) and left
// the dbias sum and its cast to two more launches.

#include "hopper.cuh"

// Outside the anonymous namespace: the exported entry point takes it.
struct BiasGeluBwdParams {
  const void* x;
  const void* g;
  const void* bias;
  void* dx;
  void* dbias;
  float* part;  // [splits + groups of splits][F] fp32
  int* ticket;  // [slabs][groups of splits], then [slabs]
  int N, F;
  int fc, slabs, splits, base, rem, group;  // the plan
  int bias_bf16;  // 1 where bias and dbias are bf16, 0 where fp32
};

namespace {

enum Mode { BLOCK = 0, POLY = 1, ERF = 2 };

// consumer warps a CTA, ring stages, rows a consumer thread takes from one
// stage (`fused_gelu._BWD_WARPS`, `_BWD_STAGES`, `_RPT`): a stage is 16 KB
// of x and 16 KB of g, so two CTAs (18 warps, ~210 KB) share an SM
constexpr int NW = 8, STAGES = 3, RPT = 4;

// The fits of `ops/fused_gelu.py` (`_PHI_C`, `_DGELU_C`, `_AS_A`) spelled
// out, highest power first; 0.23809523809523808 = 1 / _POLY_R.
// Φ_poly(s) + s·Φ_poly'(s) = 0.5 + t·Σ (2i+2)·c_i·t^2i (c = _PHI_C),
// t = s / R, exactly 0 / 1 beyond |s| ≥ R; NaN at s = ±∞ or NaN, where
// the twin's s·Φ_poly'(s) is ±∞·0 (the FMA 0·s + dg: ±0 for finite s).
__device__ __forceinline__ float dmlp_poly(float s) {
  const float t = s * 0.23809523809523808f, t2 = t * t;
  float acc = fmaf(t2, 40.429349885158175f, -140.31161463856301f);
  acc = fmaf(acc, t2, 200.43393683968895f);
  acc = fmaf(acc, t2, -154.0572736902664f);
  acc = fmaf(acc, t2, 69.99194429074228f);
  acc = fmaf(acc, t2, -19.277425464019434f);
  acc = fmaf(acc, t2, 3.3461708626265905f);
  const float dg = fmaf(acc, t, 0.5f);
  return fmaf(0.f, s, s <= -4.2f ? 0.f : (s >= 4.2f ? 1.f : dg));
}

// gelu'(s) as its own odd fit: 0.5 + t·Σ c_i·t^2i, exactly 0 / 1 beyond.
__device__ __forceinline__ float dgelu_poly(float s) {
  const float t = s * 0.23809523809523808f, t2 = t * t;
  float acc = fmaf(t2, -28.13100148328976f, 125.8564616128173f);
  acc = fmaf(acc, t2, -239.9744046965949f);
  acc = fmaf(acc, t2, 256.1130938463848f);
  acc = fmaf(acc, t2, -169.03201824319132f);
  acc = fmaf(acc, t2, 71.6240707797499f);
  acc = fmaf(acc, t2, -19.301024758068174f);
  acc = fmaf(acc, t2, 3.3437508389045996f);
  const float dg = fmaf(acc, t, 0.5f);
  return s <= -4.2f ? 0.f : (s >= 4.2f ? 1.f : dg);
}

// Φ(s) = 0.5·(1 + erf(s/√2)) by the A&S 7.1.26 erf (exp2-domain): the
// `_gelu_parts` of the twin, sign(u)·(…) with erf(0) = 0 and NaN kept.
__device__ __forceinline__ float gelu_parts(float s) {
  const float u = s * 0.7071067811865476f, a = fabsf(u);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * exp2f(-(a * a) * 1.4426950408889634f);
  const float erf_u = u > 0.f ? e : (u < 0.f ? -e : u);
  return 0.5f * (1.f + erf_u);
}

// dGELU/ds of each mode; 0.7213475204444817 = _LOG2E / 2,
// 0.3989422804014327 = 1/√(2π).
template <int MODE>
__device__ __forceinline__ float dgelu(float s) {
  if constexpr (MODE == BLOCK) {
    return dmlp_poly(s);
  } else if constexpr (MODE == POLY) {
    return dgelu_poly(s);
  } else {
    const float pdf =
        exp2f(-(s * s) * 0.7213475204444817f) * 0.3989422804014327f;
    return gelu_parts(s) + s * pdf;
  }
}

// v rounded to T and back (bf16: round to nearest even; fp32: v)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// 8 bf16 sums a + b of 8 bf16 pairs, each rounded once
__device__ __forceinline__ uint4 add_bf16x8(const uint4& a, const uint4& b) {
  uint4 r;
  asm("add.rn.bf16x2 %0, %4, %8;\n\t"
      "add.rn.bf16x2 %1, %5, %9;\n\t"
      "add.rn.bf16x2 %2, %6, %10;\n\t"
      "add.rn.bf16x2 %3, %7, %11;"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y),
        "r"(b.z), "r"(b.w));
  return r;
}

// Shared memory, each region 16-byte aligned: [ring: STAGES × (x | g),
// each RPT·ng rows of a slab] [full and empty mbarriers of each stage] [the
// row groups' dbias sums: nt × VEC fp32] [flags]. The wrapper
// (`fused_gelu._bwd_smem`) sizes the same layout.
template <typename T, bool BULK>
__host__ __device__ size_t smem_bytes(int fc) {
  constexpr int VEC = 16 / sizeof(T), nt = 32 * NW;
  const int tpr = (fc + VEC - 1) / VEC, ng = nt / tpr;
  size_t n = 0;
  if (BULK) {
    n = static_cast<size_t>(STAGES) * 2 * RPT * ng * fc * sizeof(T);
    n = (n + 15) & ~size_t(15);
    n += static_cast<size_t>(STAGES) * 16;
  }
  n += static_cast<size_t>(nt) * VEC * 4;
  n = (n + 15) & ~size_t(15);
  return n + 16;
}

// NW consumer warps, and in the BULK instantiations one producer warp after
// them. Two CTAs an SM cap a thread at 96 registers: the HAS_BIAS
// instantiations spill a few hundred bytes, all of it in the finish after
// the stage loop (the loop itself has no local-memory access).
template <typename T, int MODE, bool HAS_BIAS, bool BULK>
__global__ void __launch_bounds__((NW + 1) * 32, 2)
    bias_gelu_bwd_kernel(const __grid_constant__ BiasGeluBwdParams p) {
  constexpr int VEC = 16 / sizeof(T);  // columns of a 16-byte chunk
  constexpr int nt = NW * 32, S = STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = p.F, fc = p.fc;
  const int tpr = (fc + VEC - 1) / VEC;  // chunks of a slab
  const int ng = nt / tpr;               // row groups
  const int R = RPT * ng;                // rows of a stage

  const int slab = blockIdx.x % p.slabs, split = blockIdx.x / p.slabs;
  const int col0 = slab * fc, wc = min(fc, F - col0);
  const int start = split * p.base + min(split, p.rem);
  const int end = start + p.base + (split < p.rem ? 1 : 0);

  extern __shared__ __align__(128) unsigned char smem[];
  // an input's share of a stage; one row of the slab
  const size_t in_bytes = static_cast<size_t>(R) * fc * sizeof(T);
  const size_t rb = static_cast<size_t>(wc) * sizeof(T);
  size_t off = 0;
  uint64_t* full = nullptr;
  uint64_t* empty = nullptr;
  if constexpr (BULK) {
    off = align16(static_cast<size_t>(S) * 2 * in_bytes);
    full = reinterpret_cast<uint64_t*>(smem + off);
    empty = full + S;
    off += static_cast<size_t>(S) * 16;
  }
  [[maybe_unused]] float* red =
      reinterpret_cast<float*>(smem + off);  // [ng][tpr·VEC]
  [[maybe_unused]] int* flag = reinterpret_cast<int*>(
      smem + align16(off + static_cast<size_t>(nt) * VEC * 4));

  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, NW);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == NW) {
      // the producer: stage n holds rows r0 .. r0 + cnt − 1 of the slab
      if (lane == 0) {
        int n = 0;
        for (int r0 = start; r0 < end; r0 += R, ++n) {
          const int cnt = min(R, end - r0), i = n % S;
          if (n >= S) mbar_wait<true>(empty + i, (n / S - 1) & 1);
          unsigned char* dst = smem + i * 2 * in_bytes;
          const long long o = static_cast<long long>(r0) * F + col0;
          const T* xs = static_cast<const T*>(p.x) + o;
          const T* gs = static_cast<const T*>(p.g) + o;
          mbar_expect_tx(full + i, static_cast<uint32_t>(2 * cnt * rb));
          if (wc == F) {
            bulk_load(dst, xs, static_cast<uint32_t>(cnt * rb), full + i);
            bulk_load(dst + in_bytes, gs, static_cast<uint32_t>(cnt * rb),
                      full + i);
          } else {
            for (int j = 0; j < cnt; ++j) {
              const long long rj = static_cast<long long>(j) * F;
              bulk_load(dst + j * rb, xs + rj, static_cast<uint32_t>(rb),
                        full + i);
              bulk_load(dst + in_bytes + j * rb, gs + rj,
                        static_cast<uint32_t>(rb), full + i);
            }
          }
        }
      }
      return;  // the consumers sync among themselves from here on
    }
  }

  const int rg = threadIdx.x / tpr, cl = threadIdx.x - rg * tpr;
  const int col = col0 + cl * VEC;  // this thread's first column
  const bool active = rg < ng && cl * VEC < wc;
  // BLOCK on bf16 rows adds the bias as packed bf16 pairs
  constexpr bool PACKED = MODE == BLOCK && HAS_BIAS && sizeof(T) == 2;
  [[maybe_unused]] float b[VEC];
  [[maybe_unused]] uint4 bw;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    acc[j] = 0.f;
    if constexpr (HAS_BIAS) {
      b[j] = active && col + j < F ? ld_any(p.bias, col + j, p.bias_bf16)
                                   : 0.f;
      if constexpr (MODE == BLOCK) b[j] = round_to<T>(b[j]);  // x's dtype
    }
  }
  if constexpr (PACKED) bw = pack8(b);

  // s from x: x + b in fp32, rounded to x's dtype in BLOCK
  auto preact = [&](const float* xv, float* sv) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sv[j] = xv[j];
      if constexpr (HAS_BIAS) {
        sv[j] += b[j];
        if constexpr (MODE == BLOCK) sv[j] = round_to<T>(sv[j]);
      }
    }
  };
  // dx = g·dg(s) in fp32
  auto grad = [&](const float* sv, const float* gv, float* dv) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dv[j] = gv[j] * dgelu<MODE>(sv[j]);
  };
  // dbias terms: dx rounded to x's dtype in BLOCK (rv), else unrounded
  auto add_terms = [&](const float* dv, const float* rv) {
    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += MODE == BLOCK ? rv[j] : dv[j];
    }
  };

  int n = 0;  // stages taken
  for (int r0 = start; r0 < end; r0 += R, ++n) {
    const int cnt = min(R, end - r0);
    const int i = BULK ? n % S : 0;
    [[maybe_unused]] const unsigned char* st = smem + i * 2 * in_bytes;
    if constexpr (BULK) mbar_wait<true>(full + i, (n / S) & 1);
    if (active) {
      if constexpr (BULK) {
        uint4 xw[RPT], gw[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int j = rg + q * ng;
          if (j < cnt) {
            xw[q] = lds128(st + j * rb + cl * 16);
            gw[q] = lds128(st + in_bytes + j * rb + cl * 16);
          }
        }
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int j = rg + q * ng;
          if (j < cnt) {
            float sv[VEC], gv[VEC], dv[VEC];
            if constexpr (PACKED) {
              unpack(add_bf16x8(xw[q], bw), static_cast<T*>(nullptr), sv);
            } else {
              float xv[VEC];
              unpack(xw[q], static_cast<T*>(nullptr), xv);
              preact(xv, sv);
            }
            unpack(gw[q], static_cast<T*>(nullptr), gv);
            grad(sv, gv, dv);
            T* dst = static_cast<T*>(p.dx) +
                     static_cast<long long>(r0 + j) * F + col;
            if constexpr (sizeof(T) == 2) {
              const uint4 w = pack8(dv);  // dx rounded once
              *reinterpret_cast<uint4*>(dst) = w;
              float rv[VEC];
              if constexpr (MODE == BLOCK && HAS_BIAS)
                unpack(w, static_cast<T*>(nullptr), rv);
              add_terms(dv, rv);
            } else {
              *reinterpret_cast<float4*>(dst) =
                  make_float4(dv[0], dv[1], dv[2], dv[3]);
              add_terms(dv, dv);
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int j = rg + q * ng;
          if (j < cnt) {
            const long long o = static_cast<long long>(r0 + j) * F;
            const T* xr = static_cast<const T*>(p.x) + o;
            const T* gr = static_cast<const T*>(p.g) + o;
            float xv[VEC], sv[VEC], gv[VEC], dv[VEC], rv[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              xv[e] = col + e < F ? to_f(xr[col + e]) : 0.f;
              gv[e] = col + e < F ? to_f(gr[col + e]) : 0.f;
            }
            preact(xv, sv);
            grad(sv, gv, dv);
            T* dr = static_cast<T*>(p.dx) + o;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              rv[e] = round_to<T>(dv[e]);
              if (col + e < F) from_f(dr + col + e, dv[e]);
            }
            add_terms(dv, rv);
          }
        }
      }
    }
    if constexpr (BULK) {
      __syncwarp();  // every lane has read its rows of the stage
      if (lane == 0) mbar_arrive(empty + i);
    }
  }

  if constexpr (HAS_BIAS) {
    // the split's row of the slab: the row groups' sums added in order
    if (active) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(rg * tpr + cl) * VEC + j] = acc[j];
    }
    cbar(NW);
    float* prow = p.part + static_cast<size_t>(split) * F + col0;
    for (int e = threadIdx.x; e < wc; e += nt) {
      float v = red[e];
      for (int r = 1; r < ng; ++r) v += red[r * tpr * VEC + e];
      prow[e] = v;
    }
    // the finish: the group's splits in order, then the slab's groups
    const int ngr = (p.splits + p.group - 1) / p.group;
    const int grp = split / p.group, s_lo = grp * p.group;
    const int s_n = min(p.splits - s_lo, p.group);
    int* t_grp = p.ticket + slab * ngr + grp;
    int* t_slab = p.ticket + p.slabs * ngr + slab;
    float* gsum = p.part + static_cast<size_t>(p.splits) * F;  // [ngr][F]
    auto write_dbias = [&](int e, float v) {
      st_any(p.dbias, col0 + e, v, p.bias_bf16);
    };
    // the splits' or groups' rows src[k·F + e], e < wc, added in k order
    auto sums = [&](const float* src, int n, auto&& out) {
      ordered_sums(src, F, n, wc, nt, out);
    };
    cbar(NW);
    if (threadIdx.x == 0) flag[0] = take_ticket(t_grp, s_n - 1);
    cbar(NW);
    if (flag[0]) {
      const float* src = p.part + static_cast<size_t>(s_lo) * F + col0;
      if (ngr == 1) {
        sums(src, s_n, write_dbias);
      } else {
        float* dst = gsum + static_cast<size_t>(grp) * F + col0;
        sums(src, s_n, [&](int e, float v) { dst[e] = v; });
        cbar(NW);
        if (threadIdx.x == 0) flag[1] = take_ticket(t_slab, ngr - 1);
        cbar(NW);
        if (flag[1]) {
          sums(gsum + col0, ngr, write_dbias);
          if (threadIdx.x == 0) *t_slab = 0;
        }
      }
      if (threadIdx.x == 0) *t_grp = 0;
    }
  }
}

template <typename T, int MODE, bool HB, bool BULK>
cudaError_t launch(const BiasGeluBwdParams& p, cudaStream_t stream,
                   int* occupancy) {
  auto kern = bias_gelu_bwd_kernel<T, MODE, HB, BULK>;
  const size_t smem = smem_bytes<T, BULK>(p.fc);
  const int threads = (NW + (BULK ? 1 : 0)) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kern,
                                                         threads, smem);
  kern<<<p.slabs * p.splits, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t by_flags(const BiasGeluBwdParams& p, int has_bias, int bulk,
                     cudaStream_t s, int* occ) {
  if (has_bias)
    return bulk ? launch<T, MODE, true, true>(p, s, occ)
                : launch<T, MODE, true, false>(p, s, occ);
  return bulk ? launch<T, MODE, false, true>(p, s, occ)
              : launch<T, MODE, false, false>(p, s, occ);
}

template <typename T>
cudaError_t by_mode(const BiasGeluBwdParams& p, int mode, int has_bias,
                    int bulk, cudaStream_t s, int* occ) {
  switch (mode) {
    case BLOCK: return by_flags<T, BLOCK>(p, has_bias, bulk, s, occ);
    case POLY: return by_flags<T, POLY>(p, has_bias, bulk, s, occ);
    case ERF: return by_flags<T, ERF>(p, has_bias, bulk, s, occ);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One backward launch (occupancy == NULL), or the CTAs of that
// instantiation an SM holds, into *occupancy (no launch). `p` is read on
// the host: x, g and dx bf16 (x_bf16 = 1) or fp32; mode BLOCK, POLY or ERF;
// bulk = 1 for the ring (F·bytes a multiple of 16, rows 16-byte aligned),
// 0 for the masked loads; each slab at most one 16-byte chunk a consumer
// thread; the shared memory is the `smem_bytes` layout of fc. Returns the
// cudaError_t.
extern "C" int bias_gelu_bwd(const BiasGeluBwdParams* p, int x_bf16,
                             int mode, int has_bias, int bulk, void* stream,
                             int* occupancy) {
  const int vec = x_bf16 ? 8 : 4;
  if (p->fc < 1 || (p->fc + vec - 1) / vec > 32 * NW ||
      (occupancy == nullptr && p->group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? by_mode<bf16>(*p, mode, has_bias, bulk, s, occupancy)
             : by_mode<float>(*p, mode, has_bias, bulk, s, occupancy);
  return static_cast<int>(err);
}

// The shared memory of one instantiation at a slab width fc, for the
// wrapper's check of its own sizing.
extern "C" long long bias_gelu_bwd_smem(int x_bf16, int bulk, int fc) {
  size_t n;
  if (x_bf16)
    n = bulk ? smem_bytes<bf16, true>(fc) : smem_bytes<bf16, false>(fc);
  else
    n = bulk ? smem_bytes<float, true>(fc) : smem_bytes<float, false>(fc);
  return static_cast<long long>(n);
}

extern "C" const char* bias_gelu_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
