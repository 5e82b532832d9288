// AdaLN-RMSNorm backward for Hopper (sm_90a): rows 12 and 14 as one kernel.
//
// Replaces the Pallas functions `_backward`
// (video_diffusion_speedrun_tpu/ops/fused_adaln.py:156, kernels
// `_bwd_kernel` / `_bwd_kernel_nogamma`) and `_gr_backward` (:379,
// `_gr_bwd_kernel*`). Per row of x [B, L, D] (row 14: the saved x_new),
// in fp32:
//   r = rsqrt(mean(x²) + eps), n = x·r, dn = g·(1 + scale[b])·γ?,
//   dx = r·(dn − n·mean(n·dn))      (row 14: dx += gx, dδ = dx·gate[b]),
// and the column sums over L, per b: dshift = Σg, dscale = Σg·n·γ?,
// dgate = Σdx·δ (row 14); dγ = Σ_b Σ_L g·n·(1 + scale).
//
// What bounds it on the card: bytes. Row 12 reads x and g and writes dx,
// row 14 reads x_new, δ, gx, gy and writes dx, dδ, each at ~20 fp32 flops
// an element: at [64, 528, 512] bf16, 104 / 208 MB, 31 / 62 µs at
// 3.35 TB/s. The design keeps every input row in flight under the
// arithmetic of the rows before it, and finishes the column sums in the
// same launch:
// - A persistent grid of occupancy × SMs CTAs, the B·L rows split into
//   contiguous runs that differ by at most one row (the plan of
//   `fused_adaln._bwd_plan`: run c starts at c·base + min(c, rem)). A run
//   that crosses a b boundary flushes its column partials there.
// - A ring of `stages` stages in shared memory, each holding up to 2·nw
//   consecutive rows of one b (x, g and, for row 14, gx and δ). A producer
//   warp fills a stage with one `cp.async.bulk` per input (one a row where
//   rows are not contiguous), completing on the stage's full mbarrier, as
//   soon as the nw consumer warps have released it on its empty mbarrier;
//   so the next stage of every input is in flight under this stage's
//   arithmetic. A copy moves a whole stage of an input (16 KB at D = 512
//   bf16), not one 1 KB row: few large copies keep the copy engine's
//   per-copy cost off the stream.
// - Consumer warp w takes rows w and w + nw of each stage, so that two
//   rows' latency chains (loads, the row reductions, rsqrt) interleave and
//   share the loads of the per-b constants. Lane l owns the 16-byte chunks
//   l, l + 32, ... of a row, read with 16-byte shared loads (no bank
//   conflicts; the constants are laid out so that theirs have none
//   either): r and mean(n·dn) are warp shuffles (no block barrier in the
//   row loop), dx and dδ leave with 16-byte stores, and row 14's dgate
//   term reads δ from the stage.
// - Two column sums (three for row 14) per b: Σg, Σg·n (γ and 1 + scale
//   are constant along L, so dscale = γ·Σg·n and b's share of dγ is
//   (1 + scale)·Σg·n) and Σdx·δ. Per lane in registers at D ≤ 1024 (16 or
//   32 columns a lane), in shared memory above; at a flush they add in
//   warp order into one fp32 slot per (CTA, b) in global memory.
// - The finish, in the launch and deterministic: a CTA that flushed b
//   takes a ticket (one thread: `__threadfence`, `atomicAdd`, a fence) of
//   its group of GROUP CTAs of b; the group's last CTA adds the group's
//   slots in CTA order, and where b spans more groups, takes a ticket of b,
//   whose last one adds the group sums in order. It writes dshift, dscale,
//   dgate of b in their dtypes, rounded once from fp32. With γ it leaves
//   b's fp32 dγ row; dγ adds those rows in b order the same way, in groups
//   of GROUP b's. Every finisher resets its ticket to 0, so the int32
//   tickets (`_BwdPlan.tickets`, zeroed once per device and stream by the
//   wrapper) are 0 between launches; launches on one stream run in order,
//   so they share them safely. No float atomics: two launches give the
//   same bits. Tickets of groups, not one of the whole launch, spread the
//   finish over the CTAs while others still stream rows: one last CTA
//   would read all (CTAs + B − 1) slots, 2–3 MB at the train shape, alone
//   at the end, and at B = 2 the ~130 slots of each b.
// - Rows whose width or address rules out 16-byte bulk copies (D·bytes not
//   a multiple of 16, an unaligned view), or too wide for a ring of two
//   stages, go through the MASKED instantiation: the same row arithmetic,
//   partials and finish, its loads from global memory, each column
//   checked against D.
// Why CUDA and not Triton, where the other AdaLN kernels stay: the ring
// needs to decide when each copy is issued, so that the next rows of every
// input are in flight under this row's arithmetic, and the finish needs a
// cross-CTA ticket with release/acquire ordering inside the launch. Triton
// leaves both to its compiler; its kernels waited on each load in program
// order (one memory round trip a tile, three for row 14) and finished the
// sums with 3–5 torch launches after the kernel.

#include "hopper.cuh"

// Outside the anonymous namespace: the exported entry point takes it.
struct AdaLNBwdParams {
  const void* x;  // row 12: x; row 14: x_new
  const void* g;  // row 12: g; row 14: gy
  const void* gx;
  const void* dl;  // δ
  const void* scale;
  const void* gate;
  const void* gamma;
  void* dx;
  void* dd;  // dδ
  void* dshift;
  void* dscale;
  void* dgate;
  void* dgamma;
  float* part;  // [ctas + B − 1][NS][D] fp32 slots, then [B][D] (dγ per b)
  int* ticket;  // [B + 1]
  long long x_sb, x_sl, g_sb, g_sl, gx_sb, gx_sl, dl_sb, dl_sl;
  long long scale_sb, gate_sb;
  int B, L, D;
  int ctas, base, rem;  // the plan
  int stages, warps;  // ring stages; consumer warps a CTA
  float eps;
  // 1 where the [B, D] / [D] operand or output is bf16, 0 where fp32
  int scale_bf16, gate_bf16, gamma_bf16;
  int dshift_bf16, dscale_bf16, dgate_bf16, dgamma_bf16;
};

namespace {

enum Mode { C16 = 0, C32 = 1, SMEM = 2, MASKED = 3 };

// N contiguous values stored from fp32 (16 or 8 bytes, aligned).
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(bf16* p, const float* f) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = pack8(f);
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
  }
}

// A chunk of N columns from col0 of a row in global memory, one access a
// column (the MASKED instantiation): those at or past D read 0.
template <int N, typename U>
__device__ __forceinline__ void ldg_chunk(const U* row, int col0, int D,
                                          float* f) {
#pragma unroll
  for (int j = 0; j < N; ++j) f[j] = col0 + j < D ? to_f(row[col0 + j]) : 0.f;
}

// A chunk stored: one vector access, or (CHECK, the MASKED instantiation)
// one access a column, none at or past D.
template <int N, bool CHECK, typename U>
__device__ __forceinline__ void store_chunk(U* row, int col0, int D,
                                            const float* f) {
  if constexpr (CHECK) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (col0 + j < D) from_f(row + col0 + j, f[j]);
  } else {
    store_vec<N>(row + col0, f);
  }
}

// The CTA whose run holds row r (the inverse of start(c) = c·base +
// min(c, rem)).
__device__ __forceinline__ int cta_of(int r, int base, int rem) {
  const int cut = rem * (base + 1);
  return r < cut ? r / (base + 1) : rem + (r - cut) / base;
}

// CTAs whose slots of one b a first-level finish adds (`_BwdPlan.GROUP`)
constexpr int GROUP = 8;

// 8 bytes of shared memory into registers (lds128's half)
__device__ __forceinline__ uint2 lds64(const void* p) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}

// N elements of U from shared memory at p (16-byte aligned, 8 where
// N·bytes is 8) as fp32
template <int N, typename U>
__device__ __forceinline__ void lds_vec(const U* p, float* f) {
  constexpr int BYTES = N * static_cast<int>(sizeof(U));
  if constexpr (BYTES == 8) {  // 4 bf16
    const uint2 w = lds64(p);
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xffff0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q)
      unpack(lds128(reinterpret_cast<const unsigned char*>(p) + 16 * q),
             static_cast<U*>(nullptr), f + q * (16 / sizeof(U)));
  }
}

// The per-b constants (1 + scale, γ, gate) in shared memory: column
// k·VEC + 4·q + u of a chunk k at (q·nk + k)·4 + u, so that lane l's
// float4s of quad q lie side by side (no bank conflicts).
template <int VEC>
__device__ __forceinline__ int cst_idx(int col, int nk) {
  const int k = col / VEC, j = col - k * VEC;
  return ((j >> 2) * nk + k) * 4 + (j & 3);
}

template <int VEC, bool CHECK>
__device__ __forceinline__ void lds_cst(const float* base, int k, int nk,
                                        int D, float* f) {
  if constexpr (CHECK) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      f[j] = k * VEC + j < D ? base[cst_idx<VEC>(k * VEC + j, nk)] : 0.f;
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const uint4 w = lds128(base + (q * nk + k) * 4);
      unpack(w, static_cast<float*>(nullptr), f + 4 * q);
    }
  }
}

// Bulk copies of n consecutive rows of `row` bytes from src (rows `sl`
// elements of U apart) into dst, completing on bar: one copy where the rows
// are contiguous, else one a row.
template <typename U>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const U* src,
                                          long long sl, int D, int n,
                                          uint64_t* bar) {
  const uint32_t row = static_cast<uint32_t>(D * sizeof(U));
  if (sl == D) {
    bulk_load(dst, src, row * n, bar);
  } else {
    for (int i = 0; i < n; ++i) bulk_load(dst + i * row, src + i * sl, row, bar);
  }
}

template <typename T, typename TD, bool GATED>
__host__ __device__ __forceinline__ size_t slot_bytes(int D) {
  return static_cast<size_t>(D) * (sizeof(T) * (GATED ? 3 : 2) +
                                   (GATED ? sizeof(TD) : 0));
}

// Rows a consumer warp takes from one stage: two rows' latency chains
// (loads, the row reductions, rsqrt) interleave, and share the loads of
// the per-b constants.
constexpr int RPW = 2;

template <int N>
struct Rows {
  static constexpr int value = N;
};

// Shared memory, each region 16-byte aligned: [ring: stages × RPW·nw row
// slots, x | g | gx | δ rows of a stage side by side] [mbarriers: full and
// empty of each stage] [constants NC × nk·VEC fp32] [the warps' partials
// nw × NS × cpl × 32 fp32: accumulated there (SMEM, MASKED) or stored there
// at a flush (C16, C32)] [4 flags]. The wrapper (`fused_adaln._bwd_smem`)
// sizes the same layout.
template <typename T, typename TD, bool HAS_GAMMA, bool GATED, int MODE>
__host__ __device__ size_t smem_bytes(int D, int nw, int stages) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NS = GATED ? 3 : 2;
  constexpr int NC = 1 + (HAS_GAMMA ? 1 : 0) + (GATED ? 1 : 0);
  const size_t nk = (D + VEC - 1) / VEC;
  const size_t cpl = (nk + 31) / 32 * VEC;
  size_t n = 0;
  if (MODE != MASKED) {
    n += static_cast<size_t>(RPW) * nw * stages *
         slot_bytes<T, TD, GATED>(D);
    n = (n + 15) & ~size_t(15);
    n += static_cast<size_t>(stages) * 16;
  }
  n += static_cast<size_t>(NC) * nk * VEC * 4;
  n = (n + 15) & ~size_t(15);
  n += static_cast<size_t>(nw) * NS * cpl * 32 * 4;
  n = (n + 15) & ~size_t(15);
  return n + 16;
}

// nw consumer warps, and in the bulk modes one producer warp after them.
template <typename T, typename TD, bool HAS_GAMMA, bool GATED, int MODE>
__global__ void __launch_bounds__(288, 1)
    adaln_bwd_kernel(const __grid_constant__ AdaLNBwdParams p) {
  constexpr int VEC = 16 / sizeof(T);  // columns of a 16-byte chunk of x
  constexpr bool MSK = MODE == MASKED;
  constexpr bool REG = MODE == C16 || MODE == C32;
  // column sums over a b's rows: 0 Σg (dshift), 1 Σg·n (dscale = γ·Σg·n,
  // b's share of dγ = (1 + scale)·Σg·n), [2 Σdx·δ (dgate)]
  constexpr int NS = GATED ? 3 : 2;
  constexpr int NC = 1 + (HAS_GAMMA ? 1 : 0) + (GATED ? 1 : 0);
  constexpr int S_GATE = 2;
  constexpr int C_GAMMA = 1, C_GATE = NC - 1;
  constexpr int RCH = (MODE == C16 ? 16 : 32) / VEC;  // register chunks

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = p.warps, nt = nw * 32;  // consumers
  const int D = p.D, L = p.L, S = p.stages;
  const int nk = (D + VEC - 1) / VEC;  // chunks of a row
  const int kpl = (nk + 31) / 32;      // chunks of a lane, at most
  const int cpl = kpl * VEC;
  const int csz = nk * VEC;  // floats of one constant
  const float inv_d = 1.0f / static_cast<float>(D);

  extern __shared__ __align__(128) unsigned char smem[];
  const size_t row_t = static_cast<size_t>(D) * sizeof(T);
  const size_t row_d = static_cast<size_t>(D) * sizeof(TD);
  const int sr = RPW * nw;  // rows of a stage
  const size_t stage = static_cast<size_t>(sr) * slot_bytes<T, TD, GATED>(D);
  size_t off = 0;
  unsigned char* ring = smem;
  uint64_t* full = nullptr;
  uint64_t* empty = nullptr;
  if constexpr (!MSK) {
    off = align16(S * stage);
    full = reinterpret_cast<uint64_t*>(smem + off);
    empty = full + S;
    off += static_cast<size_t>(S) * 16;
  }
  float* cst = reinterpret_cast<float*>(smem + off);
  off = align16(off + static_cast<size_t>(NC) * csz * 4);
  float* part_s = reinterpret_cast<float*>(smem + off);  // nw × NS × cpl × 32
  off = align16(off + static_cast<size_t>(nw) * NS * cpl * 32 * 4);
  int* flag = reinterpret_cast<int*>(smem + off);
  float* acc_s = part_s + static_cast<size_t>(warp) * NS * cpl * 32;

  const int c = blockIdx.x;
  const int start = c * p.base + min(c, p.rem);
  const int end = start + p.base + (c < p.rem ? 1 : 0);

  if constexpr (!MSK) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, nw);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == nw) {
      // the producer: stage n holds rows r0 .. r0 + cnt − 1 of one b
      if (lane == 0) {
        int n = 0;
        for (int lo = start; lo < end;) {
          const int b = lo / L, hi = min(end, (b + 1) * L);
          for (int r0 = lo; r0 < hi; r0 += sr, ++n) {
            const int cnt = min(sr, hi - r0), l0 = r0 - b * L, i = n % S;
            if (n >= S) mbar_wait<true>(empty + i, (n / S - 1) & 1);
            unsigned char* dst = ring + i * stage;
            mbar_expect_tx(full + i, static_cast<uint32_t>(
                                         cnt * slot_bytes<T, TD, GATED>(D)));
            copy_rows(dst, static_cast<const T*>(p.x) + b * p.x_sb + l0 * p.x_sl,
                      p.x_sl, D, cnt, full + i);
            copy_rows(dst + sr * row_t,
                      static_cast<const T*>(p.g) + b * p.g_sb + l0 * p.g_sl,
                      p.g_sl, D, cnt, full + i);
            if constexpr (GATED) {
              copy_rows(dst + 2 * sr * row_t,
                        static_cast<const T*>(p.gx) + b * p.gx_sb + l0 * p.gx_sl,
                        p.gx_sl, D, cnt, full + i);
              copy_rows(dst + 3 * sr * row_t,
                        static_cast<const TD*>(p.dl) + b * p.dl_sb + l0 * p.dl_sl,
                        p.dl_sl, D, cnt, full + i);
            }
          }
          lo = hi;
        }
      }
      return;  // the consumers sync among themselves from here on
    }
  }

  float acc[REG ? NS : 1][REG ? RCH * VEC : 1];
#pragma unroll
  for (int s = 0; s < (REG ? NS : 1); ++s)
#pragma unroll
    for (int e = 0; e < (REG ? RCH * VEC : 1); ++e) acc[s][e] = 0.f;
  if constexpr (!REG) {
    for (int e = lane; e < NS * cpl * 32; e += 32) acc_s[e] = 0.f;
  }

  // runs body(i) over this lane's chunks i (chunk k = lane + 32·i < nk),
  // unrolled where the partials live in registers
  auto for_chunks = [&](auto&& body) {
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < RCH; ++i)
        if (lane + 32 * i < nk) body(i);
    } else {
      for (int i = 0; i < kpl; ++i)
        if (lane + 32 * i < nk) body(i);
    }
  };
  auto add_acc = [&](int s, int i, int j, float v) {
    if constexpr (REG)
      acc[s][i * VEC + j] += v;
    else
      acc_s[(s * cpl + i * VEC + j) * 32 + lane] += v;
  };

  // global scratch: the (CTA, b) slots, the (group, b) slots, dγ per b and
  // per group of b's; tickets of the (group, b) finishes, of the b's, of
  // the groups of b's, of dγ
  const int ng = (p.ctas + GROUP - 1) / GROUP;
  const int nbg = (p.B + GROUP - 1) / GROUP;
  float* slots = p.part;
  float* gslots = slots + static_cast<size_t>(p.ctas + p.B - 1) * NS * D;
  float* grows = gslots + static_cast<size_t>(ng + p.B - 1) * NS * D;
  float* bgrows = grows + static_cast<size_t>(p.B) * D;
  int* t_group = p.ticket;
  int* t_b = t_group + ng + p.B - 1;
  int* t_bg = t_b + p.B;
  int* t_gamma = t_bg + nbg;

  int n = 0;  // stages taken
  for (int seg_lo = start; seg_lo < end;) {
    const int b = seg_lo / L;
    const int seg_hi = min(end, (b + 1) * L);
    // b's sums, element e = s·D + col, rounded once into their dtypes;
    // γ and 1 + scale of b are in the constants (the finisher of b has
    // just taken rows of b)
    auto write_b = [&](int e, float v) {
      const int s = e / D, col = e - s * D;
      const long long o = static_cast<long long>(b) * D + col;
      if (s == 0) {
        st_any(p.dshift, o, v, p.dshift_bf16);
      } else if (s == 1) {
        const int ci = cst_idx<VEC>(col, nk);
        st_any(p.dscale, o, HAS_GAMMA ? cst[C_GAMMA * csz + ci] * v : v,
               p.dscale_bf16);
        if constexpr (HAS_GAMMA) grows[o] = cst[ci] * v;
      } else {
        st_any(p.dgate, o, v, p.dgate_bf16);
      }
    };
    for (int col = threadIdx.x; col < D; col += nt) {
      const int ci = cst_idx<VEC>(col, nk);
      cst[ci] = 1.f + ld_any(p.scale, b * p.scale_sb + col, p.scale_bf16);
      if (HAS_GAMMA && seg_lo == start)
        cst[C_GAMMA * csz + ci] = ld_any(p.gamma, col, p.gamma_bf16);
      if constexpr (GATED)
        cst[C_GATE * csz + ci] = ld_any(p.gate, b * p.gate_sb + col, p.gate_bf16);
    }
    cbar(nw);

    // rows r0 + warp and r0 + warp + nw of each stage, NR of them here
    auto process = [&](auto rows_tag, int r0, const unsigned char* st) {
      constexpr int NR = decltype(rows_tag)::value;
      const T* xr[NR];
      const T* gr[NR];
      const T* gxr[NR];
      const TD* dr[NR];
      T* dxr[NR];
      TD* ddr[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const int r = r0 + warp + q * nw;
        if constexpr (MSK) {
          const int l = r - b * L;
          xr[q] = static_cast<const T*>(p.x) + b * p.x_sb + l * p.x_sl;
          gr[q] = static_cast<const T*>(p.g) + b * p.g_sb + l * p.g_sl;
          gxr[q] = static_cast<const T*>(p.gx) + b * p.gx_sb + l * p.gx_sl;
          dr[q] = static_cast<const TD*>(p.dl) + b * p.dl_sb + l * p.dl_sl;
        } else {
          const int w = warp + q * nw;  // the row's slot in the stage
          xr[q] = reinterpret_cast<const T*>(st + w * row_t);
          gr[q] = reinterpret_cast<const T*>(st + (sr + w) * row_t);
          gxr[q] = reinterpret_cast<const T*>(st + (2 * sr + w) * row_t);
          dr[q] = reinterpret_cast<const TD*>(st + 3 * sr * row_t + w * row_d);
        }
        dxr[q] = static_cast<T*>(p.dx) + static_cast<long long>(r) * D;
        ddr[q] = static_cast<TD*>(p.dd) + static_cast<long long>(r) * D;
      }
      // pass 1: Σx² and Σx·dn over each row
      float ss[NR], t[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) ss[q] = t[q] = 0.f;
      for_chunks([&](int i) {
        const int k = lane + 32 * i;
        float ops[VEC], mul[VEC];
        [[maybe_unused]] float gam[VEC];
        lds_cst<VEC, MSK>(cst, k, nk, D, ops);
        if constexpr (HAS_GAMMA) lds_cst<VEC, MSK>(cst + C_GAMMA * csz, k, nk, D, gam);
#pragma unroll
        for (int j = 0; j < VEC; ++j) mul[j] = HAS_GAMMA ? ops[j] * gam[j] : ops[j];
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          float xv[VEC], gv[VEC];
          if constexpr (MSK) {
            ldg_chunk<VEC>(xr[q], k * VEC, D, xv);
            ldg_chunk<VEC>(gr[q], k * VEC, D, gv);
          } else {
            unpack(lds128(xr[q] + k * VEC), static_cast<T*>(nullptr), xv);
            unpack(lds128(gr[q] + k * VEC), static_cast<T*>(nullptr), gv);
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            ss[q] += xv[j] * xv[j];
            t[q] += xv[j] * (gv[j] * mul[j]);
          }
        }
      });
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          ss[q] += __shfl_xor_sync(0xffffffffu, ss[q], o);
          t[q] += __shfl_xor_sync(0xffffffffu, t[q], o);
        }
      float rr[NR], cd[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        rr[q] = rsqrtf(ss[q] * inv_d + p.eps);
        cd[q] = rr[q] * t[q] * inv_d;  // mean(n·dn)
      }

      // pass 2: dx (dδ), the column partials, row by row within a column
      for_chunks([&](int i) {
        const int k = lane + 32 * i, col0 = k * VEC;
        float mul[VEC];
        [[maybe_unused]] float gam[VEC], gate[VEC];
        lds_cst<VEC, MSK>(cst, k, nk, D, mul);
        if constexpr (HAS_GAMMA) {
          lds_cst<VEC, MSK>(cst + C_GAMMA * csz, k, nk, D, gam);
#pragma unroll
          for (int j = 0; j < VEC; ++j) mul[j] *= gam[j];
        }
        if constexpr (GATED) lds_cst<VEC, MSK>(cst + C_GATE * csz, k, nk, D, gate);
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          float xv[VEC], gv[VEC], dxv[VEC];
          [[maybe_unused]] float gxv[VEC], dv[VEC], ddv[VEC];
          if constexpr (MSK) {
            ldg_chunk<VEC>(xr[q], col0, D, xv);
            ldg_chunk<VEC>(gr[q], col0, D, gv);
            if constexpr (GATED) {
              ldg_chunk<VEC>(gxr[q], col0, D, gxv);
              ldg_chunk<VEC>(dr[q], col0, D, dv);
            }
          } else {
            unpack(lds128(xr[q] + col0), static_cast<T*>(nullptr), xv);
            unpack(lds128(gr[q] + col0), static_cast<T*>(nullptr), gv);
            if constexpr (GATED) {
              unpack(lds128(gxr[q] + col0), static_cast<T*>(nullptr), gxv);
              lds_vec<VEC>(dr[q] + col0, dv);
            }
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float nn = xv[j] * rr[q];
            const float dn = gv[j] * mul[j];
            float d = rr[q] * (dn - nn * cd[q]);
            add_acc(0, i, j, gv[j]);
            add_acc(1, i, j, gv[j] * nn);
            if constexpr (GATED) {
              d += gxv[j];
              add_acc(S_GATE, i, j, d * dv[j]);
              ddv[j] = d * gate[j];  // dδ
            }
            dxv[j] = d;
          }
          store_chunk<VEC, MSK>(dxr[q], col0, D, dxv);
          if constexpr (GATED) store_chunk<VEC, MSK>(ddr[q], col0, D, ddv);
        }
      });
    };

    for (int r0 = seg_lo; r0 < seg_hi; r0 += sr, ++n) {
      const int i_slot = MSK ? 0 : n % S;
      const unsigned char* st = ring + i_slot * stage;
      if constexpr (!MSK) mbar_wait<true>(full + i_slot, (n / S) & 1);
      if (r0 + warp + nw < seg_hi)
        process(Rows<2>{}, r0, st);
      else if (r0 + warp < seg_hi)
        process(Rows<1>{}, r0, st);
      if constexpr (!MSK) {
        __syncwarp();  // every lane has read its rows of the stage
        if (lane == 0) mbar_arrive(empty + i_slot);
      }
    }

    // flush: the warps' partials of b, added in warp order, to slot c + b
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < RCH; ++i) {
        if (i >= kpl) continue;
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            acc_s[(s * cpl + i * VEC + j) * 32 + lane] = acc[s][i * VEC + j];
            acc[s][i * VEC + j] = 0.f;
          }
      }
    }
    cbar(nw);
    float* dst = slots + static_cast<size_t>(c + b) * NS * D;
    for (int e = threadIdx.x; e < NS * D; e += nt) {
      const int s = e / D, col = e - s * D;
      const int k = col / VEC, j = col - k * VEC;
      const int idx = (s * cpl + (k >> 5) * VEC + j) * 32 + (k & 31);
      float v = part_s[idx];
      for (int w = 1; w < nw; ++w)
        v += part_s[static_cast<size_t>(w) * NS * cpl * 32 + idx];
      dst[e] = v;
    }
    cbar(nw);
    if constexpr (!REG) {
      for (int e = lane; e < NS * cpl * 32; e += 32) acc_s[e] = 0.f;
    }
    // b's CTAs c0..c1 finish in groups of GROUP: the last CTA of this
    // group adds the group's slots; where b spans more than one group, the
    // last group adds the group sums
    const int c0 = cta_of(b * L, p.base, p.rem);
    const int c1 = cta_of((b + 1) * L - 1, p.base, p.rem);
    const int kg = c / GROUP, k0 = c0 / GROUP, k1 = c1 / GROUP;
    const int g_lo = max(c0, kg * GROUP);
    const int g_hi = min(c1, kg * GROUP + GROUP - 1);
    if (threadIdx.x == 0)
      flag[0] = take_ticket(t_group + kg + b, g_hi - g_lo);
    cbar(nw);
    if (flag[0]) {
      const float* src = slots + static_cast<size_t>(g_lo + b) * NS * D;
      bool b_done = k0 == k1;
      if (b_done) {
        ordered_sums(src, NS * D, g_hi - g_lo + 1, NS * D, nt, write_b);
      } else {
        float* dst_g = gslots + static_cast<size_t>(kg + b) * NS * D;
        ordered_sums(src, NS * D, g_hi - g_lo + 1, NS * D, nt,
                     [&](int e, float v) { dst_g[e] = v; });
        cbar(nw);
        if (threadIdx.x == 0) flag[1] = take_ticket(t_b + b, k1 - k0);
        cbar(nw);
        b_done = flag[1];
        if (b_done) {
          ordered_sums(gslots + static_cast<size_t>(k0 + b) * NS * D,
                       NS * D, k1 - k0 + 1, NS * D, nt, write_b);
          if (threadIdx.x == 0) t_b[b] = 0;
        }
      }
      if (threadIdx.x == 0) t_group[kg + b] = 0;
      if constexpr (HAS_GAMMA) {
        // b's dγ row is in: the last b of its group of GROUP b's adds the
        // group's rows, the last group the group rows, in b order
        if (b_done) {
          const int bg = b / GROUP, b_lo = bg * GROUP;
          const int b_hi = min(p.B, b_lo + GROUP) - 1;
          cbar(nw);
          if (threadIdx.x == 0) flag[2] = take_ticket(t_bg + bg, b_hi - b_lo);
          cbar(nw);
          if (flag[2]) {
            const float* rows = grows + static_cast<size_t>(b_lo) * D;
            auto write_gamma = [&](int col, float v) {
              st_any(p.dgamma, col, v, p.dgamma_bf16);
            };
            if (nbg == 1) {
              ordered_sums(rows, D, b_hi - b_lo + 1, D, nt, write_gamma);
            } else {
              float* dst_bg = bgrows + static_cast<size_t>(bg) * D;
              ordered_sums(rows, D, b_hi - b_lo + 1, D, nt,
                           [&](int col, float v) { dst_bg[col] = v; });
              cbar(nw);
              if (threadIdx.x == 0) flag[3] = take_ticket(t_gamma, nbg - 1);
              cbar(nw);
              if (flag[3]) {
                ordered_sums(bgrows, D, nbg, D, nt, write_gamma);
                if (threadIdx.x == 0) *t_gamma = 0;
              }
            }
            if (threadIdx.x == 0) t_bg[bg] = 0;
          }
        }
      }
    }
    cbar(nw);  // flags, constants and buffers are reused
    seg_lo = seg_hi;
  }
}

template <typename T, typename TD, bool G, bool GATED, int MODE>
cudaError_t launch(const AdaLNBwdParams& p, cudaStream_t stream,
                   int* occupancy) {
  auto kern = adaln_bwd_kernel<T, TD, G, GATED, MODE>;
  const size_t smem = smem_bytes<T, TD, G, GATED, MODE>(p.D, p.warps,
                                                        p.stages);
  const int threads = (p.warps + (MODE == MASKED ? 0 : 1)) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kern,
                                                         threads, smem);
  kern<<<p.ctas, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TD, bool G, bool GATED>
cudaError_t by_mode(const AdaLNBwdParams& p, int mode, cudaStream_t s,
                    int* occ) {
  switch (mode) {
    case C16: return launch<T, TD, G, GATED, C16>(p, s, occ);
    case C32: return launch<T, TD, G, GATED, C32>(p, s, occ);
    case SMEM: return launch<T, TD, G, GATED, SMEM>(p, s, occ);
    case MASKED: return launch<T, TD, G, GATED, MASKED>(p, s, occ);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename TD>
cudaError_t by_flags(const AdaLNBwdParams& p, int gated, int has_gamma,
                     int mode, cudaStream_t s, int* occ) {
  if (gated)
    return has_gamma ? by_mode<T, TD, true, true>(p, mode, s, occ)
                     : by_mode<T, TD, false, true>(p, mode, s, occ);
  return has_gamma ? by_mode<T, T, true, false>(p, mode, s, occ)
                   : by_mode<T, T, false, false>(p, mode, s, occ);
}

}  // namespace

// One backward launch (occupancy == NULL), or the CTAs of that
// instantiation an SM holds, into *occupancy (no launch). `p` is read on
// the host: x and the row inputs bf16 (x_bf16 = 1) or fp32, δ bf16
// (dl_bf16 = 1) or fp32; p->warps consumer warps (1–8) beside the producer
// warp of the bulk modes; p->ctas, base, rem the plan; the shared memory is
// the `smem_bytes` layout of (D, warps, stages). mode is one of C16, C32,
// SMEM, MASKED. Returns the cudaError_t.
extern "C" int adaln_bwd(const AdaLNBwdParams* p, int gated, int has_gamma,
                         int x_bf16, int dl_bf16, int mode, void* stream,
                         int* occupancy) {
  if (p->warps < 1 || p->warps > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16)
    err = dl_bf16 || !gated
              ? by_flags<bf16, bf16>(*p, gated, has_gamma, mode, s, occupancy)
              : by_flags<bf16, float>(*p, gated, has_gamma, mode, s, occupancy);
  else
    err = dl_bf16 && gated
              ? by_flags<float, bf16>(*p, gated, has_gamma, mode, s, occupancy)
              : by_flags<float, float>(*p, gated, has_gamma, mode, s, occupancy);
  return static_cast<int>(err);
}

// The shared memory of one instantiation at (D, nw, stages), for the
// wrapper's check of its own sizing.
extern "C" long long adaln_bwd_smem(int gated, int has_gamma, int x_bf16,
                                    int dl_bf16, int mode, int D, int nw,
                                    int stages) {
#define VDS_SMEM(T, TD, G, GT)                                             \
  switch (mode) {                                                          \
    case C16: return static_cast<long long>(smem_bytes<T, TD, G, GT, C16>(D, nw, stages)); \
    case C32: return static_cast<long long>(smem_bytes<T, TD, G, GT, C32>(D, nw, stages)); \
    case SMEM: return static_cast<long long>(smem_bytes<T, TD, G, GT, SMEM>(D, nw, stages)); \
    default: return static_cast<long long>(smem_bytes<T, TD, G, GT, MASKED>(D, nw, stages)); \
  }
  if (x_bf16 && (dl_bf16 || !gated)) {
    if (gated) { if (has_gamma) { VDS_SMEM(bf16, bf16, true, true) } else { VDS_SMEM(bf16, bf16, false, true) } }
    if (has_gamma) { VDS_SMEM(bf16, bf16, true, false) } else { VDS_SMEM(bf16, bf16, false, false) }
  }
  if (x_bf16) {
    if (has_gamma) { VDS_SMEM(bf16, float, true, true) } else { VDS_SMEM(bf16, float, false, true) }
  }
  if (gated && dl_bf16) {
    if (has_gamma) { VDS_SMEM(float, bf16, true, true) } else { VDS_SMEM(float, bf16, false, true) }
  }
  if (gated) { if (has_gamma) { VDS_SMEM(float, float, true, true) } else { VDS_SMEM(float, float, false, true) } }
  if (has_gamma) { VDS_SMEM(float, float, true, false) } else { VDS_SMEM(float, float, false, false) }
#undef VDS_SMEM
}

extern "C" const char* adaln_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
