// The factored-ν AdamW update of the optimizer-in-backward step (sm_90a):
// every factored leaf of one update group in two launches.
//
// Replaces no Pallas kernel: in JAX the factored branch of `_adamw_leaf`
// (video_diffusion_speedrun_tpu/train/inloop.py:88-98) is XLA work. Its
// plain twin is `factored_leaf_update` (train/optim.py), ~37 full-size
// launches a leaf. Per [out, in] weight (torch layout), in fp32, with the
// divisors n_out and n_in the WHOLE weight's dims:
//   row[i] = Σ_o g², col[o] = Σ_i g²                  (pass 1, "sums")
//   vr ← b2·vr + (1−b2)·(row/n_out), vc ← b2·vc + (1−b2)·(col/n_in)
//   denom = max(Σ_i vr / n_in, 1e-30)
//   m2 = b1·m + (1−b1)·g, v̂ = (vc[o]·vr[i]) / denom   (pass 2, "apply")
//   p ← p + (−(lr·lr_t))·((m2/bc1)/(√(v̂/bc2)+eps) + wd·p)
// Every operation of pass 2 and of the factors' update rounds on its own
// (__fmul_rn, __fdiv_rn, ...), in the twin's order, so no FMA contraction
// departs from it; at bf16 p takes `adamw_leaf_delta`'s rounding order as
// in csrc/adamw_multi_tensor.cu (wd·p and the delta round to bf16, the sum
// rounds again), and m leaves in its storage dtype.
//
// What bounds it on the card: bytes. The row and column sums of g² must be
// finished before any element is updated, so at least two passes: g read
// once for the sums (2 B an element in bf16), then g, m and p read and m and
// p written (10 B): 12 B an element, 1.36 GB for an XL block's 113.2 M
// factored elements, 0.405 ms at 3.35 TB/s. The twin moves ~180 B.
// The design:
// - The same tiles in both launches: each leaf cut into tiles of
//   TILE_ROWS rows × TILE_COLS columns, one CTA a tile (found from the
//   leaves' first tiles), the leaves of the group in one launch. Thread t
//   owns 8 adjacent columns (16-byte loads of bf16) of row group t / 64:
//   rows rg, rg + 4, ... of the tile, a warp reading 512 contiguous bytes
//   a row.
// - Pass 1 squares each element once (rounded, as the twin's g²) and sums
//   it two ways: across its 8 columns and the warp's lanes, into the row's
//   share of `col` (the tile's two warps of a row added in shared memory);
//   and down its rows into the tile's partial of `row`. Eight rows are in
//   flight a thread, held as loaded (16 bytes each); each of the two sums
//   over them is a fixed tree. Partials go to an fp32 workspace ([row
//   blocks, in] and [column blocks, out] a leaf), with no float atomics.
// - Finished in the launch, in a fixed order (deterministic), by tickets
//   (the release/acquire pattern of `take_ticket`, hopper.cuh): the last
//   CTA of a column block adds that block's row partials in row-block
//   order, in fp64, and updates vr; the last CTA of a row block adds its
//   rows' col partials in column-block order and updates vc; the last
//   column block of the leaf sums vr (fp64, then a fixed tree) into denom.
//   Each finish reads at most ~0.3 MB from L2 (the tall adaLN weight's
//   column block), so the tail after the copies stays short. Each finisher
//   resets its ticket, so the int32 tickets (zeroed once by the wrapper)
//   are 0 between launches. Where a hook sums the factors over ranks (a
//   sharded weight), pass 1 stops at the local row and col sums, and the
//   wrapper finishes them between the launches.
// - Pass 2 keeps its 8 columns' vr in registers over the tile's rows, one
//   row of g, m and p at a time: its ~60 instructions an element (four
//   correctly rounded divisions and a square root) want warps more than
//   rows in flight, so the register budget is set for 4 CTAs an SM.
// Rows whose width is not a multiple of 8 take scalar loads, each column
// checked against n_in; the tiles and sums are the same.

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // adjacent columns a thread owns
constexpr int TILE_COLS = 512;
constexpr int COL_THREADS = TILE_COLS / VEC;         // 64 threads a row
constexpr int ROW_GROUPS = THREADS / COL_THREADS;    // 4 rows at a time
constexpr int TILE_ROWS = 128;
constexpr int UNROLL = 8;  // rows in flight a thread in pass 1
// CTAs an SM, for the register budget: enough warps in flight to cover
// the loads' latency (pass 1) and the divisions' (pass 2)
constexpr int SUMS_CTAS = 2, APPLY_CTAS = 4;
static_assert(UNROLL == 8 && VEC == 8, "the sums are trees of 8");

struct Consts {
  float b1, omb1, b2, omb2, eps;
};

// The device tables of one group, built once by the wrapper. Per leaf:
// ptrs (p, m, vr, vc); offs, in floats into the workspace: the row
// partials, the col partials, and (sums over ranks) the local row and col
// sums; dims: local n_out, n_in, row blocks, column blocks, its first
// ticket (one a column block, one a row block, then one for the leaf),
// its first tile (the tiles of a leaf run row block by row block);
// hyper: lr, wd (rounded to bf16 for bf16 p), the whole weight's n_out and
// n_in.
struct Tables {
  const long long* ptrs;
  const long long* offs;
  const int* dims;
  const float* hyper;
  int n_leaves;
  long long denom;  // workspace offset of denom [leaves]
};

// This CTA's tile: the last leaf whose first tile is at most blockIdx.x
// (a leaf with no tiles is passed over), its row and column block.
struct Tile {
  int leaf, rb, cb;
  const int* d;  // the leaf's dims
};
__device__ __forceinline__ Tile tile_of(const Tables& t) {
  const int b = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < t.n_leaves && t.dims[6 * (leaf + 1) + 5] <= b) ++leaf;
  const int* d = t.dims + 6 * leaf;
  return {leaf, (b - d[5]) / d[3], (b - d[5]) % d[3], d};
}

__device__ __forceinline__ void load8(const float* p, long long i, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  const float4 b = *reinterpret_cast<const float4*>(p + i + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, long long i, float* x) {
  unpack8(*reinterpret_cast<const uint4*>(p + i), x);
}
__device__ __forceinline__ void store8(float* p, long long i, const float* x) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(bf16* p, long long i, const float* x) {
  *reinterpret_cast<uint4*>(p + i) = pack8(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The sum of 8 values as a fixed tree.
__device__ __forceinline__ float tree8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}

// One element of pass 2: m and p in fp32 registers, updated in place.
template <bool BF16P>
__device__ __forceinline__ void apply_elem(float& p, float& m, float g,
                                           float vc_o, float vr_i,
                                           float denom, float neg_lr,
                                           float wd, float bc1, float bc2,
                                           const Consts& k) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  const float vhat = __fdiv_rn(__fmul_rn(vc_o, vr_i), denom);
  const float dir = __fdiv_rn(
      __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vhat, bc2)), k.eps));
  if (BF16P) {
    const float wdp = round_bf16(__fmul_rn(wd, p));
    p = __fadd_rn(p, round_bf16(__fmul_rn(neg_lr, __fadd_rn(dir, wdp))));
  } else {
    p = __fadd_rn(p, __fmul_rn(neg_lr, __fadd_rn(dir, __fmul_rn(wd, p))));
  }
}

// 8 adjacent values of a row as loaded, before they are widened to fp32
template <typename GT>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw(const bf16* p, long long i,
                                         Raw8<bf16>& r) {
  r.u = *reinterpret_cast<const uint4*>(p + i);
}
__device__ __forceinline__ void load_raw(const float* p, long long i,
                                         Raw8<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p + i);
  r.b = *reinterpret_cast<const float4*>(p + i + 4);
}
__device__ __forceinline__ void widen(const Raw8<bf16>& r, float* x) {
  unpack8(r.u, x);
}
__device__ __forceinline__ void widen(const Raw8<float>& r, float* x) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

template <typename GT>
__global__ void __launch_bounds__(THREADS, SUMS_CTAS)
    factored_adamw_sums_kernel(const Tables t,
                               const long long* __restrict__ g_ptrs,
                               float* __restrict__ ws, int* tickets,
                               const Consts k, const int partial) {
  __shared__ float row_red[2][TILE_ROWS];
  __shared__ __align__(16) float col_red[ROW_GROUPS][TILE_COLS];
  __shared__ double fin[THREADS];
  __shared__ int flags;
  const Tile tl = tile_of(t);
  const int leaf = tl.leaf, rb = tl.rb, cb = tl.cb;
  const int* d = tl.d;
  const int n_out = d[0], n_in = d[1], n_rb = d[2], n_cb = d[3];
  const long long* of = t.offs + 4 * leaf;
  const GT* g = reinterpret_cast<const GT*>(g_ptrs[leaf]);
  const int tid = threadIdx.x, lane = tid % 32, half = (tid / 32) % 2;
  const int rg = tid / COL_THREADS;
  const int c0 = cb * TILE_COLS + (tid % COL_THREADS) * VEC;
  const bool vec = n_in % VEC == 0 && c0 < n_in;
  const int r0 = rb * TILE_ROWS;
  const int rows = min(TILE_ROWS, n_out - r0);

  float cacc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) cacc[e] = 0.f;
  // j is the same for the warp's lanes: the shuffles see every lane
  for (int j = rg; j < rows; j += ROW_GROUPS * UNROLL) {
    Raw8<GT> raw[UNROLL];
    if (vec) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = j + u * ROW_GROUPS;
        if (r < rows)
          load_raw(g, static_cast<long long>(r0 + r) * n_in + c0, raw[u]);
      }
    }
    // the column sums over the 8 rows as the tree ((0+1)+(2+3))+((4+5)+
    // (6+7)), folded as each row arrives
    float lv0[VEC], lv1[VEC], lv2[VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = j + u * ROW_GROUPS;
      float x[VEC];
      if (r < rows && vec) {
        widen(raw[u], x);
      } else {
        const long long base = static_cast<long long>(r0 + r) * n_in + c0;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          x[e] = r < rows && c0 + e < n_in ? to_f(g[base + e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = __fmul_rn(x[e], x[e]);
      float s = tree8(x);
#pragma unroll
      for (int w = 16; w > 0; w /= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
      if (lane == 0 && r < rows) row_red[half][r] = s;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (u % 2 == 0) {
          lv0[e] = x[e];
          continue;
        }
        const float a = lv0[e] + x[e];
        if (u % 4 == 1) {
          lv1[e] = a;
          continue;
        }
        const float b = lv1[e] + a;
        if (u == 3)
          lv2[e] = b;
        else
          cacc[e] += lv2[e] + b;
      }
    }
  }
  float4* cr =
      reinterpret_cast<float4*>(&col_red[rg][(tid % COL_THREADS) * VEC]);
  cr[0] = make_float4(cacc[0], cacc[1], cacc[2], cacc[3]);
  cr[1] = make_float4(cacc[4], cacc[5], cacc[6], cacc[7]);
  __syncthreads();
  float* rowpart = ws + of[0];
  float* colpart = ws + of[1];
  for (int c = tid; c < TILE_COLS; c += THREADS) {
    const int col = cb * TILE_COLS + c;
    if (col < n_in)
      rowpart[static_cast<long long>(rb) * n_in + col] =
          (col_red[0][c] + col_red[1][c]) + (col_red[2][c] + col_red[3][c]);
  }
  for (int r = tid; r < rows; r += THREADS)
    colpart[static_cast<long long>(cb) * n_out + r0 + r] =
        row_red[0][r] + row_red[1][r];
  __syncthreads();

  // two tickets: the last row block of this column block finishes row[i]
  // for its columns, the last column block of this row block col[o] for
  // its rows (the fences as in `take_ticket`)
  int* tk = tickets + d[4];
  if (tid == 0) {
    __threadfence();
    const int lc = atomicAdd(tk + cb, 1) == n_rb - 1;
    const int lr = atomicAdd(tk + n_cb + rb, 1) == n_cb - 1;
    __threadfence();
    if (lc) tk[cb] = 0;
    if (lr) tk[n_cb + rb] = 0;
    flags = lc | lr << 1;
  }
  __syncthreads();
  const int f = flags;
  if (f == 0) return;
  const float* hy = t.hyper + 4 * leaf;
  const float n_out_g = hy[2], n_in_g = hy[3];
  float* vr = reinterpret_cast<float*>(t.ptrs[4 * leaf + 2]);
  float* vc = reinterpret_cast<float*>(t.ptrs[4 * leaf + 3]);
  if (f & 2) {
    for (int r = tid; r < rows; r += THREADS) {
      const int o = r0 + r;
      double acc = 0.0;
#pragma unroll 4
      for (int q = 0; q < n_cb; ++q)
        acc += __ldcg(colpart + static_cast<long long>(q) * n_out + o);
      const float col = __double2float_rn(acc);
      if (partial)
        ws[of[3] + o] = col;
      else
        vc[o] = __fadd_rn(__fmul_rn(k.b2, vc[o]),
                          __fmul_rn(k.omb2, __fdiv_rn(col, n_in_g)));
    }
  }
  if (!(f & 1)) return;
  static_assert(TILE_COLS == 2 * THREADS, "two columns a thread");
  const int ca = cb * TILE_COLS + tid, cz = ca + THREADS;
  double a0 = 0.0, a1 = 0.0;
#pragma unroll 8
  for (int q = 0; q < n_rb; ++q) {
    const float* src = rowpart + static_cast<long long>(q) * n_in;
    if (ca < n_in) a0 += __ldcg(src + ca);
    if (cz < n_in) a1 += __ldcg(src + cz);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = h ? cz : ca;
    if (col >= n_in) break;
    const float row = __double2float_rn(h ? a1 : a0);
    if (partial)
      ws[of[2] + col] = row;
    else
      vr[col] = __fadd_rn(__fmul_rn(k.b2, vr[col]),
                          __fmul_rn(k.omb2, __fdiv_rn(row, n_out_g)));
  }
  if (partial) return;
  __syncthreads();

  // the last column block of the leaf: denom from the whole of vr
  int* tick = tk + n_cb + n_rb;
  if (tid == 0) flags = take_ticket(tick, n_cb - 1);
  __syncthreads();
  if (!flags) return;
  if (tid == 0) *tick = 0;
  double s = 0.0;
#pragma unroll 8
  for (int i = tid; i < n_in; i += THREADS) s += __ldcg(vr + i);
  fin[tid] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w /= 2) {
    if (tid < w) fin[tid] += fin[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    const float den = __fdiv_rn(__double2float_rn(fin[0]), n_in_g);
    ws[t.denom + leaf] = den < 1e-30f ? 1e-30f : den;  // NaN stays NaN
  }
}

template <typename PT, typename MT>
__global__ void __launch_bounds__(THREADS, APPLY_CTAS)
    factored_adamw_apply_kernel(const Tables t,
                                const long long* __restrict__ g_ptrs,
                                const float* __restrict__ ws,
                                const float* __restrict__ scalars,
                                const Consts k) {
  constexpr bool BF16P = sizeof(PT) == 2;
  const Tile tl = tile_of(t);
  const int leaf = tl.leaf, rb = tl.rb, cb = tl.cb;
  const int* d = tl.d;
  const int n_out = d[0], n_in = d[1];
  const int tid = threadIdx.x, rg = tid / COL_THREADS;
  const int c0 = cb * TILE_COLS + (tid % COL_THREADS) * VEC;
  if (c0 >= n_in) return;
  PT* p = reinterpret_cast<PT*>(t.ptrs[4 * leaf]);
  MT* m = reinterpret_cast<MT*>(t.ptrs[4 * leaf + 1]);
  const float* vr = reinterpret_cast<const float*>(t.ptrs[4 * leaf + 2]);
  const float* vc = reinterpret_cast<const float*>(t.ptrs[4 * leaf + 3]);
  const PT* g = reinterpret_cast<const PT*>(g_ptrs[leaf]);
  const float neg_lr = -__fmul_rn(t.hyper[4 * leaf], scalars[0]);
  const float wd = t.hyper[4 * leaf + 1];
  const float bc1 = scalars[1], bc2 = scalars[2];
  const float denom = ws[t.denom + leaf];
  const int r0 = rb * TILE_ROWS;
  const int rows = min(TILE_ROWS, n_out - r0);

  if (n_in % VEC == 0) {
    float vri[VEC];
    load8(vr, c0, vri);
    for (int j = rg; j < rows; j += ROW_GROUPS) {
      const long long i = static_cast<long long>(r0 + j) * n_in + c0;
      float pp[VEC], mm[VEC], gg[VEC];
      load8(g, i, gg);
      load8(m, i, mm);
      load8(p, i, pp);
      const float vco = vc[r0 + j];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        apply_elem<BF16P>(pp[e], mm[e], gg[e], vco, vri[e], denom, neg_lr,
                          wd, bc1, bc2, k);
      store8(p, i, pp);
      store8(m, i, mm);
    }
    return;
  }
  for (int j = rg; j < rows; j += ROW_GROUPS) {
    const long long base = static_cast<long long>(r0 + j) * n_in;
    const float vco = vc[r0 + j];
    for (int e = 0; e < VEC && c0 + e < n_in; ++e) {
      const long long i = base + c0 + e;
      float pe = to_f(p[i]), me = to_f(m[i]);
      apply_elem<BF16P>(pe, me, to_f(g[i]), vco, vr[c0 + e], denom, neg_lr,
                        wd, bc1, bc2, k);
      from_f(p + i, pe);
      from_f(m + i, me);
    }
  }
}

}  // namespace

// 0: rows of a tile, 1: columns of a tile.
extern "C" long long factored_adamw_geometry(int which) {
  return which == 0 ? TILE_ROWS : TILE_COLS;
}

// Pass 1 over n_tiles tiles: the factors' sums (partial = 0: finished into
// vr, vc and denom; 1: the local row and col sums only). grads_bf16
// selects bf16 gradients. b2/omb2 are the fp32 roundings of b2 and 1−b2.
// Returns the launch's cudaError_t.
extern "C" int factored_adamw_sums(const void* ptrs, const void* offs,
                                   const void* dims, const void* hyper,
                                   int n_leaves, long long denom,
                                   const void* g_ptrs,
                                   void* ws, void* tickets, int n_tiles,
                                   float b2, float omb2, int partial,
                                   int grads_bf16, void* stream) {
  const Tables t{static_cast<const long long*>(ptrs),
                 static_cast<const long long*>(offs),
                 static_cast<const int*>(dims),
                 static_cast<const float*>(hyper),
                 n_leaves, denom};
  const Consts k{0.f, 0.f, b2, omb2, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const long long*>(g_ptrs);
  auto* w = static_cast<float*>(ws);
  auto* tk = static_cast<int*>(tickets);
  if (grads_bf16)
    factored_adamw_sums_kernel<bf16><<<n_tiles, THREADS, 0, s>>>(
        t, gp, w, tk, k, partial);
  else
    factored_adamw_sums_kernel<float><<<n_tiles, THREADS, 0, s>>>(
        t, gp, w, tk, k, partial);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 over the same tiles: m and p from g and the finished factors.
// params_bf16 selects bf16 parameters and gradients (wd in the table
// already rounded to bf16), moments_bf16 the bf16 storage of m. scalars:
// (lr_t, bc1, bc2) on the device. Returns the launch's cudaError_t.
extern "C" int factored_adamw_apply(const void* ptrs, const void* offs,
                                    const void* dims, const void* hyper,
                                    int n_leaves, long long denom,
                                    const void* g_ptrs, const void* ws,
                                    const void* scalars, int n_tiles,
                                    float b1, float omb1, float eps,
                                    int params_bf16, int moments_bf16,
                                    void* stream) {
  const Tables t{static_cast<const long long*>(ptrs),
                 static_cast<const long long*>(offs),
                 static_cast<const int*>(dims),
                 static_cast<const float*>(hyper),
                 n_leaves, denom};
  const Consts k{b1, omb1, 0.f, 0.f, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const long long*>(g_ptrs);
  const auto* w = static_cast<const float*>(ws);
  const auto* sc = static_cast<const float*>(scalars);
  if (params_bf16 && moments_bf16)
    factored_adamw_apply_kernel<bf16, bf16><<<n_tiles, THREADS, 0, s>>>(
        t, gp, w, sc, k);
  else if (params_bf16)
    factored_adamw_apply_kernel<bf16, float><<<n_tiles, THREADS, 0, s>>>(
        t, gp, w, sc, k);
  else if (moments_bf16)
    factored_adamw_apply_kernel<float, bf16><<<n_tiles, THREADS, 0, s>>>(
        t, gp, w, sc, k);
  else
    factored_adamw_apply_kernel<float, float><<<n_tiles, THREADS, 0, s>>>(
        t, gp, w, sc, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* factored_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
