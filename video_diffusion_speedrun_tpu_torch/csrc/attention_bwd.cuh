// The attention backward shared by the short, long and ring paths, for
// Hopper (sm_90a): header-only, instantiated by `short_attention_bwd.cu`
// (rows 4–5: ROPE on or off), `long_attention_bwd.cu` (rows 7 and 9:
// pre-rotated q/k, ROPE off, with or without the kv-bias) and
// `ring_attention_bwd.cu` (row 11: ROPE on with separate q and k tables,
// the kv-bias, the given merged o and lse). It replaces the Pallas
// backward functions of `video_diffusion_speedrun_tpu/ops/fused_attention.py`:
// `_backward_short_qkv` (:873) and `_backward_short` (:1042), `_backward`
// (:534) with its split-off tail `_backward_tail` (:1596), and
// `_ring_chunk_bwd` (:1235).
//
// What it computes, per (b, h), with the TPU kernels' rounding points
// (`_bwd_short_kernel` and `_bwd_dkv_kernel` / `_bwd_dq_kernel` round alike):
//   q, k rotated in fp32 by their own tables (ROPE), then
//   qs = bf16(q·scale·log2e), qd = bf16(q·scale), kc = bf16(k),
//   kd = bf16(k·scale); p = exp2(qs·kcᵀ + bias − lse) in fp32 (BIAS: the
//   fp32 kv row; lse is the exp2-domain one the caller gives, the forward's
//   or, on the ring, the merged one over all chunks),
//   δ = rowsum(do ⊙ o) in fp32, dv = bf16(p)ᵀ·do, dp = do·vᵀ,
//   ds = bf16(p·(dp − δ)), dq = ds·kd, dk = dsᵀ·qd, both accumulated in
//   fp32 and rotated back by Rᵀ (x1·c − x2·s, x1·s + x2·c) when ROPE,
//   stored bf16.
//
// What bounds it on the card: 10·B·H·Lq·Lk·D useful flops against a few
// bytes per q/k/v/o element — compute-bound at every shape the model runs
// (~90 GFLOP over ~100 MB at B=64, H=4, L=528; ~690 GFLOP over ~60 MB at
// B=2, H=4, L=8208). So every product runs on Hopper's warpgroup tensor
// instruction (wgmma, bf16 in, fp32 accumulate), its operands brought to
// shared memory by the Tensor Memory Accelerator (TMA), and each product
// is done once.
//
// The design: one pass, warp-specialised. A block owns BN = 128 kv rows
// of one (b, h) and runs three warpgroups. In warpgroup 0 one thread loads
// by TMA — kc, kd and v of the 128 rows once (resident), then per q tile
// of BM = 64 rows qs and do (and the tile's lse and δ) into a 2-stage ring
// and qd into one buffer, each guarded by mbarriers — and one thread of
// warp 1 writes the dq partials (below). Warpgroups 1 and 2 each own 64
// kv rows (setmaxnreg: 240 registers each, 24 for warpgroup 0). Per q
// tile each, in two halves of 32 q columns, forms sᵀ = kc·qsᵀ and
// dpᵀ = v·doᵀ (wgmma, both operands in shared memory, K-major over D) and
// from them pᵀ and dsᵀ in fp32 registers; accumulates dv += bf16(pᵀ)·do
// (A from registers, B MN-major); writes bf16(dsᵀ) to a shared tile; then
// accumulates dk += bf16(dsᵀ)·qd (A from that tile, B MN-major) — dk and
// dv stay in registers for the whole q loop — and computes its half of
// the tile's dq partial ds·kd over all 128 kv rows (A and B MN-major): 10
// units of tensor work where the earlier two-pass design recomputed s and
// dp for a dq pass (14). Where the kv blocks alone leave SMs idle (a short
// kv against a long q, or a 137th block), each kv block's q tiles are
// split over a few blocks (SPLIT), whose fp32 dk, dv partials a last kernel
// sums in split order.
//
// dq across kv blocks, deterministically: each tile's fp32 partial goes to
// shared memory, and the writer thread adds it to an fp32 accumulator
// (tiles of 64 q rows) with one bulk copy (kv block 0) or bulk reduce-add
// (the others). A counter per (b, h, q tile) holds the number of the kv
// block whose turn it is; the writer waits for its turn, adds, frees the
// staging buffer once the add has read it, waits for the add to complete
// and passes the turn on, so the sum order is fixed and two launches give
// the same bits (the TPU instead stores one partial per
// kv block and sums them outside). Blocks take their (kv block, b, h) from
// an atomic ticket when they start, kv block major where the (b, h) are
// fewer than the SMs (the blocks running at once then share each (b, h)'s
// q tiles in L2), else (b, h) major (a (b, h)'s few kv blocks run together
// and read its q tiles once from memory, not once each): either way a
// block only waits for a smaller ticket, which a block already running
// holds, so the waits cannot deadlock whatever the grid and the order the
// hardware starts blocks in. A last kernel rounds the accumulator to bf16 (dq rotated back
// by the q table when ROPE).
//
// Registers: dk and dv alone hold 128 of a consumer thread's 240. ptxas
// gives the consumers setmaxnreg's 240 only if no trap can be reached in
// their code (with one it keeps them to the launch's 168, spills dk and dv
// every tile and serialises every wgmma, C7512), so only the loader's and
// the writer's waits trap (mbar_wait). What is left (PERF.md §6, PR 6):
// one block per SM (~226 KB of shared memory), so a block's setup and
// epilogue do not overlap another's, and a single dq staging buffer.
//
// A prologue rotates and rounds q and k once (as the forward's
// `rope_rotate_kernel`) into head-major scratch [B, H, L, D], computes δ
// and copies lse into rows padded to whole q tiles, so the main kernel
// streams ready bf16 tiles and never touches cos/sin until dk's final Rᵀ.
// TMA zero-fills the ragged edges, and p and ds are set to 0 past Lq
// (columns of pᵀ) and past Lk or on a kv row whose bias is −1e30 (its
// rows), so a padded row adds nothing to dq, dk or dv whatever its lse:
// exp2(s − 1e30 − lse) is 0 for any finite lse as it is, and this keeps
// it 0 where lse is itself ≈ −1e30 (a ring chunk of padding against its
// own lse), where the formula gives 0, 1 or inf by rounding. A wait that
// spins for ~10 s traps, so a fault ends the launch instead of hanging the
// card. Every offset that grows with B·L·H·D is 64-bit.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int BN = 128;  // kv rows owned by a block: 64 per consumer warpgroup
constexpr int BM = 64;   // q rows of each streamed tile
constexpr int NT = 384;  // the producer warpgroup and two consumer ones
constexpr int NSTAGE = 2;
// a kv-bias at or below this masks its row (the ring's padding is −1e30)
constexpr float kMaskedBias = -1e29f;

// In fp32: (x1, x2) ← (x1·c − x2·s, x1·s + x2·c), the transpose of rotate8,
// for the two accumulator values a thread holds at columns col, col+1.
__device__ __forceinline__ void rotate_t2(float* x1, float* x2, const float* cs,
                                          const float* sn) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float y1 = x1[e] * cs[e] - x2[e] * sn[e];
    const float y2 = x1[e] * sn[e] + x2[e] * cs[e];
    x1[e] = y1;
    x2[e] = y2;
  }
}

// q side, one thread per 8 rotation pairs of one (b, l, h):
// qs/qd [B, H, L, D]; rows [B·H, 2, Lp]: δ = Σ_d do·o, then lse copied
// (Lp = L padded to whole q tiles; the padding is never read as a value).
template <int D, bool ROPE>
__global__ void prep_q_kernel(const bf16* __restrict__ q, long long q_sb,
                              long long q_sl, const bf16* __restrict__ dout,
                              long long do_sb, long long do_sl,
                              const bf16* __restrict__ o, long long o_sb,
                              long long o_sl, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t,
                              const float* __restrict__ lse,
                              bf16* __restrict__ qs, bf16* __restrict__ qd,
                              float* __restrict__ rows, int H, int L, int Lp,
                              float q_mul, float scale, long long total) {
  constexpr int H2 = D / 2;
  constexpr int CH = H2 / 8;  // threads per (b, l, h) row: 8 or 4
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const bool valid = i < total;
  const long long ii = valid ? i : 0;
  const int c = static_cast<int>(ii % CH) * 8;
  long long rest = ii / CH;
  const int h = static_cast<int>(rest % H);
  rest /= H;
  const int l = static_cast<int>(rest % L);
  const long long b = rest / L;
  float part = 0.f;
  if (valid) {
    const bf16* p = q + b * q_sb + l * q_sl + h * D + c;
    float x1[8], x2[8], a1[8], a2[8];
    unpack8(*reinterpret_cast<const uint4*>(p), x1);
    unpack8(*reinterpret_cast<const uint4*>(p + H2), x2);
    if (ROPE)
      rotate8(x1, x2, cos_t + static_cast<long long>(l) * H2 + c,
              sin_t + static_cast<long long>(l) * H2 + c);
    const long long out = ((b * H + h) * L + l) * D + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a1[j] = x1[j] * q_mul;
      a2[j] = x2[j] * q_mul;
      x1[j] *= scale;
      x2[j] *= scale;
    }
    *reinterpret_cast<uint4*>(qs + out) = pack8(a1);
    *reinterpret_cast<uint4*>(qs + out + H2) = pack8(a2);
    *reinterpret_cast<uint4*>(qd + out) = pack8(x1);
    *reinterpret_cast<uint4*>(qd + out + H2) = pack8(x2);
    const bf16* pd = dout + b * do_sb + l * do_sl + h * D + c;
    const bf16* po = o + b * o_sb + l * o_sl + h * D + c;
    float g1[8], g2[8], o1[8], o2[8];
    unpack8(*reinterpret_cast<const uint4*>(pd), g1);
    unpack8(*reinterpret_cast<const uint4*>(pd + H2), g2);
    unpack8(*reinterpret_cast<const uint4*>(po), o1);
    unpack8(*reinterpret_cast<const uint4*>(po + H2), o2);
#pragma unroll
    for (int j = 0; j < 8; ++j) part += g1[j] * o1[j] + g2[j] * o2[j];
  }
  // the CH threads of a row are consecutive lanes of one warp
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffff, part, off);
  if (valid && c == 0) {
    const long long bh = b * H + h;
    rows[bh * 2 * Lp + l] = part;
    rows[bh * 2 * Lp + Lp + l] = lse[bh * L + l];
  }
}

// k side: kc = bf16(rot(k)), kd = bf16(rot(k)·scale) into [B, H, L, D].
template <int D, bool ROPE>
__global__ void prep_k_kernel(const bf16* __restrict__ k, long long k_sb,
                              long long k_sl, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t,
                              bf16* __restrict__ kc, bf16* __restrict__ kd,
                              int H, int L, float scale, long long total) {
  constexpr int H2 = D / 2;
  constexpr int CH = H2 / 8;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % CH) * 8;
  long long rest = i / CH;
  const int h = static_cast<int>(rest % H);
  rest /= H;
  const int l = static_cast<int>(rest % L);
  const long long b = rest / L;
  const bf16* p = k + b * k_sb + l * k_sl + h * D + c;
  float x1[8], x2[8];
  unpack8(*reinterpret_cast<const uint4*>(p), x1);
  unpack8(*reinterpret_cast<const uint4*>(p + H2), x2);
  if (ROPE)
    rotate8(x1, x2, cos_t + static_cast<long long>(l) * H2 + c,
            sin_t + static_cast<long long>(l) * H2 + c);
  const long long out = ((b * H + h) * L + l) * D + c;
  *reinterpret_cast<uint4*>(kc + out) = pack8(x1);
  *reinterpret_cast<uint4*>(kc + out + H2) = pack8(x2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x1[j] *= scale;
    x2[j] *= scale;
  }
  *reinterpret_cast<uint4*>(kd + out) = pack8(x1);
  *reinterpret_cast<uint4*>(kd + out + H2) = pack8(x2);
}


// Byte offsets into the block's shared memory. A bf16 tile is stored as
// panels of 64 columns (128 bytes a row, the TMA's 128-byte swizzle): kc,
// kd, v [NP panels][BN rows] for the block's life; per stage qs and do
// [NP][BM rows] and the stage's δ and lse rows; qd [NP][BM] and ds [BN kv
// rows][BM q] (one panel) single; the dq partial of each consumer
// warpgroup, fp32 [BM][64] with its 16-byte chunks swizzled; the barriers.
template <int D>
struct Layout {
  static constexpr int NP = D / 64;
  static constexpr int NDQ = D == 128 ? 2 : 1;  // dq writers: warpgroups
  static constexpr int PANEL_KV = BN * 128;
  static constexpr int PANEL_Q = BM * 128;
  static constexpr int KV_TILE = NP * PANEL_KV;
  static constexpr int Q_TILE = NP * PANEL_Q;
  static constexpr int KC = 0;
  static constexpr int KD = KV_TILE;
  static constexpr int V = 2 * KV_TILE;
  static constexpr int Q = 3 * KV_TILE;  // stage s: qs, do
  static constexpr int STAGE = 2 * Q_TILE;
  static constexpr int QD = Q + NSTAGE * STAGE;
  static constexpr int DS = QD + Q_TILE;
  static constexpr int DQ = DS + BN * 128;
  static constexpr int DQ_TILE = BM * 64 * 4;
  static constexpr int ROWS = DQ + NDQ * DQ_TILE;  // stage s: δ, lse
  static constexpr int BARS = ROWS + NSTAGE * 2 * BM * 4;
  // full[NSTAGE], empty[NSTAGE], qd_full, qd_empty, kv, dq_full,
  // dq_empty, then the ticket and the block's smem base >> 4
  static constexpr int BYTES = BARS + (2 * NSTAGE + 5) * 8 + 16;
  static constexpr uint32_t STAGE_TX = STAGE + 2 * BM * 4;
  static constexpr uint32_t KV_TX = 3 * KV_TILE;
};

// The offset of fp32 element (r, c) of a BM × 64 dq tile: 16-byte chunks
// XOR-swizzled by the row, so the consumers' stores meet no bank conflict.
__device__ __forceinline__ int dq_tile_off(int r, int c) {
  return r * 64 + (((c >> 2) ^ (r & 15)) << 2) + (c & 3);
}

// The one-pass backward, warp-specialised. Warpgroup 0: warp 0 loads (one
// thread issues every TMA copy), warp 1 adds the dq partials to the
// accumulator (one thread, bulk copies from shared memory). Warpgroups 1
// and 2 each own 64 of the block's BN kv rows. Block (ticket → kv block n,
// b, h); `sync` holds the ticket counter, then per (b, h, q tile) one turn
// counter per dq writer, all zero at launch. dq_acc [B·H, ⌈Lq/BM⌉, D/64]
// tiles of BM × 64 fp32 (swizzled as dq_tile_off) needs no initialisation:
// kv block 0 copies, the later ones add. rows [B·H, 2, Lqp] holds δ and
// lse, padded to whole q tiles (Lqp = ⌈Lq/BM⌉·BM).
template <int D, bool ROPE, bool BIAS, bool SPLIT>
__global__ void __launch_bounds__(NT, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap tm_qs,
               const __grid_constant__ CUtensorMap tm_qd,
               const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_kc,
               const __grid_constant__ CUtensorMap tm_kd,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ rows,
               const float* __restrict__ cos_t,
               const float* __restrict__ sin_t,
               const float* __restrict__ kbias, bf16* __restrict__ dk,
               long long dk_sb, long long dk_sl, bf16* __restrict__ dv,
               long long dv_sb, long long dv_sl, float* __restrict__ dq_acc,
               int* __restrict__ sync, float* __restrict__ dkv_part,
               int splits, int kv_major, int nbh, int H, int Lq,
               int Lk) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NSTAGE;
  uint64_t* qd_full = empty + NSTAGE;
  uint64_t* qd_empty = qd_full + 1;
  uint64_t* kvbar = qd_empty + 1;
  uint64_t* dq_full = kvbar + 1;
  uint64_t* dq_empty = dq_full + 1;
  int* s_tile = reinterpret_cast<int*>(dq_empty + 1);
  uint32_t* s_base4 = reinterpret_cast<uint32_t*>(s_tile + 1);

  const int nq = (Lq + BM - 1) / BM;
  const int lqp = nq * BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init(qd_full, 1);
    mbar_init(qd_empty, 2 * 128);
    mbar_init(kvbar, 1);
    mbar_init(dq_full, 128 * L::NDQ);
    mbar_init(dq_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *s_tile = atomicAdd(sync, 1);
    *s_base4 = smem_u32(smem) >> 4;
  }
  __syncthreads();
  const int tile = *s_tile;
  // SPLIT = false compiles the unsplit kernel: one block per kv block
  const int nsplit = SPLIT ? splits : 1;
  const int split = tile % nsplit;
  const int nkv = (Lk + BN - 1) / BN;
  const int nblk = kv_major ? tile / nsplit / nbh : tile / nsplit % nkv;
  const int bh = kv_major ? tile / nsplit % nbh : tile / nsplit / nkv;
  // this block's q tiles [j0, j0 + nj): all of them, or its share of a
  // split (which adds its dk, dv partials apart)
  const int j0 = split * nq / nsplit;
  const int nj = (split + 1) * nq / nsplit - j0;
  const int b = bh / H;
  const int h = bh % H;
  const int n0 = nblk * BN;
  // the turn counters of (b, h), one per q tile
  int* turn = sync + 1 + static_cast<long long>(bh) * nq;
  // warp-uniform as the compiler sees it, so setmaxnreg takes effect
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);

  if (wg == 0) {  // ---- loader and dq writer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {  // loader
      mbar_expect_tx(kvbar, L::KV_TX);
#pragma unroll
      for (int p = 0; p < L::NP; ++p) {
        tma_load_3d(smem + L::KC + p * L::PANEL_KV, &tm_kc, kvbar, 64 * p, n0,
                    bh);
        tma_load_3d(smem + L::KD + p * L::PANEL_KV, &tm_kd, kvbar, 64 * p, n0,
                    bh);
        tma_load_4d(smem + L::V + p * L::PANEL_KV, &tm_v, kvbar, 64 * p, h,
                    n0, b);
      }
      const float* rows_bh = rows + static_cast<long long>(bh) * 2 * lqp;
      for (int jj = 0; jj < nj; ++jj) {
        const int j = j0 + jj;
        const int s = jj % NSTAGE;
        const int m0 = j * BM;
        mbar_wait<true>(&empty[s], ((jj / NSTAGE) & 1) ^ 1);
        unsigned char* st = smem + L::Q + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE_TX);
#pragma unroll
        for (int p = 0; p < L::NP; ++p) {
          tma_load_3d(st + p * L::PANEL_Q, &tm_qs, &full[s], 64 * p, m0, bh);
          tma_load_4d(st + L::Q_TILE + p * L::PANEL_Q, &tm_do, &full[s],
                      64 * p, h, m0, b);
        }
        float* r = reinterpret_cast<float*>(smem + L::ROWS) + s * 2 * BM;
        bulk_load(r, rows_bh + m0, BM * 4, &full[s]);
        bulk_load(r + BM, rows_bh + lqp + m0, BM * 4, &full[s]);
        // qd is read last in a tile: one buffer, refilled once the
        // consumers' dk product of the tile before is done
        mbar_wait<true>(qd_empty, (jj & 1) ^ 1);
        mbar_expect_tx(qd_full, L::Q_TILE);
#pragma unroll
        for (int p = 0; p < L::NP; ++p)
          tma_load_3d(smem + L::QD + p * L::PANEL_Q, &tm_qd, qd_full, 64 * p,
                      m0, bh);
      }
    } else if (threadIdx.x == 32) {  // dq writer
      // a tile's partial: the NDQ warpgroups' BM × 64 blocks, adjacent in
      // shared memory and in the accumulator
      constexpr uint32_t bytes = L::NDQ * L::DQ_TILE;
      const uint32_t src = smem_u32(smem + L::DQ);
      float* acc_bh = dq_acc + static_cast<long long>(bh) * nq * L::NP *
                                   (BM * 64);
      for (int jj = 0; jj < nj; ++jj) {
        const int j = j0 + jj;
        mbar_wait<true>(dq_full, jj & 1);
        const long long t0 = clock64();
        while (ld_acquire(turn + j) != nblk) check_stuck(t0);
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        float* dst = acc_bh + static_cast<long long>(j) * L::NP * (BM * 64);
        if (nblk == 0)
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
              "%2;\n" ::"l"(dst),
              "r"(src), "r"(bytes)
              : "memory");
        else
          asm volatile(
              "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
              "[%0], [%1], %2;\n" ::"l"(dst),
              "r"(src), "r"(bytes)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the staging buffer is free once read; the turn passes once the
        // add is done
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(dq_empty);
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        st_release(turn + j, nblk + 1);
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;  // which 64 kv rows
    const int tid = threadIdx.x % 128;
    const int wq = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;

    // this thread's two kv rows: their bias, and whether they take part
    // (inside Lk and not masked by a −1e30 bias)
    const int kv_row0 = n0 + 64 * c + 16 * wq + g;
    bool kv_in[2];
    float row_kb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kv_in[r] = kv_row0 + 8 * r < Lk;
      row_kb[r] = BIAS && kv_in[r] ? kbias[kv_row0 + 8 * r] : 0.f;
      if (BIAS) kv_in[r] = kv_in[r] && row_kb[r] > kMaskedBias;
    }

    float adk[D / 2], adv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
    // dq of the tile: D/2 columns (64c ..) per warpgroup at D = 128; at
    // D = 64 both compute all 64 (no divergent wgmma) and warpgroup 0 sends
    const bool has_dq = c < L::NDQ;

    mbar_wait<false>(kvbar, 0);
    for (int jj = 0; jj < nj; ++jj) {
      const int j = j0 + jj;
      const int s = jj % NSTAGE;
      const int m0 = j * BM;
      // the base reloaded every tile: descriptors computed from it cannot
      // be hoisted out of the loop into registers the accumulators need
      uint32_t b4;
      asm volatile("ld.shared.u32 %0, [%1];\n"
                   : "=r"(b4)
                   : "r"(smem_u32(s_base4)));
      const uint32_t st = L::Q + s * L::STAGE;  // this stage's offset
      const uint32_t sb = b4 << 4;               // the block's shared base
      // this thread's δ (and, BM floats on, lse) of column 2t of the stage
      const uint32_t rows_t = sb + L::ROWS + s * 2 * BM * 4 + 8 * t;
      mbar_wait<false>(&full[s], (jj / NSTAGE) & 1);

      // per half of the tile's 64 q columns: sᵀ = kc·qsᵀ and dpᵀ = v·doᵀ
      // (64 kv × 32 q, K-major over D), then pᵀ = exp2(sᵀ (+ bias[row]) −
      // lse[col]) and dsᵀ = pᵀ·(dpᵀ − δ[col]), both 0 past Lq or on a kv
      // row that takes no part, as bf16 A fragments (k-step kk: q columns
      // 16kk ..); half a tile's products at a time keeps the fp32 logits
      // within the registers the dk and dv accumulators leave
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        float sc[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff =
              (kk / 4) * L::PANEL_KV + 64 * c * 128 + (kk % 4) * 32;
          const uint32_t qoff =
              (kk / 4) * L::PANEL_Q + 32 * hq * 128 + (kk % 4) * 32;
          wgmma_ss_n32<0, 0>(sc, b4 + desc_lo(L::KC + koff, 16),
                             b4 + desc_lo(st + qoff, 16), kk > 0);
          wgmma_ss_n32<0, 0>(dp, b4 + desc_lo(L::V + koff, 16),
                             b4 + desc_lo(st + L::Q_TILE + qoff, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<16>(sc);
        fence_regs<16>(dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 32 * hq + 8 * i + 2 * t;
          const float2 dl = lds_f2(rows_t + (32 * hq + 8 * i) * 4);
          const float2 ls = lds_f2(rows_t + (BM + 32 * hq + 8 * i) * 4);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool valid = m0 + col + (e & 1) < Lq && kv_in[r];
            const float sb = BIAS ? sc[4 * i + e] + row_kb[r] : sc[4 * i + e];
            const float pe = exp2f(sb - ((e & 1) ? ls.y : ls.x));
            p[e] = valid ? pe : 0.f;
            ds[e] = valid ? pe * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x))
                          : 0.f;
          }
          const int kk = 2 * hq + i / 2, hi = i % 2;
          pa[kk][2 * hi] = pack_bf16(p[0], p[1]);
          pa[kk][2 * hi + 1] = pack_bf16(p[2], p[3]);
          da[kk][2 * hi] = pack_bf16(ds[0], ds[1]);
          da[kk][2 * hi + 1] = pack_bf16(ds[2], ds[3]);
        }
      }

      // dv += bf16(pᵀ)·do: A from registers, B MN-major (K = q, N = D)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t bd =
            b4 + desc_lo(st + L::Q_TILE + kk * 16 * 128, L::PANEL_Q);
        if constexpr (D == 128)
          wgmma_rs_n128<1>(adv, pa[kk], bd, 1);
        else
          wgmma_rs_n64<1>(adv, pa[kk], bd, 1);
      }
      wgmma_commit();

      // dsᵀ [kv row][q col] into the single ds buffer, in its
      // 128-byte-swizzled rows, once both warpgroups' dq product of the
      // tile before has read it
      named_sync(1, 256);
      // row 64c + 16wq + g (+ 8), 16-byte chunk j at chunk j ^ g (its row
      // mod 8): the XOR lands on address bits 4–6, which the row's base
      // leaves 0
      const uint32_t ds_row = sb + L::DS + (64 * c + 16 * wq + g) * 128 + 4 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sts_u32((ds_row + (e & 1) * 8 * 128 + ((2 * kk + (e >> 1)) << 4)) ^
                      (g << 4),
                  da[kk][e]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1, 256);

      // dk += bf16(dsᵀ)·qd with A = this warpgroup's rows of the ds buffer
      // (K-major: q along the row) and B = qd (MN-major), and this
      // warpgroup's share of the tile's dq partial ds·kd over BN kv rows
      // (A and B MN-major)
      mbar_wait<false>(qd_full, jj & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint32_t ad = b4 + desc_lo(L::DS + 64 * c * 128 + kk * 32, 16);
        const uint32_t bd = b4 + desc_lo(L::QD + kk * 16 * 128, L::PANEL_Q);
        if constexpr (D == 128)
          wgmma_ss_n128<0, 1>(adk, ad, bd, 1);
        else
          wgmma_ss_n64<0, 1>(adk, ad, bd, 1);
      }
      float adq[32];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t koff = kk * 16 * 128;
        wgmma_ss_n64<1, 1>(
            adq, b4 + desc_lo(L::DS + koff, BN * 128),
            b4 + desc_lo(L::KD + (c % L::NP) * L::PANEL_KV + koff,
                         L::PANEL_KV),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(adv);
      fence_regs<D / 2>(adk);
      fence_regs<32>(adq);
      fence_regs<16>(&pa[0][0]);  // the A fragments live until the wait
      mbar_arrive(&empty[s]);  // this stage's qs and do are read
      mbar_arrive(qd_empty);
      if (!has_dq) continue;

      // the partial to shared memory, once the writer has sent the last
      mbar_wait<false>(dq_empty, (jj & 1) ^ 1);
      // (row, column 8i + 2t) at dq_tile_off: the chunk 2i + t/2 of the
      // row XOR the row mod 16, again on address bits 4–7 only
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * wq + g + 8 * r;
        const uint32_t at = sb + L::DQ + c * L::DQ_TILE + row * 256 +
                            8 * (t & 1) + ((t >> 1) << 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sts_f2((at + (i << 5)) ^ ((row & 15) << 4), adq[4 * i + 2 * r],
                 adq[4 * i + 2 * r + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(dq_full);
    }

    // with the q tiles split over blocks: this block's fp32 partials of dk
    // (unrotated) and dv, [split][dk, dv][B·H, Lk, D], summed in split
    // order by dkv_reduce_kernel
    if (SPLIT) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kv_row0 + 8 * r;
        if (row >= Lk) continue;
        float* pk = dkv_part + ((static_cast<long long>(split) * 2 * nbh +
                                 bh) * Lk + row) * D;
        float* pv = pk + static_cast<long long>(nbh) * Lk * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          *reinterpret_cast<float2*>(pk + 8 * i + 2 * t) =
              make_float2(adk[4 * i + 2 * r], adk[4 * i + 2 * r + 1]);
          *reinterpret_cast<float2*>(pv + 8 * i + 2 * t) =
              make_float2(adv[4 * i + 2 * r], adv[4 * i + 2 * r + 1]);
        }
      }
      return;
    }
    // dv, and dk rotated back by Rᵀ of the k table when ROPE, as bf16
    constexpr int H2 = D / 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv_row0 + 8 * r;
      if (row >= Lk) continue;
      if (ROPE) {
#pragma unroll
        for (int i = 0; i < D / 16; ++i) {
          const int col = 8 * i + 2 * t;
          const float* cs = cos_t + static_cast<long long>(row) * H2 + col;
          const float* sn = sin_t + static_cast<long long>(row) * H2 + col;
          rotate_t2(&adk[4 * i + 2 * r], &adk[4 * (i + D / 16) + 2 * r], cs,
                    sn);
        }
      }
      bf16* ov = dv + b * dv_sb + static_cast<long long>(row) * dv_sl + h * D;
      bf16* ok = dk + b * dk_sb + static_cast<long long>(row) * dk_sl + h * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(ov + 8 * i + 2 * t) =
            pack_bf16(adv[4 * i + 2 * r], adv[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ok + 8 * i + 2 * t) =
            pack_bf16(adk[4 * i + 2 * r], adk[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dq = bf16(dq_acc) → [B, Lq, H·D] with row strides, rotated back by Rᵀ
// of the q table when ROPE; one thread per 8 pairs. dq_acc holds BM × 64
// tiles [B·H, ⌈L/BM⌉, D/64] (dq_tile_off inside a tile).
template <int D, bool ROPE>
__global__ void dq_store_kernel(const float* __restrict__ acc,
                                const float* __restrict__ cos_t,
                                const float* __restrict__ sin_t,
                                bf16* __restrict__ dq, long long dq_sb,
                                long long dq_sl, int H, int L,
                                long long total) {
  constexpr int H2 = D / 2;
  constexpr int CH = H2 / 8;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % CH) * 8;
  long long rest = i / CH;
  const int l = static_cast<int>(rest % L);
  rest /= L;
  const int h = static_cast<int>(rest % H);
  const long long b = rest / H;
  const int nq = (L + BM - 1) / BM;
  const int r = l % BM;
  // columns c .. c+7 and c+H2 .. c+H2+7: two 4-float chunks each
  float x1[8], x2[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = c + half * H2;
    const float* tile = acc + (((b * H + h) * nq + l / BM) * (D / 64) +
                               col / 64) * (BM * 64);
    float* x = half ? x2 : x1;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(
          tile + dq_tile_off(r, col % 64 + j));
      x[j] = u.x, x[j + 1] = u.y, x[j + 2] = u.z, x[j + 3] = u.w;
    }
  }
  if (ROPE) {
    const float* cs = cos_t + static_cast<long long>(l) * H2 + c;
    const float* sn = sin_t + static_cast<long long>(l) * H2 + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y1 = x1[j] * cs[j] - x2[j] * sn[j];
      const float y2 = x1[j] * sn[j] + x2[j] * cs[j];
      x1[j] = y1;
      x2[j] = y2;
    }
  }
  bf16* out = dq + b * dq_sb + static_cast<long long>(l) * dq_sl + h * D + c;
  *reinterpret_cast<uint4*>(out) = pack8(x1);
  *reinterpret_cast<uint4*>(out + H2) = pack8(x2);
}

// dk, dv = the sum of the `splits` fp32 partials [split][dk, dv][B·H, L, D]
// in split order, dk rotated back by Rᵀ of the k table when ROPE, as bf16
// [B, L, H·D] with row strides; one thread per 8 pairs.
template <int D, bool ROPE>
__global__ void dkv_reduce_kernel(const float* __restrict__ part, int splits,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t,
                                  bf16* __restrict__ dk, long long dk_sb,
                                  long long dk_sl, bf16* __restrict__ dv,
                                  long long dv_sb, long long dv_sl, int H,
                                  int L, long long total) {
  constexpr int H2 = D / 2;
  constexpr int CH = H2 / 8;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % CH) * 8;
  long long rest = i / CH;
  const int l = static_cast<int>(rest % L);
  rest /= L;
  const int h = static_cast<int>(rest % H);
  const long long b = rest / H;
  const long long plane = total / CH * D;  // B·H·L·D
  float k1[8] = {}, k2[8] = {}, v1[8] = {}, v2[8] = {};
  for (int z = 0; z < splits; ++z) {
    const float* pk = part + 2 * z * plane + ((b * H + h) * L + l) * D + c;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(pk + j);
      const float4 e = *reinterpret_cast<const float4*>(pk + H2 + j);
      const float4 u = *reinterpret_cast<const float4*>(pk + plane + j);
      const float4 w = *reinterpret_cast<const float4*>(pk + plane + H2 + j);
      k1[j] += a.x, k1[j + 1] += a.y, k1[j + 2] += a.z, k1[j + 3] += a.w;
      k2[j] += e.x, k2[j + 1] += e.y, k2[j + 2] += e.z, k2[j + 3] += e.w;
      v1[j] += u.x, v1[j + 1] += u.y, v1[j + 2] += u.z, v1[j + 3] += u.w;
      v2[j] += w.x, v2[j + 1] += w.y, v2[j + 2] += w.z, v2[j + 3] += w.w;
    }
  }
  if (ROPE) {
    const float* cs = cos_t + static_cast<long long>(l) * H2 + c;
    const float* sn = sin_t + static_cast<long long>(l) * H2 + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y1 = k1[j] * cs[j] - k2[j] * sn[j];
      const float y2 = k1[j] * sn[j] + k2[j] * cs[j];
      k1[j] = y1;
      k2[j] = y2;
    }
  }
  bf16* ok = dk + b * dk_sb + static_cast<long long>(l) * dk_sl + h * D + c;
  bf16* ov = dv + b * dv_sb + static_cast<long long>(l) * dv_sl + h * D + c;
  *reinterpret_cast<uint4*>(ok) = pack8(k1);
  *reinterpret_cast<uint4*>(ok + H2) = pack8(k2);
  *reinterpret_cast<uint4*>(ov) = pack8(v1);
  *reinterpret_cast<uint4*>(ov + H2) = pack8(v2);
}


// q rotates by cos_q/sin_q [Lq, D/2] and k by cos_k/sin_k [Lk, D/2]
// (ROPE); kbias [Lk] fp32 (BIAS). Scratch: qs/qd [B, H, Lq, D] and kc/kd
// [B, H, Lk, D] bf16, rows [B·H, 2, Lqp] and dq_acc [B·H, Lqp, D] (as BM × 64
// tiles) fp32, sync 1 + B·H·⌈Lq/BM⌉ int32 (zeroed here), Lqp = ⌈Lq/BM⌉·BM;
// with splits > 1 (each kv block's q tiles split over that many blocks,
// where the kv blocks alone leave SMs idle) dkv_part [splits][2][B·H, Lk,
// D] fp32.
// The TMA maps are encoded at every launch: they hold the scratch's
// addresses, which are new at every call.
template <int D, bool ROPE, bool BIAS>
cudaError_t launch_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, const void* cos_q,
                                 const void* sin_q, const void* cos_k,
                                 const void* sin_k, const void* kbias,
                                 void* qs, void* qd, void* kc, void* kd,
                                 void* rows, void* dq_acc, void* sync,
                                 void* dkv_part, int splits, void* dq,
                                 void* dk, void* dv, int B, int H,
                                 int Lq, int Lk, const long long* st,
                                 float scale, float q_mul,
                                 cudaStream_t stream) {
  // st: q, k, v, o, do, dq, dk, dv — (batch, row) stride pairs in elements
  const int threads = 256;
  const float* cq = static_cast<const float*>(cos_q);
  const float* sq = static_cast<const float*>(sin_q);
  const float* ck = static_cast<const float*>(cos_k);
  const float* sk = static_cast<const float*>(sin_k);
  const int nbh = B * H;
  const int nq = (Lq + BM - 1) / BM;
  cudaError_t err = cudaMemsetAsync(
      sync, 0, sizeof(int) * (1 + static_cast<size_t>(nbh) * nq), stream);
  if (err != cudaSuccess) return err;
  const long long tq = static_cast<long long>(B) * Lq * H * (D / 16);
  prep_q_kernel<D, ROPE><<<static_cast<unsigned>((tq + threads - 1) / threads),
                           threads, 0, stream>>>(
      static_cast<const bf16*>(q), st[0], st[1], static_cast<const bf16*>(dout),
      st[8], st[9], static_cast<const bf16*>(o), st[6], st[7], cq, sq,
      static_cast<const float*>(lse), static_cast<bf16*>(qs),
      static_cast<bf16*>(qd), static_cast<float*>(rows), H, Lq, nq * BM,
      q_mul, scale, tq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long tk = static_cast<long long>(B) * Lk * H * (D / 16);
  prep_k_kernel<D, ROPE><<<static_cast<unsigned>((tk + threads - 1) / threads),
                           threads, 0, stream>>>(
      static_cast<const bf16*>(k), st[2], st[3], ck, sk, static_cast<bf16*>(kc),
      static_cast<bf16*>(kd), H, Lk, scale, tk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // head-major scratch [B·H, L, D]; do and v strided [B, L, H, D]
  CUtensorMap maps[6];
  const long long q3[3] = {D, Lq, nbh}, k3[3] = {D, Lk, nbh};
  const long long qs3[2] = {D, static_cast<long long>(Lq) * D};
  const long long ks3[2] = {D, static_cast<long long>(Lk) * D};
  const long long do4[4] = {D, H, Lq, B}, v4[4] = {D, H, Lk, B};
  const long long dos4[3] = {D, st[9], st[8]}, vs4[3] = {D, st[5], st[4]};
  const int qbox3[3] = {64, BM, 1}, kbox3[3] = {64, BN, 1};
  const int qbox4[4] = {64, 1, BM, 1}, kbox4[4] = {64, 1, BN, 1};
  const void* ptrs[6] = {qs, qd, dout, kc, kd, v};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) {
    const bool q_side = i < 3;
    if (i == 2 || i == 5)
      err = bf16_map(&maps[i], ptrs[i], 4, q_side ? do4 : v4,
                     q_side ? dos4 : vs4, q_side ? qbox4 : kbox4);
    else
      err = bf16_map(&maps[i], ptrs[i], 3, q_side ? q3 : k3,
                     q_side ? qs3 : ks3, q_side ? qbox3 : kbox3);
  }
  if (err != cudaSuccess) return err;

  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int smem = Layout<D>::BYTES + 1024;  // + the alignment slack
  auto kern = splits > 1 ? bwd_kernel<D, ROPE, BIAS, true>
                         : bwd_kernel<D, ROPE, BIAS, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>((Lk + BN - 1) / BN) * nbh * splits, NT, smem,
         stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const float*>(rows), ck, sk,
      static_cast<const float*>(kbias), static_cast<bf16*>(dk), st[12],
      st[13], static_cast<bf16*>(dv), st[14], st[15],
      static_cast<float*>(dq_acc), static_cast<int*>(sync),
      static_cast<float*>(dkv_part), splits, nbh < sms ? 1 : 0, nbh, H, Lq,
      Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long tk2 = static_cast<long long>(B) * H * Lk * (D / 16);
    dkv_reduce_kernel<D, ROPE>
        <<<static_cast<unsigned>((tk2 + threads - 1) / threads), threads, 0,
           stream>>>(static_cast<const float*>(dkv_part), splits, ck, sk,
                     static_cast<bf16*>(dk), st[12], st[13],
                     static_cast<bf16*>(dv), st[14], st[15], H, Lk, tk2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long td = static_cast<long long>(B) * H * Lq * (D / 16);
  dq_store_kernel<D, ROPE><<<static_cast<unsigned>((td + threads - 1) / threads),
                             threads, 0, stream>>>(
      static_cast<const float*>(dq_acc), cq, sq, static_cast<bf16*>(dq),
      st[10], st[11], H, Lq, td);
  return cudaGetLastError();
}

}  // namespace
