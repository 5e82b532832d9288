// The attention forward of the short, long and ring paths, for Hopper
// (sm_90a): header-only, instantiated by `short_attention_fwd.cu` (rows
// 1–2: q rotated by the RoPE table or not, no kv-bias),
// `long_attention_fwd.cu` (rows 6 and 8: q and k pre-rotated, with or
// without the kv-bias) and `ring_attention_fwd.cu` (row 10: q and k
// rotated by tables of their own, the kv-bias of the ring's padded tail).
//
// What it computes, per (b, h): o = softmax(q·kᵀ·scale + bias)·v over the
// flat [B, L, H·D] layouts, and lse = log2 Σ exp2(s) (the exp2-domain
// log-sum-exp), at the rounding points of the TPU kernels, which differ by
// how q arrives (QMode):
//   Q_ROPE / Q_SCALE (`_fwd_short_kernel`, `_ring_fwd_kernel`): q rotates
//     by its table rows (Q_ROPE) in fp32 by the −θ convention (y1 = x1·c +
//     x2·s, y2 = −x1·s + x2·c), takes the factor scale·log2e in fp32 and
//     rounds to bf16; k arrives rotated and rounded (`rope_rotate_kernel`
//     below, the same math); s = q·kᵀ in fp32, + the fp32 kv-bias row;
//   Q_PRE (`_fwd_kernel` over pre-rotated q, k): s = dot(q, k) in fp32,
//     THEN × scale·log2e, then + the bias.
// In all: p = exp2(s − m) rounds to bf16 for the PV product, the row sum l
// stays fp32, o = (Σ p·v) / l.
//
// What bounds it on the card: 4·B·H·Lq·Lk·D tensor flops against a few
// bytes per q/k/v/o element — ~300 flops a byte at 1040², ~4,000 at
// L = 8208: compute-bound at every shape the model runs, except the
// cross-attention (Lk = 512), where the q and o traffic weighs as much.
//
// The design (after `attention_bwd.cuh` and the usual Hopper flash
// forward): a block owns BM = 128 q rows of one (b, h) and runs three
// warpgroups. In warpgroup 0 one thread loads, by TMA, k and v tiles of
// BN = 128 rows into a ring of NSTAGE stages, each guarded by its own full
// and empty mbarriers for k and for v (and, for Q_PRE, the q tile once).
// Warpgroups 1 and 2 (setmaxnreg: 240 registers each, 24 for warpgroup 0)
// each own 64 q rows: with Q_ROPE / Q_SCALE they rotate and scale them in
// fp32 into the 128-byte-swizzled q tile while the first k/v tiles load.
// Per kv tile each forms S = Q·Kᵀ (wgmma m64n128k16, both operands in
// shared memory, K-major) and accumulates O += bf16(P)·V (wgmma with P as
// the A operand in registers, V MN-major); O, m and l stay in registers
// for the whole kv sweep.
//
// Overlap of the softmax with the tensor cores, two ways. Across the
// warpgroups (ping-pong): each issues its products only in its turn, which
// a pair of named barriers passes back and forth, so one warpgroup's
// softmax (8192 exp2 a tile at 16 a clock on the SM's MUFU units) runs
// under the other's products. Inside a warpgroup: the turn issues
// S(j) = Q·K(j)ᵀ and O += P(j−1)·V(j−1) together, and the softmax of S(j)
// runs while the PV product is still in flight; O is rescaled by
// exp2(m_old − m_new) only once that product is done. Measured on the
// H100 (PERF.md §6, PR 7): the ping-pong buys ~5% at L = 8208, exp2 by
// MUFU alone ~5% more; three stages, q by TMA with the rotation in shared
// memory, tree-shaped row reductions and the rescale under S(j) did not
// help.
//
// The ragged kv edge (TMA fills rows past Lk with zeros) is masked with
// −inf: at L = 8208 = 64·128 + 16 the last tile holds 16 columns, and the
// 16 prefix columns that the TPU splits off (`_forward_tail`) are columns
// of the first. The ragged q edge is zero (TMA fill, or the rotation's
// guard) and not stored; a block whose last 64 rows are all past Lq runs
// one consumer warpgroup. A row whose every column carries the −1e30 bias
// (a ring chunk that is all padding) keeps m = −1e30: p = 1 on its
// columns, o their mean, lse ≈ −1e30, all finite, so the ring's merge
// gives it zero weight. The epilogue stages o, normalised by l, through
// the warpgroup's rows of the q tile for 16-byte stores. Registers: as in
// the backward, no wait of the consumer warpgroups can trap (mbar_wait
// <false>), so ptxas holds them to setmaxnreg's 240. Every offset that
// grows with B·L·H·D is 64-bit.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // q rows of a block: 64 per consumer warpgroup
constexpr int BN = 128;  // kv rows of a streamed tile
constexpr int NT = 384;  // the producer warpgroup and two consumer ones
constexpr int NSTAGE = 2;

// how q arrives, which sets where scale·log2e is applied
enum QMode { Q_PRE = 0, Q_SCALE = 1, Q_ROPE = 2 };

// 2^x by the SM's MUFU unit alone. exp2f adds a range check and two
// rescales a call so that results below 2^-126 come out as denormals; here
// they flush to 0. A p below 2^-126 of its row maximum moves neither o,
// l nor lse, and the softmax spends three instructions fewer a logit.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// k [B, L, H·D] (row stride k_sl) rotated by cos/sin [L, D/2] into the
// contiguous bf16 scratch kr [B, L, H·D]; one thread rotates 8 pairs.
template <int D>
__global__ void rope_rotate_kernel(const bf16* __restrict__ k,
                                   const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t,
                                   bf16* __restrict__ kr, int H, int L,
                                   long long k_sb, long long k_sl,
                                   long long total) {
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
  rotate8(x1, x2, cos_t + static_cast<long long>(l) * H2 + c,
          sin_t + static_cast<long long>(l) * H2 + c);
  bf16* out = kr + ((b * L + l) * H + h) * D + c;
  *reinterpret_cast<uint4*>(out) = pack8(x1);
  *reinterpret_cast<uint4*>(out + H2) = pack8(x2);
}

// Byte offsets into the block's shared memory. A bf16 tile is stored as
// panels of 64 columns (128 bytes a row, the TMA's 128-byte swizzle): q
// [NP panels][BM rows] for the block's life (and o's staging at the end),
// per stage k and v [NP][BN rows]; then the barriers and the block's
// shared base >> 4.
template <int D>
struct FwdLayout {
  static constexpr int NP = D / 64;
  static constexpr int PANEL_Q = BM * 128;
  static constexpr int PANEL_KV = BN * 128;
  static constexpr int KV_TILE = NP * PANEL_KV;
  static constexpr int Q = 0;
  static constexpr int K = NP * PANEL_Q;  // stage s at K + s·KV_TILE
  static constexpr int V = K + NSTAGE * KV_TILE;
  static constexpr int BARS = V + NSTAGE * KV_TILE;
  // q_full, full_k[NSTAGE], full_v[NSTAGE], empty_k[NSTAGE],
  // empty_v[NSTAGE], then the base
  static constexpr int BYTES = BARS + (1 + 4 * NSTAGE) * 8 + 16;
};

// The byte offset of the 16-byte chunk holding columns col .. col + 7 of
// row r of a 128-byte-swizzled tile of `panel` bytes a 64-column panel.
__device__ __forceinline__ uint32_t swz_off(int r, int col, int panel) {
  return (col / 64) * panel + r * 128 + ((((col % 64) / 8) ^ (r & 7)) << 4);
}

// Block (q tile, h, b). tm_q (Q_PRE only), tm_k and tm_v: TMA maps of
// [B, L, H, D] with row strides; with Q_ROPE / Q_SCALE q is read directly
// (batch and row strides q_sb, q_sl) and rotated by cos_q/sin_q [Lq, D/2]
// (Q_ROPE). kbias [Lk] fp32 (BIAS). o [B, Lq, H·D] bf16 and lse [B, H, Lq]
// fp32 contiguous. mul = scale·log2e, applied to q (Q_ROPE, Q_SCALE) or to
// the logits (Q_PRE).
template <int D, int QM, bool BIAS>
__global__ void __launch_bounds__(NT, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const bf16* __restrict__ q, long long q_sb, long long q_sl,
               const float* __restrict__ cos_q,
               const float* __restrict__ sin_q,
               const float* __restrict__ kbias, bf16* __restrict__ o,
               float* __restrict__ lse, int H, int Lq, int Lk, float mul) {
  using L = FwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + NSTAGE;
  uint64_t* empty_k = full_v + NSTAGE;
  uint64_t* empty_v = empty_k + NSTAGE;
  uint32_t* s_base4 = reinterpret_cast<uint32_t*>(empty_v + NSTAGE);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (Lk + BN - 1) / BN;
  // consumer warpgroups with rows inside Lq: 1 where the ragged last tile
  // holds 64 rows or fewer
  const int ncons = q0 + 64 < Lq ? 2 : 1;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 128 * ncons);
      mbar_init(&empty_v[s], 128 * ncons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *s_base4 = smem_u32(smem) >> 4;
  }
  __syncthreads();
  // warp-uniform as the compiler sees it, so setmaxnreg takes effect
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);

  if (wg == 0) {  // ---- loader ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      if (QM == Q_PRE) {
        mbar_expect_tx(q_full, L::NP * L::PANEL_Q);
#pragma unroll
        for (int p = 0; p < L::NP; ++p)
          tma_load_4d(smem + L::Q + p * L::PANEL_Q, &tm_q, q_full, 64 * p, h,
                      q0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NSTAGE;
        const int parity = ((j / NSTAGE) & 1) ^ 1;
        const int n0 = j * BN;
        mbar_wait<true>(&empty_k[s], parity);
        mbar_expect_tx(&full_k[s], L::KV_TILE);
#pragma unroll
        for (int p = 0; p < L::NP; ++p)
          tma_load_4d(smem + L::K + s * L::KV_TILE + p * L::PANEL_KV, &tm_k,
                      &full_k[s], 64 * p, h, n0, b);
        mbar_wait<true>(&empty_v[s], parity);
        mbar_expect_tx(&full_v[s], L::KV_TILE);
#pragma unroll
        for (int p = 0; p < L::NP; ++p)
          tma_load_4d(smem + L::V + s * L::KV_TILE + p * L::PANEL_KV, &tm_v,
                      &full_v[s], 64 * p, h, n0, b);
      }
    }
  } else {  // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;  // which 64 q rows
    if (c >= ncons) return;
    const bool pingpong = ncons == 2;
    const int tid = threadIdx.x % 128;
    const int wq = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;

    if (QM == Q_PRE) {
      mbar_wait<false>(q_full, 0);
    } else {
      // this warpgroup's 64 rows: rotate (Q_ROPE) and take scale·log2e in
      // fp32, round to bf16, into the swizzled q tile; every load is
      // issued before the first use
      constexpr int H2 = D / 2;
      constexpr int CH = H2 / 8;         // threads per row
      constexpr int ITEMS = 64 * CH / 128;  // 8-pair items per thread
      const bf16* qb = q + b * q_sb + h * D;
      uint4 u1[ITEMS], u2[ITEMS];
      float4 tc[ITEMS][2], ts[ITEMS][2];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int idx = tid + 128 * it;
        const int gr = q0 + 64 * c + idx / CH;
        const int cc = (idx % CH) * 8;
        u1[it] = u2[it] = make_uint4(0u, 0u, 0u, 0u);
        if (gr < Lq) {
          const bf16* p = qb + static_cast<long long>(gr) * q_sl + cc;
          u1[it] = *reinterpret_cast<const uint4*>(p);
          u2[it] = *reinterpret_cast<const uint4*>(p + H2);
          if (QM == Q_ROPE) {
            const long long t0 = static_cast<long long>(gr) * H2 + cc;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              tc[it][e] = reinterpret_cast<const float4*>(cos_q + t0)[e];
              ts[it][e] = reinterpret_cast<const float4*>(sin_q + t0)[e];
            }
          }
        }
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int idx = tid + 128 * it;
        const int r = 64 * c + idx / CH;
        const int cc = (idx % CH) * 8;
        float x1[8], x2[8];
        unpack8(u1[it], x1);
        unpack8(u2[it], x2);
        if (QM == Q_ROPE && q0 + r < Lq) {
          const float cv[8] = {tc[it][0].x, tc[it][0].y, tc[it][0].z,
                               tc[it][0].w, tc[it][1].x, tc[it][1].y,
                               tc[it][1].z, tc[it][1].w};
          const float sv[8] = {ts[it][0].x, ts[it][0].y, ts[it][0].z,
                               ts[it][0].w, ts[it][1].x, ts[it][1].y,
                               ts[it][1].z, ts[it][1].w};
          rotate8_cs(x1, x2, cv, sv);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x1[i] *= mul;
          x2[i] *= mul;
        }
        *reinterpret_cast<uint4*>(smem + L::Q + swz_off(r, cc, L::PANEL_Q)) =
            pack8(x1);
        *reinterpret_cast<uint4*>(smem + L::Q +
                                  swz_off(r, cc + H2, L::PANEL_Q)) = pack8(x2);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + c, 128);
    }

    float sacc[BN / 2];  // S of this tile: rows 16wq + g (+ 8), BN columns
    float oacc[D / 2];
    uint32_t pa[BN / 16][4];  // bf16(P) as A fragments, k-step kk: 16kk ..
    float m_row[2] = {-INFINITY, -INFINITY};
    float l_row[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

    // S(j) = Q·K(j)ᵀ into sacc; the stage's K-major descriptors from the
    // base reloaded here, so the compiler cannot hoist every descriptor
    // out of the loop into registers the accumulators need
    auto issue_s = [&](int s) {
      uint32_t b4;
      asm volatile("ld.shared.u32 %0, [%1];\n"
                   : "=r"(b4)
                   : "r"(smem_u32(s_base4)));
      const uint32_t qa = b4 + desc_lo(L::Q + 64 * c * 128, 16);
      const uint32_t ka = b4 + desc_lo(L::K + s * L::KV_TILE, 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * L::PANEL_Q + (kk % 4) * 32) >> 4;
        const uint32_t koff = ((kk / 4) * L::PANEL_KV + (kk % 4) * 32) >> 4;
        wgmma_ss_n128<0, 0>(sacc, qa + off, ka + koff, kk > 0);
      }
    };
    // O += bf16(P)·V(stage s): A from registers, B MN-major (K = kv, N = D)
    auto issue_pv = [&](int s) {
      uint32_t b4;
      asm volatile("ld.shared.u32 %0, [%1];\n"
                   : "=r"(b4)
                   : "r"(smem_u32(s_base4)));
      const uint32_t va = b4 + desc_lo(L::V + s * L::KV_TILE, L::PANEL_KV);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        if constexpr (D == 128)
          wgmma_rs_n128<1>(oacc, pa[kk], va + ((kk * 16 * 128) >> 4), 1);
        else
          wgmma_rs_n64<1>(oacc, pa[kk], va + ((kk * 16 * 128) >> 4), 1);
      }
    };
    // the logits of the tile at n0 (Q_PRE: × mul; BIAS: + the kv row; −inf
    // past Lk), the new row maxima and sums; sacc becomes exp2(s − m) in
    // fp32; returns each row's rescale factor exp2(m_old − m_new) in alpha
    auto softmax = [&](int n0, float* alpha) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (QM == Q_PRE) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[4 * i + e] *= mul;
        }
        if (BIAS) {
          const float b0 = col < Lk ? kbias[col] : 0.f;
          const float b1 = col + 1 < Lk ? kbias[col + 1] : 0.f;
          sacc[4 * i] += b0;
          sacc[4 * i + 2] += b0;
          sacc[4 * i + 1] += b1;
          sacc[4 * i + 3] += b1;
        }
      }
      if (n0 + BN > Lk) {  // ragged kv edge
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = n0 + 8 * i + 2 * t;
          if (col >= Lk) sacc[4 * i] = sacc[4 * i + 2] = -INFINITY;
          if (col + 1 >= Lk) sacc[4 * i + 1] = sacc[4 * i + 3] = -INFINITY;
        }
      }
      // exp2 domain; this thread holds rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_row[r];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          mx = fmaxf(mx, fmaxf(sacc[4 * i + 2 * r], sacc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        alpha[r] = exp2_ftz(m_row[r] - mx);  // 0 on the first tile
        m_row[r] = mx;
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          sacc[4 * i + 2 * r] = exp2_ftz(sacc[4 * i + 2 * r] - mx);
          sacc[4 * i + 2 * r + 1] = exp2_ftz(sacc[4 * i + 2 * r + 1] - mx);
          rs += sacc[4 * i + 2 * r] + sacc[4 * i + 2 * r + 1];
        }
        rs += __shfl_xor_sync(0xffffffff, rs, 1);
        rs += __shfl_xor_sync(0xffffffff, rs, 2);
        l_row[r] = l_row[r] * alpha[r] + rs;
      }
    };
    // bf16(P): the accumulator fragments of columns 16kk .. 16kk + 15 are
    // the A fragment of k-step kk
    auto to_pa = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    // the turns: warpgroup c issues its products after named_sync(1 + c)
    // and hands the turn on with named_arrive(2 − c); warpgroup 1 gives
    // warpgroup 0 the first turn and skips its last hand-on, so every
    // arrival meets a wait
    const int my_turn = 1 + c, other_turn = 2 - c;
    if (pingpong && c == 1) named_arrive(1, 256);

    float alpha[2];
    mbar_wait<false>(&full_k[0], 0);
    if (pingpong) named_sync(my_turn, 256);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    if (pingpong) named_arrive(other_turn, 256);
    wgmma_wait<0>();
    fence_regs<BN / 2>(sacc);
    mbar_arrive(&empty_k[0]);
    softmax(0, alpha);
    to_pa();

    for (int j = 1; j < ntiles; ++j) {
      const int s = j % NSTAGE;
      const int sp = (j - 1) % NSTAGE;
      mbar_wait<false>(&full_k[s], (j / NSTAGE) & 1);
      mbar_wait<false>(&full_v[sp], ((j - 1) / NSTAGE) & 1);
      if (pingpong) named_sync(my_turn, 256);
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_pv(sp);
      wgmma_commit();
      if (pingpong) named_arrive(other_turn, 256);
      wgmma_wait<1>();  // S(j) is done, P(j−1)·V(j−1) may still run
      fence_regs<BN / 2>(sacc);
      mbar_arrive(&empty_k[s]);
      softmax(j * BN, alpha);
      wgmma_wait<0>();
      fence_regs<D / 2>(oacc);
      fence_regs<BN / 4>(&pa[0][0]);  // the A fragments live until the wait
      mbar_arrive(&empty_v[sp]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        oacc[4 * i] *= alpha[0];
        oacc[4 * i + 1] *= alpha[0];
        oacc[4 * i + 2] *= alpha[1];
        oacc[4 * i + 3] *= alpha[1];
      }
      to_pa();
    }

    const int sl = (ntiles - 1) % NSTAGE;
    mbar_wait<false>(&full_v[sl], ((ntiles - 1) / NSTAGE) & 1);
    if (pingpong) named_sync(my_turn, 256);
    wgmma_fence();
    issue_pv(sl);
    wgmma_commit();
    if (pingpong && c == 0) named_arrive(other_turn, 256);
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
    fence_regs<BN / 4>(&pa[0][0]);
    mbar_arrive(&empty_v[sl]);

    // o = O / l into this warpgroup's rows of the q tile (every product
    // reading them is done), then 16-byte rows to o; lse = m + log2 l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * c + 16 * wq + g + 8 * r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(smem + L::Q +
                                     swz_off(row, 8 * i, L::PANEL_Q) + 4 * t) =
            pack_bf16(oacc[4 * i + 2 * r] / l_row[r],
                      oacc[4 * i + 2 * r + 1] / l_row[r]);
    }
    named_sync(3 + c, 128);
    const long long o_sl = static_cast<long long>(H) * D;
    for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
      const int row = 64 * c + idx / (D / 8);
      const int col = (idx % (D / 8)) * 8;
      const int gr = q0 + row;
      if (gr < Lq)
        *reinterpret_cast<uint4*>(o + (static_cast<long long>(b) * Lq + gr) *
                                          o_sl + h * D + col) =
            *reinterpret_cast<const uint4*>(smem + L::Q +
                                            swz_off(row, col, L::PANEL_Q));
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 64 * c + 16 * wq + g + 8 * r;
        if (row < Lq)
          lse[(static_cast<long long>(b) * H + h) * Lq + row] =
              m_row[r] + log2f(l_row[r]);
      }
    }
  }
}

// q [B, Lq, H·D], k/v [B, Lk, H·D] bf16 with unit column stride and the
// given batch/row strides (in elements). Q_ROPE: q rotates by cos_q/sin_q
// [Lq, D/2], k by cos_k/sin_k [Lk, D/2] into the scratch k_rot [B, Lk,
// H·D] first; Q_PRE: q and k arrive rotated. kbias [Lk] fp32 (BIAS). o
// [B, Lq, H·D] bf16 and lse [B, H, Lq] fp32 contiguous. The TMA maps are
// encoded at every launch: they hold the operands' addresses.
template <int D, int QM, bool BIAS>
cudaError_t launch_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* cos_q, const void* sin_q,
                                 const void* cos_k, const void* sin_k,
                                 const void* kbias, void* k_rot, void* o,
                                 void* lse, int B, int H, int Lq, int Lk,
                                 long long q_sb, long long q_sl,
                                 long long k_sb, long long k_sl,
                                 long long v_sb, long long v_sl, float mul,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (QM == Q_ROPE) {
    const long long total = static_cast<long long>(B) * Lk * H * (D / 16);
    const int threads = 256;
    rope_rotate_kernel<D><<<static_cast<unsigned>((total + threads - 1) / threads),
                            threads, 0, stream>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos_k),
        static_cast<const float*>(sin_k), static_cast<bf16*>(k_rot), H, Lk,
        k_sb, k_sl, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k = k_rot;
    k_sl = static_cast<long long>(H) * D;
    k_sb = Lk * k_sl;
  }
  // [B, L, H, D] with row strides; boxes of 64 columns × BM or BN rows
  CUtensorMap maps[3] = {};
  const long long qd[4] = {D, H, Lq, B}, kd[4] = {D, H, Lk, B};
  const long long qs[3] = {D, q_sl, q_sb}, ks[3] = {D, k_sl, k_sb};
  const long long vs[3] = {D, v_sl, v_sb};
  const int qbox[4] = {64, 1, BM, 1}, kbox[4] = {64, 1, BN, 1};
  if (QM == Q_PRE) err = bf16_map(&maps[0], q, 4, qd, qs, qbox);
  if (err == cudaSuccess) err = bf16_map(&maps[1], k, 4, kd, ks, kbox);
  if (err == cudaSuccess) err = bf16_map(&maps[2], v, 4, kd, vs, kbox);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdLayout<D>::BYTES + 1024;  // + the alignment slack
  auto kernel = fwd_kernel<D, QM, BIAS>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q), q_sb, q_sl,
      static_cast<const float*>(cos_q), static_cast<const float*>(sin_q),
      static_cast<const float*>(kbias), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Lq, Lk, mul);
  return cudaGetLastError();
}

}  // namespace
