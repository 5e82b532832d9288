// The attention backward passes shared by the short, long and ring paths,
// for Hopper (sm_90a): header-only, instantiated by `short_attention_bwd.cu`
// (ROPE on or off), `long_attention_bwd.cu` (pre-rotated q/k, ROPE off,
// with or without the kv-bias) and `ring_attention_bwd.cu` (ROPE on with
// separate q and k tables, the kv-bias, the given merged o and lse).
//
// What they compute, per (b, h), with the TPU kernels' rounding points
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
// B=2, H=4, L=8208), so every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate).
//
// How it differs from the TPU kernels: the TPU walks the q blocks of one
// (b, h) in order and carries dk/dv in VMEM scratch across them. Blocks on
// the H100 run in no order, so nothing carries over: a dk/dv pass (one
// block per 64 kv rows, looping over every q tile) and a dq pass (one block
// per 64 q rows, looping over every kv tile) each own their outputs. No
// atomics, so the result is deterministic. The price is recomputing
// s and dp in both passes: 14 units of work instead of 10. Neither pass
// holds anything sized by L, so the same passes serve any length: at
// L = 8208 each block streams 257 tiles of 32 rows. Every offset that
// grows with B·L·H·D is 64-bit.
//
// A prologue rotates and rounds q and k once (as the forward's
// `rope_rotate_kernel`) into head-major scratch [B, H, L, D] and computes δ,
// so the passes stream ready bf16 tiles (cp.async, double-buffered) and
// never touch cos/sin until the final Rᵀ (dq by the q table, dk by the k
// table). Ragged q/kv edges are zero-filled on load; p is forced to 0 past
// Lq (dk/dv pass) or Lk (dq pass), and rows past the edge are not stored.
#pragma once

#include "mma_utils.cuh"

namespace {

constexpr int NWARPS = 4;        // 16 rows each
constexpr int BR = 16 * NWARPS;  // rows owned by a block (kv or q)
constexpr int NT = NWARPS * 32;
constexpr int BS = 32;           // rows of each streamed tile

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
// qs/qd [B, H, L, D] and δ [B, H, L] = Σ_d do·o.
template <int D, bool ROPE>
__global__ void prep_q_kernel(const bf16* __restrict__ q, long long q_sb,
                              long long q_sl, const bf16* __restrict__ dout,
                              long long do_sb, long long do_sl,
                              const bf16* __restrict__ o, long long o_sb,
                              long long o_sl, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t,
                              bf16* __restrict__ qs, bf16* __restrict__ qd,
                              float* __restrict__ delta, int H, int L,
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
  if (valid && c == 0) delta[(b * H + h) * L + l] = part;
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

// Stores the two fp32 accumulator rows (g, g+8) a thread holds of a 16-row
// warp tile as bf16, rotated back by Rᵀ first when ROPE; rows past `lim`
// are dropped. acc[i] holds columns i·8 + 2t, +1; column c < D/2 pairs with
// c + D/2, i.e. acc[i] with acc[i + D/16], in the same thread.
template <int D, bool ROPE>
__device__ __forceinline__ void store_rows(float (*acc)[4], bf16* base,
                                           long long row_stride, int row0,
                                           int lim, const float* cos_t,
                                           const float* sin_t, int g, int t) {
  constexpr int H2 = D / 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= lim) continue;
    if (ROPE) {
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int c = i * 8 + 2 * t;
        const float* cs = cos_t + static_cast<long long>(row) * H2 + c;
        const float* sn = sin_t + static_cast<long long>(row) * H2 + c;
        rotate_t2(&acc[i][2 * r], &acc[i + D / 16][2 * r], cs, sn);
      }
    }
    bf16* out = base + static_cast<long long>(row) * row_stride;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8 + 2 * t) =
          pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// dk/dv pass: block (kv tile, h, b). kc and v of its 64 kv rows stay in
// shared memory; qs, qd, do, lse and δ stream in tiles of BS q rows. Each
// warp owns 16 kv rows and computes the transposed products sᵀ = kc·qsᵀ and
// dpᵀ = v·doᵀ, so pᵀ and dsᵀ come out as A fragments of dv += pᵀ·do and
// dk += dsᵀ·qd. With BIAS each kv row's kbias joins its logits.
template <int D, bool ROPE, bool BIAS>
__global__ void __launch_bounds__(NT)
    bwd_dkdv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ qd,
                    const bf16* __restrict__ kc, const bf16* __restrict__ v,
                    long long v_sb, long long v_sl,
                    const bf16* __restrict__ dout, long long do_sb,
                    long long do_sl, const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t,
                    const float* __restrict__ kbias, bf16* __restrict__ dk,
                    long long dk_sb, long long dk_sl, bf16* __restrict__ dv,
                    long long dv_sb, long long dv_sl, int H, int Lq, int Lk) {
  constexpr int LD = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int CH = D / 8;  // 16-byte chunks per row
  // [kc: BR][v: BR][stage 0: qs, qd, do: 3·BS][stage 1: 3·BS] rows, then
  // lse and δ [2][BS] each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*s_k)[LD] = reinterpret_cast<bf16(*)[LD]>(smem_raw);
  bf16(*s_v)[LD] = s_k + BR;
  bf16(*s_q)[LD] = s_v + BR;
  float* s_lse = reinterpret_cast<float*>(s_q + 6 * BS);
  float* s_dl = s_lse + 2 * BS;

  const int n0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  {
    const bf16* kb = kc + bh * Lk * D;
    const bf16* vb = v + b * v_sb + h * D;
    for (int idx = threadIdx.x; idx < BR * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = n0 + r < Lk;
      const long long gr = valid ? n0 + r : 0;
      cp_async16(&s_k[r][c], kb + gr * D + c, valid);
      cp_async16(&s_v[r][c], vb + gr * v_sl + c, valid);
    }
  }
  const bf16* qsb = qs + bh * Lq * D;
  const bf16* qdb = qd + bh * Lq * D;
  const bf16* dob = dout + b * do_sb + h * D;
  auto load_q = [&](int st, int m0) {
    for (int idx = threadIdx.x; idx < BS * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = m0 + r < Lq;
      const long long gr = valid ? m0 + r : 0;
      cp_async16(&s_q[st * 3 * BS + r][c], qsb + gr * D + c, valid);
      cp_async16(&s_q[st * 3 * BS + BS + r][c], qdb + gr * D + c, valid);
      cp_async16(&s_q[st * 3 * BS + 2 * BS + r][c], dob + gr * do_sl + c,
                 valid);
    }
    for (int r = threadIdx.x; r < BS; r += NT) {
      const bool valid = m0 + r < Lq;
      s_lse[st * BS + r] = valid ? lse[bh * Lq + m0 + r] : 0.f;
      s_dl[st * BS + r] = valid ? delta[bh * Lq + m0 + r] : 0.f;
    }
    cp_async_commit();
  };

  const int nq = (Lq + BS - 1) / BS;
  load_q(0, 0);  // one group: the resident k/v tile and q tile 0

  // the bias of this thread's two kv rows (g, g + 8 of the warp's 16)
  float row_kb[2] = {0.f, 0.f};
  if (BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = n0 + warp * 16 + g + 8 * r;
      row_kb[r] = row < Lk ? kbias[row] : 0.f;
    }
  }

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;

  for (int j = 0; j < nq; ++j) {
    const int m0 = j * BS;
    const int st = j & 1;
    if (j + 1 < nq)
      load_q(st ^ 1, m0 + BS);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const bf16(*t_qs)[LD] = s_q + st * 3 * BS;
    const bf16(*t_qd)[LD] = t_qs + BS;
    const bf16(*t_do)[LD] = t_qs + 2 * BS;
    const float* t_lse = s_lse + st * BS;
    const float* t_dl = s_dl + st * BS;

    // sᵀ = kc·qsᵀ and dpᵀ = v·doᵀ: 16 kv rows × BS q columns per warp
    float s[BS / 8][4], dp[BS / 8][4];
#pragma unroll
    for (int i = 0; i < BS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, &s_k[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
      ldmatrix_x4(va, &s_v[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < BS / 16; ++np) {
        const int br = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int bc = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t qf[4], df[4];
        ldmatrix_x4(qf, &t_qs[br][bc]);
        ldmatrix_x4(df, &t_do[br][bc]);
        mma_bf16(s[2 * np], ka, qf[0], qf[1]);
        mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[2 * np], va, df[0], df[1]);
        mma_bf16(dp[2 * np + 1], va, df[2], df[3]);
      }
    }

    // pᵀ = exp2(sᵀ (+ bias[row]) − lse[col]), 0 past Lq;
    // dsᵀ = pᵀ·(dpᵀ − δ[col])
#pragma unroll
    for (int i = 0; i < BS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + 2 * t + (e & 1);
        const float sb = BIAS ? s[i][e] + row_kb[e >> 1] : s[i][e];
        const float p = m0 + col < Lq ? exp2f(sb - t_lse[col]) : 0.f;
        s[i][e] = p;
        dp[i][e] = p * (dp[i][e] - t_dl[col]);
      }

    // dv += bf16(pᵀ)·do and dk += bf16(dsᵀ)·qd; A fragments from registers
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, &t_do[kk * 16 + (lane % 16)][dd * 16 + (lane / 16) * 8]);
        mma_bf16(adv[2 * dd], pa, f[0], f[1]);
        mma_bf16(adv[2 * dd + 1], pa, f[2], f[3]);
        ldmatrix_x4_trans(f, &t_qd[kk * 16 + (lane % 16)][dd * 16 + (lane / 16) * 8]);
        mma_bf16(adk[2 * dd], da, f[0], f[1]);
        mma_bf16(adk[2 * dd + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // stage st is read; iteration j+1 refills it
  }

  const int row0 = n0 + warp * 16;
  store_rows<D, false>(adv, dv + b * dv_sb + h * D, dv_sl, row0, Lk, nullptr,
                       nullptr, g, t);
  store_rows<D, ROPE>(adk, dk + b * dk_sb + h * D, dk_sl, row0, Lk, cos_t,
                      sin_t, g, t);
}

// dq pass: block (q tile, h, b). qs and do of its 64 q rows stay in shared
// memory; kc, kd and v stream in tiles of BS kv rows. Each warp owns 16 q
// rows: s = qs·kcᵀ (+ bias), dp = do·vᵀ, ds = bf16(p·(dp − δ)), dq += ds·kd.
template <int D, bool ROPE, bool BIAS>
__global__ void __launch_bounds__(NT)
    bwd_dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ kc,
                  const bf16* __restrict__ kd, const bf16* __restrict__ v,
                  long long v_sb, long long v_sl,
                  const bf16* __restrict__ dout, long long do_sb,
                  long long do_sl, const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const float* __restrict__ kbias, bf16* __restrict__ dq,
                  long long dq_sb, long long dq_sl, int H, int Lq, int Lk) {
  constexpr int LD = D + 8;
  constexpr int CH = D / 8;
  // [qs: BR][do: BR][stage 0: kc, kd, v: 3·BS][stage 1: 3·BS] rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*s_q)[LD] = reinterpret_cast<bf16(*)[LD]>(smem_raw);
  bf16(*s_do)[LD] = s_q + BR;
  bf16(*s_kv)[LD] = s_do + BR;

  const int m0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  {
    const bf16* qb = qs + bh * Lq * D;
    const bf16* dob = dout + b * do_sb + h * D;
    for (int idx = threadIdx.x; idx < BR * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = m0 + r < Lq;
      const long long gr = valid ? m0 + r : 0;
      cp_async16(&s_q[r][c], qb + gr * D + c, valid);
      cp_async16(&s_do[r][c], dob + gr * do_sl + c, valid);
    }
  }
  const bf16* kcb = kc + bh * Lk * D;
  const bf16* kdb = kd + bh * Lk * D;
  const bf16* vb = v + b * v_sb + h * D;
  auto load_kv = [&](int st, int n0) {
    for (int idx = threadIdx.x; idx < BS * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = n0 + r < Lk;
      const long long gr = valid ? n0 + r : 0;
      cp_async16(&s_kv[st * 3 * BS + r][c], kcb + gr * D + c, valid);
      cp_async16(&s_kv[st * 3 * BS + BS + r][c], kdb + gr * D + c, valid);
      cp_async16(&s_kv[st * 3 * BS + 2 * BS + r][c], vb + gr * v_sl + c, valid);
    }
    cp_async_commit();
  };

  // lse and δ of this thread's two rows
  float row_lse[2], row_dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    row_lse[r] = row < Lq ? lse[bh * Lq + row] : 0.f;
    row_dl[r] = row < Lq ? delta[bh * Lq + row] : 0.f;
  }

  const int nk = (Lk + BS - 1) / BS;
  load_kv(0, 0);  // one group: the resident q/do tile and kv tile 0

  float adq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[i][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int n0 = j * BS;
    const int st = j & 1;
    if (j + 1 < nk)
      load_kv(st ^ 1, n0 + BS);
    else
      cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16(*t_kc)[LD] = s_kv + st * 3 * BS;
    const bf16(*t_kd)[LD] = t_kc + BS;
    const bf16(*t_v)[LD] = t_kc + 2 * BS;

    float s[BS / 8][4], dp[BS / 8][4];
#pragma unroll
    for (int i = 0; i < BS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, &s_q[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
      ldmatrix_x4(da, &s_do[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < BS / 16; ++np) {
        const int br = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int bc = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, &t_kc[br][bc]);
        ldmatrix_x4(vf, &t_v[br][bc]);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }

    // p = exp2(s (+ bias[col]) − lse[row]), 0 past Lk; ds = p·(dp − δ[row])
    // into dp
#pragma unroll
    for (int i = 0; i < BS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + i * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p =
            col < Lk ? exp2f((BIAS ? s[i][e] + kbias[col] : s[i][e]) - row_lse[r])
                     : 0.f;
        dp[i][e] = p * (dp[i][e] - row_dl[r]);
      }

    // dq += bf16(ds)·kd
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, &t_kd[kk * 16 + (lane % 16)][dd * 16 + (lane / 16) * 8]);
        mma_bf16(adq[2 * dd], da, f[0], f[1]);
        mma_bf16(adq[2 * dd + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();
  }

  store_rows<D, ROPE>(adq, dq + b * dq_sb + h * D, dq_sl, m0 + warp * 16, Lq,
                      cos_t, sin_t, g, t);
}

// q rotates by cos_q/sin_q [Lq, D/2] and k by cos_k/sin_k [Lk, D/2]
// (ROPE); kbias [Lk] fp32 (BIAS).
template <int D, bool ROPE, bool BIAS>
cudaError_t launch_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, const void* cos_q,
                                 const void* sin_q, const void* cos_k,
                                 const void* sin_k, const void* kbias,
                                 void* qs, void* qd,
                                 void* kc, void* kd, void* delta, void* dq,
                                 void* dk, void* dv, int B, int H, int Lq,
                                 int Lk, const long long* st, float scale,
                                 float q_mul, cudaStream_t stream) {
  // st: q, k, v, o, do, dq, dk, dv — (batch, row) stride pairs in elements
  const int threads = 256;
  const float* cq = static_cast<const float*>(cos_q);
  const float* sq = static_cast<const float*>(sin_q);
  const float* ck = static_cast<const float*>(cos_k);
  const float* sk = static_cast<const float*>(sin_k);
  const float* kb = static_cast<const float*>(kbias);
  const long long tq = static_cast<long long>(B) * Lq * H * (D / 16);
  prep_q_kernel<D, ROPE><<<static_cast<unsigned>((tq + threads - 1) / threads),
                           threads, 0, stream>>>(
      static_cast<const bf16*>(q), st[0], st[1], static_cast<const bf16*>(dout),
      st[8], st[9], static_cast<const bf16*>(o), st[6], st[7], cq, sq,
      static_cast<bf16*>(qs), static_cast<bf16*>(qd),
      static_cast<float*>(delta), H, Lq, q_mul, scale, tq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long tk = static_cast<long long>(B) * Lk * H * (D / 16);
  prep_k_kernel<D, ROPE><<<static_cast<unsigned>((tk + threads - 1) / threads),
                           threads, 0, stream>>>(
      static_cast<const bf16*>(k), st[2], st[3], ck, sk, static_cast<bf16*>(kc),
      static_cast<bf16*>(kd), H, Lk, scale, tk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int LD = D + 8;
  constexpr int smem_dkdv = (2 * BR + 6 * BS) * LD * 2 + 4 * BS * 4;
  constexpr int smem_dq = (2 * BR + 6 * BS) * LD * 2;
  auto dkdv = bwd_dkdv_kernel<D, ROPE, BIAS>;
  auto dqk = bwd_dq_kernel<D, ROPE, BIAS>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  dkdv<<<dim3((Lk + BR - 1) / BR, H, B), NT, smem_dkdv, stream>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(qd),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(v), st[4], st[5],
      static_cast<const bf16*>(dout), st[8], st[9], l, dl, ck, sk, kb,
      static_cast<bf16*>(dk), st[12], st[13], static_cast<bf16*>(dv), st[14],
      st[15], H, Lq, Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Lq + BR - 1) / BR, H, B), NT, smem_dq, stream>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(kd), static_cast<const bf16*>(v), st[4], st[5],
      static_cast<const bf16*>(dout), st[8], st[9], l, dl, cq, sq, kb,
      static_cast<bf16*>(dq), st[10], st[11], H, Lq, Lk);
  return cudaGetLastError();
}

}  // namespace
