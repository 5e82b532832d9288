// The attention forward with RoPE in the kernel, for Hopper (sm_90a):
// header-only, instantiated by `short_attention_fwd.cu` (ROPE on or off, no
// kv-bias) and `ring_attention_fwd.cu` (ROPE on, separate q and k tables,
// the additive kv-bias of the ring's padded tail).
//
// What it computes, per (b, h): o = softmax(q·kᵀ·scale + bias)·v over the
// flat [B, L, H·D] layouts, and lse = log2 Σ exp2(s) (the exp2-domain
// log-sum-exp). Rounding points follow the TPU kernels (`_fwd_short_kernel`,
// `_ring_fwd_kernel`): q rotates by its table rows, k by its own, in fp32
// by the −θ convention (y1 = x1·c + x2·s, y2 = −x1·s + x2·c); q takes the
// factor scale·log2e in fp32, then both round to bf16; logits accumulate in
// fp32 and take the fp32 bias row; p = exp2(s − m) rounds to bf16 for the
// PV product, the row sum stays fp32.
//
// What bounds it on the card: at the sampling shapes (B=2, H=16, L=1040,
// D=128) it is compute-bound — 4·B·H·Lq·Lk·D flops against ~2·B·(2Lq+2Lk)·H·D
// bytes, ~300 flops a byte. So every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate); q, the logits and the
// output accumulator stay in registers for the whole kv sweep (the online
// softmax never writes a logit to memory); k/v tiles stream into shared
// memory by cp.async, double-buffered, so the next tile's copy overlaps this
// tile's products. Nothing is sized by Lk, so the same kernel takes the
// ring's chunks up to 4096 kv rows.
//
// The TPU kernel rotates all of k in VMEM once per q block, which at its
// two q blocks per head is cheap. Here a head has 17 q tiles of 64 rows,
// and rotating each k tile in every one of them re-reads 32 KB of fp32
// cos/sin per tile and serialises the loads. So k is rotated once, by
// `rope_rotate_kernel`, into a bf16 scratch (the same fp32 math and the
// same rounding as in the TPU kernel), and the attention kernel streams the
// rotated k; each block rotates its own q tile on the way in.
//
// The ragged kv edge is zero-filled by cp.async and masked with −inf (the
// TPU uses −1e30 on padded columns); the ragged q edge is zero-filled and
// not stored. A row whose every column carries the −1e30 bias (a ring chunk
// that is all padding) keeps m = −1e30: p = 1 on its columns, o their mean,
// lse ≈ −1e30, all finite, so the ring's merge gives it zero weight.
#pragma once

#include "mma_utils.cuh"

namespace {

constexpr int NWARPS = 4;  // 16 q rows each; 8 warps measured slower
constexpr int BM = 16 * NWARPS;  // q rows per block
constexpr int NT = NWARPS * 32;
constexpr int BN = 64;  // kv rows per tile

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

// q rotates by cos_q/sin_q [Lq, D/2] (ROPE); k arrives rotated. With BIAS,
// kbias [Lk] fp32 is added to each row's logits.
template <int D, bool ROPE, bool BIAS>
__global__ void __launch_bounds__(NT)
    attention_fwd_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ cos_q,
                         const float* __restrict__ sin_q,
                         const float* __restrict__ kbias,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         int H, int Lq, int Lk, long long q_sb,
                         long long q_sl, long long k_sb, long long k_sl,
                         long long v_sb, long long v_sl, float q_mul) {
  constexpr int LD = D + 8;  // padded row: conflict-free ldmatrix
  // tiles [k0][v0][k1][v1], each BN rows; the q tile is staged in k1
  // before the first copy into that buffer starts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*tiles)[BN][LD] = reinterpret_cast<bf16(*)[BN][LD]>(smem_raw);
  bf16(*s_q)[LD] = tiles[2];

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row within the 8-row group
  const int t = lane % 4;  // fragment column pair

  const bf16* kb = k + b * k_sb + h * D;
  const bf16* vb = v + b * v_sb + h * D;
  auto load_kv = [&](int buf, int n0) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
    for (int idx = threadIdx.x; idx < BN * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = n0 + r < Lk;
      const long long gr = valid ? n0 + r : 0;
      cp_async16(&tiles[2 * buf][r][c], kb + gr * k_sl + c, valid);
      cp_async16(&tiles[2 * buf + 1][r][c], vb + gr * v_sl + c, valid);
    }
    cp_async_commit();
  };

  const int ntiles = (Lk + BN - 1) / BN;
  load_kv(0, 0);

  // q tile: rotate (ROPE) and take scale·log2e in fp32, round to bf16
  {
    constexpr int H2 = D / 2;
    constexpr int CH = H2 / 8;
    const bf16* qb = q + b * q_sb + h * D;
    for (int idx = threadIdx.x; idx < BM * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const int gr = q0 + r;
      float x1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float x2[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gr < Lq) {
        const bf16* p = qb + static_cast<long long>(gr) * q_sl + c;
        unpack8(*reinterpret_cast<const uint4*>(p), x1);
        unpack8(*reinterpret_cast<const uint4*>(p + H2), x2);
        if (ROPE)
          rotate8(x1, x2, cos_q + static_cast<long long>(gr) * H2 + c,
                  sin_q + static_cast<long long>(gr) * H2 + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x1[i] *= q_mul;
          x2[i] *= q_mul;
        }
      }
      *reinterpret_cast<uint4*>(&s_q[r][c]) = pack8(x1);
      *reinterpret_cast<uint4*>(&s_q[r][c + H2]) = pack8(x2);
    }
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(qf[kc], &s_q[warp * 16 + (lane % 16)][kc * 16 + (lane / 16) * 8]);
  __syncthreads();  // the q staging area is free for tile 1

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int n0 = j * BN;
    if (j + 1 < ntiles)
      load_kv((j + 1) & 1, n0 + BN);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait_one();  // this thread's copies of tile j have landed
    __syncthreads();      // ... and everyone's
    const bf16(*s_k)[LD] = tiles[2 * (j & 1)];
    const bf16(*s_v)[LD] = tiles[2 * (j & 1) + 1];

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &s_k[np * 16 + (lane % 8) + (lane / 16) * 8]
                            [kc * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }
    }

    if (BIAS) {  // the additive kv row, before the ragged mask
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + i * 8 + 2 * t;
        const float b0 = col < Lk ? kbias[col] : 0.f;
        const float b1 = col + 1 < Lk ? kbias[col + 1] : 0.f;
        s[i][0] += b0;
        s[i][2] += b0;
        s[i][1] += b1;
        s[i][3] += b1;
      }
    }

    if (n0 + BN > Lk) {  // ragged kv edge
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + i * 8 + 2 * t;
        if (col >= Lk) s[i][0] = s[i][2] = -INFINITY;
        if (col + 1 >= Lk) s[i][1] = s[i][3] = -INFINITY;
      }
    }

    // online softmax, exp2 domain; this thread holds rows g (r=0), g+8 (r=1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_row[r];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float alpha = exp2f(m_row[r] - mx);  // 0 on the first tile
      m_row[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        s[i][2 * r] = exp2f(s[i][2 * r] - mx);
        s[i][2 * r + 1] = exp2f(s[i][2 * r + 1] - mx);
        rs += s[i][2 * r] + s[i][2 * r + 1];
      }
      rs += __shfl_xor_sync(0xffffffff, rs, 1);
      rs += __shfl_xor_sync(0xffffffff, rs, 2);
      l_row[r] = l_row[r] * alpha + rs;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][2 * r] *= alpha;
        acc[i][2 * r + 1] *= alpha;
      }
    }

    // acc += bf16(p) · v: the logit fragments are the A fragments of p
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &s_v[kc * 16 + (lane % 16)][dp * 16 + (lane / 16) * 8]);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // tile j's buffer is read; iteration j+1 refills it
  }

  const long long o_sl = static_cast<long long>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    bf16* orow = o + (static_cast<long long>(b) * Lq + row) * o_sl + h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * t) =
          pack_bf16(acc[i][2 * r] / l_row[r], acc[i][2 * r + 1] / l_row[r]);
    }
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Lq + row] = m_row[r] + log2f(l_row[r]);
  }
}

// With ROPE, k rotates by cos_k/sin_k into k_rot first, then the attention
// kernel streams k_rot.
template <int D, bool ROPE, bool BIAS>
cudaError_t launch_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* cos_q, const void* sin_q,
                                 const void* cos_k, const void* sin_k,
                                 const void* kbias, void* k_rot, void* o,
                                 void* lse, int B, int H, int Lq, int Lk,
                                 long long q_sb, long long q_sl,
                                 long long k_sb, long long k_sl,
                                 long long v_sb, long long v_sl, float q_mul,
                                 cudaStream_t stream) {
  if (ROPE) {
    const long long total = static_cast<long long>(B) * Lk * H * (D / 16);
    const int threads = 256;
    rope_rotate_kernel<D><<<static_cast<unsigned>((total + threads - 1) / threads),
                            threads, 0, stream>>>(
        static_cast<const bf16*>(k), static_cast<const float*>(cos_k),
        static_cast<const float*>(sin_k), static_cast<bf16*>(k_rot), H, Lk,
        k_sb, k_sl, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k = k_rot;
    k_sl = static_cast<long long>(H) * D;
    k_sb = Lk * k_sl;
  }
  constexpr int smem = 4 * BN * (D + 8) * sizeof(bf16);
  auto kernel = attention_fwd_kernel<D, ROPE, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(cos_q),
      static_cast<const float*>(sin_q), static_cast<const float*>(kbias),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Lq, Lk, q_sb, q_sl,
      k_sb, k_sl, v_sb, v_sl, q_mul);
  return cudaGetLastError();
}

}  // namespace
