// Long-path attention forward over pre-rotated q/k, for Hopper (sm_90a).
//
// Replaces the Pallas function `_forward`
// (video_diffusion_speedrun_tpu/ops/fused_attention.py:251) on the arities
// the port takes: q and k arrive rotated (`_rotate_flat`, :85; the long
// path's `_preroted_flash`, :1812 — kernels `_fwd_kernel_noro` (:124) and
// `_fwd_kernel_noro2` (:135), body `_fwd_kernel` (:188-248)), with or
// without the additive kv-bias row (`has_bias`, :214-215, 296-302), which
// the ring path's fallback for chunks above 4096 kv rows passes
// (`_ring_chunk_fwd`, :1189-1193). The bias joins the scaled logits before
// the ragged-tile mask, as on the TPU.
//
// In the same launch it computes what the TPU splits off at lengths such
// as 8208 = 16 + 8·1024 that do not tile into its 1024-row blocks:
// `_forward_tail` (:1468) folds the 16 prefix kv columns into the bulk's
// online softmax with `_tail_merge_kernel` (:1435). Here kv streams in
// 64-row tiles and the ragged last tile is masked, so the prefix columns
// are one more step of the same online-softmax update, for every q row.
//
// What it computes, per (b, h): o = softmax(q·kᵀ·scale)·v and the
// exp2-domain lse = log2 Σ exp2(s), with the long path's rounding points,
// which differ from the short kernels': s = dot(q, k) of the bf16 inputs,
// accumulated in fp32, THEN × scale·log2e (:210-213); the short kernels
// fold scale·log2e into q before rounding it. p = exp2(s − m) rounds to
// bf16 for the PV product, the row sum stays fp32.
//
// What bounds it on the card: 4·B·H·Lq·Lk·D flops against
// ~2·B·(2Lq + 2Lk)·H·D bytes, ~4,000 flops a byte at L = 8208: far on the
// compute side. So every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate); q, the logits and the output
// accumulator stay in registers for the whole kv sweep (the online softmax
// never writes a logit to memory); k/v tiles stream into shared memory by
// cp.async, double-buffered, so the next tile's copy overlaps this tile's
// products. q is already rotated and rounded, so it too arrives by cp.async
// (the short kernel rotates and scales it on the way in). Nothing is sized
// by L: a block holds one 64-row q tile and two k/v tiles whatever the
// length, and every offset that grows with B·L·H·D is 64-bit.
//
// The ragged kv edge is zero-filled by cp.async and masked with −inf (the
// TPU uses −1e30 on padded columns); the ragged q edge is zero-filled and
// not stored.

#include "mma_utils.cuh"

namespace {

constexpr int NWARPS = 4;        // 16 q rows each
constexpr int BM = 16 * NWARPS;  // q rows per block
constexpr int NT = NWARPS * 32;
constexpr int BN = 64;           // kv rows per tile

// With BIAS, kbias [Lk] fp32 is added to each row's scaled logits.
template <int D, bool BIAS>
__global__ void __launch_bounds__(NT)
    long_attention_fwd_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ kbias,
                              bf16* __restrict__ o, float* __restrict__ lse,
                              int H, int Lq, int Lk, long long q_sb,
                              long long q_sl, long long k_sb, long long k_sl,
                              long long v_sb, long long v_sl, float s_mul) {
  constexpr int LD = D + 8;  // padded row: conflict-free ldmatrix
  constexpr int CH = D / 8;  // 16-byte chunks per row
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

  // group 0: the q tile; group 1: kv tile 0
  {
    const bf16* qb = q + b * q_sb + h * D;
    for (int idx = threadIdx.x; idx < BM * CH; idx += NT) {
      const int r = idx / CH;
      const int c = (idx % CH) * 8;
      const bool valid = q0 + r < Lq;
      const long long gr = valid ? q0 + r : 0;
      cp_async16(&s_q[r][c], qb + gr * q_sl + c, valid);
    }
    cp_async_commit();
  }
  const int ntiles = (Lk + BN - 1) / BN;
  load_kv(0, 0);
  cp_async_wait_one();  // this thread's q copies have landed
  __syncthreads();      // ... and everyone's
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

    // the long path scales the fp32 logits, after the product
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= s_mul;

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

template <int D, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kbias, void* o, void* lse, int B, int H,
                   int Lq, int Lk, long long q_sb,
                   long long q_sl, long long k_sb, long long k_sl,
                   long long v_sb, long long v_sl, float s_mul,
                   cudaStream_t stream) {
  constexpr int smem = 4 * BN * (D + 8) * sizeof(bf16);
  auto kernel = long_attention_fwd_kernel<D, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(kbias),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Lq, Lk, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
      s_mul);
  return cudaGetLastError();
}

}  // namespace

// q [B, Lq, H·D], k/v [B, Lk, H·D] bf16, q and k already rotated, with unit
// column stride and the given batch/row strides (in elements); any Lq, Lk.
// kbias [Lk] fp32 added to the scaled logits, or null for none. o
// [B, Lq, H·D] bf16 and lse [B, H, Lq] fp32 contiguous. s_mul =
// scale·log2e, applied to the fp32 logits. Returns the cudaError_t of the
// launch.
extern "C" int long_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* kbias, void* o, void* lse,
                                  int B, int H, int Lq, int Lk, int D,
                                  long long q_sb, long long q_sl,
                                  long long k_sb, long long k_sl,
                                  long long v_sb, long long v_sl, float s_mul,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VDS_LAUNCH(DD, BB)                                                  \
  if (D == DD && (kbias != nullptr) == BB)                                  \
  return static_cast<int>(launch<DD, BB>(q, k, v, kbias, o, lse, B, H, Lq, \
                                         Lk, q_sb, q_sl, k_sb, k_sl, v_sb, \
                                         v_sl, s_mul, s))
  VDS_LAUNCH(128, false);
  VDS_LAUNCH(128, true);
  VDS_LAUNCH(64, false);
  VDS_LAUNCH(64, true);
#undef VDS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* long_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
