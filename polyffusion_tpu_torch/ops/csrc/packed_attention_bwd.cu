// Packed whole-sequence self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel polyffusion_tpu/ops/fused_attention.py:_packed_bwd_kernel.
// For every batch item and head, with q, k, v and dO read straight out of the
// packed (B, T, H*D) layout (head h is the lane slice h*D:(h+1)*D), it recomputes
//   S  = Q K^T * scale,  P = softmax(S)                      (fp32)
//   Pc = P rounded to the input dtype (after the division by the row sum)
//   dV = Pc^T dO,  dP = dO V^T
//   dS = (Pc * (dP - rowsum(dP * Pc)) * scale) rounded to the input dtype
//   dQ = dS K,     dK = dS^T Q                               (fp32 accumulate)
// and writes dQ, dK, dV in the input dtype, packed like the inputs. The row
// sum is taken over dP * Pc, as the TPU kernel does (fused_attention.py:148),
// not over dO * O: the two agree in fp32 and differ in bf16.
//
// What bounds it on an H100: five T x T x D products per (batch, head), so at
// the UNet's T = 1024, D = 64 in bf16 the tensor cores' operations bound it, and
// at T = 256 the bytes of q, k, v, dO, dQ, dK, dV.
//
// What the design does about it: the TPU kernel keeps a whole (T, T) in VMEM;
// K and V of one head at T = 1024 alone exceed a block's shared memory. So it
// runs FlashAttention-2 style in two kernels, without atomics (the result is
// deterministic), recomputing P from per-row statistics instead of storing it:
//   A. one block per 64-query tile: three passes over the key tiles give the
//      row max m and row sum l, then dsum = rowsum(dP * Pc), then dQ = dS K.
//      (m, l, dsum) go to a small fp32 scratch of shape (B, H, T, 3).
//   B. one block per 64-key tile: one pass over the query tiles recomputes P
//      and dS from the scratch and accumulates dV += Pc^T dO and dK += dS^T Q.
// That is ten tile products where five would do; fusing the passes is later
// work. bf16 runs every product on the tensor cores with mma.sync m16n8k16
// (four warps of 16 rows, accumulators reused as the A operand of the next
// product, as in the forward); fp32 runs FMA on the CUDA cores (256 threads,
// 4 x 4 register tiles), since the tensor cores would round it to TF32.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreadsTc = 128;  // bf16: four warps of 16 rows
constexpr int kThreads32 = 256;  // fp32: 16 x 16 threads
constexpr int kLdP = kTile + 4;  // fp32 (64, 64) tiles in shared memory

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16). Fragment layout (g = lane / 4, t = lane % 4):
//   A (16x16): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16x8):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]

// acc (16 x 64) = A[row0 .. row0+15] B^T for two (64, D) bf16 tiles in shared
// memory, rows ld apart. acc[n][e] is row row0 + g + 8 (e / 2), column
// 8n + 2t + e % 2.
template <int D>
__device__ __forceinline__ void tile_abt(float (*acc)[4], const bf16* as, const bf16* bs, int ld,
                                         int row0, int g, int t) {
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* ar = as + (row0 + g) * ld + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld_b32(ar), ld_b32(ar + 8 * ld), ld_b32(ar + 8), ld_b32(ar + 8 * ld + 8)};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const bf16* br = bs + (n * 8 + g) * ld + kk * 16 + 2 * t;
      mma_bf16(acc[n], a, ld_b32(br), ld_b32(br + 8));
    }
  }
}

// acc (16 x D) += P B, where P (16 x 64) is held in the C layout of tile_abt
// and is rounded to bf16 on its way in, and B is a (64, D) bf16 tile in shared
// memory, rows ld apart, read by ldmatrix.trans.
template <int D>
__device__ __forceinline__ void tile_pb(float (*acc)[4], const float (*p)[4], const bf16* bs, int ld,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]), pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* brow = bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, brow + n * 8);
      mma_bf16(acc[n], pa, b[0], b[1]);
      mma_bf16(acc[n + 1], pa, b[2], b[3]);
    }
  }
}

// Kernel A: dQ and the per-row statistics of one 64-query tile.
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ stats,
                 int seq, int n_heads, float scale) {
  constexpr int kLd = D + 8;  // padded row: fragment loads hit 32 distinct banks
  extern __shared__ uint4 smem_a[];
  bf16* qs = reinterpret_cast<bf16*>(smem_a);
  bf16* dos = qs + kTile * kLd;
  bf16* ks = dos + kTile * kLd;
  bf16* vs = ks + kTile * kLd;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(blockIdx.z) * seq * row_stride +
                         static_cast<long>(blockIdx.y) * D;
  const int q0 = blockIdx.x * kTile;

  copy_tile_bf16<D, kThreadsTc>(q + head_base + q0 * row_stride, row_stride, qs, kLd);
  copy_tile_bf16<D, kThreadsTc>(dout + head_base + q0 * row_stride, row_stride, dos, kLd);

  // pass 1: row max m of S and row sum l of exp(S - m); rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    copy_tile_bf16<D, kThreadsTc>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
    __syncthreads();
    float s[kTile / 8][4];
    tile_abt<D>(s, qs, ks, kLd, row0, g, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        s[n][2 * r] *= scale;
        s[n][2 * r + 1] *= scale;
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
        rs += expf(s[n][2 * r] - m_new) + expf(s[n][2 * r + 1] - m_new);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * expf(m[r] - m_new) + rs;
      m[r] = m_new;
    }
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: dsum = rowsum(dP * Pc)
  float dsum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    copy_tile_bf16<D, kThreadsTc>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
    copy_tile_bf16<D, kThreadsTc>(v + head_base + k0 * row_stride, row_stride, vs, kLd);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
    tile_abt<D>(s, qs, ks, kLd, row0, g, t);
    tile_abt<D>(dp, dos, vs, kLd, row0, g, t);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pc = round_bf16(expf(s[n][e] * scale - m[r]) * inv_l[r]);
        dsum[r] += dp[n][e] * pc;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
  }

  // pass 3: dQ = dS K
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    copy_tile_bf16<D, kThreadsTc>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
    copy_tile_bf16<D, kThreadsTc>(v + head_base + k0 * row_stride, row_stride, vs, kLd);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
    tile_abt<D>(s, qs, ks, kLd, row0, g, t);
    tile_abt<D>(dp, dos, vs, kLd, row0, g, t);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pc = round_bf16(expf(s[n][e] * scale - m[r]) * inv_l[r]);
        s[n][e] = pc * (dp[n][e] - dsum[r]) * scale;  // dS, rounded by tile_pb
      }
    tile_pb<D>(acc, s, ks, kLd, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    bf16* dst = dq + head_base + row * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    if (t == 0) {
      float* st = stats + ((static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * seq + row) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = dsum[r];
    }
  }
}

// Kernel B: dK and dV of one 64-key tile. Rows of every product are this
// block's keys, so S^T = K Q^T and dP^T = V dO^T come out in the layout that
// the products with dO and Q take as their A operand.
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
attn_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ stats,
                   int seq, int n_heads, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ uint4 smem_b[];
  bf16* ks = reinterpret_cast<bf16*>(smem_b);
  bf16* vs = ks + kTile * kLd;
  bf16* qs = vs + kTile * kLd;
  bf16* dos = qs + kTile * kLd;
  float* ms = reinterpret_cast<float*>(dos + kTile * kLd);
  float* ils = ms + kTile;
  float* dss = ils + kTile;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(blockIdx.z) * seq * row_stride +
                         static_cast<long>(blockIdx.y) * D;
  const int k0 = blockIdx.x * kTile;
  const float* head_stats = stats + (static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * seq * 3;

  copy_tile_bf16<D, kThreadsTc>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
  copy_tile_bf16<D, kThreadsTc>(v + head_base + k0 * row_stride, row_stride, vs, kLd);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    copy_tile_bf16<D, kThreadsTc>(q + head_base + q0 * row_stride, row_stride, qs, kLd);
    copy_tile_bf16<D, kThreadsTc>(dout + head_base + q0 * row_stride, row_stride, dos, kLd);
    if (threadIdx.x < kTile) {
      const float* st = head_stats + (q0 + threadIdx.x) * 3;
      ms[threadIdx.x] = st[0];
      ils[threadIdx.x] = 1.f / st[1];
      dss[threadIdx.x] = st[2];
    }
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
    tile_abt<D>(s, ks, qs, kLd, row0, g, t);    // S^T
    tile_abt<D>(dp, vs, dos, kLd, row0, g, t);  // dP^T
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);  // the query
        const float pc = round_bf16(expf(s[n][e] * scale - ms[col]) * ils[col]);
        s[n][e] = pc;
        dp[n][e] = pc * (dp[n][e] - dss[col]) * scale;  // dS^T
      }
    tile_pb<D>(dva, s, dos, kLd, lane);  // dV += Pc^T dO
    tile_pb<D>(dka, dp, qs, kLd, lane);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long off = head_base + (k0 + row0 + g + 8 * r) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) = pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) = pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA. Thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16)
// holds rows ty*4 .. ty*4+3 of every (64, 64) tile, at columns tx + 16 j.

// s[i][j] = sum_d A[ty*4 + i][d] B[tx + 16 j][d] for two (64, D) fp32 tiles in
// shared memory, rows ld floats apart.
template <int D>
__device__ __forceinline__ void tile_abt_f32(float (*s)[4], const float* as, const float* bs, int ld,
                                             int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(as + (ty * 4 + i) * ld + d, a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(bs + (tx + 16 * j) * ld + d, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
  }
}

// acc[i][4 c + e] += sum_j P[ty*4 + i][j] B[j][64 c + 4 tx + e], with P a (64, 64)
// tile in shared memory (rows kLdP apart) and B a (64, D) tile (rows ld apart).
template <int D>
__device__ __forceinline__ void tile_pb_f32(float (*acc)[D / 16], const float* ps, const float* bs,
                                            int ld, int tx, int ty) {
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(ps + (ty * 4 + i) * kLdP + j, p[i]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        float b[4];
        load4(bs + (j + jj) * ld + 64 * c + tx * 4, b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * c + e] = fmaf(p[i][jj], b[e], acc[i][4 * c + e]);
      }
    }
  }
}

// Sums v over the 16 threads of a row (one half-warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, long row_stride, const float (*acc)[D / 16],
                                               int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 64; ++c) store4(dst + (ty * 4 + i) * row_stride + 64 * c + tx * 4, &acc[i][4 * c]);
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ stats,
                int seq, int n_heads, float scale) {
  constexpr int kLd = D + 4;
  extern __shared__ float4 smem_fa[];
  float* qs = reinterpret_cast<float*>(smem_fa);
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(blockIdx.z) * seq * row_stride +
                         static_cast<long>(blockIdx.y) * D;
  const int q0 = blockIdx.x * kTile;

  copy_tile_f32<D, kThreads32>(q + head_base + q0 * row_stride, row_stride, qs, kLd);
  copy_tile_f32<D, kThreads32>(dout + head_base + q0 * row_stride, row_stride, dos, kLd);

  // pass 1: row max and row sum
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    copy_tile_f32<D, kThreads32>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
    __syncthreads();
    float s[4][4];
    tile_abt_f32<D>(s, qs, ks, kLd, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(rs);
      m[i] = m_new;
    }
  }
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv_l[i] = 1.f / l[i];

  // pass 2: dsum = rowsum(dP * P)
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    copy_tile_f32<D, kThreads32>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
    copy_tile_f32<D, kThreads32>(v + head_base + k0 * row_stride, row_stride, vs, kLd);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt_f32<D>(s, qs, ks, kLd, tx, ty);
    tile_abt_f32<D>(dp, dos, vs, kLd, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsum[i] += dp[i][j] * (expf(s[i][j] * scale - m[i]) * inv_l[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dsum[i] = row_sum16(dsum[i]);

  // pass 3: dQ = dS K
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    copy_tile_f32<D, kThreads32>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
    copy_tile_f32<D, kThreads32>(v + head_base + k0 * row_stride, row_stride, vs, kLd);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt_f32<D>(s, qs, ks, kLd, tx, ty);
    tile_abt_f32<D>(dp, dos, vs, kLd, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] * scale - m[i]) * inv_l[i];
        ps[(ty * 4 + i) * kLdP + tx + 16 * j] = p * (dp[i][j] - dsum[i]) * scale;
      }
    __syncthreads();
    tile_pb_f32<D>(acc, ps, ks, kLd, tx, ty);
  }

  store_rows_f32<D>(dq + head_base + q0 * row_stride, row_stride, acc, tx, ty);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* st = stats + ((static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * seq + q0 + ty * 4 + i) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = dsum[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats,
                  int seq, int n_heads, float scale) {
  constexpr int kLd = D + 4;
  extern __shared__ float4 smem_fb[];
  float* ks = reinterpret_cast<float*>(smem_fb);
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* pts = dos + kTile * kLd;  // P^T (keys x queries)
  float* dsts = pts + kTile * kLdP;  // dS^T
  float* ms = dsts + kTile * kLdP;
  float* ils = ms + kTile;
  float* dss = ils + kTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(blockIdx.z) * seq * row_stride +
                         static_cast<long>(blockIdx.y) * D;
  const int k0 = blockIdx.x * kTile;
  const float* head_stats = stats + (static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * seq * 3;

  copy_tile_f32<D, kThreads32>(k + head_base + k0 * row_stride, row_stride, ks, kLd);
  copy_tile_f32<D, kThreads32>(v + head_base + k0 * row_stride, row_stride, vs, kLd);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    copy_tile_f32<D, kThreads32>(q + head_base + q0 * row_stride, row_stride, qs, kLd);
    copy_tile_f32<D, kThreads32>(dout + head_base + q0 * row_stride, row_stride, dos, kLd);
    if (threadIdx.x < kTile) {
      const float* st = head_stats + (q0 + threadIdx.x) * 3;
      ms[threadIdx.x] = st[0];
      ils[threadIdx.x] = 1.f / st[1];
      dss[threadIdx.x] = st[2];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt_f32<D>(s, ks, qs, kLd, tx, ty);    // S^T
    tile_abt_f32<D>(dp, vs, dos, kLd, tx, ty);  // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;  // the query
        const float p = expf(s[i][j] * scale - ms[col]) * ils[col];
        pts[(ty * 4 + i) * kLdP + col] = p;
        dsts[(ty * 4 + i) * kLdP + col] = p * (dp[i][j] - dss[col]) * scale;
      }
    __syncthreads();
    tile_pb_f32<D>(dva, pts, dos, kLd, tx, ty);  // dV += P^T dO
    tile_pb_f32<D>(dka, dsts, qs, kLd, tx, ty);  // dK += dS^T Q
  }

  store_rows_f32<D>(dk + head_base + k0 * row_stride, row_stride, dka, tx, ty);
  store_rows_f32<D>(dv + head_base + k0 * row_stride, row_stride, dva, tx, ty);
}

// ---------------------------------------------------------------------------

template <typename T, typename KernelA, typename KernelB>
cudaError_t launch(KernelA ka, KernelB kb, int threads, size_t smem_a, size_t smem_b,
                   std::atomic<uint64_t>& set_a, std::atomic<uint64_t>& set_b, const void* q,
                   const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int batch, int seq, int n_heads, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(ka, smem_a, set_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(kb, smem_b, set_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kTile, n_heads, batch);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  ka<<<grid, threads, smem_a, stream>>>(qt, kt, vt, dot, static_cast<T*>(dq), stats, seq, n_heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<grid, threads, smem_b, stream>>>(qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv),
                                        stats, seq, n_heads, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, float* stats, int batch, int seq, int n_heads,
                        float scale, cudaStream_t stream) {
  constexpr size_t kSmemA = sizeof(bf16) * 4 * kTile * (D + 8);
  constexpr size_t kSmemB = kSmemA + sizeof(float) * 3 * kTile;
  static std::atomic<uint64_t> set_a{0}, set_b{0};
  return launch<bf16>(attn_bwd_dq_bf16<D>, attn_bwd_dkdv_bf16<D>, kThreadsTc, kSmemA, kSmemB, set_a,
                      set_b, q, k, v, dout, dq, dk, dv, stats, batch, seq, n_heads, scale, stream);
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, float* stats, int batch, int seq, int n_heads,
                        float scale, cudaStream_t stream) {
  constexpr size_t kSmemA = sizeof(float) * (4 * kTile * (D + 4) + kTile * kLdP);
  constexpr size_t kSmemB = sizeof(float) * (4 * kTile * (D + 4) + 2 * kTile * kLdP + 3 * kTile);
  static std::atomic<uint64_t> set_a{0}, set_b{0};
  return launch<float>(attn_bwd_dq_f32<D>, attn_bwd_dkdv_f32<D>, kThreads32, kSmemA, kSmemB, set_a,
                       set_b, q, k, v, dout, dq, dk, dv, stats, batch, seq, n_heads, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats: (batch, n_heads, seq, 3) fp32
// scratch. Returns a cudaError_t (0 on success).
extern "C" int packed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                    void* dq, void* dk, void* dv, void* stats, int batch, int seq,
                                    int n_heads, int head_dim, int dtype, float scale, void* stream) {
  if (seq <= 0 || seq % kTile != 0 || batch <= 0 || n_heads <= 0 || batch > 65535 ||
      n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0 && head_dim == 64)
    return static_cast<int>(launch_fp32<64>(q, k, v, dout, dq, dk, dv, st, batch, seq, n_heads, scale, s));
  if (dtype == 0 && head_dim == 128)
    return static_cast<int>(launch_fp32<128>(q, k, v, dout, dq, dk, dv, st, batch, seq, n_heads, scale, s));
  if (dtype == 1 && head_dim == 64)
    return static_cast<int>(launch_bf16<64>(q, k, v, dout, dq, dk, dv, st, batch, seq, n_heads, scale, s));
  if (dtype == 1 && head_dim == 128)
    return static_cast<int>(launch_bf16<128>(q, k, v, dout, dq, dk, dv, st, batch, seq, n_heads, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
