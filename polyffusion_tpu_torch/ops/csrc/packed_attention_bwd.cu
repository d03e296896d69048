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
// the UNet's T = 1024, D = 64 in bf16 the tensor cores' operations bound it
// (0.0434 ms at (16, 1024, 4*64)), and at T = 256 the bytes of q, k, v, dO,
// dQ, dK, dV (0.0044 ms at (16, 256, 4*64)).
//
// What the design does about it (bf16): the forward (packed_attention.cu)
// saves the row log-sum-exp lse = max + log(sum), so P = exp(S * scale - lse)
// needs no pass over the keys for the row max and sum. Two kernels, each a
// producer warp that streams (64, 64) tiles with TMA (3-D tensor maps, the
// 128-byte swizzle, mbarriers) into a ring of three stages at D = 64 (two at
// 128) and one consumer warpgroup of wgmma m64n64k16 products:
//   1. query-major, one block per 64-query tile with Q and dO resident: a
//      first pass over the key tiles makes S and dP (two products per tile)
//      for dsum = rowsum(dP * Pc), written fp32 (B, H, T); a second pass
//      makes them again and dQ += dS K (three), with dS from registers (its
//      rows are this tile's queries) and K read MN-major. dQ is written in
//      the input dtype at the end.
//   2. key-major, one block per 64-key tile with K and V resident, the query
//      tiles and their lse and dsum streamed: S^T = K Q^T and dP^T = V dO^T
//      (shared memory, K-major), then dV += Pc^T dO and dK += dS^T Q with
//      Pc^T and dS^T from registers and dO and Q MN-major (four products);
//      each tile's dV and dK finish behind the next tile's S^T and dP^T.
// That is nine tile products per (query tile, key tile) where the five of
// the bound would do, and no atomics: every sum has one owner, so the
// result is the same from run to run. A key-major design that also made dQ
// (seven products; dS^T staged through shared memory, dQ's partial sums
// added atomically into an fp32 scratch, then cast) was slower at the UNet's
// shapes: waiting for each tile's dQ product drained the tensor cores.
//
// fp32 (CUDA-core FMA, unchanged; the tensor cores would round to TF32): two
// kernels without atomics, deterministic. A: one block per 64-query tile,
// three passes over the key tiles (row max m and sum l, then dsum, then dQ),
// (m, l, dsum) to a small fp32 scratch (B, H, T, 3). B: one block per 64-key
// tile, one pass over the query tiles for dV and dK. 256 threads, 4 x 4
// register tiles.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads32 = 256;  // fp32: 16 x 16 threads
constexpr int kLdP = kTile + 4;  // fp32 (64, 64) tiles in shared memory

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA rings, one producer warp and one consumer warpgroup per block

constexpr int kThreadsWg = 128 + 32;

// Stages of a ring: a tile's stage goes back one step after its products are
// issued, so three keep the copies ahead where shared memory allows.
template <int D>
constexpr int ring_stages() {
  return D == 64 ? 3 : 2;
}

// Shared memory of either kernel: two resident 64-row tiles (Q and dO, or K and
// V), then the ring of streamed pairs of tiles (K and V, or Q and dO), then
// ``extra`` bytes per stage (the streamed rows' lse and dsum), then barriers.
template <int D, uint32_t kExtra>
struct BwdSmem {
  static constexpr int kNc = D / kChunk;
  static constexpr int kStages = ring_stages<D>();
  static constexpr uint32_t kPair = 2 * kNc * kChunkBytes;
  static constexpr size_t kBytes =
      1024 + kPair + kStages * (kPair + kExtra) + (1 + 2 * kStages) * 8;
};

// The producer: the resident pair once, then ``n_loads`` streamed pairs, load
// j being tile j % n_tiles, into the ring; ``stats`` (or null) also streams
// the tile's 64 lse and 64 dsum values.
template <int D, uint32_t kExtra>
__device__ __forceinline__ void produce(const CUtensorMap* res0, const CUtensorMap* res1,
                                        const CUtensorMap* str0, const CUtensorMap* str1,
                                        uint8_t* res, uint8_t* ring, float* stats,
                                        uint64_t* res_full, uint64_t* full, uint64_t* empty,
                                        int col, int row0, int b, int n_tiles, int n_loads,
                                        const float* lse_rows, const float* dsum_rows) {
  using L = BwdSmem<D, kExtra>;
  constexpr int kNc = L::kNc;
  mbar_expect_tx(res_full, L::kPair);
  for (int c = 0; c < kNc; ++c) {
    tma_load_chunk(res + c * kChunkBytes, res0, res_full, col + c * kChunk, row0, b);
    tma_load_chunk(res + (kNc + c) * kChunkBytes, res1, res_full, col + c * kChunk, row0, b);
  }
  for (int j = 0; j < n_loads; ++j) {
    const int st = j % L::kStages;
    const int row = (j % n_tiles) * kTile;
    if (j >= L::kStages) mbar_wait(&empty[st], (j / L::kStages - 1) & 1);
    uint8_t* pair = ring + st * L::kPair;
    mbar_expect_tx(&full[st], L::kPair + kExtra);
    for (int c = 0; c < kNc; ++c) {
      tma_load_chunk(pair + c * kChunkBytes, str0, &full[st], col + c * kChunk, row, b);
      tma_load_chunk(pair + (kNc + c) * kChunkBytes, str1, &full[st], col + c * kChunk, row, b);
    }
    if constexpr (kExtra > 0) {
      float* st_stats = stats + st * 2 * kTile;
      bulk_load(st_stats, lse_rows + row, kTile * 4, &full[st]);
      bulk_load(st_stats + kTile, dsum_rows + row, kTile * 4, &full[st]);
    }
  }
}

__device__ __forceinline__ void init_ring(uint64_t* res_full, uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// 1. dsum and dQ of one 64-query tile; Q and dO resident, the key tiles (K and
// V) streamed twice. The first pass makes S = Q K^T and dP = dO V^T for
// dsum = rowsum(dP * Pc); the second makes them again for dS, and dQ += dS K
// with dS from registers (its rows are this tile's queries) and K MN-major.
template <int D>
__global__ void __launch_bounds__(kThreadsWg)
attention_bwd_dq(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                 float* __restrict__ dsum, bf16* __restrict__ dq, int seq, int n_heads,
                 float scale) {
  using L = BwdSmem<D, 0>;
  constexpr int kNc = L::kNc;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_dq[];
  uint8_t* qs = align_1024(smem_dq);
  uint8_t* dos = qs + kNc * kChunkBytes;
  uint8_t* ring = qs + L::kPair;
  uint64_t* rows_full = reinterpret_cast<uint64_t*>(ring + kStages * L::kPair);
  uint64_t* full = rows_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int n_tiles = seq / kTile;
  init_ring(rows_full, full, empty, kStages);

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      produce<D, 0>(&qmap, &domap, &kmap, &vmap, qs, ring, nullptr, rows_full, full, empty,
                    h * D, q0, b, n_tiles, 2 * n_tiles, nullptr, nullptr);
    return;
  }

  // rows of every product are this tile's queries: g = lane / 4 owns rows
  // g and g + 8 of its warp's 16, with the 3 other threads of its quad
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long head_rows = (static_cast<long>(b) * n_heads + h) * seq;
  const float c = scale * kLog2e;  // exp(x scale - lse) = 2^(x c - lse log2(e))
  float row_lse2[2], row_dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) row_lse2[r] = lse[head_rows + q0 + warp * 16 + g + 8 * r] * kLog2e;

  float dqa[kNc][32];
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[ch][i] = 0.f;
  uint32_t ds[4][4];  // dS of the last key tile, the A operand of dQ += dS K

  mbar_wait(rows_full, 0);
  for (int j = 0; j < 2 * n_tiles; ++j) {
    const int st = j % kStages;
    const uint8_t* ks = ring + st * L::kPair;
    const uint8_t* vs = ks + kNc * kChunkBytes;
    const bool second = j >= n_tiles;
    mbar_wait(&full[st], (j / kStages) & 1);
    float s[32], dp[32];  // S = Q K^T and dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(s, desc_kmajor(qs, kk), desc_kmajor(ks, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(dp, desc_kmajor(dos, kk), desc_kmajor(vs, kk), kk > 0);
    wgmma_commit();
    if (j > n_tiles) {  // the last tile's dQ product is done: its stage goes back
      wgmma_wait<2>();
#pragma unroll
      for (int ch = 0; ch < kNc; ++ch) fence_regs(dqa[ch]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ds[kk]);
      mbar_arrive(&empty[(j - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)  // Pc = round(exp(S scale - lse)); row i / 2 % 2
      s[i] = round_bf16(fast_exp2(fmaf(s[i], c, -row_lse2[(i / 2) % 2])));
    if (!second) {
#pragma unroll
      for (int i = 0; i < 32; ++i) row_dsum[(i / 2) % 2] += dp[i] * s[i];
      mbar_arrive(&empty[st]);
      if (j == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          row_dsum[r] += __shfl_xor_sync(0xffffffffu, row_dsum[r], 1);
          row_dsum[r] += __shfl_xor_sync(0xffffffffu, row_dsum[r], 2);
          if (t == 0) dsum[head_rows + q0 + warp * 16 + g + 8 * r] = row_dsum[r];
        }
      }
      continue;
    }
    // dS = round(Pc (dP - dsum) scale), then dQ += dS K
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - row_dsum[(i / 2) % 2]) * scale;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(dp, kk, ds[kk]);
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dqa[ch], ds[kk], desc_mnmajor(ks, ch, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch) fence_regs(dqa[ch]);

  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(b) * seq * row_stride + static_cast<long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dst = dq + head_base + (q0 + warp * 16 + g + 8 * r) * row_stride + 2 * t;
#pragma unroll
    for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + ch * kChunk + 8 * n) =
            pack2_bf16(dqa[ch][4 * n + 2 * r], dqa[ch][4 * n + 2 * r + 1]);
  }
}

// 2. dK and dV of one 64-key tile; K and V resident, the query tiles (Q and
// dO, with their lse and dsum) streamed. Rows of every product are this
// block's keys: S^T = K Q^T and dP^T = V dO^T from shared memory (K-major),
// then dV += Pc^T dO and dK += dS^T Q with Pc^T and dS^T from registers and
// dO and Q MN-major.
template <int D>
__global__ void __launch_bounds__(kThreadsWg)
attention_bwd_dkdv(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int seq, int n_heads, float scale) {
  using L = BwdSmem<D, 2 * kTile * 4>;
  constexpr int kNc = L::kNc;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_kv[];
  uint8_t* ks = align_1024(smem_kv);
  uint8_t* vs = ks + kNc * kChunkBytes;
  uint8_t* ring = ks + L::kPair;
  float* stats = reinterpret_cast<float*>(ring + kStages * L::kPair);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kStages * 2 * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int n_tiles = seq / kTile;
  const long head_rows = (static_cast<long>(b) * n_heads + h) * seq;
  init_ring(kv_full, full, empty, kStages);

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      produce<D, 2 * kTile * 4>(&kmap, &vmap, &qmap, &domap, ks, ring, stats, kv_full, full,
                                empty, h * D, k0, b, n_tiles, n_tiles, lse + head_rows,
                                dsum + head_rows);
    return;
  }

  // accumulator rows are this block's 64 keys (16 per warp; g = lane / 4 owns
  // rows g and g + 8 of its warp's), columns queries
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c = scale * kLog2e;

  float dka[kNc][32], dva[kNc][32];
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[ch][i] = dva[ch][i] = 0.f;
  // Pc^T and dS^T of the last query tile, the A operands of dV and dK (pc[kk]
  // covers queries 16kk..16kk+15)
  uint32_t pc[4][4], ds[4][4];

  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint8_t* qs = ring + st * L::kPair;
    const uint8_t* dos = qs + kNc * kChunkBytes;
    const float* st_lse = stats + st * 2 * kTile;
    const float* st_dsum = st_lse + kTile;
    mbar_wait(&full[st], (j / kStages) & 1);

    float acc_s[32], acc_dp[32];  // S^T = K Q^T, dP^T = V dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(acc_s, desc_kmajor(ks, kk), desc_kmajor(qs, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(acc_dp, desc_kmajor(vs, kk), desc_kmajor(dos, kk), kk > 0);
    wgmma_commit();
    if (j > 0) {  // the last tile's dV and dK are done: its stage goes back
      wgmma_wait<2>();
#pragma unroll
      for (int ch = 0; ch < kNc; ++ch) {
        fence_regs(dva[ch]);
        fence_regs(dka[ch]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pc[kk]);
        fence_regs(ds[kk]);
      }
      mbar_arrive(&empty[(j - 1) % kStages]);
    }

    // Pc^T = round(exp(S^T scale - lse[query])); dV += Pc^T dO while dP^T finishes
    wgmma_wait<1>();
    fence_regs(acc_s);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float l0 = st_lse[8 * n + 2 * t] * kLog2e;
      const float l1 = st_lse[8 * n + 2 * t + 1] * kLog2e;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pc[n / 2][2 * (n % 2) + r] = pack2_bf16(fast_exp2(fmaf(acc_s[4 * n + 2 * r], c, -l0)),
                                                fast_exp2(fmaf(acc_s[4 * n + 2 * r + 1], c, -l1)));
    }
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dva[ch], pc[kk], desc_mnmajor(dos, ch, kk), 1);
    wgmma_commit();

    // dS^T = round(Pc^T (dP^T - dsum[query]) scale); dK += dS^T Q
    wgmma_wait<1>();
    fence_regs(acc_dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float s0 = st_dsum[8 * n + 2 * t];
      const float s1 = st_dsum[8 * n + 2 * t + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 p = unpack2_bf16(pc[n / 2][2 * (n % 2) + r]);
        ds[n / 2][2 * (n % 2) + r] = pack2_bf16(p.x * (acc_dp[4 * n + 2 * r] - s0) * scale,
                                                p.y * (acc_dp[4 * n + 2 * r + 1] - s1) * scale);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dka[ch], ds[kk], desc_mnmajor(qs, ch, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch) {
    fence_regs(dva[ch]);
    fence_regs(dka[ch]);
  }

  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(b) * seq * row_stride + static_cast<long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long off = head_base + (k0 + warp * 16 + g + 8 * r) * row_stride + 2 * t;
#pragma unroll
    for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * r;
        *reinterpret_cast<uint32_t*>(dk + off + ch * kChunk + 8 * n) =
            pack2_bf16(dka[ch][i], dka[ch][i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + ch * kChunk + 8 * n) =
            pack2_bf16(dva[ch][i], dva[ch][i + 1]);
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

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, void* dq, void* dk, void* dv, float* dsum, int batch,
                        int seq, int n_heads, float scale, cudaStream_t stream) {
  constexpr size_t kSmemDq = BwdSmem<D, 0>::kBytes;
  constexpr size_t kSmemKv = BwdSmem<D, 2 * kTile * 4>::kBytes;
  static std::atomic<uint64_t> set_dq{0}, set_kv{0};
  const auto dq_kernel = attention_bwd_dq<D>;
  const auto kv_kernel = attention_bwd_dkdv<D>;
  cudaError_t err = allow_smem(dq_kernel, kSmemDq, set_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(kv_kernel, kSmemKv, set_kv);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const void* srcs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    err = chunk_map(&maps[i], srcs[i], n_heads * D, seq, batch);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(seq / kTile, n_heads, batch);
  dq_kernel<<<grid, kThreadsWg, kSmemDq, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, dsum,
                                                   static_cast<bf16*>(dq), seq, n_heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<grid, kThreadsWg, kSmemKv, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, dsum,
                                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                   seq, n_heads, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, float* stats, int batch, int seq, int n_heads,
                        float scale, cudaStream_t stream) {
  constexpr size_t kSmemA = sizeof(float) * (4 * kTile * (D + 4) + kTile * kLdP);
  constexpr size_t kSmemB = sizeof(float) * (4 * kTile * (D + 4) + 2 * kTile * kLdP + 3 * kTile);
  static std::atomic<uint64_t> set_a{0}, set_b{0};
  const auto ka = attn_bwd_dq_f32<D>;
  const auto kb = attn_bwd_dkdv_f32<D>;
  cudaError_t err = allow_smem(ka, kSmemA, set_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(kb, kSmemB, set_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kTile, n_heads, batch);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  ka<<<grid, kThreads32, kSmemA, stream>>>(qt, kt, vt, dot, static_cast<float*>(dq), stats, seq,
                                           n_heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<grid, kThreads32, kSmemB, stream>>>(qt, kt, vt, dot, static_cast<float*>(dk),
                                           static_cast<float*>(dv), stats, seq, n_heads, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: the forward's (batch, n_heads, seq)
// fp32 row log-sum-exp, needed for bf16 and not read for fp32. scratch: fp32,
// bf16 (batch, n_heads, seq) for dsum; fp32 (batch, n_heads, seq, 3) for (m,
// l, dsum). Returns a cudaError_t (0 on success).
extern "C" int packed_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, void* dq, void* dk, void* dv, void* scratch,
                                    int batch, int seq, int n_heads, int head_dim, int dtype,
                                    float scale, void* stream) {
  if (seq <= 0 || seq % kTile != 0 || batch <= 0 || n_heads <= 0 || batch > 65535 ||
      n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const float* ls = static_cast<const float*>(lse);
  if (dtype == 0 && head_dim == 64)
    return static_cast<int>(launch_fp32<64>(q, k, v, dout, dq, dk, dv, sc, batch, seq, n_heads, scale, s));
  if (dtype == 0 && head_dim == 128)
    return static_cast<int>(launch_fp32<128>(q, k, v, dout, dq, dk, dv, sc, batch, seq, n_heads, scale, s));
  if (dtype == 1 && ls == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && head_dim == 64)
    return static_cast<int>(
        launch_bf16<64>(q, k, v, dout, ls, dq, dk, dv, sc, batch, seq, n_heads, scale, s));
  if (dtype == 1 && head_dim == 128)
    return static_cast<int>(
        launch_bf16<128>(q, k, v, dout, ls, dq, dk, dv, sc, batch, seq, n_heads, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
