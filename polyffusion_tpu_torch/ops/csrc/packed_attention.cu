// Packed whole-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels polyffusion_tpu/ops/fused_attention.py:_packed_kernel
// (kernel 1, packed_attention_fwd) and :_attn_kernel (kernel 3,
// head_major_attention_fwd), one set of bodies. For every batch item and head
// it reads q, k, v straight out of the packed (B, T, H*D) layout that the
// to_q/to_k/to_v projections produce (head h is the lane slice h*D:(h+1)*D,
// reached by stride, never transposed), computes
//   S = Q K^T * scale            (fp32)
//   P = softmax(S) per row       (fp32)
//   O = P.astype(v.dtype) V      (fp32 accumulate)
// and writes O back in the same packed layout. No (T, T) tensor ever reaches
// device memory. Kernel 3's (BH, T, D) layout is the packed one with one head.
// On request (bf16, a gradient will be taken) it also writes the row
// log-sum-exp lse = max + log(sum) of S * scale, fp32 (B, H, T), which the
// bf16 backward (packed_attention_bwd.cu) takes in place of a pass over K for
// the row max and sum. The fp32 backward recomputes them, so the fp32 forward
// writes none.
//
// What bounds it on an H100: 4*T*D operations per query row against 8*D
// bytes, so in bf16 T = 1024 (D = 64) is bound by the tensor cores'
// operations (0.139 ms at (128, 1024, 4*64)) and T = 256 by bytes (0.020 ms
// at (128, 256, 4*64)).
//
// What the design does about it (bf16): one block owns 64 queries of one
// (batch, head), computed by one consumer warpgroup, while a producer warp
// streams 64-key tiles of K and V into a ring of three shared-memory stages
// with TMA: one thread issues each (64, 64) box of a 3-D tensor map (column,
// row, batch) in the 128-byte swizzle, and the stage's mbarrier counts the
// bytes in; the consumers hand a stage back through a second mbarrier. Both
// products are wgmma m64n64k16 with A from registers: S = Q K^T with Q read
// once from its swizzled tile into registers and K from shared memory
// (K-major), then O += P V with P the S accumulators rounded to bf16 (they
// map pair by pair onto wgmma's register-A layout, as in FlashAttention-3)
// and V from shared memory read MN-major through the descriptor's transpose
// bit (V is not transposed in memory). Each step issues S of tile j and P V
// of tile j - 1 together, so the tensor cores run P V while the online
// softmax of tile j (running row max and sum in fp32, exp2 of one FMA of the
// raw score) runs on the four threads that share a row. D = 128 is two
// 64-column chunks: two boxes per tile, two accumulators of O. Tensor maps
// are cached per host thread (hopper.cuh), so a launch encodes none once a
// shape and address have been seen. Two consumer warpgroups per block (128
// queries sharing each K/V tile) and 128-key tiles were both slower at the
// UNet's shapes: fewer blocks fit an SM.
//
// fp32 (CUDA-core FMA, unchanged): the tensor cores would round to TF32, so
// each of 256 threads holds a 4 x 4 tile of S and a 4 x D/16 tile of O in
// registers and reads shared memory as float4, one load for every eight FMAs.
//
// Both round the probabilities to v's dtype before the P V product, as the TPU
// kernel does (fused_attention.py:73-75); the row sum that divides O at the end
// is the fp32 sum of the unrounded values.
//
// Kernel 3 takes any T >= 1, so the bodies have a compile-time tail switch
// (kTail): rows at or past T of the last tile read as zeros (the TMA map's
// bounds; the fp32 copies write zeros) and are never stored, and keys at or
// past T score -inf before the running maximum (a zero-filled key would score
// 0). Every key tile the loop visits holds at least one key below T, so a
// row's maximum is finite after its first tile; the exponent's offset is still
// taken as 0 while the maximum is -inf, so that no tile can give
// exp(-inf - (-inf)). Without the switch (kernel 1, and kernel 3 at
// T % 64 == 0) no tail code is compiled.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockQ = kTile;  // queries per block
constexpr int kBlockK = kTile;  // keys per streamed tile (fp32)

template <int D, int kThreads, bool kTail>
__device__ __forceinline__ void copy_rows_f32(const float* __restrict__ src, long row_stride,
                                              float* dst, int ld, int rows) {
  if constexpr (!kTail) {
    copy_tile_f32<D, kThreads>(src, row_stride, dst, ld);
  } else {
    constexpr int kChunks = kTile * D / 4;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (D / 4);
      const int d = (c % (D / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) load4(src + r * row_stride + d, v);
      store4(dst + r * ld + d, v);
    }
  }
}

// The offset of a row's exponentials: its running maximum, or 0 while that is
// -inf (only reachable with kTail, where a row may have seen no key yet).
template <bool kTail>
__device__ __forceinline__ float exp_offset(float m) {
  if constexpr (kTail) return m == -INFINITY ? 0.f : m;
  return m;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, a TMA-fed K/V ring, one producer warp

constexpr int kStages = 3;  // the P V of tile j - 1 holds its stage while tile j + 1 loads

// Shared memory of one block: its 64 queries, then the ring of K/V tiles (a K
// tile, then a V tile; each a stack of 64-column chunks of 64 rows).
template <int D>
struct FwdSmem {
  static constexpr int kNc = D / kChunk;
  static constexpr uint32_t kQ = kNc * kChunkBytes;
  static constexpr uint32_t kStage = 2 * kNc * kChunkBytes;
  static constexpr size_t kBytes = 1024 + kQ + kStages * kStage + (1 + 2 * kStages) * 8;
};

template <int D, bool kTail>
__global__ void __launch_bounds__(128 + 32)
attention_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                    float* __restrict__ lse, int seq, int n_heads, float scale) {
  using L = FwdSmem<D>;
  constexpr int kNc = L::kNc;
  extern __shared__ uint8_t smem_fwd[];
  uint8_t* qs = align_1024(smem_fwd);
  uint8_t* ring = qs + L::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_tiles = (seq + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < kNc; ++c)
        tma_load_chunk(qs + c * kChunkBytes, &qmap, q_full, h * D + c * kChunk, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&empty[st], (j / kStages - 1) & 1);
        uint8_t* ks = ring + st * L::kStage;
        mbar_expect_tx(&full[st], L::kStage);
        for (int c = 0; c < kNc; ++c) {
          tma_load_chunk(ks + c * kChunkBytes, &kmap, &full[st], h * D + c * kChunk,
                         j * kBlockK, b);
          tma_load_chunk(ks + (kNc + c) * kChunkBytes, &vmap, &full[st], h * D + c * kChunk,
                         j * kBlockK, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: 64 query rows, 16 per warp; g = lane / 4 owns rows
  // g and g + 8 of its warp's 16, with the 3 other threads of its quad. The
  // softmax of tile j runs while the tensor cores do P V of tile j - 1.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c = scale * kLog2e;  // exp(x scale) = 2^(x c)

  float o[kNc][32];
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[ch][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running maximum of the unscaled scores
  float l[2] = {0.f, 0.f};
  float s[32];        // S = Q K^T: s[4n + e] is row g + 8 (e / 2), key 8n + 2t + e % 2
  uint32_t pa[4][4];  // P of the last tile in bf16, the A operand of P V

  mbar_wait(q_full, 0);
  uint32_t qa[D / 16][4];  // Q as the A operand, from the swizzled chunks
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint8_t* base = qs + (kk / 4) * kChunkBytes + (warp * 16 + g) * 128 + 4 * t;
    const int p0 = ((2 * (kk % 4)) ^ g) * 16, p1 = ((2 * (kk % 4) + 1) ^ g) * 16;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + p0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * 128 + p0);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + p1);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * 128 + p1);
  }
  for (int j = 0; j <= n_tiles; ++j) {
    const int st = j % kStages;
    const int prev = (j + kStages - 1) % kStages;
    if (j < n_tiles) mbar_wait(&full[st], (j / kStages) & 1);
    wgmma_fence();
    if (j < n_tiles) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<0>(s, qa[kk], desc_kmajor(ring + st * L::kStage, kk), kk > 0);
      wgmma_commit();
    }
    if (j > 0) {  // O += P V of tile j - 1: V MN-major
      const uint8_t* vs = ring + prev * L::kStage + kNc * kChunkBytes;
#pragma unroll
      for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o[ch], pa[kk], desc_mnmajor(vs, ch, kk), 1);
      wgmma_commit();
    }
    if (j == n_tiles) {
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < kNc; ++ch) fence_regs(o[ch]);
      break;
    }
    if (j > 0) wgmma_wait<1>(); else wgmma_wait<0>();
    fence_regs(s);

    // online softmax of tile j; a row's scores lie with the 4 threads of a quad
    float alpha[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * r + e];
          if constexpr (kTail) {
            if (j * kBlockK + 8 * n + 2 * t + e >= seq) x = -INFINITY;
          }
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float off = exp_offset<kTail>(mx) * c;
      alpha[r] = fast_exp2(fmaf(m[r], c, -off));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * r + e];
          x = fast_exp2(fmaf(x, c, -off));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      rs[r] = sum;
      m[r] = mx;
    }

    if (j > 0) {  // P V of tile j - 1 is done: its stage goes back, O is rescaled
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < kNc; ++ch) fence_regs(o[ch]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&empty[prev]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[ch][4 * n + 2 * r] *= alpha[r];
          o[ch][4 * n + 2 * r + 1] *= alpha[r];
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, pa[kk]);
  }

  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(b) * seq * row_stride + static_cast<long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (kTail && row >= seq) continue;
    const float inv = 1.f / l[r];
    bf16* dst = out + head_base + row * row_stride + 2 * t;
#pragma unroll
    for (int ch = 0; ch < kNc; ++ch)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + ch * kChunk + n * 8) =
            pack2_bf16(o[ch][4 * n + 2 * r] * inv, o[ch][4 * n + 2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(static_cast<long>(b) * n_heads + h) * seq + row] = m[r] * scale + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA

constexpr int kThreads32 = 256;  // 16 x 16 threads
constexpr int kLdP = kBlockK + 4;

template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads32)
packed_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out,
                             int seq, int n_heads, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kOc = D / 64;  // float4 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * kLd;
  float* vs = ks + kBlockK * kLd;
  float* ps = vs + kBlockK * kLd;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(blockIdx.z) * seq * row_stride +
                         static_cast<long>(blockIdx.y) * D;
  const int q0 = blockIdx.x * kBlockQ;

  copy_rows_f32<D, kThreads32, kTail>(q + head_base + q0 * row_stride, row_stride, qs, kLd,
                                      seq - q0);

  float m[4], l[4], o[4][4 * kOc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kOc; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    copy_rows_f32<D, kThreads32, kTail>(k + head_base + k0 * row_stride, row_stride, ks, kLd,
                                        seq - k0);
    copy_rows_f32<D, kThreads32, kTail>(v + head_base + k0 * row_stride, row_stride, vs, kLd,
                                        seq - k0);
    __syncthreads();

    // S tile: rows ty*4+i, key columns tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(qs + (ty * 4 + i) * kLd + d, a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(ks + (tx + 16 * j) * kLd + d, b[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
    }

    // online softmax; the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (kTail && k0 + tx + 16 * j >= seq) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      const float e_off = exp_offset<kTail>(m_new);
      const float alpha = expf(m[i] - e_off);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - e_off);
        rs += p;
        ps[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, sh);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kOc; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V: rows ty*4+i, value columns 64*g + tx*4 + e
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(ps + (ty * 4 + i) * kLdP + j, p[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < kOc; ++g) {
          float b[4];
          load4(vs + (j + jj) * kLd + 64 * g + tx * 4, b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][4 * g + e] = fmaf(p[i][jj], b[e], o[i][4 * g + e]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (kTail && row >= seq) continue;
    const float inv = 1.f / l[i];
    float* dst = out + head_base + row * row_stride;
#pragma unroll
    for (int g = 0; g < kOc; ++g) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = o[i][4 * g + e] * inv;
      store4(dst + 64 * g + tx * 4, r);
    }
  }
}

// ---------------------------------------------------------------------------

template <int D, bool kTail>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                        int batch, int seq, int n_heads, float scale, cudaStream_t stream) {
  using L = FwdSmem<D>;
  static std::atomic<uint64_t> smem_set{0};
  const auto kernel = attention_fwd_wgmma<D, kTail>;
  cudaError_t err = allow_smem(kernel, L::kBytes, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = chunk_map(&maps[i], srcs[i], n_heads * D, seq, batch);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, n_heads, batch);
  kernel<<<grid, 128 + 32, L::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                                 static_cast<bf16*>(out), lse, seq, n_heads,
                                                 scale);
  return cudaGetLastError();
}

template <int D, bool kTail>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int batch,
                        int seq, int n_heads, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * (3 * kBlockQ * (D + 4) + kBlockQ * kLdP);
  static std::atomic<uint64_t> smem_set{0};
  const auto kernel = packed_attention_fp32_kernel<D, kTail>;
  const cudaError_t err = allow_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, n_heads, batch);
  kernel<<<grid, kThreads32, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), seq, n_heads, scale);
  return cudaGetLastError();
}

template <bool kTail>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                     int batch, int seq, int n_heads, int head_dim, int dtype, float scale,
                     cudaStream_t s) {
  if (dtype == 0 && lse != nullptr) return cudaErrorInvalidValue;  // the fp32 body writes none
  if (dtype == 0 && head_dim == 64)
    return launch_fp32<64, kTail>(q, k, v, out, batch, seq, n_heads, scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_fp32<128, kTail>(q, k, v, out, batch, seq, n_heads, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64, kTail>(q, k, v, out, lse, batch, seq, n_heads, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128, kTail>(q, k, v, out, lse, batch, seq, n_heads, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: null, or (bf16 only) (batch, n_heads,
// seq) fp32 for the row log-sum-exp. Returns a cudaError_t (0 on success).
extern "C" int packed_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int batch, int seq, int n_heads, int head_dim,
                                    int dtype, float scale, void* stream) {
  if (seq <= 0 || seq % kBlockQ != 0 || batch <= 0 || n_heads <= 0 || batch > 65535 ||
      n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<false>(q, k, v, out, static_cast<float*>(lse), batch, seq,
                                          n_heads, head_dim, dtype, scale,
                                          static_cast<cudaStream_t>(stream)));
}

// Head-major (BH, T, D) attention, any T >= 1 (kernel 3): the packed kernel with
// one head; the tail switch is on only where T is not a multiple of the tile.
extern "C" int head_major_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        int bh, int seq, int head_dim, int dtype, float scale,
                                        void* stream) {
  if (seq <= 0 || bh <= 0 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      seq % kBlockQ == 0
          ? dispatch<false>(q, k, v, out, nullptr, bh, seq, 1, head_dim, dtype, scale, s)
          : dispatch<true>(q, k, v, out, nullptr, bh, seq, 1, head_dim, dtype, scale, s);
  return static_cast<int>(err);
}
