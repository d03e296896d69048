// Packed whole-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel polyffusion_tpu/ops/fused_attention.py:_packed_kernel.
// For every batch item and head it reads q, k, v straight out of the packed
// (B, T, H*D) layout that the to_q/to_k/to_v projections produce (head h is the
// lane slice h*D:(h+1)*D, reached by stride, never transposed), computes
//   S = Q K^T * scale            (fp32)
//   P = softmax(S) per row       (fp32)
//   O = P.astype(v.dtype) V      (fp32 accumulate)
// and writes O back in the same packed layout. No (T, T) tensor ever reaches
// device memory.
//
// What bounds it on an H100: at the UNet's shapes (T = 1024 or 256, D = 64) the
// work is 4*T*D operations per query row against 8*D bytes, so in bf16 T = 1024
// is bound by the tensor cores' operations and T = 256 by bytes.
//
// What the design does about it: the TPU kernel keeps a whole sequence in VMEM,
// but K and V of one head at T = 1024 (256 KiB in bf16) exceed the 227 KB of
// shared memory a block can use. So one block owns 64 queries of one (batch,
// head) and streams 64-key tiles of K and V through shared memory with an
// online softmax (running row max and row sum in fp32, fp32 accumulators).
//   - bf16: four warps of 16 query rows each run both products on the tensor
//     cores (mma.sync m16n8k16, bf16 in, fp32 accumulate). S stays in the
//     registers it is accumulated in, and the same registers, rounded to bf16,
//     are the A operand of P V, as in FlashAttention-2. Shared-memory rows are
//     padded by 16 bytes so that the fragment loads hit 32 distinct banks.
//     wgmma and TMA (the route to the full tensor-core rate) are later work.
//   - fp32: the tensor cores would round to TF32, so the fp32 kernel does its
//     arithmetic as fp32 FMA on the CUDA cores (67 TFLOP/s peak): each of 256
//     threads holds a 4 x 4 tile of S and a 4 x D/16 tile of O in registers and
//     reads shared memory as float4, one load for every eight FMAs.
// Both round the probabilities to v's dtype before the P V product, as the TPU
// kernel does (fused_attention.py:73-75); the row sum that divides O at the end
// is the fp32 sum of the unrounded values.
//
// The same bodies are the head-major attention forward (head_major_attention_fwd
// below), which replaces the TPU kernel fused_attention.py:_attn_kernel: its
// (BH, T, D) layout is the packed one with one head (row stride D, BH in place
// of B). That kernel takes any T >= 1, so the bodies have a compile-time tail
// switch (kTail): the last query and key tiles may be ragged, rows at or past T
// are copied as zeros and never stored, and keys at or past T score -inf before
// the running maximum. Every key tile the loop visits holds at least one key
// below T, so a row's maximum is finite after its first tile; the exponent's
// offset is still taken as 0 while the maximum is -inf, so that no tile can
// give exp(-inf - (-inf)). Without the switch (kernel 1, and the head-major
// kernel at T % 64 == 0) the code is the packed kernel's as it was. At the
// (512, 1024 / 256, 64) bf16 shapes of a batch-128 self-attention in
// head-major form, the bound is that of the packed kernel at the same work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = kTile;  // queries per block
constexpr int kBlockK = kTile;  // keys per streamed tile

// copy_tile_bf16 / copy_tile_f32 of rows [0, rows) of a 64-row tile; with
// kTail the rows at or past ``rows`` are written as zeros and never read.
template <int D, int kThreads, bool kTail>
__device__ __forceinline__ void copy_rows_bf16(const bf16* __restrict__ src, long row_stride,
                                               bf16* dst, int ld, int rows) {
  if constexpr (!kTail) {
    copy_tile_bf16<D, kThreads>(src, row_stride, dst, ld);
  } else {
    constexpr int kChunks = kTile * D / 8;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (D / 8);
      const int d = (c % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * row_stride + d);
      *reinterpret_cast<uint4*>(dst + r * ld + d) = val;
    }
  }
}

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
// bf16: tensor cores (mma.sync)

constexpr int kWarpsTc = kBlockQ / 16;
constexpr int kThreadsTc = 32 * kWarpsTc;

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16x8):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
template <int D, bool kTail>
__global__ void __launch_bounds__(kThreadsTc)
packed_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out,
                             int seq, int n_heads, float scale) {
  constexpr int kLd = D + 8;    // padded row: consecutive rows start 4 banks apart
  constexpr int kKs = D / 16;   // k-steps of S = Q K^T
  constexpr int kNd = D / 8;    // n-tiles of O
  constexpr int kNk = kBlockK / 8;  // n-tiles of S
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + kBlockQ * kLd;
  bf16* vs = ks + kBlockK * kLd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long row_stride = static_cast<long>(n_heads) * D;
  const long head_base = static_cast<long>(blockIdx.z) * seq * row_stride +
                         static_cast<long>(blockIdx.y) * D;
  const int q0 = blockIdx.x * kBlockQ;

  copy_rows_bf16<D, kThreadsTc, kTail>(q + head_base + q0 * row_stride, row_stride, qs, kLd,
                                       seq - q0);
  __syncthreads();
  uint32_t qa[kKs][4];  // this warp's 16 query rows as A fragments, kept for the whole loop
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) {
    const bf16* r0 = qs + (warp * 16 + g) * kLd + kk * 16 + 2 * t;
    qa[kk][0] = ld_b32(r0);
    qa[kk][1] = ld_b32(r0 + 8 * kLd);
    qa[kk][2] = ld_b32(r0 + 8);
    qa[kk][3] = ld_b32(r0 + 8 * kLd + 8);
  }

  float o[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    copy_rows_bf16<D, kThreadsTc, kTail>(k + head_base + k0 * row_stride, row_stride, ks, kLd,
                                         seq - k0);
    copy_rows_bf16<D, kThreadsTc, kTail>(v + head_base + k0 * row_stride, row_stride, vs, kLd,
                                         seq - k0);
    __syncthreads();

    // S = Q K^T: B[d][key] = K[key][d], so b0/b1 are adjacent pairs of a K row
    float s[kNk][4];
#pragma unroll
    for (int n = 0; n < kNk; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        const bf16* kr = ks + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], ld_b32(kr), ld_b32(kr + 8));
      }
    }

    // online softmax; a row's 64 scores lie with the 4 threads of one quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNk; ++n) {
        s[n][2 * r] *= scale;
        s[n][2 * r + 1] *= scale;
        if constexpr (kTail) {  // keys n*8 + 2t and n*8 + 2t + 1 of this tile
          const int key = k0 + n * 8 + 2 * t;
          if (key >= seq) s[n][2 * r] = -INFINITY;
          if (key + 1 >= seq) s[n][2 * r + 1] = -INFINITY;
        }
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float off = exp_offset<kTail>(m_new);
      const float alpha = expf(m[r] - off);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kNk; ++n) {
        s[n][2 * r] = expf(s[n][2 * r] - off);
        s[n][2 * r + 1] = expf(s[n][2 * r + 1] - off);
        rs += s[n][2 * r] + s[n][2 * r + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the S accumulators of key tiles 2kk and 2kk+1, rounded to bf16,
    // are the A fragment of keys 16kk..16kk+15; V comes in by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kNd; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + n * 8);
        mma_bf16(o[n], pa, b[0], b[1]);
        mma_bf16(o[n + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (kTail && row >= seq) continue;
    const float inv = 1.f / l[r];
    bf16* dst = out + head_base + row * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
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

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, std::atomic<uint64_t>& smem_set,
                   const void* q, const void* k, const void* v, void* out, int batch, int seq,
                   int n_heads, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, n_heads, batch);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), seq, n_heads, scale);
  return cudaGetLastError();
}

template <int D, bool kTail>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int batch,
                        int seq, int n_heads, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(bf16) * 3 * kBlockQ * (D + 8);
  static std::atomic<uint64_t> smem_set{0};
  return launch<bf16>(packed_attention_bf16_kernel<D, kTail>, kThreadsTc, kSmem, smem_set, q, k,
                      v, out, batch, seq, n_heads, scale, stream);
}

template <int D, bool kTail>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int batch,
                        int seq, int n_heads, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * (3 * kBlockQ * (D + 4) + kBlockQ * kLdP);
  static std::atomic<uint64_t> smem_set{0};
  return launch<float>(packed_attention_fp32_kernel<D, kTail>, kThreads32, kSmem, smem_set, q, k,
                       v, out, batch, seq, n_heads, scale, stream);
}

template <bool kTail>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int batch, int seq,
                     int n_heads, int head_dim, int dtype, float scale, cudaStream_t s) {
  if (dtype == 0 && head_dim == 64)
    return launch_fp32<64, kTail>(q, k, v, out, batch, seq, n_heads, scale, s);
  if (dtype == 0 && head_dim == 128)
    return launch_fp32<128, kTail>(q, k, v, out, batch, seq, n_heads, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64, kTail>(q, k, v, out, batch, seq, n_heads, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128, kTail>(q, k, v, out, batch, seq, n_heads, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int packed_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                    int batch, int seq, int n_heads, int head_dim,
                                    int dtype, float scale, void* stream) {
  if (seq <= 0 || seq % kBlockQ != 0 || batch <= 0 || n_heads <= 0 || batch > 65535 ||
      n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<false>(q, k, v, out, batch, seq, n_heads, head_dim, dtype,
                                          scale, static_cast<cudaStream_t>(stream)));
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
          ? dispatch<false>(q, k, v, out, bh, seq, 1, head_dim, dtype, scale, s)
          : dispatch<true>(q, k, v, out, bh, seq, 1, head_dim, dtype, scale, s);
  return static_cast<int>(err);
}
