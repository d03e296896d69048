// GroupNorm + per-channel affine backward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel polyffusion_tpu/ops/gn_bwd.py:_gn_bwd_kernel. Per
// batch item b and group g, with x_hat = (x - mean_g) * inv_g:
//   dbeta_c  = sum_hw dy                 (per item: a (B, C) fp32 partial)
//   dgamma_c = sum_hw dy * x_hat         (per item: a (B, C) fp32 partial)
//   S1 = sum_c gamma_c dbeta_c,  S2 = sum_c gamma_c dgamma_c   (over the group)
//   dx = inv_g * (dy * gamma_c - (S1 / N + x_hat * S2 / N)),  N = cg * H * W
// The caller sums the partials over B.
//
// What bounds it on an H100: bytes. It reads x and dy and writes dx, some
// twenty operations per element; at the UNet's shapes that is 3 B C H W
// elements against 3.35 TB/s.
//
// What the design does about it: in NCHW one (b, g) is one contiguous span of
// cg * H * W elements (192 KB at most in bf16 at the UNet's shapes), so one
// block owns it and both passes over it stay inside the block: pass 1 reads x
// and dy once with 16-byte vector loads and forms the per-channel sums in fp32
// (warp shuffles, then shared memory), pass 2 reads them again, mostly from the
// 50 MB L2, and writes dx in x's dtype. A block has 8 warps; when a group has
// fewer than 8 channels, several warps share a channel in pass 1. On the TPU the
// sums were a matmul against a group-membership matrix; here they are plain
// shuffles, since a block sees exactly one group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 64;  // channels per group (the wrapper checks)

// 16 bytes of T as floats
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float* in) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per (batch item, group): blockIdx.x = b * groups + g.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean_c,
              const float* __restrict__ inv_c, const float* __restrict__ gamma,
              T* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
              int channels, int groups, int hw) {
  constexpr int V = Vec<T>::N;
  // (channel, slice) partial sums: cg * slices <= max(cg, kWarps) <= kMaxChannels
  __shared__ float part_db[kMaxChannels];
  __shared__ float part_dg[kMaxChannels];
  __shared__ float gam[kMaxChannels];
  __shared__ float wdb[kMaxChannels];  // gamma_c * dbeta_c
  __shared__ float wdg[kMaxChannels];  // gamma_c * dgamma_c
  __shared__ float s12[2];

  const int b = blockIdx.x / groups;
  const int cg = channels / groups;
  const int c0 = (blockIdx.x % groups) * cg;
  const long base = (static_cast<long>(b) * channels + c0) * hw;
  const float mean = mean_c[b * channels + c0];  // the group's, repeated per channel
  const float inv = inv_c[b * channels + c0];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = hw / V;  // vectors per channel

  // pass 1: per-channel sums of dy and dy * x_hat; `slices` warps per channel
  const int slices = cg >= kWarps ? 1 : kWarps / cg;
  for (int p = warp; p < cg * slices; p += kWarps) {
    const int c = p / slices;
    const T* xc = x + base + static_cast<long>(c) * hw;
    const T* dyc = dy + base + static_cast<long>(c) * hw;
    float db = 0.f, dg = 0.f;
    for (int i = (p % slices) * 32 + lane; i < nvec; i += slices * 32) {
      float xv[V], dv[V];
      Vec<T>::load(xc + i * V, xv);
      Vec<T>::load(dyc + i * V, dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        db += dv[e];
        dg += dv[e] * ((xv[e] - mean) * inv);
      }
    }
    db = warp_sum(db);
    dg = warp_sum(dg);
    if (lane == 0) {
      part_db[p] = db;
      part_dg[p] = dg;
    }
  }
  __syncthreads();
  if (threadIdx.x < cg) {
    const int c = threadIdx.x;
    float db = 0.f, dg = 0.f;
    for (int s = 0; s < slices; ++s) {
      db += part_db[c * slices + s];
      dg += part_dg[c * slices + s];
    }
    dbeta[b * channels + c0 + c] = db;
    dgamma[b * channels + c0 + c] = dg;
    gam[c] = gamma[c0 + c];
    wdb[c] = gam[c] * db;
    wdg[c] = gam[c] * dg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < cg; ++c) {
      s1 += wdb[c];
      s2 += wdg[c];
    }
    const float n = static_cast<float>(cg) * static_cast<float>(hw);
    s12[0] = s1 / n;
    s12[1] = s2 / n;
  }
  __syncthreads();

  // pass 2: dx over the group's contiguous span
  const float s1 = s12[0], s2 = s12[1];
  for (int i = threadIdx.x; i < cg * nvec; i += kThreads) {
    const float gm = gam[i / nvec];
    float xv[V], dv[V], out[V];
    Vec<T>::load(x + base + static_cast<long>(i) * V, xv);
    Vec<T>::load(dy + base + static_cast<long>(i) * V, dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = (xv[e] - mean) * inv;
      out[e] = inv * (dv[e] * gm - (s1 + xh * s2));
    }
    Vec<T>::store(dx + base + static_cast<long>(i) * V, out);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, dy, dx: (batch, channels, hw)
// contiguous; mean_c, inv_c, dgamma, dbeta: (batch, channels) fp32; gamma:
// (channels,) fp32. Returns a cudaError_t (0 on success).
extern "C" int gn_bwd(const void* x, const void* dy, const void* mean_c, const void* inv_c,
                      const void* gamma, void* dx, void* dgamma, void* dbeta, int batch,
                      int channels, int groups, int hw, int dtype, void* stream) {
  if (batch <= 0 || groups <= 0 || channels % groups != 0 || channels / groups > kMaxChannels ||
      hw <= 0 || hw % 8 != 0 || static_cast<long>(batch) * groups > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean_c);
  const float* iv = static_cast<const float*>(inv_c);
  const float* gm = static_cast<const float*>(gamma);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  const unsigned blocks = static_cast<unsigned>(batch) * groups;
  if (dtype == 0) {
    gn_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), m, iv, gm,
        static_cast<float*>(dx), dg, db, channels, groups, hw);
  } else if (dtype == 1) {
    gn_bwd_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), m, iv, gm,
        static_cast<bf16*>(dx), dg, db, channels, groups, hw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
