// GroupNorm forward, its per-channel affine and an optional SiLU, in one pass
// for Hopper (sm_90a), over NCHW or channels-last (NHWC) activations.
//
// Kernel 8. It replaces no TPU kernel: on the TPU XLA fused the statistics,
// the affine and the SiLU of polyffusion_tpu/models/unet.py:FP32GroupNorm into
// neighbouring work. The port ran them eagerly (ops/gn_bwd.py:gn_primal, then
// nn.SiLU): an fp32 copy of x, its square, two sums, some fifteen small
// launches on (B, C) tensors, x * a, + off and the SiLU, 30-34 bytes of memory
// traffic an element. This kernel reads x once and writes y once (4 bytes an
// element in bf16), with the same roundings:
//   mean = S1 * (1 / n), var = max(S2 * (1 / n) - mean * mean, 0)
//   inv = rsqrt(var + eps)                                  (fp32, per group)
//   a = inv * gamma_c, off = beta_c - mean * inv * gamma_c  (fp32, then x's dtype)
//   z = round(round(x * a) + off); y = round(z / (1 + exp(-z))) with the SiLU
// where S1, S2 are the fp32 sums of x and x^2 over the group and n its element
// count. The products and sums are the _rn intrinsics, so that no fused
// multiply-add joins two roundings the plain version keeps apart; exp is the
// accurate expf, the division IEEE (nvcc without fast math), as PyTorch's SiLU.
//
// What bounds it on an H100: bytes (some twenty operations an element).
// The design (that of kernel 6, ops/csrc/gn_bwd.cu, for one tensor):
//   - NCHW: one (item, group) is one contiguous span of cg * H * W elements;
//     NHWC: one item is one contiguous span of H * W * C elements holding every
//     group. A span is held in shared memory, split over a thread-block
//     cluster of k CTAs (k = 1, 2, 4 or 8; the wrapper's gn_fwd_plan chooses
//     k, the share and the chunk, and this file checks them); thread 0 copies
//     the CTA's share in with 1-D bulk copies (cp.async.bulk), one mbarrier a
//     chunk, so the statistics start on the first chunk while the rest arrive;
//   - the statistics: fp32 sums of x and x^2 per thread, per warp (shuffles),
//     per CTA in a fixed order; the cluster's CTAs exchange their partials
//     through distributed shared memory, each adding them in rank order, so
//     all hold the same group sums and two launches give the same bits;
//   - the apply reads the share again from shared memory and writes y with
//     16-byte stores: device-memory traffic is x once and y once.
// In NHWC a thread always sees the same V channels (its slot: the channel
// vector of 16 bytes at a position), so it keeps their a and off in registers
// and its sums belong to one group (the wrapper requires cg % V == 0).
// Every CTA ends with a cluster barrier, so that none leaves while a peer may
// still read its shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 128;  // channels per group in NCHW (the wrapper checks)
constexpr int kMaxGroups = 64;    // groups in NHWC, where a CTA sees every group
constexpr int kMaxChunks = 16;    // bulk-copy chunks per CTA (one mbarrier each)
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 220 * 1024;  // the share of x, rounded up to 128 bytes

template <typename T>
struct Vec;

// 16 bytes of T as floats, and back with the type's round-to-nearest-even
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
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) { load4(p, out); }
  __device__ __forceinline__ static void store(float* p, const float* in) { store4(p, in); }
  __device__ __forceinline__ static float round(float v) { return v; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ __forceinline__ size_t round_up_128(size_t n) { return (n + 127) / 128 * 128; }

struct FwdArgs {
  const void* x;
  const void* gamma;  // (C,), fp32 or bf16 (param_bf16), as beta
  const void* beta;
  void* y;
  int batch, channels, groups, hw;
  int share;          // elements of the span per CTA (NCHW: a multiple of 8; NHWC: of C)
  int chunk;          // elements per bulk copy (a multiple of 8)
  int param_bf16;
  float eps;
};

__device__ __forceinline__ float param(const FwdArgs& a, const void* p, int c) {
  return a.param_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c])
                      : static_cast<const float*>(p)[c];
}

// (mean, inv) of a group from its sums, with _affine32's roundings on the card
// (PyTorch divides by a host scalar as a product with its reciprocal)
__device__ __forceinline__ float2 group_stats(float s1, float s2, float n, float eps) {
  const float rn = 1.0f / n;
  const float mean = __fmul_rn(s1, rn);
  const float var = fmaxf(__fsub_rn(__fmul_rn(s2, rn), __fmul_rn(mean, mean)), 0.0f);
  return make_float2(mean, rsqrtf(__fadd_rn(var, eps)));
}

// (a, off) of channel c in x's dtype (held as floats)
template <typename T>
__device__ __forceinline__ float2 channel_affine(const FwdArgs& a, int c, float2 st) {
  const float gm = param(a, a.gamma, c);
  const float scale = __fmul_rn(st.y, gm);
  const float off = __fsub_rn(param(a, a.beta, c), __fmul_rn(__fmul_rn(st.x, st.y), gm));
  return make_float2(Vec<T>::round(scale), Vec<T>::round(off));
}

template <typename T, bool kSilu>
__device__ __forceinline__ float apply(float x, float scale, float off) {
  const float z = Vec<T>::round(__fadd_rn(Vec<T>::round(__fmul_rn(x, scale)), off));
  if (!kSilu) return z;
  return z / (1.0f + expf(-z));
}

// The cluster's shared-memory layout and copies of one CTA's share.
template <typename T>
struct Share {
  const int k, rank, start, n, nchunks;
  T* xs;
  uint64_t* bars;
  int ready = -1;

  __device__ Share(const FwdArgs& a, long base, int span, uint64_t* bars_, uint8_t* smem)
      : k(static_cast<int>(cluster_nctarank())),
        rank(static_cast<int>(cluster_ctarank())),
        start(min(rank * a.share, span)),
        n(min(start + a.share, span) - start),
        nchunks((n + a.chunk - 1) / a.chunk),
        xs(reinterpret_cast<T*>(smem)),
        bars(bars_) {
    if (threadIdx.x == 0) {
      const T* xg = static_cast<const T*>(a.x) + base + start;
      for (int j = 0; j < nchunks; ++j) mbar_init(&bars[j], 1);
      fence_mbar_init();
      for (int j = 0; j < nchunks; ++j) {
        const int e0 = j * a.chunk;
        const uint32_t bytes = static_cast<uint32_t>(min(a.chunk, n - e0)) * sizeof(T);
        mbar_expect_tx(&bars[j], bytes);
        bulk_load(xs + e0, xg + e0, bytes, &bars[j]);
      }
    }
  }

  // vector i (elements i * V ..) of the share, once its chunk is in; the
  // apply visits the vectors the statistics visited, in the same thread
  __device__ __forceinline__ void wait_for(int i, int chunk) {
    const int ch = i * Vec<T>::N / chunk;
    if (ch != ready) {
      mbar_wait(&bars[ch], 0);
      ready = ch;
    }
  }
};

// The cluster's sum of own[0 .. count) (this CTA's partials) in rank order,
// into own itself once every CTA has read it; count <= kThreads.
__device__ __forceinline__ void cluster_sum(float (*own)[kMaxGroups], float (*tot)[kMaxGroups],
                                            int count, int k) {
  if (k > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (threadIdx.x < count) {
    const int g = threadIdx.x;
    if (k > 1) {  // all k loads in flight at once, then the sums in rank order
      float p1[kMaxCluster], p2[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        p1[r] = r < k ? ld_cluster_f32(&own[0][g], r) : 0.f;
        p2[r] = r < k ? ld_cluster_f32(&own[1][g], r) : 0.f;
      }
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        s1 += p1[r];
        s2 += p2[r];
      }
      tot[0][g] = s1;
      tot[1][g] = s2;
    } else {
      tot[0][g] = own[0][g];
      tot[1][g] = own[1][g];
    }
  }
  if (k > 1) cluster_arrive();  // done reading the peers; the matching wait ends the kernel
  __syncthreads();
}

// NCHW: one cluster of k CTAs per (item, group): blockIdx.x / k = b * groups + g.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads) gn_fwd_nchw_kernel(const FwdArgs a) {
  constexpr int V = Vec<T>::N;
  __shared__ uint64_t bars[kMaxChunks];
  __shared__ float warp_part[2][kWarps];
  __shared__ float own[2][kMaxGroups];
  __shared__ float tot[2][kMaxGroups];
  __shared__ float2 aff[kMaxChannels];
  extern __shared__ __align__(128) uint8_t smem[];

  const int k = static_cast<int>(cluster_nctarank());
  const int bg = blockIdx.x / k;
  const int g = bg % a.groups;
  const int cg = a.channels / a.groups;
  const int span = cg * a.hw;
  const long base = static_cast<long>(bg) * span;
  Share<T> sh(a, base, span, bars, smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the barriers are initialised before anyone waits on them

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < sh.n / V; i += kThreads) {
    sh.wait_for(i, a.chunk);
    float xv[V];
    Vec<T>::load(sh.xs + i * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s1 += xv[e];
      s2 += xv[e] * xv[e];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    warp_part[0][warp] = s1;
    warp_part[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t1 += warp_part[0][w];
      t2 += warp_part[1][w];
    }
    own[0][0] = t1;
    own[1][0] = t2;
  }
  cluster_sum(own, tot, 1, sh.k);
  if (threadIdx.x < cg) {
    const float2 st = group_stats(tot[0][0], tot[1][0], static_cast<float>(span), a.eps);
    aff[threadIdx.x] = channel_affine<T>(a, g * cg + threadIdx.x, st);
  }
  __syncthreads();

  T* yg = static_cast<T*>(a.y) + base + sh.start;
  for (int i = threadIdx.x; i < sh.n / V; i += kThreads) {
    const float2 af = aff[(sh.start + i * V) / a.hw];
    float xv[V];
    Vec<T>::load(sh.xs + i * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) xv[e] = apply<T, kSilu>(xv[e], af.x, af.y);
    Vec<T>::store(yg + i * V, xv);
  }
  if (sh.k > 1) cluster_wait();
}

// NHWC: one cluster of k CTAs per item: blockIdx.x / k = b. Thread t holds the
// channel vector slot = t % P (P = C / V) at positions t / P, + Q, ... (Q =
// kThreads / P; threads from Q * P on idle); a share is whole positions.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads) gn_fwd_nhwc_kernel(const FwdArgs a) {
  constexpr int V = Vec<T>::N;
  __shared__ uint64_t bars[kMaxChunks];
  __shared__ float part[2][kThreads];
  __shared__ float own[2][kMaxGroups];
  __shared__ float tot[2][kMaxGroups];
  extern __shared__ __align__(128) uint8_t smem[];

  const int k = static_cast<int>(cluster_nctarank());
  const int b = blockIdx.x / k;
  const int span = a.channels * a.hw;
  const long base = static_cast<long>(b) * span;
  Share<T> sh(a, base, span, bars, smem);
  const int P = a.channels / V;
  const int Q = kThreads / P;
  const int slot = threadIdx.x % P;
  const int q0 = threadIdx.x / P;
  const int cg = a.channels / a.groups;
  const int g = slot * V / cg;  // every channel of the slot lies in group g
  const int npos = sh.n / a.channels;
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  if (q0 < Q) {
    for (int p = q0; p < npos; p += Q) {
      const int i = p * P + slot;
      sh.wait_for(i, a.chunk);
      float xv[V];
      Vec<T>::load(sh.xs + i * V, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1 += xv[e];
        s2 += xv[e] * xv[e];
      }
    }
  }
  part[0][threadIdx.x] = s1;
  part[1][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < a.groups) {  // group t: its slots, position rows in order
    const int spg = cg / V;
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < Q; ++q)
      for (int j = threadIdx.x * spg; j < (threadIdx.x + 1) * spg; ++j) {
        t1 += part[0][q * P + j];
        t2 += part[1][q * P + j];
      }
    own[0][threadIdx.x] = t1;
    own[1][threadIdx.x] = t2;
  }
  cluster_sum(own, tot, a.groups, sh.k);

  if (q0 < Q) {
    const float2 st =
        group_stats(tot[0][g], tot[1][g], static_cast<float>(cg) * a.hw, a.eps);
    float sc[V], of[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float2 af = channel_affine<T>(a, slot * V + e, st);
      sc[e] = af.x;
      of[e] = af.y;
    }
    T* yg = static_cast<T*>(a.y) + base + sh.start;
    for (int p = q0; p < npos; p += Q) {
      const int i = p * P + slot;
      float xv[V];
      Vec<T>::load(sh.xs + i * V, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) xv[e] = apply<T, kSilu>(xv[e], sc[e], of[e]);
      Vec<T>::store(yg + i * V, xv);
    }
  }
  if (sh.k > 1) cluster_wait();
}

template <typename T, bool kNhwc, bool kSilu>
auto kernel_of() {
  if constexpr (kNhwc) {
    return gn_fwd_nhwc_kernel<T, kSilu>;
  } else {
    return gn_fwd_nchw_kernel<T, kSilu>;
  }
}

// Raises the kernel's shared-memory limit once per device.
template <typename T, bool kNhwc, bool kSilu>
cudaError_t prepare() {
  static std::atomic<uint64_t> smem_set{0};
  return allow_smem(kernel_of<T, kNhwc, kSilu>(), kMaxSmem, smem_set);
}

template <typename T, bool kNhwc, bool kSilu>
cudaError_t launch(const FwdArgs& a, int cluster, cudaStream_t stream) {
  cudaError_t err = prepare<T, kNhwc, kSilu>();
  if (err != cudaSuccess) return err;
  const unsigned units = static_cast<unsigned>(a.batch) * (kNhwc ? 1 : a.groups);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = round_up_128(static_cast<size_t>(a.share) * sizeof(T));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a span in one CTA: a plain launch
  err = cudaLaunchKernelEx(&cfg, kernel_of<T, kNhwc, kSilu>(), a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const FwdArgs& a, int cluster, int nhwc, int silu, cudaStream_t s) {
  if (nhwc) return silu ? launch<T, true, true>(a, cluster, s) : launch<T, true, false>(a, cluster, s);
  return silu ? launch<T, false, true>(a, cluster, s) : launch<T, false, false>(a, cluster, s);
}

}  // namespace

// dtype, param_dtype: 0 = float32, 1 = bfloat16. x, y: (batch, channels, hw)
// contiguous (nhwc = 0) or (batch, hw, channels) contiguous (nhwc = 1); gamma,
// beta: (channels,) in param_dtype. The plan (cluster, share, chunk) comes
// from ops/gn_fwd.py:gn_fwd_plan. Returns a cudaError_t (0 on success).
extern "C" int gn_fwd(const void* x, const void* gamma, const void* beta, void* y, int batch,
                      int channels, int groups, int hw, int cluster, int share, int chunk,
                      int dtype, int param_dtype, int nhwc, int silu, float eps, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (batch <= 0 || groups <= 0 || channels % groups != 0 || hw <= 0 || hw % 8 != 0 ||
      static_cast<long>(channels) * hw > 0x7fffffffL ||
      static_cast<long>(batch) * groups * cluster > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cg = channels / groups;
  if (nhwc ? (groups > kMaxGroups || cg % vec != 0 || channels / vec > kThreads ||
              share % channels != 0)
           : cg > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  const long span = nhwc ? static_cast<long>(channels) * hw : static_cast<long>(cg) * hw;
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(bf16);
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) || share <= 0 ||
      share % 8 != 0 || chunk <= 0 || chunk % 8 != 0 ||
      static_cast<long>(share) * cluster < span || (share + chunk - 1) / chunk > kMaxChunks ||
      round_up_128(static_cast<size_t>(share) * item) > static_cast<size_t>(kMaxSmem) ||
      (dtype != 0 && dtype != 1) || (param_dtype != 0 && param_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x, gamma, beta, y, batch, channels, groups, hw, share, chunk, param_dtype, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_t<float>(a, cluster, nhwc, silu, s)
                                     : launch_t<bf16>(a, cluster, nhwc, silu, s));
}
