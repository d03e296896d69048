// GroupNorm + per-channel affine backward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel polyffusion_tpu/ops/gn_bwd.py:_gn_bwd_kernel and the
// sum over the batch that _gna_bwd takes after it. Per batch item b and group
// g, with x_hat = (x - mean_g) * inv_g and N = cg * H * W:
//   db_bc = sum_hw dy,  dg_bc = sum_hw dy * x_hat        (per item and channel)
//   S1 = sum_c gamma_c db_bc,  S2 = sum_c gamma_c dg_bc   (over the group)
//   dx = inv_g * (dy * gamma_c - (S1 / N + x_hat * S2 / N))
//   dbeta_c = sum_b db_bc,  dgamma_c = sum_b dg_bc        (in the weight's dtype)
// One launch computes all three.
//
// What bounds it on an H100: bytes. It reads x and dy and writes dx, some
// twenty operations per element; at the UNet's shapes that is 3 B C H W
// elements against 3.35 TB/s. The first design (one 256-thread block per
// (item, group), both passes reading device memory) read x and dy twice: at
// (16, 64, 128, 128) bf16 its 512 blocks hold 64 MB in flight, more than the
// 50 MB L2, so the second pass went back to HBM. Its wrapper added two sums
// over B and the dtype casts as launches of their own.
//
// What the design does about it: in NCHW one (b, g) is one contiguous span of
// cg * H * W elements of x and the same of dy. It is held in shared memory,
// split over a thread-block cluster of k CTAs (k = 1, 2, 4 or 8, the smallest
// whose share fits 64 KB, so that three CTAs share an SM and one's copies
// overlap another's stores; where none does, 8 CTAs of up to 200 KB; the
// wrapper's gn_bwd_plan chooses k, the share and the chunk, and this file
// checks them):
//   - thread 0 copies the CTA's share of x and dy in with 1-D bulk copies
//     (cp.async.bulk), one mbarrier per chunk, each used once (parity 0), so
//     pass 1 starts on the first chunk while the rest arrive;
//   - pass 1 forms per-channel fp32 sums of dy and dy * x_hat over the share
//     from shared memory (a share may start or end inside a channel: the
//     channel of an element is its index / (H W)); the CTAs of the cluster
//     exchange their per-channel partials through distributed shared memory
//     (mapa + ld.shared::cluster between two cluster barriers), each summing
//     them in rank order, so all hold the same S1 and S2;
//   - pass 2 reads x and dy again from shared memory and writes dx in x's
//     dtype with 16-byte stores. Device-memory traffic is x and dy once and dx
//     once: exactly the bound's count;
//   - the sum over B: the last warp of each cluster's rank 0 writes its
//     item's per-channel partials to an fp32 (2, B, C) scratch, fences, and
//     takes a ticket from a per-group counter while the other warps run pass
//     2; the CTA that draws ticket B - 1 sums the partials over b in a fixed
//     order (strided slices of b, then the slices in turn: no float atomics,
//     so two launches give the same bits), writes dgamma and dbeta in the
//     weight's dtype and resets the counter to 0. The counters live in one zeroed int32 array per device that the
//     wrapper keeps: the port runs every backward on one stream, and two
//     backwards in flight at once on two streams would need two arrays.
// Every CTA ends with a cluster barrier, so that none leaves while a peer may
// still read its shared memory. On the TPU the group sums were a matmul
// against a group-membership matrix; here a CTA sees exactly one group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 64;   // channels per group (the wrapper checks)
constexpr int kMaxChunks = 16;     // bulk-copy chunks per CTA (one mbarrier each)
constexpr int kMaxCluster = 8;
// dynamic shared memory a CTA may take: x's and dy's shares, each rounded up
// to 128 bytes (the wrapper's budget is at most this)
constexpr int kMaxSmem = 220 * 1024;

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
  __device__ __forceinline__ static void load(const float* p, float* out) { load4(p, out); }
  __device__ __forceinline__ static void store(float* p, const float* in) { store4(p, in); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ __forceinline__ size_t round_up_128(size_t n) { return (n + 127) / 128 * 128; }

struct Args {
  const void* x;
  const void* dy;
  const float* mean_c;  // (B, C) fp32, the group's statistics repeated per channel
  const float* inv_c;
  const void* gamma;    // (C,), fp32 or bf16 (gamma_bf16)
  void* dx;
  float* partials;      // (2, B, C) fp32 scratch: dgamma's, then dbeta's per item
  void* dgamma;         // (C,), fp32 or bf16 (param_bf16)
  void* dbeta;
  int* tickets;         // (groups,) int32, 0 between launches
  int batch, channels, groups, hw;
  int share;            // elements of the span per CTA of the cluster (a multiple of 8)
  int chunk;            // elements per bulk copy (a multiple of 8)
  int gamma_bf16, param_bf16;
};

// One cluster of k CTAs per (batch item, group): blockIdx.x / k = b * groups + g.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_bwd_cluster_kernel(const Args a) {
  constexpr int V = Vec<T>::N;
  __shared__ uint64_t bars[kMaxChunks];
  __shared__ float part_db[kMaxChannels];   // (channel, slice) partials: cg * slices <= 64
  __shared__ float part_dg[kMaxChannels];
  __shared__ float own[2][kMaxChannels];    // this CTA's per-channel sums (read by the cluster)
  __shared__ float gam[kMaxChannels];
  __shared__ float tot[2][kMaxChannels];    // the item's per-channel dgamma, dbeta sums
  __shared__ float fin[2][kThreads];        // the sum over B: (item slice, channel) partials
  __shared__ float s12[2];
  __shared__ int last;
  extern __shared__ __align__(128) uint8_t smem[];

  const int k = static_cast<int>(cluster_nctarank());
  const int rank = static_cast<int>(cluster_ctarank());
  const int bg = blockIdx.x / k;
  const int b = bg / a.groups;
  const int g = bg % a.groups;
  const int cg = a.channels / a.groups;
  const int c0 = g * cg;
  const int span = cg * a.hw;
  const long base = (static_cast<long>(b) * a.channels + c0) * a.hw;
  const int start = min(rank * a.share, span);  // this CTA's elements [start, end) of the span
  const int end = min(start + a.share, span);
  const int n = end - start;
  const int nchunks = (n + a.chunk - 1) / a.chunk;
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = reinterpret_cast<T*>(smem + round_up_128(static_cast<size_t>(a.share) * sizeof(T)));
  const T* xg = static_cast<const T*>(a.x) + base + start;
  const T* dg_in = static_cast<const T*>(a.dy) + base + start;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int j = 0; j < nchunks; ++j) mbar_init(&bars[j], 1);
    fence_mbar_init();
    for (int j = 0; j < nchunks; ++j) {
      const int e0 = j * a.chunk;
      const uint32_t bytes = static_cast<uint32_t>(min(a.chunk, n - e0)) * sizeof(T);
      mbar_expect_tx(&bars[j], 2 * bytes);
      bulk_load(xs + e0, xg + e0, bytes, &bars[j]);
      bulk_load(ds + e0, dg_in + e0, bytes, &bars[j]);
    }
  }
  if (threadIdx.x < kMaxChannels) own[0][threadIdx.x] = own[1][threadIdx.x] = 0.f;
  const float mean = a.mean_c[b * a.channels + c0];
  const float inv = a.inv_c[b * a.channels + c0];
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // a thread reads vector i (elements i * V ..) of the share once its chunk is in
  int ready = -1;
  auto wait_for = [&](int i) {
    const int ch = i * V / a.chunk;
    if (ch != ready) {
      mbar_wait(&bars[ch], 0);
      ready = ch;
    }
  };

  // pass 1: per-channel sums of dy and dy * x_hat over the channels this share
  // touches (c_lo .. c_hi of the group), `slices` warps a channel
  const int c_lo = n > 0 ? start / a.hw : 0;
  const int nch = n > 0 ? (end - 1) / a.hw - c_lo + 1 : 0;
  const int slices = nch >= kWarps ? 1 : kWarps / max(nch, 1);
  for (int p = warp; p < nch * slices; p += kWarps) {
    const int c = c_lo + p / slices;
    const int v0 = (max(start, c * a.hw) - start) / V;
    const int v1 = (min(end, (c + 1) * a.hw) - start) / V;
    float db = 0.f, dgv = 0.f;
    for (int i = v0 + (p % slices) * 32 + lane; i < v1; i += slices * 32) {
      wait_for(i);
      float xv[V], dv[V];
      Vec<T>::load(xs + i * V, xv);
      Vec<T>::load(ds + i * V, dv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        db += dv[e];
        dgv += dv[e] * ((xv[e] - mean) * inv);
      }
    }
    db = warp_sum(db);
    dgv = warp_sum(dgv);
    if (lane == 0) {
      part_db[p] = db;
      part_dg[p] = dgv;
    }
  }
  __syncthreads();
  if (threadIdx.x < nch) {
    const int c = threadIdx.x;
    float db = 0.f, dgv = 0.f;
    for (int s = 0; s < slices; ++s) {
      db += part_db[c * slices + s];
      dgv += part_dg[c * slices + s];
    }
    own[0][c_lo + c] = db;
    own[1][c_lo + c] = dgv;
  }

  // the group's per-channel sums: every CTA adds the cluster's partials in
  // rank order, so all hold the same values
  if (k > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  float* part = a.partials;
  if (threadIdx.x < cg) {
    const int c = threadIdx.x;
    float db = 0.f, dgv = 0.f;
    if (k > 1) {  // all k loads in flight at once, then the sums in rank order
      float pb[kMaxCluster], pg[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        pb[r] = r < k ? ld_cluster_f32(&own[0][c], r) : 0.f;
        pg[r] = r < k ? ld_cluster_f32(&own[1][c], r) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        db += pb[r];
        dgv += pg[r];
      }
    } else {
      db = own[0][c];
      dgv = own[1][c];
    }
    const float gm = a.gamma_bf16 ? __bfloat162float(static_cast<const bf16*>(a.gamma)[c0 + c])
                                  : static_cast<const float*>(a.gamma)[c0 + c];
    gam[c] = gm;
    tot[0][c] = dgv;
    tot[1][c] = db;
    part_db[c] = gm * db;
    part_dg[c] = gm * dgv;
  }
  if (k > 1) cluster_arrive();  // done reading the peers; the matching wait is the last line
  __syncthreads();
  if (warp == 0) {  // S1, S2: a fixed shuffle tree over the group's channels
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < cg; c += 32) {
      s1 += part_db[c];
      s2 += part_dg[c];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float nn = static_cast<float>(cg) * static_cast<float>(a.hw);
      s12[0] = s1 / nn;
      s12[1] = s2 / nn;
    }
  }
  __syncthreads();

  // rank 0's last warp hands the item's per-channel sums to the sum over B
  // (the fence and the ticket cost it a round trip to L2; the other warps go
  // on with pass 2 meanwhile)
  if (rank == 0 && warp == kWarps - 1) {
    for (int c = lane; c < cg; c += 32) {
      part[b * a.channels + c0 + c] = tot[0][c];
      part[(a.batch + b) * a.channels + c0 + c] = tot[1][c];
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) last = atomicAdd(&a.tickets[g], 1) == a.batch - 1;
  }

  // pass 2: dx over the share, from shared memory
  const float s1 = s12[0], s2 = s12[1];
  T* dxg = static_cast<T*>(a.dx) + base + start;
  for (int i = threadIdx.x; i < n / V; i += kThreads) {
    wait_for(i);
    const float gm = gam[(start + i * V) / a.hw];
    float xv[V], dv[V], out[V];
    Vec<T>::load(xs + i * V, xv);
    Vec<T>::load(ds + i * V, dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = (xv[e] - mean) * inv;
      out[e] = inv * (dv[e] * gm - (s1 + xh * s2));
    }
    Vec<T>::store(dxg + i * V, out);
  }

  // the sum over B, by the CTA that drew the last ticket of group g: thread
  // (j, c) adds items j, j + J, ... of channel c, then thread c adds the J
  // sums, each in that order
  if (rank == 0) {
    __syncthreads();
    if (last) {
      const int J = kThreads / cg;
      const int c = threadIdx.x % cg, j = threadIdx.x / cg;
      float sg = 0.f, sb = 0.f;
      if (j < J) {
#pragma unroll 4
        for (int bb = j; bb < a.batch; bb += J) {
          sg += __ldcg(part + bb * a.channels + c0 + c);
          sb += __ldcg(part + (a.batch + bb) * a.channels + c0 + c);
        }
      }
      fin[0][threadIdx.x] = sg;
      fin[1][threadIdx.x] = sb;
      __syncthreads();
      if (threadIdx.x < cg) {
        sg = sb = 0.f;
        for (int jj = 0; jj < J; ++jj) {
          sg += fin[0][jj * cg + threadIdx.x];
          sb += fin[1][jj * cg + threadIdx.x];
        }
        if (a.param_bf16) {
          static_cast<bf16*>(a.dgamma)[c0 + threadIdx.x] = __float2bfloat16_rn(sg);
          static_cast<bf16*>(a.dbeta)[c0 + threadIdx.x] = __float2bfloat16_rn(sb);
        } else {
          static_cast<float*>(a.dgamma)[c0 + threadIdx.x] = sg;
          static_cast<float*>(a.dbeta)[c0 + threadIdx.x] = sb;
        }
      }
      if (threadIdx.x == 0) atomicExch(&a.tickets[g], 0);
    }
  }
  if (k > 1) cluster_wait();
}

// Raises the kernel's shared-memory limit once per device.
template <typename T>
cudaError_t prepare() {
  static std::atomic<uint64_t> smem_set{0};
  return allow_smem(gn_bwd_cluster_kernel<T>, kMaxSmem, smem_set);
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int cluster, unsigned blocks,
                                  size_t smem_bytes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a span in one CTA: a plain launch
  return cfg;
}

template <typename T>
cudaError_t launch(const Args& a, int cluster, cudaStream_t stream) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, cluster, static_cast<unsigned>(a.batch) * a.groups * cluster,
      2 * round_up_128(static_cast<size_t>(a.share) * sizeof(T)), stream);
  err = cudaLaunchKernelEx(&cfg, gn_bwd_cluster_kernel<T>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t max_active_clusters(int cluster, int* out) {
  const cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, cluster, 132u * cluster, kMaxSmem, nullptr);
  return cudaOccupancyMaxActiveClusters(out, gn_bwd_cluster_kernel<T>, &cfg);
}

}  // namespace

// dtype, gamma_dtype, param_dtype: 0 = float32, 1 = bfloat16. x, dy, dx:
// (batch, channels, hw) contiguous; mean_c, inv_c: (batch, channels) fp32;
// gamma: (channels,); dgamma, dbeta: (channels,) in param_dtype; partials:
// 2 * batch * channels fp32 of scratch; tickets: groups int32, zero. The plan
// (cluster, share, chunk) comes from ops/gn_bwd.py:gn_bwd_plan. Returns a
// cudaError_t (0 on success).
extern "C" int gn_bwd(const void* x, const void* dy, const void* mean_c, const void* inv_c,
                      const void* gamma, void* dx, void* dgamma, void* dbeta, void* partials,
                      void* tickets, int batch, int channels, int groups, int hw, int cluster,
                      int share, int chunk, int dtype, int gamma_dtype, int param_dtype,
                      void* stream) {
  if (batch <= 0 || groups <= 0 || channels % groups != 0 || channels / groups > kMaxChannels ||
      hw <= 0 || hw % 8 != 0 || static_cast<long>(batch) * groups * cluster > 0x7fffffffL ||
      static_cast<long>(channels / groups) * hw > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long span = static_cast<long>(channels / groups) * hw;
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(bf16);
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) || share <= 0 ||
      share % 8 != 0 || chunk <= 0 || chunk % 8 != 0 ||
      static_cast<long>(share) * cluster < span || (share + chunk - 1) / chunk > kMaxChunks ||
      2 * round_up_128(static_cast<size_t>(share) * item) > static_cast<size_t>(kMaxSmem) ||
      (dtype != 0 && dtype != 1) || (gamma_dtype != 0 && gamma_dtype != 1) ||
      (param_dtype != 0 && param_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, dy, static_cast<const float*>(mean_c), static_cast<const float*>(inv_c), gamma,
               dx, static_cast<float*>(partials), dgamma, dbeta, static_cast<int*>(tickets),
               batch, channels, groups, hw, share, chunk, gamma_dtype, param_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch<float>(a, cluster, s) : launch<bf16>(a, cluster, s));
}

// Clusters of `cluster` (2, 4 or 8) CTAs, each with the most shared memory
// the kernel takes, that the card can hold at once (0: such a launch would
// fail), into *out. Returns a cudaError_t.
extern "C" int gn_bwd_max_active_clusters(int cluster, int dtype, int* out) {
  if (cluster != 2 && cluster != 4 && cluster != kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 0 ? max_active_clusters<float>(cluster, out)
                                     : max_active_clusters<bf16>(cluster, out));
}
