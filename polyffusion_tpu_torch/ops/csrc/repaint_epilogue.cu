// The RePaint step epilogue for Hopper (sm_90a), fp32, elementwise.
//
// Replaces the TPU kernel polyffusion_tpu/ops/pallas_sampler.py:_epilogue_kernel.
// After the UNet's eps, one inpainting step of the DDPM sampler is, with seven
// per-step scalars a..g from the host's schedule tables:
//   x0    = a * x - b * eps
//   x_unk = c * x0 + d * x + e * p_noise
//   x_kn  = f * orig + g * q_noise
//   out   = x_kn * m + x_unk * (1 - m)
//
// What bounds it on an H100: bytes. Six fp32 inputs are read once and one
// output written once, 28 bytes per element against about a dozen operations.
// At the sampler's (B, 2, 128, 128) that is 28 * 32768 B bytes: 0.55 us at
// request A's batch 2, where the launch and one DRAM round trip (some 4 us in
// all) set the time, and the sampler is host-bound besides.
//
// What the design does about it: one pass, no intermediate in device memory
// (in eager PyTorch the same chain is some nine launches), 16-byte loads and
// stores. For its launch-bound caller:
//   - programmatic dependent launch (cudaLaunchAttributeProgrammaticStream-
//     Serialization): the kernel may start while the kernel before it on the
//     stream (the CFG combine that writes eps) finishes, so that its launch
//     overlaps that kernel's tail; griddepcontrol.wait, before any load, holds
//     it until that kernel's writes are complete, so it takes its inputs from
//     any kernel. (An L2 prefetch of x, p_noise, orig, q_noise and mask before
//     the wait gained nothing measurable, scripts/gn_bwd_epilogue_designs.py.)
//   - a grid of 128-thread blocks of one float4 a thread, so that request A's
//     16 384 float4s spread over 128 blocks (the first design ran them as 64
//     blocks of 256 threads) and every load of a thread is in flight at once;
//   - the scalars come by value as kernel arguments: they are host table
//     entries, so no device scalar and no sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr long long kThreads = 128;

struct Scalars {
  float a, b, c, d, e, f, g;
};

__device__ __forceinline__ float step(const Scalars& s, float x, float eps, float pn, float orig,
                                      float qn, float m) {
  const float x0 = s.a * x - s.b * eps;
  const float x_unk = s.c * x0 + s.d * x + s.e * pn;
  const float x_kn = s.f * orig + s.g * qn;
  return x_kn * m + x_unk * (1.0f - m);
}

// Block i owns float4s [i * kThreads, (i + 1) * kThreads): one a thread. The
// inputs are not __restrict__: through a const __restrict__ pointer a load
// compiles to ld.global.nc, which the compiler moves across griddepcontrol.wait
// (it did, in chip_smoke.py's planted copy); plain loads stay on their side.
__global__ void __launch_bounds__(kThreads)
    repaint_epilogue_kernel(const float4* x, const float4* eps, const float4* p_noise,
                            const float4* orig, const float4* q_noise, const float4* mask,
                            float4* __restrict__ out, long long n4, Scalars s) {
  grid_dependency_wait();  // the previous kernel's output (eps) is complete from here on
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 vx = x[i], ve = eps[i], vp = p_noise[i], vo = orig[i], vq = q_noise[i],
               vm = mask[i];
  float4 r;
  r.x = step(s, vx.x, ve.x, vp.x, vo.x, vq.x, vm.x);
  r.y = step(s, vx.y, ve.y, vp.y, vo.y, vq.y, vm.y);
  r.z = step(s, vx.z, ve.z, vp.z, vo.z, vq.z, vm.z);
  r.w = step(s, vx.w, ve.w, vp.w, vo.w, vq.w, vm.w);
  out[i] = r;
}

__global__ void empty_kernel() {}

// A predecessor that lets its dependents start early, as a check needs one:
// each CTA triggers them as it starts, waits delay_ns, then copies its part
// of src to dst. A kernel launched after it with programmatic dependent
// launch that reads dst before griddepcontrol.wait reads it stale.
__global__ void early_trigger_copy_kernel(const float4* __restrict__ src,
                                          float4* __restrict__ dst, long long n4,
                                          unsigned long long delay_ns) {
  grid_launch_dependents();
  const uint64_t t0 = global_timer_ns();
  while (global_timer_ns() - t0 < delay_ns) {
  }
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[i] = src[i];
}

}  // namespace

// n: the number of elements, a multiple of 4; all seven pointers 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int repaint_epilogue(const void* x, const void* eps, const void* p_noise,
                                const void* orig, const void* q_noise, const void* mask, void* out,
                                long long n, float a, float b, float c, float d, float e, float f,
                                float g, void* stream) {
  const long long n4 = n / 4;
  if (n4 <= 0) return static_cast<int>(cudaSuccess);
  if ((n4 + kThreads - 1) / kThreads > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n4 + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, repaint_epilogue_kernel, static_cast<const float4*>(x),
      static_cast<const float4*>(eps), static_cast<const float4*>(p_noise),
      static_cast<const float4*>(orig), static_cast<const float4*>(q_noise),
      static_cast<const float4*>(mask), static_cast<float4*>(out), n4,
      Scalars{a, b, c, d, e, f, g});
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// One launch of an empty kernel (one block of 32 threads): the floor below
// which no kernel of the port can go, timed beside kernels 6 and 7. Returns the
// launch's cudaError_t.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Copies n floats (a multiple of 4, both pointers 16-byte aligned) from src
// to dst delay_ns after it starts, having let the next kernel on the stream
// start (early_trigger_copy_kernel): 132 CTAs, so that all run at once and
// trigger together. Returns the launch's cudaError_t.
extern "C" int early_trigger_copy(const void* src, void* dst, long long n,
                                  unsigned long long delay_ns, void* stream) {
  early_trigger_copy_kernel<<<132, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<float4*>(dst), n / 4, delay_ns);
  return static_cast<int>(cudaGetLastError());
}
