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
// At the sampler's (B, 2, 128, 128) that is 28 * 32768 B bytes; at small
// batch the launch itself (a few microseconds) is larger than that.
//
// What the design does about it: one pass, no intermediate in device memory
// (in eager PyTorch the same chain is some nine launches, each reading and
// writing whole tensors). A grid-stride loop over float4s, so every load and
// store is 16 bytes and neighbouring threads touch neighbouring addresses; the
// wrapper checks that all seven tensors are contiguous, 16-byte aligned and of
// one shape whose size is a multiple of 4. The scalars come by value as kernel
// arguments: they are host table entries, so no device scalar and no sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of the H100

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

__global__ void __launch_bounds__(kThreads)
    repaint_epilogue_kernel(const float4* __restrict__ x, const float4* __restrict__ eps,
                            const float4* __restrict__ p_noise, const float4* __restrict__ orig,
                            const float4* __restrict__ q_noise, const float4* __restrict__ mask,
                            float4* __restrict__ out, long long n4, Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 vx = x[i], ve = eps[i], vp = p_noise[i], vo = orig[i], vq = q_noise[i],
                 vm = mask[i];
    float4 r;
    r.x = step(s, vx.x, ve.x, vp.x, vo.x, vq.x, vm.x);
    r.y = step(s, vx.y, ve.y, vp.y, vo.y, vq.y, vm.y);
    r.z = step(s, vx.z, ve.z, vp.z, vo.z, vq.z, vm.z);
    r.w = step(s, vx.w, ve.w, vp.w, vo.w, vq.w, vm.w);
    out[i] = r;
  }
}

}  // namespace

// n: the number of elements, a multiple of 4. Returns the launch's cudaError_t.
extern "C" int repaint_epilogue(const void* x, const void* eps, const void* p_noise,
                                const void* orig, const void* q_noise, const void* mask, void* out,
                                long long n, float a, float b, float c, float d, float e, float f,
                                float g, void* stream) {
  const long long n4 = n / 4;
  if (n4 <= 0) return static_cast<int>(cudaSuccess);
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  repaint_epilogue_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(eps),
      static_cast<const float4*>(p_noise), static_cast<const float4*>(orig),
      static_cast<const float4*>(q_noise), static_cast<const float4*>(mask),
      static_cast<float4*>(out), n4, Scalars{a, b, c, d, e, f, g});
  return static_cast<int>(cudaGetLastError());
}
