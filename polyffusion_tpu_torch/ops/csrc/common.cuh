// Helpers shared by the port's attention kernels: tile copies into shared
// memory, the bf16 tensor-core product (mma.sync m16n8k16) and its fragment
// loads, and the once-per-device shared-memory attribute.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;  // rows of every tile the kernels copy

// Copies a (64, D) bf16 tile whose rows are row_stride elements apart into
// shared memory, rows ld elements apart, 16 bytes per thread and load.
template <int D, int kThreads>
__device__ __forceinline__ void copy_tile_bf16(const bf16* __restrict__ src, long row_stride,
                                               bf16* dst, int ld) {
  constexpr int kChunks = kTile * D / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int d = (c % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + d) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + d);
  }
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Copies a (64, D) fp32 tile whose rows are row_stride elements apart into
// shared memory, rows ld floats apart.
template <int D, int kThreads>
__device__ __forceinline__ void copy_tile_f32(const float* __restrict__ src, long row_stride,
                                              float* dst, int ld) {
  constexpr int kChunks = kTile * D / 4;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float v[4];
    load4(src + r * row_stride + d, v);
    store4(dst + r * ld + d, v);
  }
}

// Raises a kernel's dynamic shared-memory limit to smem, once per device: done
// is the set of devices (one bit each) on which this kernel has it already.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
