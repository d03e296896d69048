// Hopper (sm_90a) building blocks shared by the bf16 attention kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// m64n64k16 bf16 products, and the host-side tensor maps.
//
// Every bf16 tile in shared memory is a stack of "chunks" of 64 rows x 64
// columns (128 bytes a row), 1024-byte aligned, in the 128-byte swizzle that
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte piece p of row r
// lies at r * 128 + ((p ^ (r % 8)) * 16). A tile of D = 128 columns is two such
// chunks, 8 KB apart. wgmma reads them through descriptors:
//   K-major (the product's depth runs along a row): 8-row groups 1024 bytes
//     apart (SBO); the 16-column step kk of a chunk starts kk * 32 bytes in.
//   MN-major (the depth runs down the rows, transpose bit set): rows of depth
//     128 bytes apart, 8-row groups 1024 bytes apart (SBO), 64-wide column
//     chunks LBO apart; the 16-row step kk starts kk * 2048 bytes in.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChunk = 64;              // rows and columns of one swizzled chunk
constexpr uint32_t kChunkBytes = 8192;  // 64 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to the 1024-byte alignment of the swizzle.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and adds ``bytes`` to the transfers the current phase awaits.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity ``parity`` has completed. A wait of more
// than some 10 s (a copy or an arrival that never comes) traps, so that a
// fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

// -- asynchronous copies ---------------------------------------------------------

// One (64, 64) box of a 3-D map (column, row, batch) into a swizzled chunk.
__device__ __forceinline__ void tma_load_chunk(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int col, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// ``bytes`` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- wgmma -----------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at ``p`` (see the head note).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | uint64_t{1} << 62;
}

// K-major chunked tile: the 16-column step kk of a tile of D = 64 * chunks columns.
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return gmma_desc(tile + (kk / 4) * kChunkBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major chunked tile: rows 16kk..16kk+15 of the 64-column chunk c.
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int c, int kk) {
  return gmma_desc(tile + c * kChunkBytes + kk * 2048, kChunkBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed product groups are
// pending (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (relative error below 2^-22).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Keeps the compiler from moving reads or reuse of registers that an
// asynchronous product reads or writes across the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both from shared memory.
// The accumulator layout (warp w, g = lane / 4, t = lane % 4): d[4n + e] is
// row 16w + g + 8 (e / 2), column 8n + 2t + e % 2.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, "
      "%35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64) (+)= A (64 x 16, bf16 in registers) B (16 x 64, shared memory).
// A's layout is the accumulator's for 16 columns, packed in pairs: a[0] = row
// g, columns 2t, 2t+1; a[1] = row g + 8; a[2], a[3] = the same at column 2t + 8.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTransB));
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The accumulator's 16 columns 16kk..16kk+15, rounded to bf16, as the A
// operand of a register product.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack2_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// -- host: tensor maps -----------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library is not
// linked against libcuda); null where it is missing.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 (batch, rows, cols) tensor, row-major, as a 3-D map read in (64, 64)
// boxes with the 128-byte swizzle; rows past ``rows`` read as zeros.
inline cudaError_t make_chunk_map(CUtensorMap* map, const void* base, int cols, int rows,
                                  int batch) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {kChunk, kChunk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// chunk_map's cache hits and misses over every host thread of the process
// (tensor_map_cache_counts).
inline std::atomic<long long> map_cache_hits{0}, map_cache_misses{0};

// make_chunk_map through a small cache: encoding costs microseconds of host
// time, and a host-bound caller launches the same shapes at the same
// addresses again and again. One per host thread, 16 sets of 4 maps, keyed by
// everything the map encodes, so a hit is always the map a fresh encode would
// give. Large allocations are aligned to 2 MB, so the set comes from a
// multiplicative hash of every bit of the key, not from low address bits.
inline cudaError_t chunk_map(CUtensorMap* map, const void* base, int cols, int rows,
                             int batch) {
  struct Entry {
    const void* base;
    int cols, rows, batch;
    CUtensorMap map;
  };
  constexpr size_t kWays = 4;
  thread_local Entry cache[16 * kWays] = {};
  thread_local size_t next = 0;
  const uint64_t key = (static_cast<uint64_t>(reinterpret_cast<uintptr_t>(base)) ^
                        static_cast<uint64_t>(rows) << 40 ^ static_cast<uint64_t>(cols) << 20 ^
                        static_cast<uint64_t>(batch) << 52) *
                       0x9E3779B97F4A7C15ull;
  Entry* set = cache + (key >> 60) * kWays;
  for (size_t w = 0; w < kWays; ++w) {
    const Entry& e = set[w];
    if (e.base == base && e.cols == cols && e.rows == rows && e.batch == batch) {
      *map = e.map;
      map_cache_hits.fetch_add(1, std::memory_order_relaxed);
      return cudaSuccess;
    }
  }
  map_cache_misses.fetch_add(1, std::memory_order_relaxed);
  const cudaError_t err = make_chunk_map(map, base, cols, rows, batch);
  if (err == cudaSuccess) set[next++ % kWays] = Entry{base, cols, rows, batch, *map};
  return err;
}

}  // namespace

// The tensor-map cache's hits and misses so far, into counts[0] and counts[1].
extern "C" void tensor_map_cache_counts(long long* counts) {
  counts[0] = map_cache_hits.load(std::memory_order_relaxed);
  counts[1] = map_cache_misses.load(std::memory_order_relaxed);
}
