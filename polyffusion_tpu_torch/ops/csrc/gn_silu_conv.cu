// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (sm_90a), NCHW,
// stride 1, padding 1, in three forms:
//   fp32 and bf16   out = conv3x3(SiLU(x * a + off), w) + b (+ residual)
//   int8            the same contraction on int8 operands, rescaled in fp32
// each with one input or two (the virtual channel concat [x1, x2]).
//
// Replaces the TPU kernel polyffusion_tpu/ops/fused_gn_conv.py:_kernel (:36),
// with quantized=False (kernel 4: gn_silu_conv3x3, gn_silu_conv3x3_concat) and
// quantized=True (kernel 5: gn_silu_conv3x3_q, gn_silu_conv3x3_concat_q).
// a and off are the fp32 per-(batch, channel) GroupNorm affine; the
// normalised, activated tensor never reaches device memory, and with two
// inputs neither does the concat. The weights come packed tap-major,
// (9, O, w_ld): the first input's channels from 0, the second's from C1
// rounded up to 16 (so that a TMA box of either starts 16-byte aligned), w_ld
// a multiple of 16, zeros elsewhere (the wrapper packs them once per weight
// version, ops/fused_gn_conv.py:packed_weight).
//
// What bounds it on an H100: at the UNet's shapes (C, O = 64-512, H = W =
// 16-128, batch 128) a site does 2 * 9 * C * O operations per output pixel
// against (C + O) * 2 bytes read and written, so in bf16 the tensor cores'
// operations bound the sites with C + O >= 256 and the bytes those at 64 -> 64
// (the int8 form halves the operations' bound: 1,979 TOP/s). Beside both, the
// prologue: x * a + off, an IEEE expf and reciprocal and the rounding for
// every input element of the tile and its halo, some 30 instructions on the
// CUDA cores, and the input's reads, whose 10-pixel row segments use a third
// of each 32-byte sector they touch. At 64 -> 64 that prologue takes three
// times as long as the products. The first design (8 x 16 pixels x 64
// channels a block, mma.sync) ran its patch build, products and epilogue one
// after the other, each some 0.4-0.5 ms at (128, 64 -> 64, 128^2) + residual
// (scripts/gn_conv_split.py; PERF.md §6).
//
// What the design does about it (bf16 and int8): an implicit GEMM whose block
// owns one batch item, 16 x 8 output pixels and N output channels, N = 64 (O
// <= 64), 128 (O <= 128) or 256, so the prologue runs once per 64-256 output
// channels (once per input element and its halo share, 1.41 x, where O <=
// 256). 256 threads, two warpgroups of one m64 tile (8 pixel rows) each; two
// blocks an SM up to N = 128 (128 registers a thread), one at 256.
//   - The input channels go in chunks of 128 bytes a pixel (64 bf16 or 128
//     int8 channels). The SiLU'd, rounded (int8: quantized) chunk is a patch in
//     shared memory in wgmma's core-matrix layout without swizzle: plane p
//     holds 16 bytes of channels of every patch pixel, pixel after pixel. The A
//     operand of tap (dy, dx) for 8 output rows is then the patch at pixel
//     (row + dy) * 10 + dx: a shift is a 16-byte offset of the descriptor's
//     start, 8-row groups are one patch row (160 bytes) apart and the depth's
//     core matrices one plane apart. No im2col is built.
//   - The weights of one (chunk, tap), N rows x 128 bytes, come by TMA (a 3-D
//     map (w_ld, O, 9), 128-byte swizzle, rows past O zero-filled) into a ring
//     of four stages; thread 0 issues each copy once every thread has handed
//     the stage back through an mbarrier, two taps behind (no producer warp: a
//     ninth warp would cost a whole warpgroup's registers).
//   - Per tap the warpgroups issue their products (wgmma m64nNk16 bf16 ->
//     fp32, or m64nNk32 s8 -> s32; both operands K-major; k-steps past the
//     chunk's channels skipped) and, while the tensor cores run them, build a
//     slice of the next chunk's patch into the second patch buffer: x read
//     straight from global memory, each slice's loads issued a tap before its
//     build. The patch is 0 outside the image and past the channels: SiLU(off)
//     is not 0.
//   - The epilogue stages the accumulators (fp32; int8 rescaled by the
//     activation's and the channel's scale) in shared memory, channel-major,
//     then each thread writes whole 8-pixel NCHW row segments: the bias and
//     the residual (read 16 bytes at a time, four segments' loads in flight
//     before the first store) added in fp32, one rounding, one 16-byte store
//     (fp32 outputs: two).
// The patch build still takes most of the time at 64 -> 64 (PERF.md §6): a
// chunk's build is longer than its products there, so the tensor cores wait.
// int8: one activation scale per batch item, amax / 127, where amax = max
// |SiLU| in fp32 over both inputs is found first by a separate pass
// (gn_silu_amax_kernel): the whole item's maximum must be known before the
// first value is quantized. Values are rounded half to even (__float2int_rn,
// as jnp.round) from the value rounded to the activation's storage type, as
// the TPU kernel quantizes its bf16 buffer.
//
// fp32 takes FMA on the CUDA cores instead (the tensor cores would round to
// TF32), each of 256 threads 8 pixels x 4 channels, loading synchronously: it
// serves the checks against the CPU, not the main path.
//
// The arithmetic of x * a + off and SiLU is written as the plain PyTorch
// version computes it on the card (a product and a sum each rounded, then
// y * (1 / (1 + exp(-y)))), so that both round the same values the same way.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // fp32 body and amax pass
constexpr int kAmaxParts = 64;  // amax pass: blocks per batch item

// One input of the (virtual) channel concat.
struct Part {
  const void* x;      // (B, C, H, W), the activation's dtype
  const float* a;     // (B, ld) fp32, channel c at a[b * ld + c]
  const float* off;
  int channels;
  int ld;
};

struct Args {
  Part p[2];               // p[1].channels == 0 for one input
  const void* w;           // (9, O, w_ld): the activation's dtype, or int8
  int w_ld;
  int w_split;             // the second input's first channel in w: C1 rounded up to 16
  const float* w_scale;    // (O,) int8 only
  const void* bias;        // (O,) fp32 or bf16
  int bias_bf16;
  const void* residual;    // (B, O, H, W) or null
  void* out;               // (B, O, H, W)
  const float* amax_part;  // int8 only: (B, kAmaxParts) partial maxima
  int height, width, out_ch;
  int tw_shift;            // fp32 body: its tile is 128 pixels, 1 << tw_shift wide
  int tiles_w;             // fp32 body: tiles across the width
  int async_rows;          // input rows are 16-byte aligned (the amax pass's vector loads)
  int vec_out;             // output and residual rows may go 16 bytes at a time
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float silu_affine(float x, float a, float off) {
  const float y = __fadd_rn(__fmul_rn(x, a), off);
  return __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
}

__device__ __forceinline__ float bias_at(const Args& g, int o) {
  return g.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(g.bias)[o])
                     : static_cast<const float*>(g.bias)[o];
}

// Chunk i of the (virtual) input channels, chunks of cc channels: part pi,
// channels [cb, cb + kc) of it, at channel cw of the packed weights.
struct Chunk {
  int pi, cb, kc, cw;
};

__device__ __forceinline__ int n_chunks(const Args& g, int cc) {
  return (g.p[0].channels + cc - 1) / cc + (g.p[1].channels + cc - 1) / cc;
}

__device__ __forceinline__ Chunk chunk_at(const Args& g, int i, int cc) {
  const int n0 = (g.p[0].channels + cc - 1) / cc;
  Chunk c;
  c.pi = i >= n0;
  c.cb = (c.pi ? i - n0 : i) * cc;
  c.kc = min(cc, g.p[c.pi].channels - c.cb);
  c.cw = c.cb + (c.pi ? g.w_split : 0);
  return c;
}

// ---------------------------------------------------------------------------
// bf16 and int8: wgmma, a TMA-fed weight ring

constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTW = 8;           // tile width in pixels
constexpr int kPW = kTW + 2;     // patch width
constexpr int kPlanes = 8;       // 16-byte planes of a chunk: 128 bytes of channels a pixel
constexpr int kKSteps = 4;       // 32-byte k-steps of a chunk

template <typename S> struct OpTraits;
template <> struct OpTraits<bf16> { static constexpr int kPerPlane = 8; };
template <> struct OpTraits<int8_t> { static constexpr int kPerPlane = 16; };

// Sizes and shared-memory offsets of one block: N output channels of 128
// pixels, 16 rows x 8 (one m64 tile, 8 rows, per warpgroup).
template <typename S, int kN>
struct Conv {
  // weight ring: one (chunk, tap) a stage; blocks an SM (shared memory allows
  // 2 up to N = 128, registers allow 128 a thread then)
  static constexpr int kWStages = 4;
  static constexpr int kMinBlocks = kN <= 128 ? 2 : 1;
  static constexpr int kCC = kPlanes * OpTraits<S>::kPerPlane;  // channels a chunk
  static constexpr int kStep = kCC / kKSteps;                   // channels a k-step
  static constexpr int kTH = 16;                                // tile rows
  static constexpr int kM = kTH * kTW;                          // tile pixels
  static constexpr int kNP = (kTH + 2) * kPW;                   // patch pixels
  static constexpr uint32_t kPlane = kNP * 16;
  static constexpr uint32_t kPatch = kPlanes * kPlane;
  static constexpr uint32_t kStage = kN * 128;
  static constexpr uint32_t kRing = kWStages * kStage;
  static constexpr int kLdSt = kM + 4;  // epilogue staging row in floats: lanes hit distinct banks
  static constexpr uint32_t kStaging = kN * kLdSt * 4;
  static constexpr uint32_t kMain =
      kRing + 2 * kPatch > kStaging ? kRing + 2 * kPatch : kStaging;
  static constexpr uint32_t kAff = kMain;  // 2 buffers of (a, off), kCC floats each
  static constexpr uint32_t kBars = kAff + 2 * 2 * kCC * 4;
  static constexpr size_t kBytes = 1024 + kBars + 2 * kWStages * 8;
};

struct WTile {  // a block's batch item, first output row, column and channel
  int b, h0, w0, o0;
};

template <int kTH>
__device__ __forceinline__ WTile wtile(const Args& g, int kn) {
  const int tiles_w = (g.width + kTW - 1) / kTW;
  WTile t;
  t.b = blockIdx.z;
  t.h0 = (blockIdx.y / tiles_w) * kTH;
  t.w0 = (blockIdx.y % tiles_w) * kTW;
  t.o0 = blockIdx.x * kn;
  return t;
}

// Orders this thread's generic-proxy writes to shared memory before the
// tensor cores' (async-proxy) reads that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or reuse of the accumulators across
// the wait that completes the products writing them.
template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&r)[N]) {
  fence_regs(r);
}

__device__ __forceinline__ uint16_t bits(bf16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint8_t bits(int8_t v) { return static_cast<uint8_t>(v); }

// aff[k] = a, aff[kCC + k] = off of chunk c's channel k (0 past kc).
template <int kCC>
__device__ __forceinline__ void load_aff(const Args& g, int b, const Chunk& c, float* aff) {
  const Part& p = g.p[c.pi];
  for (int k = threadIdx.x; k < kCC; k += kTcThreads) {
    const bool ok = k < c.kc;
    aff[k] = ok ? p.a[b * p.ld + c.cb + k] : 0.f;
    aff[kCC + k] = ok ? p.off[b * p.ld + c.cb + k] : 0.f;
  }
}

// The planes the products of chunk c read (two a k-step), over every patch pixel.
template <typename S>
__device__ __forceinline__ int patch_items(const Chunk& c) {
  using L = Conv<S, 64>;
  return 2 * ((c.kc + L::kStep - 1) / L::kStep) * L::kNP;
}

// The patch is built in slices of kSliceItems items, two a thread;
// item i is plane i / kNP of patch pixel i % kNP: 16 bytes of channels.
constexpr int kSliceItems = 2 * kTcThreads;

// Where item i lies: its plane, its patch pixel and whether that pixel is in
// the image.
struct Item {
  int pl, pp, ih, iw;
  bool inside;
};

template <int kNP>
__device__ __forceinline__ Item item_at(const Args& g, const WTile& t, int i) {
  Item it;
  it.pl = i / kNP;
  it.pp = i - it.pl * kNP;
  const int r = it.pp / kPW;
  it.ih = t.h0 - 1 + r;
  it.iw = t.w0 - 1 + (it.pp - r * kPW);
  it.inside = it.ih >= 0 && it.ih < g.height && it.iw >= 0 && it.iw < g.width;
  return it;
}

// The raw input of one slice held in registers between its loads and its
// build, so that a thread's loads are all in flight together (and, inside the
// tap loop, in flight while a tap's products run).
template <typename T, typename S>
struct Staged {
  T v[2][OpTraits<S>::kPerPlane];
};

// Issues the loads of slice s of chunk c's patch (items past total: none):
// the channels of each item's pixel straight from x, 0 outside the image and
// past kc.
template <typename T, typename S>
__device__ __forceinline__ void load_slice(const Args& g, const WTile& t, const Chunk& c, int s,
                                           int total, Staged<T, S>& st) {
  using L = Conv<S, 64>;
  constexpr int kPer = OpTraits<S>::kPerPlane;
  const Part& p = g.p[c.pi];
  const long plane = static_cast<long>(g.height) * g.width;
  const T* __restrict__ x =
      static_cast<const T*>(p.x) + (static_cast<long>(t.b) * p.channels + c.cb) * plane;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = s * kSliceItems + r * kTcThreads + static_cast<int>(threadIdx.x);
    const Item it = item_at<L::kNP>(g, t, i);
    const T* src = x + static_cast<long>(it.pl * kPer) * plane +
                   static_cast<long>(it.ih) * g.width + it.iw;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      st.v[r][e] = i < total && it.inside && it.pl * kPer + e < c.kc ? src[e * plane]
                                                                     : from_f<T>(0.f);
  }
}

// Builds slice s from its loaded raw input: x * a + off, SiLU, rounded to S
// (quantized by quant for int8), 0 outside the image and past kc, one
// 16-byte store an item.
template <typename T, typename S, typename Quant>
__device__ __forceinline__ void finish_slice(const Args& g, const WTile& t, const Chunk& c, int s,
                                             int total, const Staged<T, S>& st, const float* aff,
                                             uint8_t* patch, Quant quant) {
  using L = Conv<S, 64>;
  constexpr int kPer = OpTraits<S>::kPerPlane;
  constexpr int kPerWord = 4 / sizeof(S);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = s * kSliceItems + r * kTcThreads + static_cast<int>(threadIdx.x);
    if (i >= total) continue;
    const Item it = item_at<L::kNP>(g, t, i);
    uint32_t words[4];
    float a[4], off[4];  // the affine of 4 channels, loaded 16 bytes at a time
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < kPerWord; ++e) {
        const int j = wi * kPerWord + e;
        const int k = it.pl * kPer + j;
        if (j % 4 == 0) {
          load4(aff + k, a);
          load4(aff + L::kCC + k, off);
        }
        S v{};
        if (it.inside && k < c.kc) v = quant(silu_affine(to_f(st.v[r][j]), a[j % 4], off[j % 4]));
        word |= static_cast<uint32_t>(bits(v)) << (8 * sizeof(S) * e);
      }
      words[wi] = word;
    }
    *reinterpret_cast<uint4*>(patch + it.pl * L::kPlane + it.pp * 16) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// The products of one tap for this warpgroup's m64 tile (its 8 pixel rows):
// k-steps past the chunk's channels (nk of them hold some) are skipped.
template <typename S, int kN, typename Acc>
__device__ __forceinline__ void issue_tap(Acc (&acc)[kN / 2], const uint8_t* patch,
                                          const uint8_t* ws, int tap, int nk) {
  using L = Conv<S, kN>;
  const int wg = threadIdx.x >> 7;
  const int shift = (tap / 3) * kPW + tap % 3;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    if (kk < nk) {
      const uint64_t db = desc_kmajor(ws, kk);
      const uint8_t* a = patch + 2 * kk * L::kPlane + (wg * 8 * kPW + shift) * 16;
      wgmma_k(acc, gmma_desc_plain(a, L::kPlane, kPW * 16), db, 1);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2_bf16(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2_bf16(v[0], v[1]), pack2_bf16(v[2], v[3]),
                                              pack2_bf16(v[4], v[5]), pack2_bf16(v[6], v[7]));
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ long out_index(const Args& g, const WTile& t, int o, int oh) {
  return ((static_cast<long>(t.b) * g.out_ch + o) * g.height + oh) * g.width + t.w0;
}

// One 8-pixel row segment of output channel o at image row oh: the staged
// accumulators plus the bias, plus the residual (rv where vec, else read here
// element by element), rounded once.
template <typename T>
__device__ __forceinline__ void store_segment(const Args& g, const WTile& t, int o, int oh,
                                              const float* src, float bias_v, bool vec,
                                              const float (&rv)[8]) {
  float v[8];
  load4(src, v);
  load4(src + 4, v + 4);
  const long idx = out_index(g, t, o, oh);
  T* __restrict__ out = static_cast<T*>(g.out);
  if (vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] += bias_v;
      if (g.residual != nullptr) v[e] += rv[e];
    }
    store8<T>(out + idx, v);
  } else {
    const T* __restrict__ res = static_cast<const T*>(g.residual);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (t.w0 + e >= g.width) break;
      float u = v[e] + bias_v;
      if (res != nullptr) u += to_f(res[idx + e]);
      out[idx + e] = from_f<T>(u);
    }
  }
}

// T: the activation's dtype; S: the operands' storage (bf16, or int8 for the
// quantized form).
template <typename T, typename S, int kN>
__device__ __forceinline__ void conv_wgmma(const CUtensorMap* wmap, const Args& g) {
  using L = Conv<S, kN>;
  constexpr bool kQuant = sizeof(S) == 1;
  using Acc = typename std::conditional<kQuant, int, float>::type;
  extern __shared__ uint8_t smem_conv[];
  uint8_t* base = align_1024(smem_conv);
  uint8_t* ring = base;
  uint8_t* patch = base + L::kRing;
  float* aff = reinterpret_cast<float*>(base + L::kAff);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  constexpr int kWStages = L::kWStages;
  uint64_t* empty = full + kWStages;

  const WTile t = wtile<L::kTH>(g, kN);
  const int n = n_chunks(g, L::kCC);

  // Thread 0 issues every weight copy: (chunk, tap) j into stage j % kWStages,
  // once the products of j - kWStages have handed the stage back. It refills
  // the stage of the tap before last, whose hand-back every thread has almost
  // surely made, so that its wait seldom holds the warpgroup; two taps'
  // weights stay in flight.
  auto issue_weights = [&](int j) {
    const int st = j % kWStages;
    mbar_expect_tx(&full[st], L::kStage); tma_load_chunk(ring + st * L::kStage, wmap, &full[st], chunk_at(g, j / 9, L::kCC).cw, t.o0, j % 9);
  };
  auto refill = [&](int done) {  // (chunk, tap) done has been handed back by every thread
    if (threadIdx.x == 0 && done >= 0 && done + kWStages < 9 * n) {
      mbar_wait(&empty[done % kWStages], (done / kWStages) & 1);
      issue_weights(done + kWStages);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcThreads);
    }
    fence_mbar_init();
    for (int j = 0; j < kWStages && j < 9 * n; ++j) issue_weights(j);
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  float inv = 0.f, act_scale = 0.f;
  if constexpr (kQuant) {
    float amax = 0.f;
    for (int i = 0; i < kAmaxParts; ++i) amax = fmaxf(amax, g.amax_part[t.b * kAmaxParts + i]);
    amax = fmaxf(amax, 1e-6f);
    inv = __fdiv_rn(127.f, amax);
    act_scale = __fmul_rn(amax, 1.f / 127.f);
  }
  auto quant = [inv](float v) -> S {
    if constexpr (kQuant) {
      const float stored = to_f(from_f<T>(v));
      const int q = __float2int_rn(__fmul_rn(stored, inv));
      return static_cast<S>(max(-127, min(127, q)));
    } else {
      return __float2bfloat16_rn(v);
    }
  };

  Acc acc[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0;

  // chunk 0's patch before the loop; chunk i + 1's a slice per tap of chunk i
  // (3 slices: 8 planes of (16 + 2) x 10 pixels), each slice's loads
  // issued one tap ahead of its build
  load_aff<L::kCC>(g, t.b, chunk_at(g, 0, L::kCC), aff);
  if (n > 1) load_aff<L::kCC>(g, t.b, chunk_at(g, 1, L::kCC), aff + 2 * L::kCC);
  __syncthreads();
  Staged<T, S> raw;
  {
    const Chunk c0 = chunk_at(g, 0, L::kCC);
    const int total = patch_items<S>(c0);
    load_slice<T, S>(g, t, c0, 0, total, raw);
    for (int sl = 0; sl * kSliceItems < total; ++sl) {
      Staged<T, S> ahead;
      if ((sl + 1) * kSliceItems < total) load_slice<T, S>(g, t, c0, sl + 1, total, ahead);
      finish_slice<T, S>(g, t, c0, sl, total, raw, aff, patch, quant);
      raw = ahead;
    }
  }
  fence_proxy_async();
  __syncthreads();

  int k = 0;
  for (int i = 0; i < n; ++i) {
    const Chunk c = chunk_at(g, i, L::kCC);
    const uint8_t* pa = patch + (i & 1) * L::kPatch;
    const int nk = (c.kc + L::kStep - 1) / L::kStep;
    const bool more = i + 1 < n;
    const Chunk ck = more ? chunk_at(g, i + 1, L::kCC) : c;
    uint8_t* pb = patch + ((i + 1) & 1) * L::kPatch;
    const float* affn = aff + ((i + 1) & 1) * 2 * L::kCC;
    const int total = more ? patch_items<S>(ck) : 0;
    const int slices = (total + kSliceItems - 1) / kSliceItems;
    if (more) load_slice<T, S>(g, t, ck, 0, total, raw);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap, ++k) {
      const int st = k % kWStages;
      mbar_wait(&full[st], (k / kWStages) & 1);
      const uint8_t* ws = ring + st * L::kStage;
      wgmma_fence();
      issue_tap<S, kN>(acc, pa, ws, tap, nk);
      wgmma_commit();
      if (tap > 0) {  // the products of the previous tap are done: its stage goes back
        wgmma_wait<1>();
        fence_acc(acc);
        mbar_arrive(&empty[(k - 1) % kWStages]);
        refill(k - 2);
      }
      if (tap < slices) {
        finish_slice<T, S>(g, t, ck, tap, total, raw, affn, pb, quant);
        if (tap + 1 < slices) load_slice<T, S>(g, t, ck, tap + 1, total, raw);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[(k - 1) % kWStages]);
    refill(k - 2);
    if (i + 2 < n) load_aff<L::kCC>(g, t.b, chunk_at(g, i + 2, L::kCC), aff + (i & 1) * 2 * L::kCC);
    fence_proxy_async();
    __syncthreads();  // the next patch and affine are in place; this patch is free
  }

  // epilogue: the accumulators (int8: rescaled) into shared memory, channel-major
  float* stage = reinterpret_cast<float*>(base);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pix = wg * 64 + 16 * warp + gq + 8 * (e >> 1);
      const int nn = 8 * j + 2 * tq + (e & 1);
      float v;
      if constexpr (kQuant) {
        const int o = min(t.o0 + nn, g.out_ch - 1);
        v = __fmul_rn(static_cast<float>(acc[4 * j + e]), __fmul_rn(act_scale, g.w_scale[o]));
      } else {
        v = acc[4 * j + e];
      }
      stage[nn * L::kLdSt + pix] = v;
    }
  __syncthreads();
  // then whole row segments, kGroup a thread at a time: their residual loads
  // all in flight before the first store
  constexpr int kGroup = 4;
  const bool vec = g.vec_out && t.w0 + kTW <= g.width;
  for (int s0 = threadIdx.x; s0 < kN * L::kTH; s0 += kGroup * kTcThreads) {
    float rv[kGroup][8];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int seg = s0 + q * kTcThreads;
      const int nn = seg / L::kTH;
      const int o = t.o0 + nn, oh = t.h0 + seg - nn * L::kTH;
      if (vec && g.residual != nullptr && seg < kN * L::kTH && o < g.out_ch && oh < g.height)
        load8<T>(static_cast<const T*>(g.residual) + out_index(g, t, o, oh), rv[q]);
      else
#pragma unroll
        for (int e = 0; e < 8; ++e) rv[q][e] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int seg = s0 + q * kTcThreads;
      const int nn = seg / L::kTH;
      const int r = seg - nn * L::kTH;
      const int o = t.o0 + nn, oh = t.h0 + r;
      if (seg >= kN * L::kTH || o >= g.out_ch || oh >= g.height) continue;
      const float bias_v = bias_at(g, o);
      store_segment<T>(g, t, o, oh, stage + nn * L::kLdSt + r * kTW, bias_v, vec, rv[q]);
    }
  }
}

// Kernel 4 in bf16, and kernel 5's convolution (named apart for profiles).
template <int kN>
__global__ void __launch_bounds__(kTcThreads, (Conv<bf16, kN>::kMinBlocks))
gn_silu_conv_bf16_wgmma(const __grid_constant__ CUtensorMap wmap, const Args g) {
  conv_wgmma<bf16, bf16, kN>(&wmap, g);
}

template <typename T, int kN>
__global__ void __launch_bounds__(kTcThreads, (Conv<int8_t, kN>::kMinBlocks))
gn_silu_conv_q_wgmma(const __grid_constant__ CUtensorMap wmap, const Args g) {
  conv_wgmma<T, int8_t, kN>(&wmap, g);
}

// Per batch item, partial maxima of |SiLU(x * a + off)| in fp32 over both
// parts: block (p, b) takes the channels p, p + kAmaxParts, ... of the
// concat, each a contiguous plane read 16 bytes at a time where it can be.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_silu_amax_kernel(Args g, float* amax_part) {
  const int b = blockIdx.y;
  const int plane = g.height * g.width;
  constexpr int kPer = 16 / sizeof(T);
  float m = 0.f;
  for (int cc = blockIdx.x; cc < g.p[0].channels + g.p[1].channels; cc += kAmaxParts) {
    const int pi = cc >= g.p[0].channels;
    const Part& p = g.p[pi];
    const int c = pi ? cc - g.p[0].channels : cc;
    const T* x = static_cast<const T*>(p.x) + (static_cast<long>(b) * p.channels + c) * plane;
    const float a = p.a[b * p.ld + c], off = p.off[b * p.ld + c];
    if (g.async_rows && plane % kPer == 0) {
      for (int j = threadIdx.x * kPer; j < plane; j += kThreads * kPer) {
        T v[kPer];
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + j);
#pragma unroll
        for (int e = 0; e < kPer; ++e) m = fmaxf(m, fabsf(silu_affine(to_f(v[e]), a, off)));
      }
    } else {
      for (int j = threadIdx.x; j < plane; j += kThreads)
        m = fmaxf(m, fabsf(silu_affine(to_f(x[j]), a, off)));
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  __shared__ float red[kThreads / 32];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, red[i]);
    amax_part[b * kAmaxParts + blockIdx.x] = m;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA. One block owns 128 output pixels (an 8 x 16 tile; 16 x 8
// for images 8 wide) and 64 output channels; thread (tx, ty) = (tid % 16,
// tid / 16) holds output channels 4 tx .. 4 tx + 3 of pixels ty + 16 i, i < 8.

constexpr int kBM = 128;     // output pixels per block
constexpr int kBN = 64;      // output channels per block
constexpr int kKc32 = 16;
constexpr int kLdP32 = 184;  // patch row (one channel) >= 10 * 18, multiple of 4

struct Tile {  // where a block's 128 output pixels lie
  int b, h0, w0, o0, th, tw, ph, pw;
};

__device__ __forceinline__ Tile block_tile(const Args& g) {
  Tile t;
  t.o0 = blockIdx.x * kBN;
  t.tw = 1 << g.tw_shift;
  t.th = kBM >> g.tw_shift;
  t.h0 = (blockIdx.y / g.tiles_w) * t.th;
  t.w0 = (blockIdx.y % g.tiles_w) * t.tw;
  t.b = blockIdx.z;
  t.ph = t.th + 2;
  t.pw = t.tw + 2;
  return t;
}

__device__ __forceinline__ void store_out(const Args& g, const Tile& t, int m, int n, float v) {
  const int oh = t.h0 + (m >> g.tw_shift);
  const int ow = t.w0 + (m & (t.tw - 1));
  const int o = t.o0 + n;
  if (oh >= g.height || ow >= g.width || o >= g.out_ch) return;
  v += bias_at(g, o);
  const long idx = ((static_cast<long>(t.b) * g.out_ch + o) * g.height + oh) * g.width + ow;
  if (g.residual != nullptr) v += static_cast<const float*>(g.residual)[idx];
  static_cast<float*>(g.out)[idx] = v;
}

__global__ void __launch_bounds__(kThreads) gn_silu_conv_fp32_kernel(Args g) {
  extern __shared__ float4 smem32[];
  float* patch = reinterpret_cast<float*>(smem32);  // [k][pixel]
  float* ws = patch + kKc32 * kLdP32;               // [tap][k][n]
  const Tile t = block_tile(g);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int prow[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty + 16 * i;
    prow[i] = (m >> g.tw_shift) * t.pw + (m & (t.tw - 1));
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* w = static_cast<const float*>(g.w);
  const long plane = static_cast<long>(g.height) * g.width;
  const int npatch = t.ph * t.pw;
  for (int pi = 0; pi < 2; ++pi) {
    const Part& p = g.p[pi];
    const float* x = static_cast<const float*>(p.x);
    for (int cb = 0; cb < p.channels; cb += kKc32) {
      const int kc = min(kKc32, p.channels - cb);
      const int cw = cb + (pi ? g.w_split : 0);
      for (int i = threadIdx.x; i < kKc32 * npatch; i += kThreads) {
        const int k = i / npatch;
        const int pp = i - k * npatch;
        const int r = pp / t.pw;
        const int ih = t.h0 - 1 + r;
        const int iw = t.w0 - 1 + (pp - r * t.pw);
        float s = 0.f;
        if (k < kc && ih >= 0 && ih < g.height && iw >= 0 && iw < g.width) {
          const int c = cb + k;
          s = silu_affine(x[(static_cast<long>(t.b) * p.channels + c) * plane +
                            static_cast<long>(ih) * g.width + iw],
                          p.a[t.b * p.ld + c], p.off[t.b * p.ld + c]);
        }
        patch[k * kLdP32 + pp] = s;
      }
      for (int i = threadIdx.x; i < kBN * 9 * kKc32; i += kThreads) {
        const int row = i / kKc32;  // n * 9 + tap
        const int k = i - row * kKc32;
        const int n = row / 9;
        const int tap = row - n * 9;
        float v = 0.f;
        if (t.o0 + n < g.out_ch && k < kc)
          v = w[(static_cast<long>(tap) * g.out_ch + t.o0 + n) * g.w_ld + cw + k];
        ws[(tap * kKc32 + k) * kBN + n] = v;
      }
      __syncthreads();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * t.pw + tap % 3;
#pragma unroll 4
        for (int k = 0; k < kKc32; ++k) {
          float b[4];
          load4(ws + (tap * kKc32 + k) * kBN + 4 * tx, b);
          const float* pr = patch + k * kLdP32 + shift;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = pr[prow[i]];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) store_out(g, t, ty + 16 * i, 4 * tx + j, acc[i][j]);
}

// ---------------------------------------------------------------------------

// The packed weights (9, O, w_ld) as a 3-D map (channel, output channel, tap)
// read in boxes of 128 bytes of channels x rows output channels, in the
// 128-byte swizzle; output channels past O read as zeros.
cudaError_t weight_map(CUtensorMap* map, const void* w, bool int8, int w_ld, int out_ch,
                       int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t esize = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w_ld), static_cast<cuuint64_t>(out_ch), 9};
  const cuuint64_t strides[2] = {w_ld * esize, static_cast<cuuint64_t>(w_ld) * out_ch * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize), static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(w), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, typename S, int kN>
cudaError_t launch_wgmma(const Args& g, int batch, cudaStream_t stream) {
  using L = Conv<S, kN>;
  static std::atomic<uint64_t> smem_set{0};
  void (*kernel)(const CUtensorMap, const Args);
  if constexpr (sizeof(S) == 1) kernel = gn_silu_conv_q_wgmma<T, kN>;
  else kernel = gn_silu_conv_bf16_wgmma<kN>;
  cudaError_t err = allow_smem(kernel, L::kBytes, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = weight_map(&map, g.w, sizeof(S) == 1, g.w_ld, g.out_ch, kN);
  if (err != cudaSuccess) return err;
  const int tiles = ((g.height + L::kTH - 1) / L::kTH) * ((g.width + kTW - 1) / kTW);
  const dim3 grid((g.out_ch + kN - 1) / kN, tiles, batch);
  kernel<<<grid, kTcThreads, L::kBytes, stream>>>(map, g);
  return cudaGetLastError();
}

// The channel tile by O: 64 up to 64, 128 up to 128, else 256.
template <typename T, typename S>
cudaError_t launch_tc(const Args& g, int batch, cudaStream_t stream) {
  if (g.out_ch <= 64) return launch_wgmma<T, S, 64>(g, batch, stream);
  if (g.out_ch <= 128) return launch_wgmma<T, S, 128>(g, batch, stream);
  return launch_wgmma<T, S, 256>(g, batch, stream);
}

cudaError_t launch_fp32(const Args& g, int batch, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * (kKc32 * kLdP32 + 9 * kKc32 * kBN);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = allow_smem(gn_silu_conv_fp32_kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles_h = (g.height + (kBM >> g.tw_shift) - 1) / (kBM >> g.tw_shift);
  const dim3 grid((g.out_ch + kBN - 1) / kBN, tiles_h * g.tiles_w, batch);
  gn_silu_conv_fp32_kernel<<<grid, kThreads, kSmem, stream>>>(g);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Fills the shared arguments; returns false on a shape the kernels do not
// take. x_size: the bytes of one activation element.
bool make_args(Args& g, const void* x1, const void* a1, const void* off1, int c1, int ld1,
               const void* x2, const void* a2, const void* off2, int c2, int ld2, const void* w,
               int w_ld, const void* bias, int bias_bf16, const void* residual, void* out,
               int batch, int height, int width, int out_ch, int x_size) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 || out_ch <= 0 || c1 <= 0 ||
      c2 < 0 || (c2 > 0 && x2 == nullptr))
    return false;
  const int split = (c1 + 15) / 16 * 16;
  if (w != nullptr && (w_ld < split + c2 || w_ld % 16 != 0 || !aligned16(w))) return false;
  // the fp32 body's tile: 8 x 16 (16 x 8 for a narrower image)
  const int shift = width > 8 ? 4 : 3;
  g.p[0] = Part{x1, static_cast<const float*>(a1), static_cast<const float*>(off1), c1, ld1};
  g.p[1] = Part{x2, static_cast<const float*>(a2), static_cast<const float*>(off2), c2, ld2};
  g.w = w;
  g.w_ld = w_ld;
  g.w_split = split;
  g.w_scale = nullptr;
  g.bias = bias;
  g.bias_bf16 = bias_bf16;
  g.residual = residual;
  g.out = out;
  g.amax_part = nullptr;
  g.height = height;
  g.width = width;
  g.out_ch = out_ch;
  g.tw_shift = shift;
  g.tiles_w = (width + (1 << shift) - 1) >> shift;
  g.async_rows = (width * x_size) % 16 == 0 && aligned16(x1) && (c2 == 0 || aligned16(x2));
  g.vec_out = width % kTW == 0 && aligned16(out) && (residual == nullptr || aligned16(residual));
  const long tiles32 = static_cast<long>(g.tiles_w) * ((height + (kBM >> shift) - 1) / (kBM >> shift));
  const long tiles = static_cast<long>((width + kTW - 1) / kTW) * ((height + 15) / 16);
  return tiles32 <= 65535 && tiles <= 65535;
}

}  // namespace

// Kernel 4. dtype: 0 = float32, 1 = bfloat16 (x1, x2, w, residual and out).
// a1/off1: (B, ld1) fp32 over x1's c1 channels; a2/off2 likewise for x2's c2
// (c2 = 0 and x2 = null for one input); w: the packed (9, O, w_ld) of the
// head note. Returns a cudaError_t (0 on success).
extern "C" int gn_silu_conv(const void* x1, const void* a1, const void* off1, int c1, int ld1,
                            const void* x2, const void* a2, const void* off2, int c2, int ld2,
                            const void* w, int w_ld, const void* bias, int bias_bf16,
                            const void* residual, void* out, int batch, int height, int width,
                            int out_ch, int dtype, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  Args g;
  if (!make_args(g, x1, a1, off1, c1, ld1, x2, a2, off2, c2, ld2, w, w_ld, bias, bias_bf16,
                 residual, out, batch, height, width, out_ch, size))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_fp32(g, batch, s));
  if (dtype == 1) return static_cast<int>(launch_tc<bf16, bf16>(g, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 5's first pass: amax_part ((B, gn_silu_amax_parts()) fp32) gets the
// partial maxima of |SiLU(x * a + off)| over both inputs of each batch item.
extern "C" int gn_silu_amax(const void* x1, const void* a1, const void* off1, int c1, int ld1,
                            const void* x2, const void* a2, const void* off2, int c2, int ld2,
                            void* amax_part, int batch, int height, int width, int dtype,
                            void* stream) {
  Args g;
  if (!make_args(g, x1, a1, off1, c1, ld1, x2, a2, off2, c2, ld2, nullptr, 0, nullptr, 0,
                 nullptr, nullptr, batch, height, width, 1, dtype == 0 ? 4 : 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kAmaxParts, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_silu_amax_kernel<float><<<grid, kThreads, 0, s>>>(g, static_cast<float*>(amax_part));
  else if (dtype == 1)
    gn_silu_amax_kernel<bf16><<<grid, kThreads, 0, s>>>(g, static_cast<float*>(amax_part));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5's convolution, after gn_silu_amax wrote amax_part: w the packed int8
// (9, O, w_ld) with w_scale (O,) fp32; dtype as for gn_silu_conv.
extern "C" int gn_silu_conv_q(const void* x1, const void* a1, const void* off1, int c1, int ld1,
                              const void* x2, const void* a2, const void* off2, int c2, int ld2,
                              const void* w, int w_ld, const void* w_scale, const void* bias,
                              int bias_bf16, const void* residual, void* out,
                              const void* amax_part, int batch, int height, int width, int out_ch,
                              int dtype, void* stream) {
  Args g;
  if (!make_args(g, x1, a1, off1, c1, ld1, x2, a2, off2, c2, ld2, w, w_ld, bias, bias_bf16,
                 residual, out, batch, height, width, out_ch, dtype == 0 ? 4 : 2))
    return static_cast<int>(cudaErrorInvalidValue);
  g.w_scale = static_cast<const float*>(w_scale);
  g.amax_part = static_cast<const float*>(amax_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_tc<float, int8_t>(g, batch, s));
  if (dtype == 1) return static_cast<int>(launch_tc<bf16, int8_t>(g, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partial maxima per batch item that gn_silu_amax writes.
extern "C" int gn_silu_amax_parts() { return kAmaxParts; }
