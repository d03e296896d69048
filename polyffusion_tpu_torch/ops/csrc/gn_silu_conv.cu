// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (sm_90a), NCHW,
// stride 1, padding 1, in three forms:
//   fp32 and bf16   out = conv3x3(SiLU(x * a + off), w) + b (+ residual)
//   int8            the same contraction on int8 operands, rescaled in fp32
// each with one input or two (the virtual channel concat [x1, x2]).
//
// Replaces the TPU kernel polyffusion_tpu/ops/fused_gn_conv.py:_kernel, with
// quantized=False (kernel 4: gn_silu_conv3x3, gn_silu_conv3x3_concat) and
// quantized=True (kernel 5: gn_silu_conv3x3_q, gn_silu_conv3x3_concat_q).
// a and off are the fp32 per-(batch, channel) GroupNorm affine; the
// normalised, activated tensor never reaches device memory, and with two
// inputs neither does the concat.
//
// What bounds it on an H100: at the UNet's shapes (C, O = 64-512, H = W =
// 16-128, batch 128) a site does 2 * 9 * C * O operations per output pixel
// against (C + O) * 2 bytes read and written, so in bf16 the tensor cores'
// operations bound the sites with C + O >= 256 and the bytes those at 64 -> 64;
// the int8 form halves the operations' bound (1,979 TOP/s).
//
// What the design does about it: an implicit GEMM. One block owns 128 output
// pixels (an 8 x 16 tile; 16 x 8 for images 8 wide) of one batch item and 64
// output channels, and walks the (virtual) input channels in chunks of 32.
// Per chunk:
//   - the raw input rows of the tile and its one-row halo (NCHW, so each is
//     contiguous) and the chunk's a and off are copied into shared memory with
//     cp.async while the tensor cores work on the previous chunk, and the
//     chunk's weights for all nine taps while its patch is built (the wrapper
//     hands the weights over tap-major, (O, 3, 3, C), so each (o, tap) row of
//     a chunk is 64 contiguous bytes); some 100 KB of shared memory, so two
//     blocks share an SM and one's copies overlap the other's work;
//   - x * a + off and SiLU are applied in fp32 and rounded to the storage type
//     into a channel-innermost patch of (TH + 2) x (TW + 2) pixels; the halo
//     outside the image is 0 after SiLU, as the TPU kernel's zero-padded
//     buffer is;
//   - the nine shifted products run out of shared memory:
//       bf16: mma.sync m16n8k16 on the tensor cores, fp32 accumulate; 8 warps,
//         each 32 pixels x 32 channels; rows padded by 16 bytes so that the
//         fragment loads hit distinct banks;
//       int8: mma.sync m16n8k32 s8 x s8 -> s32, the same tiling. The
//         activation is quantized while the patch is built, with one scale per
//         batch item, amax / 127, where amax = max |SiLU| in fp32 over both
//         inputs is found first by a separate pass (gn_silu_amax_kernel): the
//         whole item's maximum must be known before the first value is
//         quantized. Values are rounded half to even (__float2int_rn, as
//         jnp.round) from the value rounded to the activation's storage type,
//         as the TPU kernel quantizes its bf16 buffer.
//   - fp32 takes FMA on the CUDA cores instead (the tensor cores would round
//     to TF32), each of 256 threads 8 pixels x 4 channels, loading
//     synchronously: it serves the checks against the CPU, not the main path.
// The epilogue adds the bias and the residual in fp32 and rounds once. wgmma,
// TMA and coalesced stores are later work; SiLU is recomputed for each
// 64-channel output tile and for the halo (the 10 x 18 patch of an 8 x 16
// tile is 1.4 x its pixels).
//
// The arithmetic of x * a + off and SiLU is written as the plain PyTorch
// version computes it on the card (a product and a sum each rounded, then
// y * (1 / (1 + exp(-y)))), so that both round the same values the same way.

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kKC = 32;       // input channels per chunk
constexpr int kThreads = 256;
constexpr int kMaxPatch = 10 * 18;   // (TH + 2) * (TW + 2) at most (TW 8 or 16)

// Raw rows of a chunk: a 16-byte piece of halo on either side of the tile's TW
// columns, so that every piece stays 16-byte aligned in the image's row.
template <typename T> __host__ __device__ constexpr int halo_elems() { return 16 / sizeof(T); }
template <typename T> __host__ __device__ constexpr int raw_ld(int tw) {
  return tw + 2 * halo_elems<T>();
}
template <typename T> __host__ __device__ constexpr int max_raw() {  // KC (TH + 2) raw_ld at most
  return kKC * (10 * raw_ld<T>(16) > 18 * raw_ld<T>(8) ? 10 * raw_ld<T>(16) : 18 * raw_ld<T>(8));
}
constexpr int kAmaxParts = 64;       // amax pass: blocks per batch item

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
  const void* w;           // (O, 3, 3, C1 + C2): the activation's dtype, or int8
  const float* w_scale;    // (O,) int8 only
  const void* bias;        // (O,) fp32 or bf16
  int bias_bf16;
  const void* residual;    // (B, O, H, W) or null
  void* out;               // (B, O, H, W)
  const float* amax_part;  // int8 only: (B, kAmaxParts) partial maxima
  int height, width, out_ch;
  int tw_shift;            // TW = 1 << tw_shift
  int tiles_w;
  int async_rows;          // input rows are 16-byte aligned: copied 16 bytes at a time
  int async_w;             // weight rows may be copied 16 bytes at a time
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

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

// Chunk i of the (virtual) input channels: part pi, channels [cb, cb + kc) of
// it, at concat channel cw.
struct Chunk {
  int pi, cb, kc, cw;
};

__device__ __forceinline__ int n_chunks(const Args& g) {
  return (g.p[0].channels + kKC - 1) / kKC + (g.p[1].channels + kKC - 1) / kKC;
}

__device__ __forceinline__ Chunk chunk_at(const Args& g, int i) {
  const int n0 = (g.p[0].channels + kKC - 1) / kKC;
  Chunk c;
  c.pi = i >= n0;
  c.cb = (c.pi ? i - n0 : i) * kKC;
  c.kc = min(kKC, g.p[c.pi].channels - c.cb);
  c.cw = c.cb + (c.pi ? g.p[0].channels : 0);
  return c;
}

template <typename T>
__device__ __forceinline__ void store_out(const Args& g, const Tile& t, int m, int n, float v) {
  const int oh = t.h0 + (m >> g.tw_shift);
  const int ow = t.w0 + (m & (t.tw - 1));
  const int o = t.o0 + n;
  if (oh >= g.height || ow >= g.width || o >= g.out_ch) return;
  v += g.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(g.bias)[o])
                   : static_cast<const float*>(g.bias)[o];
  const long idx = ((static_cast<long>(t.b) * g.out_ch + o) * g.height + oh) * g.width + ow;
  if (g.residual != nullptr) v += to_f(static_cast<const T*>(g.residual)[idx]);
  static_cast<T*>(g.out)[idx] = from_f<T>(v);
}

// ---------------------------------------------------------------------------
// bf16 and int8: tensor cores (mma.sync). 8 warps: 4 along the pixels (32
// each: two m16 tiles), 2 along the channels (32 each: four n8 tiles).

template <typename S> struct TcTraits;
template <> struct TcTraits<bf16> {  // m16n8k16: one k-step is 16 channels
  static constexpr int kLd = kKC + 8;   // 80-byte rows
  static constexpr int kStep = 16;
  static constexpr int kPair = 2;       // channels per 32-bit fragment register
};
template <> struct TcTraits<int8_t> {  // m16n8k32: one k-step is 32 channels
  static constexpr int kLd = kKC + 16;  // 48-byte rows
  static constexpr int kStep = 32;
  static constexpr int kPair = 4;
};

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, typename S>
struct TcSmem {  // byte offsets of the shared buffers
  static constexpr int kLd = TcTraits<S>::kLd;
  static constexpr size_t kPatch = 0;
  static constexpr size_t kW = kPatch + sizeof(S) * kMaxPatch * kLd;
  static constexpr size_t kWBuf = sizeof(S) * 9 * kBN * kLd;
  static constexpr size_t kRaw = kW + kWBuf;
  static constexpr size_t kAff = kRaw + sizeof(T) * max_raw<T>();  // a then off, kKC each
  static constexpr size_t kBytes = kAff + sizeof(float) * 2 * kKC;
};

// Starts the copies of chunk c's input into shared memory: raw[(k * (TH + 2)
// + r) * raw_ld + j] = the image's element at row h0 - 1 + r, column w0 - halo
// + j (only those inside the image are copied: the patch reads no other), and
// aff = a and off. Where the pieces cannot go 16 bytes at a time (a ragged
// tile) they are plain loads and stores.
template <typename T>
__device__ __forceinline__ void fill_input(const Args& g, const Tile& t, const Chunk& c,
                                           T* raw, float* aff) {
  constexpr int kHalo = halo_elems<T>();
  const int ld = t.tw + 2 * kHalo;
  const Part& p = g.p[c.pi];
  const T* x = static_cast<const T*>(p.x) +
               (static_cast<long>(t.b) * p.channels + c.cb) * g.height * g.width;
  const int rows = c.kc * t.ph;
  if (g.async_rows) {
    const int pieces = ld / kHalo;
    for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
      const int row = i / pieces;
      const int k = row / t.ph;
      const int ih = t.h0 - 1 + (row - k * t.ph);
      const int j = (i - row * pieces) * kHalo;
      const int iw = t.w0 - kHalo + j;
      if (ih < 0 || ih >= g.height || iw < 0 || iw >= g.width) continue;
      cp_async16(raw + row * ld + j, x + (static_cast<long>(k) * g.height + ih) * g.width + iw);
    }
  } else {
    const int span = t.tw + 2;  // the tile's columns and one on either side
    for (int i = threadIdx.x; i < rows * span; i += kThreads) {
      const int row = i / span;
      const int k = row / t.ph;
      const int ih = t.h0 - 1 + (row - k * t.ph);
      const int iw = t.w0 - 1 + (i - row * span);
      if (ih < 0 || ih >= g.height || iw < 0 || iw >= g.width) continue;
      raw[row * ld + iw - t.w0 + kHalo] = x[(static_cast<long>(k) * g.height + ih) * g.width + iw];
    }
  }
  if (threadIdx.x < 2 * c.kc) {
    const int k = threadIdx.x % c.kc;
    const float* src = threadIdx.x < c.kc ? p.a : p.off;
    cp_async4(aff + (threadIdx.x < c.kc ? 0 : kKC) + k, src + t.b * p.ld + c.cb + k);
  }
  cp_async_commit();
}

// Starts the copies of chunk c's weights for all nine taps into shared memory,
// ws[(tap * kBN + n) * kLd + k]. Where they cannot go 16 bytes at a time (O or
// C off the tile) they are plain loads and stores, 0 past O or past kc.
template <typename S>
__device__ __forceinline__ void fill_weights(const Args& g, const Tile& t, const Chunk& c, S* ws) {
  constexpr int kLd = TcTraits<S>::kLd;
  const S* w = static_cast<const S*>(g.w);
  const int ctot = g.p[0].channels + g.p[1].channels;
  if (g.async_w && c.kc == kKC && t.o0 + kBN <= g.out_ch) {
    constexpr int kPer = 16 / sizeof(S);
    constexpr int kPieces = kKC / kPer;  // per (n, tap) row
    for (int i = threadIdx.x; i < kBN * 9 * kPieces; i += kThreads) {
      const int row = i / kPieces;  // n * 9 + tap
      const int n = row / 9;
      const int tap = row - n * 9;
      const int col = (i - row * kPieces) * kPer;
      cp_async16(ws + (tap * kBN + n) * kLd + col,
                 w + (static_cast<long>(t.o0) * 9 + row) * ctot + c.cw + col);
    }
  } else {
    for (int i = threadIdx.x; i < kBN * 9 * kKC; i += kThreads) {
      const int row = i / kKC;
      const int k = i - row * kKC;
      const int n = row / 9;
      const int tap = row - n * 9;
      S v{};
      if (t.o0 + n < g.out_ch && k < c.kc)
        v = w[(static_cast<long>(t.o0 + n) * 9 + tap) * ctot + c.cw + k];
      ws[(tap * kBN + n) * kLd + k] = v;
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ uint16_t bits(bf16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint8_t bits(int8_t v) { return static_cast<uint8_t>(v); }

// patch[pixel * kLd + k] = the chunk's SiLU'd input, quantized by quant, over
// the tile's (TH + 2) x (TW + 2) pixels; 0 outside the image and past kc. Each
// thread takes kG consecutive channels of one pixel per step.
template <typename T, typename S, typename Quant>
__device__ __forceinline__ void build_patch(const Args& g, const Tile& t, const Chunk& c,
                                            const T* raw, const float* aff, S* patch,
                                            Quant quant) {
  constexpr int kLd = TcTraits<S>::kLd;
  constexpr int kG = 8;  // channels per item
  const int npatch = t.ph * t.pw;
  const int ld = raw_ld<T>(t.tw);
  for (int i = threadIdx.x; i < npatch * (kKC / kG); i += kThreads) {
    const int grp = i / npatch;
    const int pp = i - grp * npatch;
    const int r = pp / t.pw;
    const int col = pp - r * t.pw - 1 + halo_elems<T>();  // column in the raw rows
    const int ih = t.h0 - 1 + r;
    const int iw = t.w0 - halo_elems<T>() + col;
    const bool inside = ih >= 0 && ih < g.height && iw >= 0 && iw < g.width;
    constexpr int kPerWord = 4 / sizeof(S);
    uint32_t words[kG / kPerWord];
#pragma unroll
    for (int wi = 0; wi < kG / kPerWord; ++wi) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < kPerWord; ++e) {
        const int k = grp * kG + wi * kPerWord + e;
        S v{};
        if (inside && k < c.kc)
          v = quant(silu_affine(to_f(raw[(k * t.ph + r) * ld + col]), aff[k], aff[kKC + k]));
        word |= static_cast<uint32_t>(bits(v)) << (8 * sizeof(S) * e);
      }
      words[wi] = word;
    }
    // kG values of S are 16 (bf16) or 8 (int8) bytes, aligned in the padded row
    if constexpr (sizeof(S) == 2)
      *reinterpret_cast<uint4*>(patch + pp * kLd + grp * kG) =
          make_uint4(words[0], words[1], words[2], words[3]);
    else
      *reinterpret_cast<uint2*>(patch + pp * kLd + grp * kG) = make_uint2(words[0], words[1]);
  }
}

// T: the activation's dtype; S: the operands' storage (bf16, or int8 for the
// quantized form).
template <typename T, typename S>
__device__ __forceinline__ void conv_tc(const Args& g) {
  using Tr = TcTraits<S>;
  using Sm = TcSmem<T, S>;
  constexpr bool kQuant = sizeof(S) == 1;
  using Acc = typename std::conditional<kQuant, int, float>::type;
  extern __shared__ uint4 smem_tc[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_tc);
  S* patch = reinterpret_cast<S*>(base + Sm::kPatch);
  S* wbuf = reinterpret_cast<S*>(base + Sm::kW);
  T* raw = reinterpret_cast<T*>(base + Sm::kRaw);
  float* aff = reinterpret_cast<float*>(base + Sm::kAff);

  const Tile t = block_tile(g);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;
  const int wm = warp & 3;
  const int wn = warp >> 2;

  // patch pixel of the rows this lane reads, tap (0, 0): rows wm*32 + mt*16 + gq + 8r
  int prow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = wm * 32 + mt * 16 + gq + 8 * r;
      prow[mt][r] = (m >> g.tw_shift) * t.pw + (m & (t.tw - 1));
    }

  float inv = 0.f, act_scale = 0.f;
  if (kQuant) {
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

  Acc acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // The input of chunk i + 1 is copied while the tensor cores work on chunk i,
  // the weights of chunk i while its patch is built.
  const int n = n_chunks(g);
  Chunk c = chunk_at(g, 0);
  fill_input<T>(g, t, c, raw, aff);
  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();
    __syncthreads();  // chunk i's input landed; the products of chunk i - 1 are done
    fill_weights<S>(g, t, c, wbuf);
    build_patch<T, S>(g, t, c, raw, aff, patch, quant);
    cp_async_wait_all();
    __syncthreads();  // the weights landed and the patch is built; raw and aff are free
    const S* ws = wbuf;
    if (i + 1 < n) {
      c = chunk_at(g, i + 1);
      fill_input<T>(g, t, c, raw, aff);
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * t.pw + tap % 3;
#pragma unroll
      for (int kk = 0; kk < kKC / Tr::kStep; ++kk) {
        const int k0 = kk * Tr::kStep + Tr::kPair * tq;
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const S* r0 = patch + (prow[mt][0] + shift) * Tr::kLd + k0;
          const S* r1 = patch + (prow[mt][1] + shift) * Tr::kLd + k0;
          af[mt][0] = ld_u32(r0);
          af[mt][1] = ld_u32(r1);
          af[mt][2] = ld_u32(r0 + Tr::kStep / 2);
          af[mt][3] = ld_u32(r1 + Tr::kStep / 2);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const S* wr = ws + (tap * kBN + wn * 32 + nt * 8 + gq) * Tr::kLd + k0;
          const uint32_t b0 = ld_u32(wr), b1 = ld_u32(wr + Tr::kStep / 2);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (kQuant) mma_s8(acc[mt][nt], af[mt], b0, b1);
            else mma_bf16(acc[mt][nt], af[mt], b0, b1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm * 32 + mt * 16 + gq + 8 * (e >> 1);
        const int nn = wn * 32 + nt * 8 + 2 * tq + (e & 1);
        float v;
        if constexpr (kQuant) {
          const int o = min(t.o0 + nn, g.out_ch - 1);
          v = __fmul_rn(static_cast<float>(acc[mt][nt][e]), __fmul_rn(act_scale, g.w_scale[o]));
        } else {
          v = acc[mt][nt][e];
        }
        store_out<T>(g, t, m, nn, v);
      }
}

// Kernel 4 in bf16, and kernel 5's convolution (named apart for profiles).
__global__ void __launch_bounds__(kThreads, 2) gn_silu_conv_bf16_kernel(Args g) {
  conv_tc<bf16, bf16>(g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gn_silu_conv_q_kernel(Args g) {
  conv_tc<T, int8_t>(g);
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
// fp32: CUDA-core FMA. Thread (tx, ty) = (tid % 16, tid / 16) holds output
// channels 4 tx .. 4 tx + 3 of pixels ty + 16 i, i < 8.

constexpr int kKc32 = 16;
constexpr int kLdP32 = 184;  // patch row (one channel) >= kMaxPatch, multiple of 4

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

  const int ctot = g.p[0].channels + g.p[1].channels;
  const float* w = static_cast<const float*>(g.w);
  const long plane = static_cast<long>(g.height) * g.width;
  const int npatch = t.ph * t.pw;
  for (int pi = 0; pi < 2; ++pi) {
    const Part& p = g.p[pi];
    const float* x = static_cast<const float*>(p.x);
    for (int cb = 0; cb < p.channels; cb += kKc32) {
      const int kc = min(kKc32, p.channels - cb);
      const int cw = cb + (pi ? g.p[0].channels : 0);
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
          v = w[(static_cast<long>(t.o0 + n) * 9 + tap) * ctot + cw + k];
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
    for (int j = 0; j < 4; ++j) store_out<float>(g, t, ty + 16 * i, 4 * tx + j, acc[i][j]);
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_conv(Kernel kernel, size_t smem, std::atomic<uint64_t>& smem_set,
                        const Args& g, int batch, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles_h = (g.height + (kBM >> g.tw_shift) - 1) / (kBM >> g.tw_shift);
  const dim3 grid((g.out_ch + kBN - 1) / kBN, tiles_h * g.tiles_w, batch);
  kernel<<<grid, kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Args& g, int batch, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  return launch_conv(gn_silu_conv_bf16_kernel, TcSmem<bf16, bf16>::kBytes, smem_set, g, batch,
                     stream);
}

template <typename T>
cudaError_t launch_q(const Args& g, int batch, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  return launch_conv(gn_silu_conv_q_kernel<T>, TcSmem<T, int8_t>::kBytes, smem_set, g, batch,
                     stream);
}

cudaError_t launch_fp32(const Args& g, int batch, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * (kKc32 * kLdP32 + 9 * kKc32 * kBN);
  static std::atomic<uint64_t> smem_set{0};
  return launch_conv(gn_silu_conv_fp32_kernel, kSmem, smem_set, g, batch, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Fills the shared arguments; returns false on a shape the kernels do not
// take. x_size and w_size: the bytes of one activation and one weight element.
bool make_args(Args& g, const void* x1, const void* a1, const void* off1, int c1, int ld1,
               const void* x2, const void* a2, const void* off2, int c2, int ld2, const void* w,
               const void* bias, int bias_bf16, const void* residual, void* out, int batch,
               int height, int width, int out_ch, int x_size, int w_size) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 || out_ch <= 0 || c1 <= 0 ||
      c2 < 0 || (c2 > 0 && x2 == nullptr))
    return false;
  // TW = 16 (8 for a narrower image): 8 x 16 pixels per block, whose patch
  // with its halo is 10 x 18, 1.4 x the outputs (a 1 x 128 row would be 3 x)
  const int shift = width > 8 ? 4 : 3;
  g.p[0] = Part{x1, static_cast<const float*>(a1), static_cast<const float*>(off1), c1, ld1};
  g.p[1] = Part{x2, static_cast<const float*>(a2), static_cast<const float*>(off2), c2, ld2};
  g.w = w;
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
  // 16-byte pieces of a row are then either wholly inside the image or outside
  g.async_rows = (width * x_size) % 16 == 0 && aligned16(x1) && (c2 == 0 || aligned16(x2));
  g.async_w = ((c1 + c2) * w_size) % 16 == 0 && (c1 * w_size) % 16 == 0 && aligned16(w);
  const long tiles = static_cast<long>(g.tiles_w) * ((height + (kBM >> shift) - 1) / (kBM >> shift));
  return tiles <= 65535;
}

}  // namespace

// Kernel 4. dtype: 0 = float32, 1 = bfloat16 (x1, x2, w, residual and out).
// a1/off1: (B, ld1) fp32 over x1's c1 channels; a2/off2 likewise for x2's c2
// (c2 = 0 and x2 = null for one input); w: (O, 3, 3, c1 + c2). Returns a
// cudaError_t (0 on success).
extern "C" int gn_silu_conv(const void* x1, const void* a1, const void* off1, int c1, int ld1,
                            const void* x2, const void* a2, const void* off2, int c2, int ld2,
                            const void* w, const void* bias, int bias_bf16, const void* residual,
                            void* out, int batch, int height, int width, int out_ch, int dtype,
                            void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  Args g;
  if (!make_args(g, x1, a1, off1, c1, ld1, x2, a2, off2, c2, ld2, w, bias, bias_bf16, residual,
                 out, batch, height, width, out_ch, size, size))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_fp32(g, batch, s));
  if (dtype == 1) return static_cast<int>(launch_bf16(g, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 5's first pass: amax_part ((B, gn_silu_amax_parts()) fp32) gets the
// partial maxima of |SiLU(x * a + off)| over both inputs of each batch item.
extern "C" int gn_silu_amax(const void* x1, const void* a1, const void* off1, int c1, int ld1,
                            const void* x2, const void* a2, const void* off2, int c2, int ld2,
                            void* amax_part, int batch, int height, int width, int dtype,
                            void* stream) {
  Args g;
  if (!make_args(g, x1, a1, off1, c1, ld1, x2, a2, off2, c2, ld2, nullptr, nullptr, 0, nullptr,
                 nullptr, batch, height, width, 1, dtype == 0 ? 4 : 2, 1))
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

// Kernel 5's convolution, after gn_silu_amax wrote amax_part: w int8
// (O, 3, 3, C1 + C2) with w_scale (O,) fp32; dtype as for gn_silu_conv.
extern "C" int gn_silu_conv_q(const void* x1, const void* a1, const void* off1, int c1, int ld1,
                              const void* x2, const void* a2, const void* off2, int c2, int ld2,
                              const void* w, const void* w_scale, const void* bias, int bias_bf16,
                              const void* residual, void* out, const void* amax_part, int batch,
                              int height, int width, int out_ch, int dtype, void* stream) {
  Args g;
  if (!make_args(g, x1, a1, off1, c1, ld1, x2, a2, off2, c2, ld2, w, bias, bias_bf16, residual,
                 out, batch, height, width, out_ch, dtype == 0 ? 4 : 2, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  g.w_scale = static_cast<const float*>(w_scale);
  g.amax_part = static_cast<const float*>(amax_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_q<float>(g, batch, s));
  if (dtype == 1) return static_cast<int>(launch_q<bf16>(g, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partial maxima per batch item that gn_silu_amax writes.
extern "C" int gn_silu_amax_parts() { return kAmaxParts; }
