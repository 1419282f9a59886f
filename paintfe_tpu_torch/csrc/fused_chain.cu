// K-chain: the headline filter chain in one kernel — Gaussian blur,
// brightness/contrast, levels, sepia with strength, then a soft-light
// Porter-Duff flatten of an overlay at an opacity.
//
// Replaces the Pallas kernel fused_chain_kernel (paintfe_tpu/ops/
// fused_chain.py, _make_chain_kernel and _chain_kernel_fn).
//
// What bounds it on the H100: the blur's f32 multiplies and adds (2 x nt a
// channel a pixel in each pass), then about 90 f32 operations of the tail a
// pixel, above three u8 RGBA frames of device memory (image and overlay
// read, result written: 3 x 33 MB per 3840x2160 frame).  The design is
// K-blur's staged, register-blocked tile (blur_tile.cuh blur_h_pass and
// blur_v_pass: the source region staged once with cp.async, Q adjacent
// sums a thread from a register window in both passes), with two
// differences: the taps come from the block's copy in shared memory, and
// the V pass's epilogue runs the pointwise tail against the overlay pixel,
// which it requests before its sums.  The tail keeps every value in f32
// registers and off the conversion pipe:
//  - each V sum rounds to its byte with round_byte (floor(x + 0.5)
//    clipped), and every truncating u8 cast is trunc_bits (an add of 2^23
//    rounded toward zero), each byte left in the low bits of its word;
//  - every stage whose input is one byte becomes a 256-entry f32 table a
//    block fills once, with the same operations in the same order, so a
//    table entry carries the per-pixel value's bits: brightness/contrast
//    and then levels as one table of the rounded blur byte (levels itself
//    is pipeline.levels_lut, built on the host with the power correctly
//    rounded: CUDA's powf is not, and levels only sees integer inputs);
//    every x / 255, which divides a byte, as K-composite's unit table of
//    __fdiv_rn(i, 255) (unpremultiply.cuh); and soft-light's d(b), the
//    polynomial or sqrtf of b = i / 255;
//  - the three divides by the result alpha share one reciprocal (div3) at
//    opacities of at least 2^-20 and are three __fdiv_rn below
//    (pfe_chain_div_check counts the shared form against __fdiv_rn over
//    every u8 input: 0 differ);
//  - sqrtf stays (correctly rounded without fast-math), in d's table, and
//    every product and sum keeps the order of the script-level ops
//    (-fmad=false);
//  - the two special cases (a clear overlay pixel passes the base; a clear
//    result is 0) are selects.
// The taps and the levels table live in device memory, cached by the
// wrapper per sigma and per (black, white, gamma): a call copies nothing
// to the card, and two streams cannot see each other's tables.  A radius
// whose tile and tables do not fit shared memory (ops/kernels.py
// chain_tile_rows) runs K-blur and then chain_tail_kernel, which shares
// chain_tail() with the tile.
#include "blur_tile.cuh"
#include "unpremultiply.cuh"

namespace pfe {

// Scalars of the pointwise tail, computed on the host in numpy f32 exactly
// as the JAX package's _make_chain_kernel does.
struct ChainParams {
  float brightness;
  float bc_factor;
  float sep_s;
  float sep_inv;
  float opacity;
};

// Shared memory ahead of the tile's sums: the tail's three tables
// (kUnitEntries f32 each), then the taps padded to four f32, so the float4
// sums stay 16-byte aligned.  (ops/kernels.py chain_tables_bytes.)
constexpr int kChainTables = 3;

__host__ __device__ __forceinline__ int chain_taps_padded(int nt) { return (nt + 3) & ~3; }

inline size_t chain_tables_bytes(int nt) {
  return static_cast<size_t>(kChainTables * kUnitEntries + chain_taps_padded(nt)) *
         sizeof(float);
}

// cudaFuncSetAttribute is set once a kernel and device, to the most any
// tile may take (the launch's own size decides the occupancy).
constexpr int kMaxDevices = 64;

// floor(x) clipped to [0, 255] (0 for NaN), in the low byte.
__device__ __forceinline__ uint32_t trunc255_bits(float x) {
  return trunc_bits(fminf(fmaxf(x, 0.0f), 255.0f));
}

// W3C soft-light (core/blend.py _soft_light): d(b), which depends on the
// base alone, and the mix of base b under top t given d = d(b).
__device__ __forceinline__ float soft_light_d(float b) {
  return b <= 0.25f ? ((16.0f * b - 12.0f) * b + 4.0f) * b : sqrtf(b);
}

__device__ __forceinline__ float soft_light(float b, float d, float t) {
  return t <= 0.5f ? b - (1.0f - 2.0f * t) * b * (1.0f - b)
                   : b + (2.0f * t - 1.0f) * (d - b);
}

// The soft-light Porter-Duff of one pixel, straight alpha: the three
// numerators into num, the result alpha returned.
__device__ __forceinline__ float soft_light_over(const float (&bf)[3], const float (&d)[3],
                                                 float base_a, const float (&tf)[3],
                                                 float top_a, float (&num)[3]) {
  const float inv = 1.0f - top_a;
  const float out_a = top_a + base_a * inv;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    num[k] = soft_light(bf[k], d[k], tf[k]) * top_a + bf[k] * base_a * inv;
  }
  return out_a;
}

// The block's tables, entry i for the byte i: i / 255; brightness/contrast
// then levels of i; soft-light's d(i / 255).
struct ChainTables {
  float* unit;
  float* tone;
  float* soft_d;
};

// Entry threadIdx.x of each table (blockDim.x == kUnitEntries).
__device__ __forceinline__ void fill_tables(const ChainTables& t, const uint8_t* levels_lut,
                                            const ChainParams& p) {
  const unsigned i = threadIdx.x;
  const float u = unit_entry(i);
  t.unit[i] = u;
  // brightness/contrast (clip, then the u8 truncation), then levels
  const uint32_t bc = trunc255_bits(p.bc_factor * (static_cast<float>(i) + p.brightness -
                                                   128.0f) + 128.0f);
  t.tone[i] = static_cast<float>(__ldg(levels_lut + (bc & 0xFFu)));
  t.soft_d[i] = soft_light_d(u);
}

// The pointwise tail of one pixel: the blur's four V sums (not yet
// rounded) and the overlay pixel in, the packed result out, through the
// block's tables; kShare picks div3's shared reciprocal.
template <bool kShare>
__device__ __forceinline__ uint32_t chain_tail(float4 v, uint32_t ov, const ChainTables& t,
                                               const ChainParams& p) {
  const uint32_t rb[4] = {round_byte(v.x), round_byte(v.y), round_byte(v.z), round_byte(v.w)};
  const float c[3] = {t.tone[rb[0] & 0xFFu], t.tone[rb[1] & 0xFFu], t.tone[rb[2] & 0xFFu]};
  // sepia with strength
  const float sr = fminf(c[0] * 0.393f + c[1] * 0.769f + c[2] * 0.189f, 255.0f);
  const float sg = fminf(c[0] * 0.349f + c[1] * 0.686f + c[2] * 0.168f, 255.0f);
  const float sb = fminf(c[0] * 0.272f + c[1] * 0.534f + c[2] * 0.131f, 255.0f);
  const uint32_t s[3] = {trunc255_bits(c[0] * p.sep_inv + sr * p.sep_s),
                         trunc255_bits(c[1] * p.sep_inv + sg * p.sep_s),
                         trunc255_bits(c[2] * p.sep_inv + sb * p.sep_s)};
  // soft-light Porter-Duff against the overlay, truncating quantization
  float bf[3], d[3], tf[3], num[3], q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bf[k] = t.unit[s[k] & 0xFFu];
    d[k] = t.soft_d[s[k] & 0xFFu];
    tf[k] = t.unit[(ov >> (8 * k)) & 0xFFu];
  }
  const float out_a = soft_light_over(bf, d, t.unit[rb[3] & 0xFFu], tf,
                                      t.unit[ov >> 24] * p.opacity, num);
  div3<!kShare>(num, out_a, q);
  const uint32_t blended = pack_low(trunc255_bits(q[0] * 255.0f), trunc255_bits(q[1] * 255.0f),
                                    trunc255_bits(q[2] * 255.0f), trunc255_bits(out_a * 255.0f));
  // overlay alpha 0: the base passes through unchanged; result alpha 0: clear
  return (ov >> 24) == 0u ? pack_low(s[0], s[1], s[2], rb[3])
                          : (out_a == 0.0f ? 0u : blended);
}

struct SharedTaps {
  const float* t;
  __device__ __forceinline__ float operator()(int k) const { return t[k]; }
};

// The V pass's epilogue: the Q overlay pixels of a thread's column are
// requested before its sums, then each sum runs the tail into dst.
template <int Q, bool kShare>
struct ChainStore {
  const uint32_t* overlay;
  uint32_t* dst;
  int H, W;
  ChainTables tables;
  ChainParams p;
  struct Loaded {
    uint32_t ov[Q];
  };
  __device__ __forceinline__ Loaded load(int gx, int gy0) const {
    Loaded l;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int gy = gy0 + q;
      l.ov[q] = gx < W && gy < H ? __ldg(overlay + static_cast<size_t>(gy) * W + gx) : 0u;
    }
    return l;
  }
  __device__ __forceinline__ void store(float4 v, size_t o, const Loaded& l, int q) const {
    dst[o] = chain_tail<kShare>(v, l.ov[q], tables, p);
  }
};

// Q sums a thread; kMinBlocks blocks an SM bound the registers (K-blur's).
template <int Q, int kMinBlocks, bool kShare>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chain_tiled_kernel(const uint32_t* __restrict__ src, const uint32_t* __restrict__ overlay,
                   uint32_t* __restrict__ dst, const float* __restrict__ taps,
                   const uint8_t* __restrict__ levels_lut, int H, int W, int r, int nt, int th,
                   int chunk, ChainParams p) {
  extern __shared__ float4 smem[];
  float* f = reinterpret_cast<float*>(smem);
  const ChainTables tables{f, f + kUnitEntries, f + 2 * kUnitEntries};
  float* tp = f + kChainTables * kUnitEntries;
  float4* hs = reinterpret_cast<float4*>(tp + chain_taps_padded(nt));
  uint32_t* stage = reinterpret_cast<uint32_t*>(hs + (th + 2 * r) * kTileW);
  static_assert(kThreads == kUnitEntries, "one table entry a thread");
  fill_tables(tables, levels_lut, p);
  for (int k = threadIdx.x; k < nt; k += kThreads) tp[k] = __ldg(taps + k);
  // blur_h_pass's first barrier publishes the tables to the block
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  blur_h_pass<Q>(src, hs, stage, H, W, x0, y0, th, r, nt, chunk, SharedTaps{tp});
  blur_v_pass<Q>(hs, H, W, x0, y0, th, r, nt, SharedTaps{tp},
                 ChainStore<Q, kShare>{overlay, dst, H, W, tables, p});
}

// The tail alone, on an already blurred image (the large-radius route).
template <bool kShare>
__global__ void __launch_bounds__(kThreads)
chain_tail_kernel(const uint32_t* __restrict__ blurred, const uint32_t* __restrict__ overlay,
                  uint32_t* __restrict__ dst, const uint8_t* __restrict__ levels_lut, size_t n,
                  ChainParams p) {
  __shared__ float f[kChainTables * kUnitEntries];
  const ChainTables tables{f, f + kUnitEntries, f + 2 * kUnitEntries};
  static_assert(kThreads == kUnitEntries, "one table entry a thread");
  fill_tables(tables, levels_lut, p);
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the blurred bytes as exact f32: round_byte leaves them as they are
  dst[i] = chain_tail<kShare>(u8x4_to_f32(__ldg(blurred + i)), __ldg(overlay + i), tables, p);
}

// Counts, over every u8 (base, base alpha, overlay, overlay alpha) at one
// opacity, the quotients of the tail's soft-light Porter-Duff that differ
// from __fdiv_rn (counts[0]) among those compared (counts[1]: three a pixel
// with a nonzero result alpha), dispatched as the chain dispatches: div3's
// shared reciprocal at opacities of at least kShareMinOpacity, three
// __fdiv_rn below.  The three channels of a thread take (b, t),
// (255 - b, t) and (b, 255 - t).
__global__ void __launch_bounds__(kThreads)
chain_div_check_kernel(float opacity, unsigned long long* counts) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;  // 2^24 threads
  const int b = i & 0xFFu, t = (i >> 16) & 0xFFu;
  const float bf[3] = {unit_entry(b), unit_entry(255 - b), unit_entry(b)};
  const float d[3] = {soft_light_d(bf[0]), soft_light_d(bf[1]), soft_light_d(bf[2])};
  const float tf[3] = {unit_entry(t), unit_entry(t), unit_entry(255 - t)};
  const float base_a = unit_entry((i >> 8) & 0xFFu);
  const bool share = opacity >= kShareMinOpacity;
  unsigned long long differ = 0, compared = 0;
  for (int a = 1; a < 256; ++a) {  // overlay alpha 0 never reaches a divide
    float num[3], q[3];
    const float out_a = soft_light_over(bf, d, base_a, tf, unit_entry(a) * opacity, num);
    if (out_a == 0.0f) continue;
    if (share) {
      div3<false>(num, out_a, q);
    } else {
      div3<true>(num, out_a, q);
    }
    compared += 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      differ += __float_as_uint(q[c]) != __float_as_uint(__fdiv_rn(num[c], out_a));
    }
  }
  atomicAdd(counts, differ);
  atomicAdd(counts + 1, compared);
}

template <int Q, int kMinBlocks, bool kShare>
cudaError_t launch_chain(const uint32_t* src, const uint32_t* overlay, uint32_t* dst,
                         const float* taps, const uint8_t* levels, int H, int W, int r, int nt,
                         int th, int chunk, size_t smem, const ChainParams& p, cudaStream_t s) {
  auto* kernel = chain_tiled_kernel<Q, kMinBlocks, kShare>;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBlurMaxSmem));
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + th - 1) / th, 1);
  kernel<<<grid, kThreads, smem, s>>>(src, overlay, dst, taps, levels, H, W, r, nt, th, chunk, p);
  return cudaGetLastError();
}

}  // namespace pfe

extern "C" {

// The entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  Images are u8 [H, W, 4] as u32 [H, W]; `taps` (nt f32) and
// `levels` (256 u8) lie in device memory; `params` points to five f32 on
// the host (brightness, bc_factor, sep_s, sep_inv, opacity).  The tiled
// one runs th-row tiles of q (8 or 4) sums a thread (ops/kernels.py
// chain_tile_rows and blur_sums choose both from the radius).

int pfe_chain_tiled(const void* src, const void* overlay, void* dst, int H, int W,
                    const void* taps, int nt, int th, int q, const void* levels,
                    const float* params, void* stream) {
  using namespace pfe;
  const int r = nt / 2;
  const size_t tables = chain_tables_bytes(nt);
  const int chunk = blur_chunk_rows(th, r, tables);
  const size_t smem = blur_tile_bytes(th, r, tables);
  if (nt < 1 || nt % 2 == 0 || (q != 8 && q != 4) || th < q || th % q != 0 || chunk < 1 ||
      smem > kBlurMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChainParams p{params[0], params[1], params[2], params[3], params[4]};
  const auto* in = static_cast<const uint32_t*>(src);
  const auto* ov = static_cast<const uint32_t*>(overlay);
  auto* out = static_cast<uint32_t*>(dst);
  const auto* t = static_cast<const float*>(taps);
  const auto* lv = static_cast<const uint8_t*>(levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.opacity >= kShareMinOpacity) {
    e = q == 8 ? launch_chain<8, 2, true>(in, ov, out, t, lv, H, W, r, nt, th, chunk, smem, p, s)
               : launch_chain<4, 4, true>(in, ov, out, t, lv, H, W, r, nt, th, chunk, smem, p, s);
  } else {
    e = q == 8 ? launch_chain<8, 2, false>(in, ov, out, t, lv, H, W, r, nt, th, chunk, smem, p, s)
               : launch_chain<4, 4, false>(in, ov, out, t, lv, H, W, r, nt, th, chunk, smem, p, s);
  }
  return static_cast<int>(e);
}

int pfe_chain_tail(const void* blurred, const void* overlay, void* dst, int H, int W,
                   const void* levels, const float* params, void* stream) {
  using namespace pfe;
  const ChainParams p{params[0], params[1], params[2], params[3], params[4]};
  const size_t n = static_cast<size_t>(H) * W;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const auto* in = static_cast<const uint32_t*>(blurred);
  const auto* ov = static_cast<const uint32_t*>(overlay);
  auto* out = static_cast<uint32_t*>(dst);
  const auto* lv = static_cast<const uint8_t*>(levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.opacity >= kShareMinOpacity) {
    chain_tail_kernel<true><<<blocks, kThreads, 0, s>>>(in, ov, out, lv, n, p);
  } else {
    chain_tail_kernel<false><<<blocks, kThreads, 0, s>>>(in, ov, out, lv, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts[0]: quotients that differ, counts[1]: quotients compared, over the
// 2^24 x 255 u8 inputs of chain_div_check_kernel at one opacity; counts is
// two u64 in device memory, zeroed by the caller.
int pfe_chain_div_check(float opacity, void* counts, void* stream) {
  using namespace pfe;
  chain_div_check_kernel<<<(1u << 24) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      opacity, static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
