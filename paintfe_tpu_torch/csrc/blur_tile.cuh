// Shared pieces of the tiled separable Gaussian (K-blur) and the fused
// chain (K-chain): the tap table, index clamping and pixel unpacking, the
// two passes of K-chain's tile, and K-blur's staged, register-blocked tile.
//
// Numerics (bit-exact with the JAX package's _gaussian_fn and its Pallas
// kernels): taps are f32 from gaussian_kernel(); the H pass sums
// tap * pixel in tap order starting from 0 (0 + t0*x0 == t0*x0), then the
// V pass does the same over the H sums; edges replicate by clamping the
// row and column index; the result rounds as floor(x + 0.5) clipped to
// [0, 255].  The file is compiled with -fmad=false, so no multiply-add is
// contracted into an FMA, and without fast-math, so division and sqrtf are
// correctly rounded.
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace pfe {

// Output tile width in pixels: one warp reads one 128-byte row segment.
constexpr int kTileW = 32;
constexpr int kThreads = 256;
// Tap table of the tiled kernels.  A tile only fits shared memory up to a
// radius of (232448 / (kTileW * 16) - 8) / 2 = 223, i.e. 447 taps; larger
// radii take the split kernels, which read their taps from device memory.
constexpr int kMaxConstTaps = 512;

// `static`: every translation unit owns its table, set before each launch
// on the launching stream.
static __constant__ float c_taps[kMaxConstTaps];

// Shared memory of one tile's H-pass sums: th output rows plus the 2r-row
// halo, kTileW float4 each.  The wrapper (ops/kernels.py tile_rows) picks
// th so that this fits the 227 KB a block may use.
inline size_t tile_smem_bytes(int th, int r) {
  return static_cast<size_t>(th + 2 * r) * kTileW * sizeof(float4);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float4 unpack(uint32_t p) {
  return make_float4(static_cast<float>(p & 0xFFu),
                     static_cast<float>((p >> 8) & 0xFFu),
                     static_cast<float>((p >> 16) & 0xFFu),
                     static_cast<float>(p >> 24));
}

__device__ __forceinline__ float round_u8f(float x) {
  return fminf(fmaxf(floorf(x + 0.5f), 0.0f), 255.0f);
}

__device__ __forceinline__ uint32_t pack(float r, float g, float b, float a) {
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) |
         (static_cast<uint32_t>(b) << 16) | (static_cast<uint32_t>(a) << 24);
}

// acc += v * t, channel by channel, as separate IEEE multiply and add.
__device__ __forceinline__ void mac(float4& acc, float4 v, float t) {
  acc.x = acc.x + v.x * t;
  acc.y = acc.y + v.y * t;
  acc.z = acc.z + v.z * t;
  acc.w = acc.w + v.w * t;
}

// H pass of one tile: rows y0-r .. y0+th+r-1 (row index clamped), columns
// x0 .. x0+kTileW-1, into hs[(th + 2r) * kTileW] in shared memory.
__device__ __forceinline__ void h_pass_tile(const uint32_t* __restrict__ img,
                                            float4* hs, int H, int W, int x0,
                                            int y0, int th, int r, int nt) {
  const int rows = th + 2 * r;
  for (int i = threadIdx.x; i < rows * kTileW; i += blockDim.x) {
    const int row = i / kTileW;
    const int col = i - row * kTileW;
    const int gy = clampi(y0 - r + row, 0, H - 1);
    const int gx = x0 + col;
    const uint32_t* line = img + static_cast<size_t>(gy) * W;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < nt; ++k) {
      mac(acc, unpack(__ldg(line + clampi(gx - r + k, 0, W - 1))), c_taps[k]);
    }
    hs[i] = acc;
  }
}

// V pass of one output pixel of the tile from the H sums, rounded.
__device__ __forceinline__ float4 v_pass_pixel(const float4* hs, int row,
                                               int col, int nt) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < nt; ++k) {
    mac(acc, hs[(row + k) * kTileW + col], c_taps[k]);
  }
  return make_float4(round_u8f(acc.x), round_u8f(acc.y), round_u8f(acc.z),
                     round_u8f(acc.w));
}

// ---------------------------------------------------------------------------
// The staged tile (K-blur): the block's source region staged once in shared
// memory, both passes register-blocked.  K-chain still runs the tile above.
//
// A tile is kTileW output columns by th output rows (th a multiple of Q).
// Its th + 2r source rows are staged with cp.async, in as few chunks as
// shared memory allows, as u32 pixels, kTileW + 2r of them a row (clamped to
// the image when staged), at an odd pitch so that 32 lanes reading 32 rows
// hit 32 banks.  The H pass writes th + 2r rows of kTileW float4 sums, the
// column XOR-swizzled by the row so that eight lanes writing eight rows hit
// distinct banks; the V pass reads them back along rows.  A thread of
// either pass computes Q adjacent sums from a register window, so a value
// it loads serves up to Q sums.  Q is 8, or 4 for short tap counts, where
// fewer registers let twice the blocks share an SM (ops/kernels.py
// blur_sums).
// ---------------------------------------------------------------------------

constexpr size_t kBlurMaxSmem = 232448;  // bytes of shared memory a block may use

__host__ __device__ __forceinline__ int blur_src_pitch(int r) {
  return (kTileW + 2 * r) | 1;
}

inline size_t blur_sums_bytes(int th, int r) {
  return static_cast<size_t>(th + 2 * r) * kTileW * sizeof(float4);
}

// Source rows staged at once: as many as fit beside the sums, spread evenly
// over the chunks; 0 if not one row fits.  (ops/kernels.py mirrors it.)
inline int blur_chunk_rows(int th, int r) {
  const size_t sums = blur_sums_bytes(th, r);
  if (sums >= kBlurMaxSmem) return 0;
  const int rows = th + 2 * r;
  const long long room = static_cast<long long>(
      (kBlurMaxSmem - sums) / (blur_src_pitch(r) * sizeof(uint32_t)));
  if (room < 1) return 0;
  const long long chunks = (rows + room - 1) / room;
  return static_cast<int>((rows + chunks - 1) / chunks);
}

inline size_t blur_tile_bytes(int th, int r) {
  return blur_sums_bytes(th, r) + static_cast<size_t>(blur_chunk_rows(th, r)) *
                                      blur_src_pitch(r) * sizeof(uint32_t);
}

__device__ __forceinline__ int swizzle(int row, int col) {
  return row * kTileW + (col ^ (row & 7));
}

// u8 RGBA to four f32, exactly: 0x4B0000bb is 2^23 + bb as an f32, and
// subtracting 2^23 is exact.
__device__ __forceinline__ float4 u8x4_to_f32(uint32_t p) {
  const float base = 8388608.0f;
  return make_float4(__uint_as_float(__byte_perm(p, 0x4B000000u, 0x7540)) - base,
                     __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7541)) - base,
                     __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7542)) - base,
                     __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7543)) - base);
}

// round_u8f of each channel, packed, on the f32 pipe alone: y + 2^23
// rounded down holds floor(y) in its low bits for 0 <= y < 2^23 (floorf
// and the f32 -> u32 conversion take the 16-lane conversion pipe).
__device__ __forceinline__ uint32_t round_byte(float x) {
  return __float_as_uint(__fadd_rd(fminf(fmaxf(x + 0.5f, 0.0f), 255.0f), 8388608.0f));
}

__device__ __forceinline__ uint32_t round_pack(float4 v) {
  return __byte_perm(__byte_perm(round_byte(v.x), round_byte(v.y), 0x0040),
                     __byte_perm(round_byte(v.z), round_byte(v.w), 0x0040), 0x5410);
}

// Tap kb + kk into the Q sums, whose window values kb+q .. kb+q+Q-1 are
// cur[q..] then nxt[..].
template <int Q>
__device__ __forceinline__ void tap(const float4 (&cur)[Q], const float4 (&nxt)[Q],
                                    int kb, int kk, float4 (&acc)[Q]) {
  const float t = c_taps[kb + kk];
#pragma unroll
  for (int q = 0; q < Q; ++q) mac(acc[q], q + kk < Q ? cur[q + kk] : nxt[q + kk - Q], t);
}

// Taps kb .. kb+Q-1 (those below nt; kb < nt) into the Q sums, each sum
// taking its taps in order.  nxt is converted from nxt_raw after tap kb,
// which needs cur alone, so that the loads behind nxt_raw have that tap's
// time to arrive; a block of Q whole taps runs without a test a tap.
template <int Q, typename Raw, typename Cvt>
__device__ __forceinline__ void taps_block(const float4 (&cur)[Q], float4 (&nxt)[Q],
                                           const Raw (&nxt_raw)[Q], const Cvt& cvt,
                                           int kb, int nt, float4 (&acc)[Q]) {
  tap(cur, nxt, kb, 0, acc);
#pragma unroll
  for (int q = 0; q < Q; ++q) nxt[q] = cvt(nxt_raw[q]);
  if (kb + Q <= nt) {
#pragma unroll
    for (int kk = 1; kk < Q; ++kk) tap(cur, nxt, kb, kk, acc);
  } else {
#pragma unroll
    for (int kk = 1; kk < Q; ++kk) {
      if (kb + kk < nt) tap(cur, nxt, kb, kk, acc);
    }
  }
}

// acc[q] = sum over k < nt, in order, of c_taps[k] * cvt(fetch(q + k)),
// from 0: Q sums from a window of values fetch(j), each fetched and
// converted once.
template <int Q, typename Fetch, typename Cvt>
__device__ __forceinline__ void conv_run(const Fetch& fetch, const Cvt& cvt, int nt,
                                         float4 (&acc)[Q]) {
  float4 a[Q], b[Q];
  decltype(fetch(0)) raw[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a[q] = cvt(fetch(q));
  }
  for (int kb = 0; kb < nt; kb += 2 * Q) {
#pragma unroll
    for (int q = 0; q < Q; ++q) raw[q] = fetch(kb + Q + q);
    taps_block(a, b, raw, cvt, kb, nt, acc);
    if (kb + Q >= nt) break;
#pragma unroll
    for (int q = 0; q < Q; ++q) raw[q] = fetch(kb + 2 * Q + q);
    taps_block(b, a, raw, cvt, kb + Q, nt, acc);
  }
}

// Stage the tile's source rows chunk by chunk and write their H sums into
// hs[(th + 2r) * kTileW] (swizzled).  Ends with a __syncthreads().
template <int Q>
__device__ __forceinline__ void blur_h_pass(const uint32_t* __restrict__ img, float4* hs,
                                            uint32_t* src, int H, int W, int x0, int y0,
                                            int th, int r, int nt, int chunk) {
  const int rows = th + 2 * r;
  const int width = kTileW + 2 * r;
  const int pitch = blur_src_pitch(r);
  const int lane = threadIdx.x & 31;
  constexpr int kRuns = kTileW / Q;
  for (int c0 = 0; c0 < rows; c0 += chunk) {
    const int n = min(chunk, rows - c0);
    for (int row = threadIdx.x >> 5; row < n; row += blockDim.x >> 5) {
      const uint32_t* line =
          img + static_cast<size_t>(clampi(y0 - r + c0 + row, 0, H - 1)) * W;
      for (int col = lane; col < width; col += 32) {
        __pipeline_memcpy_async(src + row * pitch + col,
                                line + clampi(x0 - r + col, 0, W - 1), sizeof(uint32_t));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int it = threadIdx.x; it < n * kRuns; it += blockDim.x) {
      const int row = it % n;  // a warp takes consecutive rows
      const int col0 = (it / n) * Q;
      const uint32_t* line = src + row * pitch;
      float4 acc[Q];
      conv_run<Q>([&](int j) { return line[min(col0 + j, width - 1)]; },
                  [](uint32_t p) { return u8x4_to_f32(p); }, nt, acc);
#pragma unroll
      for (int q = 0; q < Q; ++q) hs[swizzle(c0 + row, col0 + q)] = acc[q];
    }
    __syncthreads();
  }
}

// V pass of the tile from the H sums: Q vertically adjacent outputs a
// thread, rounded and packed into dst (rows y0.., columns x0..).
template <int Q>
__device__ __forceinline__ void blur_v_pass(const float4* hs, uint32_t* __restrict__ dst,
                                            int H, int W, int x0, int y0, int th, int r,
                                            int nt) {
  const int rows = th + 2 * r;
  for (int it = threadIdx.x; it < th / Q * kTileW; it += blockDim.x) {
    const int col = it % kTileW;  // a warp takes consecutive columns
    const int row0 = (it / kTileW) * Q;
    float4 acc[Q];
    conv_run<Q>([&](int j) { return hs[swizzle(min(row0 + j, rows - 1), col)]; },
                [](float4 v) { return v; }, nt, acc);
    const int gx = x0 + col;
    if (gx >= W) continue;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int gy = y0 + row0 + q;
      if (gy < H) dst[static_cast<size_t>(gy) * W + gx] = round_pack(acc[q]);
    }
  }
}

}  // namespace pfe
