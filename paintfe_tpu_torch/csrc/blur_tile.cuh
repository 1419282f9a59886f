// Shared pieces of the tiled separable Gaussian (K-blur) and the fused
// chain (K-chain): the staged, register-blocked tile both kernels run, and
// the index clamp and multiply-add K-blur's split route also uses.
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

#include "u8_pixel.cuh"

namespace pfe {

// Output tile width in pixels: one warp reads one 128-byte row segment.
constexpr int kTileW = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// acc += v * t, channel by channel, as separate IEEE multiply and add.
__device__ __forceinline__ void mac(float4& acc, float4 v, float t) {
  acc.x = acc.x + v.x * t;
  acc.y = acc.y + v.y * t;
  acc.z = acc.z + v.z * t;
  acc.w = acc.w + v.w * t;
}

// ---------------------------------------------------------------------------
// The staged tile (K-blur and K-chain): the block's source region staged
// once in shared memory, both passes register-blocked.
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
// blur_sums).  The taps come through an accessor (K-blur's constant table,
// K-chain's copy in shared memory) and the V pass hands each sum to an
// epilogue (K-blur's rounding store, K-chain's pointwise tail).
// ---------------------------------------------------------------------------

constexpr size_t kBlurMaxSmem = 232448;  // bytes of shared memory a block may use

__host__ __device__ __forceinline__ int blur_src_pitch(int r) {
  return (kTileW + 2 * r) | 1;
}

inline size_t blur_sums_bytes(int th, int r) {
  return static_cast<size_t>(th + 2 * r) * kTileW * sizeof(float4);
}

// Source rows staged at once: as many as fit beside the sums and `reserved`
// bytes of the kernel's own tables, spread evenly over the chunks; 0 if not
// one row fits.  (ops/kernels.py mirrors it.)
inline int blur_chunk_rows(int th, int r, size_t reserved = 0) {
  const size_t used = blur_sums_bytes(th, r) + reserved;
  if (used >= kBlurMaxSmem) return 0;
  const int rows = th + 2 * r;
  const long long room = static_cast<long long>(
      (kBlurMaxSmem - used) / (blur_src_pitch(r) * sizeof(uint32_t)));
  if (room < 1) return 0;
  const long long chunks = (rows + room - 1) / room;
  return static_cast<int>((rows + chunks - 1) / chunks);
}

// The tile's shared memory: the tables, the sums and the staged rows.
inline size_t blur_tile_bytes(int th, int r, size_t reserved = 0) {
  return reserved + blur_sums_bytes(th, r) +
         static_cast<size_t>(blur_chunk_rows(th, r, reserved)) * blur_src_pitch(r) *
             sizeof(uint32_t);
}

__device__ __forceinline__ int swizzle(int row, int col) {
  return row * kTileW + (col ^ (row & 7));
}

// Tap kb + kk into the Q sums, whose window values kb+q .. kb+q+Q-1 are
// cur[q..] then nxt[..].
template <int Q, typename Taps>
__device__ __forceinline__ void tap(const float4 (&cur)[Q], const float4 (&nxt)[Q],
                                    const Taps& taps, int kb, int kk, float4 (&acc)[Q]) {
  const float t = taps(kb + kk);
#pragma unroll
  for (int q = 0; q < Q; ++q) mac(acc[q], q + kk < Q ? cur[q + kk] : nxt[q + kk - Q], t);
}

// Taps kb .. kb+Q-1 (those below nt; kb < nt) into the Q sums, each sum
// taking its taps in order.  nxt is converted from nxt_raw after tap kb,
// which needs cur alone, so that the loads behind nxt_raw have that tap's
// time to arrive; a block of Q whole taps runs without a test a tap.
template <int Q, typename Raw, typename Cvt, typename Taps>
__device__ __forceinline__ void taps_block(const float4 (&cur)[Q], float4 (&nxt)[Q],
                                           const Raw (&nxt_raw)[Q], const Cvt& cvt,
                                           const Taps& taps, int kb, int nt,
                                           float4 (&acc)[Q]) {
  tap(cur, nxt, taps, kb, 0, acc);
#pragma unroll
  for (int q = 0; q < Q; ++q) nxt[q] = cvt(nxt_raw[q]);
  if (kb + Q <= nt) {
#pragma unroll
    for (int kk = 1; kk < Q; ++kk) tap(cur, nxt, taps, kb, kk, acc);
  } else {
#pragma unroll
    for (int kk = 1; kk < Q; ++kk) {
      if (kb + kk < nt) tap(cur, nxt, taps, kb, kk, acc);
    }
  }
}

// acc[q] = sum over k < nt, in order, of taps(k) * cvt(fetch(q + k)),
// from 0: Q sums from a window of values fetch(j), each fetched and
// converted once.
template <int Q, typename Fetch, typename Cvt, typename Taps>
__device__ __forceinline__ void conv_run(const Fetch& fetch, const Cvt& cvt, const Taps& taps,
                                         int nt, float4 (&acc)[Q]) {
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
    taps_block(a, b, raw, cvt, taps, kb, nt, acc);
    if (kb + Q >= nt) break;
#pragma unroll
    for (int q = 0; q < Q; ++q) raw[q] = fetch(kb + 2 * Q + q);
    taps_block(b, a, raw, cvt, taps, kb + Q, nt, acc);
  }
}

// Stage the tile's source rows chunk by chunk and write their H sums into
// hs[(th + 2r) * kTileW] (swizzled).  Ends with a __syncthreads(); shared
// memory a thread wrote before the call is visible to every thread from the
// first sum on.
template <int Q, typename Taps>
__device__ __forceinline__ void blur_h_pass(const uint32_t* __restrict__ img, float4* hs,
                                            uint32_t* src, int H, int W, int x0, int y0,
                                            int th, int r, int nt, int chunk,
                                            const Taps& taps) {
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
                  [](uint32_t p) { return u8x4_to_f32(p); }, taps, nt, acc);
#pragma unroll
      for (int q = 0; q < Q; ++q) hs[swizzle(c0 + row, col0 + q)] = acc[q];
    }
    __syncthreads();
  }
}

// V pass of the tile from the H sums: Q vertically adjacent outputs a
// thread (rows y0.., columns x0..).  Before the sums, epi.load(gx, gy0)
// fetches what the epilogue needs of the Q pixels (column gx, rows gy0..);
// then epi.store(sum, offset, loaded, q) finishes each pixel inside the
// image, at offset gy * W + gx.
template <int Q, typename Taps, typename Epi>
__device__ __forceinline__ void blur_v_pass(const float4* hs, int H, int W, int x0, int y0,
                                            int th, int r, int nt, const Taps& taps,
                                            const Epi& epi) {
  const int rows = th + 2 * r;
  for (int it = threadIdx.x; it < th / Q * kTileW; it += blockDim.x) {
    const int col = it % kTileW;  // a warp takes consecutive columns
    const int row0 = (it / kTileW) * Q;
    const auto loaded = epi.load(x0 + col, y0 + row0);
    float4 acc[Q];
    conv_run<Q>([&](int j) { return hs[swizzle(min(row0 + j, rows - 1), col)]; },
                [](float4 v) { return v; }, taps, nt, acc);
    const int gx = x0 + col;
    if (gx >= W) continue;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int gy = y0 + row0 + q;
      if (gy < H) epi.store(acc[q], static_cast<size_t>(gy) * W + gx, loaded, q);
    }
  }
}

}  // namespace pfe
