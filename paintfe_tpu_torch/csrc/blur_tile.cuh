// Shared pieces of the tiled separable Gaussian (K-blur) and the fused
// chain (K-chain): the tap table, index clamping, pixel unpacking and the
// two passes of one output tile.
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

}  // namespace pfe
