// K-warp: the bilinear gather out[y, x] = bilerp(src, sx[y, x], sy[y, x])
// of u8 RGBA images at f32 source coordinates.
//
// Replaces the Pallas kernel gather_bilinear_u8 / gather_bilinear_u8_planned
// (paintfe_tpu/ops/warp_kernel.py, _make_kernel and _launch).  A TPU has no
// per-lane gather, so that kernel swept a DMA'd source window with sublane
// shuffles, planned per tile with buckets, and fell back to XLA for fields
// it could not plan.  A GPU thread gathers directly (four u32 taps a pixel
// through the read-only cache), so there is no planner, no bucket and no
// fallback.
//
// Numerics follow the two oracles bit for bit (compiled with -fmad=false,
// so every product and sum rounds separately, in the oracle's order):
//   mode zero  (ops/transform._bilinear_gather_zero): taps outside the
//     source are 0, two lerps along x then one along y, round half up;
//     a pixel whose x0 < -1, y0 < -1, x0 >= Ws or y0 >= Hs is 0.
//   mode clamp (effects/distort.sample_bilinear + round_u8): taps clamped
//     to the edge, product weights p00 (1-fx)(1-fy) + p10 fx (1-fy)
//     + p01 (1-fx) fy + p11 fx fy summed left to right, round half up.
// Not the texture unit: its bilinear weights are 8-bit fixed point.
//
// Coordinates are meant finite and within +-2^24.  Beyond that the float
// to int conversion saturates (cvt.rzi), and a NaN coordinate converts to
// 0 and gives 0 channels; XLA and torch on the CPU may do otherwise there.
//
// What bounds it on the H100: memory, two f32 field reads and one u32
// write a pixel, and the source once (its taps mostly from L1/L2 for
// smooth fields): 132.7 MB per 3840x2160 frame.  The first design (one
// thread a pixel, 64-bit indices) issued about 30 operations a pixel on the
// SM's 16-lane conversion pipe (int -> float of each tap channel, floorf
// and float -> int in the rounding and the coordinates), about 0.065 ms a
// 4K frame of that pipe alone, above the byte bound.  Here:
//  - the taps convert with u8x4_to_f32 and round with round_pack
//    (u8_pixel.cuh, shared with K-blur), on the integer and f32 pipes;
//    mode zero zeroes a tap outside the source after the conversion, with
//    a select, and an outside pixel is a select too;
//  - the fraction subtracts floorf's own value (saturated as the
//    conversion saturates) instead of converting the integer back;
//  - a thread computes kPx = 4 horizontally adjacent pixels: one float4
//    load of each field and one uint4 store where the row width is a
//    multiple of 4 and the fields and the output are 16-byte aligned (the
//    wrapper decides, ops/warp_kernel.warp_split), else 4-byte accesses and
//    a tail group of W % 4 pixels through the same pixel code;
//  - blocks are 2-D (32 x 4 pixels wide, 8 rows), so for a smooth field a
//    warp's taps fall on two or three source rows and a block's on a few
//    more, which L1 keeps;
//  - the fields and the output, touched once, load and store evict-first
//    (ld/st.global.cs), so that L2 keeps the source for the taps (a field
//    that reads its taps anywhere in a 4K source reads them from L2).
#include <cstdint>
#include <cuda_runtime.h>

#include "u8_pixel.cuh"

namespace pfe_warp {

using pfe::round_pack;
using pfe::u8x4_to_f32;

constexpr int kPx = 4;                        // pixels a thread (ops/warp_kernel.WARP_PX)
constexpr int kBlockX = 32, kBlockY = 8;      // threads a block: one warp a row
constexpr float kIntMin = -2147483648.0f;     // the int32 range as f32: -2^31
constexpr float kIntMax = 2147483648.0f;      // float(INT_MAX) rounds to 2^31

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float4 select4(bool keep, float4 v) {
  return make_float4(keep ? v.x : 0.0f, keep ? v.y : 0.0f, keep ? v.z : 0.0f,
                     keep ? v.w : 0.0f);
}

// a + (b - a) * f, channel by channel.
__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(a.x + (b.x - a.x) * f, a.y + (b.y - a.y) * f, a.z + (b.z - a.z) * f,
                     a.w + (b.w - a.w) * f);
}

// p00 gx gy + p10 fx gy + p01 gx fy + p11 fx fy, channel by channel.
__device__ __forceinline__ float4 weigh4(float4 a, float4 b, float4 c, float4 d, float fx,
                                         float fy, float gx, float gy) {
  return make_float4(a.x * gx * gy + b.x * fx * gy + c.x * gx * fy + d.x * fx * fy,
                     a.y * gx * gy + b.y * fx * gy + c.y * gx * fy + d.y * fx * fy,
                     a.z * gx * gy + b.z * fx * gy + c.z * gx * fy + d.z * fx * fy,
                     a.w * gx * gy + b.w * fx * gy + c.w * gx * fy + d.w * fx * fy);
}

// One output pixel at source coordinates (fxs, fys).
template <bool kZero>
__device__ __forceinline__ uint32_t warp_pixel(const uint32_t* __restrict__ img, float fxs,
                                               float fys, int Hs, int Ws) {
  const float flx = floorf(fxs), fly = floorf(fys);
  const int x0 = static_cast<int>(flx);
  const int y0 = static_cast<int>(fly);
  // wrapping +1, as the oracles' int32 add does
  const int x1 = static_cast<int>(static_cast<unsigned>(x0) + 1u);
  const int y1 = static_cast<int>(static_cast<unsigned>(y0) + 1u);
  // fxs - float(x0): floorf's value where it converts exactly, its
  // saturated value where the conversion saturates (NaN stays NaN)
  const float fx = fxs - fminf(fmaxf(flx, kIntMin), kIntMax);
  const float fy = fys - fminf(fmaxf(fly, kIntMin), kIntMax);
  const int cx0 = clampi(x0, 0, Ws - 1), cx1 = clampi(x1, 0, Ws - 1);
  const uint32_t* row0 = img + static_cast<size_t>(clampi(y0, 0, Hs - 1)) * Ws;
  const uint32_t* row1 = img + static_cast<size_t>(clampi(y1, 0, Hs - 1)) * Ws;
  const float4 p00 = u8x4_to_f32(__ldg(row0 + cx0)), p10 = u8x4_to_f32(__ldg(row0 + cx1));
  const float4 p01 = u8x4_to_f32(__ldg(row1 + cx0)), p11 = u8x4_to_f32(__ldg(row1 + cx1));
  if constexpr (kZero) {
    const bool in_x0 = x0 >= 0 && x0 < Ws, in_x1 = x1 >= 0 && x1 < Ws;
    const bool in_y0 = y0 >= 0 && y0 < Hs, in_y1 = y1 >= 0 && y1 < Hs;
    const float4 top = lerp4(select4(in_x0 && in_y0, p00), select4(in_x1 && in_y0, p10), fx);
    const float4 bot = lerp4(select4(in_x0 && in_y1, p01), select4(in_x1 && in_y1, p11), fx);
    const uint32_t q = round_pack(lerp4(top, bot, fy));
    return x0 < -1 || y0 < -1 || x0 >= Ws || y0 >= Hs ? 0u : q;
  } else {
    return round_pack(weigh4(p00, p10, p01, p11, fx, fy, 1.0f - fx, 1.0f - fy));
  }
}

// kPx adjacent pixels of one output row a thread, of one image of the
// batch (blockIdx.z): the field is shared by the batch.  kVec: W % kPx == 0
// and sx, sy, dst 16-byte aligned, so a group is one float4 load a field
// and one uint4 store; otherwise 4-byte accesses, and the last group of a
// row holds W % kPx pixels.
template <bool kZero, bool kVec>
__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_kernel(const uint32_t* __restrict__ src, const float* __restrict__ sx,
            const float* __restrict__ sy, uint32_t* __restrict__ dst, int Hs, int Ws, int H,
            int W) {
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = (blockIdx.x * kBlockX + threadIdx.x) * kPx;
  if (y >= H || x >= W) return;
  const uint32_t* img = src + blockIdx.z * static_cast<size_t>(Hs) * Ws;
  const size_t o = static_cast<size_t>(y) * W + x;
  uint32_t* out = dst + blockIdx.z * static_cast<size_t>(H) * W + o;
  float fx[kPx], fy[kPx];
  uint32_t q[kPx];
  if constexpr (kVec) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(sx + o));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(sy + o));
    fx[0] = a.x; fx[1] = a.y; fx[2] = a.z; fx[3] = a.w;
    fy[0] = b.x; fy[1] = b.y; fy[2] = b.z; fy[3] = b.w;
#pragma unroll
    for (int j = 0; j < kPx; ++j) q[j] = warp_pixel<kZero>(img, fx[j], fy[j], Hs, Ws);
    __stcs(reinterpret_cast<uint4*>(out), make_uint4(q[0], q[1], q[2], q[3]));
  } else {
    const int count = min(kPx, W - x);
    // a tail group's missing pixels read coordinate 0, a valid tap, and are
    // not stored
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      fx[j] = j < count ? __ldcs(sx + o + j) : 0.0f;
      fy[j] = j < count ? __ldcs(sy + o + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPx; ++j) q[j] = warp_pixel<kZero>(img, fx[j], fy[j], Hs, Ws);
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      if (j < count) __stcs(out + j, q[j]);
    }
  }
}

template <bool kZero>
cudaError_t launch(bool vec, dim3 grid, cudaStream_t s, const uint32_t* src, const float* sx,
                   const float* sy, uint32_t* dst, int Hs, int Ws, int H, int W) {
  const dim3 block(kBlockX, kBlockY);
  if (vec) {
    warp_kernel<kZero, true><<<grid, block, 0, s>>>(src, sx, sy, dst, Hs, Ws, H, W);
  } else {
    warp_kernel<kZero, false><<<grid, block, 0, s>>>(src, sx, sy, dst, Hs, Ws, H, W);
  }
  return cudaGetLastError();
}

}  // namespace pfe_warp

extern "C" {

// src: u8 [B, Hs, Ws, 4] as u32; sx, sy: f32 [H, W]; dst: u8 [B, H, W, 4]
// as u32.  mode 0 = zero, 1 = clamp.  vec 1 takes the 16-byte path, which
// needs W % 4 == 0 and sx, sy, dst 16-byte aligned (ops/warp_kernel.py
// warp_split); vec 0 the 4-byte one, which takes any W.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int pfe_warp_bilinear(const void* src, const void* sx, const void* sy, void* dst, int B,
                      int Hs, int Ws, int H, int W, int mode, int vec, void* stream) {
  using namespace pfe_warp;
  const uintptr_t low_bits = reinterpret_cast<uintptr_t>(sx) | reinterpret_cast<uintptr_t>(sy) |
                             reinterpret_cast<uintptr_t>(dst);
  const long long rows = (static_cast<long long>(H) + kBlockY - 1) / kBlockY;
  if (B < 1 || B > 65535 || Hs < 1 || Ws < 1 || H < 1 || W < 1 || rows > 65535 ||
      (mode != 0 && mode != 1) || (vec != 0 && vec != 1) ||
      (vec && (W % kPx != 0 || low_bits % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (W + kPx - 1) / kPx;
  const dim3 grid((groups + kBlockX - 1) / kBlockX, static_cast<unsigned>(rows), B);
  const uint32_t* in = static_cast<const uint32_t*>(src);
  const float* fx = static_cast<const float*>(sx);
  const float* fy = static_cast<const float*>(sy);
  uint32_t* out = static_cast<uint32_t*>(dst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = mode == 0 ? launch<true>(vec, grid, s, in, fx, fy, out, Hs, Ws, H, W)
                                  : launch<false>(vec, grid, s, in, fx, fy, out, Hs, Ws, H, W);
  return static_cast<int>(e);
}

}  // extern "C"
