// K-warp: the bilinear gather out[y, x] = bilerp(src, sx[y, x], sy[y, x])
// of u8 RGBA images at f32 source coordinates.
//
// Replaces the Pallas kernel gather_bilinear_u8 / gather_bilinear_u8_planned
// (paintfe_tpu/ops/warp_kernel.py, _make_kernel and _launch).  A TPU has no
// per-lane gather, so that kernel swept a DMA'd source window with sublane
// shuffles, planned per tile with buckets, and fell back to XLA for fields
// it could not plan.  A GPU thread gathers directly: one thread per output
// pixel makes four u32 loads (one per RGBA tap, through the read-only
// cache), so there is no planner, no bucket and no fallback.
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
// What bounds it on the H100: memory, one u32 source read per tap (mostly
// from L1/L2 for smooth fields), two f32 field reads and one u32 write per
// pixel: 132.7 MB per 3840x2160 frame.
#include <cstdint>
#include <cuda_runtime.h>

namespace pfe_warp {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float chan(uint32_t p, int c) {
  return static_cast<float>((p >> (8 * c)) & 0xFFu);
}

__device__ __forceinline__ uint32_t round_u8(float v) {
  return static_cast<uint32_t>(fminf(fmaxf(floorf(v + 0.5f), 0.0f), 255.0f));
}

// One thread per output pixel of one image (blockIdx.y): the field is
// shared by the batch.
template <bool kZero>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const uint32_t* __restrict__ src, const float* __restrict__ sx,
            const float* __restrict__ sy, uint32_t* __restrict__ dst, int Hs,
            int Ws, int H, int W) {
  const size_t n = static_cast<size_t>(H) * W;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* img = src + blockIdx.y * static_cast<size_t>(Hs) * Ws;
  uint32_t* out = dst + blockIdx.y * n;
  const float fxs = __ldg(sx + i);
  const float fys = __ldg(sy + i);
  const int x0 = static_cast<int>(floorf(fxs));
  const int y0 = static_cast<int>(floorf(fys));
  // wrapping +1, as the oracles' int32 add does
  const int x1 = static_cast<int>(static_cast<unsigned>(x0) + 1u);
  const int y1 = static_cast<int>(static_cast<unsigned>(y0) + 1u);
  const float fx = fxs - static_cast<float>(x0);
  const float fy = fys - static_cast<float>(y0);
  const int cx0 = clampi(x0, 0, Ws - 1), cx1 = clampi(x1, 0, Ws - 1);
  const int cy0 = clampi(y0, 0, Hs - 1), cy1 = clampi(y1, 0, Hs - 1);
  const uint32_t* row0 = img + static_cast<size_t>(cy0) * Ws;
  const uint32_t* row1 = img + static_cast<size_t>(cy1) * Ws;
  const uint32_t p00 = __ldg(row0 + cx0), p10 = __ldg(row0 + cx1);
  const uint32_t p01 = __ldg(row1 + cx0), p11 = __ldg(row1 + cx1);
  uint32_t q = 0;
  if (kZero) {
    if (x0 < -1 || y0 < -1 || x0 >= Ws || y0 >= Hs) {
      out[i] = 0;
      return;
    }
    const bool in_x0 = x0 >= 0 && x0 < Ws, in_x1 = x1 >= 0 && x1 < Ws;
    const bool in_y0 = y0 >= 0 && y0 < Hs, in_y1 = y1 >= 0 && y1 < Hs;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float tl = (in_x0 && in_y0) ? chan(p00, c) : 0.0f;
      const float tr = (in_x1 && in_y0) ? chan(p10, c) : 0.0f;
      const float bl = (in_x0 && in_y1) ? chan(p01, c) : 0.0f;
      const float br = (in_x1 && in_y1) ? chan(p11, c) : 0.0f;
      const float top = tl + (tr - tl) * fx;
      const float bot = bl + (br - bl) * fx;
      q |= round_u8(top + (bot - top) * fy) << (8 * c);
    }
  } else {
    const float gx = 1.0f - fx, gy = 1.0f - fy;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = chan(p00, c) * gx * gy + chan(p10, c) * fx * gy +
                      chan(p01, c) * gx * fy + chan(p11, c) * fx * fy;
      q |= round_u8(v) << (8 * c);
    }
  }
  out[i] = q;
}

}  // namespace pfe_warp

extern "C" {

// src: u8 [B, Hs, Ws, 4] as u32; sx, sy: f32 [H, W]; dst: u8 [B, H, W, 4]
// as u32.  mode 0 = zero, 1 = clamp.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int pfe_warp_bilinear(const void* src, const void* sx, const void* sy,
                      void* dst, int B, int Hs, int Ws, int H, int W, int mode,
                      void* stream) {
  using namespace pfe_warp;
  if (B < 1 || B > 65535 || Hs < 1 || Ws < 1 || H < 1 || W < 1 ||
      (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), B);
  const uint32_t* in = static_cast<const uint32_t*>(src);
  const float* fx = static_cast<const float*>(sx);
  const float* fy = static_cast<const float*>(sy);
  uint32_t* out = static_cast<uint32_t*>(dst);
  if (mode == 0) {
    warp_kernel<true><<<grid, kThreads, 0, s>>>(in, fx, fy, out, Hs, Ws, H, W);
  } else {
    warp_kernel<false><<<grid, kThreads, 0, s>>>(in, fx, fy, out, Hs, Ws, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
