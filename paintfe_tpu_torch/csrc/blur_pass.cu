// K-pass: one edge-clamped separable Gaussian pass along the last axis of
// a contiguous f32 [C, H, W] tensor,
//   out[c, y, x] = sum_k src[c, y, clamp(x + k - r, 0, W - 1)] * taps[k],
// summed from 0 in tap order k = 0 .. nt-1 (r = nt / 2).
//
// Replaces the Pallas kernel _pass_fn / _make_conv_kernel
// (paintfe_tpu/ops/pallas_kernels.py), the pass of gaussian_blur_pallas.
// The TPU kernel padded each row to a power-of-two lane count (its dynamic
// lane roll was wrong on other widths), kept the taps in SMEM and rolled
// the tile once per tap.  Here one thread computes one output value: the
// taps stay in device memory and are read in a run-time loop, so one kernel
// serves every sigma, and the clamped source index replaces the padding.
// Neighbouring threads read neighbouring addresses, so each tap's loads of
// a warp coalesce and the window's reuse is served by L1.  Built with
// -fmad=false: each product and sum rounds separately, as the oracle's.
//
// What bounds it on the H100: by the roofline, memory — one f32 read and
// one f32 write per value, while its nt multiplies and adds stay far below
// the f32 rate.  This first version runs one pass over f32 [4, 2160, 3840]
// at sigma 2 at about 24% of the byte bound; the likely limit is
// instruction issue (a 64-bit index division per value, a clamped index
// per tap), not yet confirmed by a profile of the kernel.
#include <cstdint>
#include <cuda_runtime.h>

namespace pfe_pass {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pass_kernel(const float* __restrict__ src, const float* __restrict__ taps,
            float* __restrict__ dst, long long rows, int W, int nt) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * W) return;
  const int x = static_cast<int>(i % W);
  const float* row = src + (i - x);
  const int r = nt / 2;
  float acc = 0.0f;
  for (int k = 0; k < nt; ++k) {
    const int sx = min(max(x + k - r, 0), W - 1);
    acc = acc + __ldg(row + sx) * __ldg(taps + k);
  }
  dst[i] = acc;
}

}  // namespace pfe_pass

extern "C" {

// src, dst: f32 [rows, W] (rows = C * H); taps: f32 [nt] in device
// memory, nt odd.  Launches on `stream` and returns cudaGetLastError().
int pfe_blur_pass(const void* src, const void* taps, void* dst, long long rows,
                  int W, int nt, void* stream) {
  using namespace pfe_pass;
  if (rows < 1 || W < 1 || nt < 1 || nt % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = rows * W;
  const long long blocks = (n + kThreads - 1) / kThreads;
  pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(taps),
      static_cast<float*>(dst), rows, W, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
