// K-blur: the separable Gaussian blur of u8 RGBA images, both passes in
// one kernel.
//
// Replaces the Pallas kernel gaussian_blur_fused_planar / gaussian_blur_fused
// (paintfe_tpu/ops/pallas_kernels.py, _make_blur2d_kernel and _blur2d_fn),
// and the XLA separable path it fell back to for more than 41 taps.
//
// What bounds it on the H100: device memory traffic of one u8 read and one
// u8 write per pixel (2 x 33 MB per 3840x2160 frame) if the f32 pass
// intermediate never leaves the SM, and the f32 multiply-adds, 2 x nt per
// channel per pixel, once the radius grows.  The design keeps the H-pass
// sums of one output tile (kTileW x th pixels plus a 2r-row halo) in
// shared memory as float4, so the intermediate never reaches device
// memory; pixels move as one u32 per RGBA pixel, so a warp reads 128
// contiguous bytes.  Taps live in constant memory and are read in a
// run-time loop: one kernel serves every radius.  The tile height shrinks
// with the radius so that (th + 2r) * kTileW * 16 bytes fit the 227 KB a
// block may use; a radius too large for an 8-row tile runs the split pair
// (an H-pass kernel and a V-pass kernel over an f32 buffer in device
// memory), with the same tap order.
#include "blur_tile.cuh"

namespace pfe {

__global__ void __launch_bounds__(kThreads)
blur_tiled_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                  int H, int W, int r, int nt, int th) {
  extern __shared__ float4 hs[];
  const size_t plane = static_cast<size_t>(H) * W;
  const uint32_t* img = src + blockIdx.z * plane;
  uint32_t* out = dst + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  h_pass_tile(img, hs, H, W, x0, y0, th, r, nt);
  __syncthreads();
  for (int i = threadIdx.x; i < th * kTileW; i += blockDim.x) {
    const int row = i / kTileW;
    const int col = i - row * kTileW;
    const int gy = y0 + row;
    const int gx = x0 + col;
    if (gy >= H || gx >= W) continue;
    const float4 v = v_pass_pixel(hs, row, col, nt);
    out[static_cast<size_t>(gy) * W + gx] = pack(v.x, v.y, v.z, v.w);
  }
}

// Split route, H pass: tmp[b, y, x] = sum_k taps[k] * src[b, y, clamp(x+k-r)].
__global__ void __launch_bounds__(kThreads)
blur_h_kernel(const uint32_t* __restrict__ src, float4* __restrict__ tmp,
              const float* __restrict__ taps, int B, int H, int W, int r,
              int nt) {
  const size_t n = static_cast<size_t>(B) * H * W;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % W);
  const uint32_t* line = src + (i - x);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < nt; ++k) {
    mac(acc, unpack(__ldg(line + clampi(x - r + k, 0, W - 1))), __ldg(taps + k));
  }
  tmp[i] = acc;
}

// Split route, V pass: dst[b, y, x] = round(sum_k taps[k] * tmp[b, clamp(y+k-r), x]).
__global__ void __launch_bounds__(kThreads)
blur_v_kernel(const float4* __restrict__ tmp, uint32_t* __restrict__ dst,
              const float* __restrict__ taps, int B, int H, int W, int r,
              int nt) {
  const size_t n = static_cast<size_t>(B) * H * W;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t b = i / plane;
  const int y = static_cast<int>((i - b * plane) / W);
  const int x = static_cast<int>(i % W);
  const float4* col = tmp + b * plane + x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < nt; ++k) {
    mac(acc, col[static_cast<size_t>(clampi(y - r + k, 0, H - 1)) * W],
        __ldg(taps + k));
  }
  dst[i] = pack(round_u8f(acc.x), round_u8f(acc.y), round_u8f(acc.z),
                round_u8f(acc.w));
}

}  // namespace pfe

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  src/dst: u8 [B, H, W, 4] as u32 [B, H, W].

int pfe_blur_tiled(const void* src, void* dst, int B, int H, int W,
                   const float* taps_host, int nt, int th, void* stream) {
  using namespace pfe;
  if (nt > kMaxConstTaps || th < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = nt / 2;
  const size_t smem = tile_smem_bytes(th, r);
  cudaError_t e = cudaSuccess;
  if (nt > 0) {
    e = cudaMemcpyToSymbolAsync(c_taps, taps_host, nt * sizeof(float), 0,
                                cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaFuncSetAttribute(blur_tiled_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((W + kTileW - 1) / kTileW, (H + th - 1) / th, B);
  blur_tiled_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), H, W, r,
      nt, th);
  return static_cast<int>(cudaGetLastError());
}

int pfe_blur_split(const void* src, void* tmp, void* dst, int B, int H, int W,
                   const void* taps_dev, int nt, void* stream) {
  using namespace pfe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = nt / 2;
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const float* taps = static_cast<const float*>(taps_dev);
  blur_h_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint32_t*>(src),
                                            static_cast<float4*>(tmp), taps, B,
                                            H, W, r, nt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  blur_v_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float4*>(tmp),
                                            static_cast<uint32_t*>(dst), taps, B,
                                            H, W, r, nt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
