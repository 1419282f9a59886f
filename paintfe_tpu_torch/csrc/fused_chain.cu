// K-chain: the headline filter chain in one kernel — Gaussian blur,
// brightness/contrast, levels, sepia with strength, then a soft-light
// Porter-Duff flatten of an overlay at an opacity.
//
// Replaces the Pallas kernel fused_chain_kernel (paintfe_tpu/ops/
// fused_chain.py, _make_chain_kernel and _chain_kernel_fn).
//
// What bounds it on the H100: device memory, three u8 RGBA frames per call
// (image read, overlay read, result write: 3 x 33 MB per 3840x2160 frame),
// plus the blur's f32 multiply-adds as the radius grows.  The design is
// K-blur's tile (H-pass sums of the tile and its 2r-row halo in shared
// memory, V pass from there), and then the pointwise tail runs in
// registers on the V-pass result: brightness/contrast, levels through a
// 256-entry u8 table (pipeline.levels_lut, built on the host with the
// power correctly rounded — CUDA's powf is not, and levels only sees
// integer inputs), sepia, and the soft-light flatten against the overlay
// pixel,
// then one u32 store.  Every stage quantizes exactly like the script-level
// ops, in f32 (truncation as floor of the clipped value).  A radius whose
// halo does not fit shared memory runs K-blur and then chain_tail_kernel,
// which shares chain_tail() with this kernel.
#include "blur_tile.cuh"

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

static __constant__ uint8_t c_levels_lut[256];
// Shared memory ahead of the H-pass sums: the levels table (a multiple of
// 16 bytes, so the float4 sums stay aligned).
constexpr size_t kLutBytes = 256;

__device__ __forceinline__ float trunc255(float x) {
  return floorf(fminf(fmaxf(x, 0.0f), 255.0f));
}

// W3C soft-light of base b under top t (core/blend.py _soft_light).
__device__ __forceinline__ float soft_light(float b, float t) {
  const float d = b <= 0.25f ? ((16.0f * b - 12.0f) * b + 4.0f) * b : sqrtf(b);
  return t <= 0.5f ? b - (1.0f - 2.0f * t) * b * (1.0f - b)
                   : b + (2.0f * t - 1.0f) * (d - b);
}

// The pointwise tail of one pixel: blurred channels (integers in [0, 255]
// held in f32) and the overlay pixel in, the packed result out.
__device__ __forceinline__ uint32_t chain_tail(float4 px, uint32_t ov_px,
                                               const uint8_t* lut,
                                               const ChainParams& p) {
  // brightness/contrast: clip, then the u8 truncation
  float c[3] = {px.x, px.y, px.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = trunc255(p.bc_factor * (c[k] + p.brightness - 128.0f) + 128.0f);
  }
  // levels through the table
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = static_cast<float>(lut[static_cast<int>(c[k])]);
  // sepia with strength
  const float sr = fminf(c[0] * 0.393f + c[1] * 0.769f + c[2] * 0.189f, 255.0f);
  const float sg = fminf(c[0] * 0.349f + c[1] * 0.686f + c[2] * 0.168f, 255.0f);
  const float sb = fminf(c[0] * 0.272f + c[1] * 0.534f + c[2] * 0.131f, 255.0f);
  c[0] = trunc255(c[0] * p.sep_inv + sr * p.sep_s);
  c[1] = trunc255(c[1] * p.sep_inv + sg * p.sep_s);
  c[2] = trunc255(c[2] * p.sep_inv + sb * p.sep_s);
  const float a = px.w;
  // overlay alpha 0: the base passes through unchanged
  const float4 ov = unpack(ov_px);
  if (ov.w == 0.0f) return pack(c[0], c[1], c[2], a);
  // soft-light Porter-Duff, straight alpha, truncating quantization
  const float base_a = a / 255.0f;
  const float top_a = ov.w / 255.0f * p.opacity;
  const float inv = 1.0f - top_a;
  const float out_a = top_a + base_a * inv;
  if (out_a == 0.0f) return 0u;
  const float tf[3] = {ov.x / 255.0f, ov.y / 255.0f, ov.z / 255.0f};
  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float bf = c[k] / 255.0f;
    const float rgb = (soft_light(bf, tf[k]) * top_a + bf * base_a * inv) / out_a;
    q[k] = trunc255(rgb * 255.0f);
  }
  return pack(q[0], q[1], q[2], trunc255(out_a * 255.0f));
}

__global__ void __launch_bounds__(kThreads)
chain_tiled_kernel(const uint32_t* __restrict__ src,
                   const uint32_t* __restrict__ overlay,
                   uint32_t* __restrict__ dst, int H, int W, int r, int nt,
                   int th, ChainParams p) {
  extern __shared__ float4 smem[];
  uint8_t* lut = reinterpret_cast<uint8_t*>(smem);
  float4* hs = smem + kLutBytes / sizeof(float4);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = c_levels_lut[i];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  h_pass_tile(src, hs, H, W, x0, y0, th, r, nt);
  __syncthreads();
  for (int i = threadIdx.x; i < th * kTileW; i += blockDim.x) {
    const int row = i / kTileW;
    const int col = i - row * kTileW;
    const int gy = y0 + row;
    const int gx = x0 + col;
    if (gy >= H || gx >= W) continue;
    const size_t o = static_cast<size_t>(gy) * W + gx;
    dst[o] = chain_tail(v_pass_pixel(hs, row, col, nt), __ldg(overlay + o), lut, p);
  }
}

// The tail alone, on an already blurred image (the large-radius route).
__global__ void __launch_bounds__(kThreads)
chain_tail_kernel(const uint32_t* __restrict__ blurred,
                  const uint32_t* __restrict__ overlay,
                  uint32_t* __restrict__ dst, size_t n, ChainParams p) {
  __shared__ uint8_t lut[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = c_levels_lut[i];
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  dst[i] = chain_tail(unpack(__ldg(blurred + i)), __ldg(overlay + i), lut, p);
}

}  // namespace pfe

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  Images are u8 [H, W, 4] as u32 [H, W]; `params` points to five
// f32 on the host (brightness, bc_factor, sep_s, sep_inv, opacity) and
// `lut_host` to the 256-byte levels table.

int pfe_chain_tiled(const void* src, const void* overlay, void* dst, int H,
                    int W, const float* taps_host, int nt, int th,
                    const float* params, const uint8_t* lut_host, void* stream) {
  using namespace pfe;
  if (nt > kMaxConstTaps || th < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = kLutBytes + tile_smem_bytes(th, nt / 2);
  cudaError_t e = cudaSuccess;
  if (nt > 0) {
    e = cudaMemcpyToSymbolAsync(c_taps, taps_host, nt * sizeof(float), 0,
                                cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaMemcpyToSymbolAsync(c_levels_lut, lut_host, 256, 0,
                              cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(chain_tiled_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const ChainParams p{params[0], params[1], params[2], params[3], params[4]};
  dim3 grid((W + kTileW - 1) / kTileW, (H + th - 1) / th, 1);
  chain_tiled_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(overlay),
      static_cast<uint32_t*>(dst), H, W, nt / 2, nt, th, p);
  return static_cast<int>(cudaGetLastError());
}

int pfe_chain_tail(const void* blurred, const void* overlay, void* dst, int H,
                   int W, const float* params, const uint8_t* lut_host,
                   void* stream) {
  using namespace pfe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_levels_lut, lut_host, 256, 0,
                                          cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const ChainParams p{params[0], params[1], params[2], params[3], params[4]};
  const size_t n = static_cast<size_t>(H) * W;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  chain_tail_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(blurred), static_cast<const uint32_t*>(overlay),
      static_cast<uint32_t*>(dst), n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
