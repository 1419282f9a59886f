// K-blur: the separable Gaussian blur of u8 RGBA images, both passes in
// one kernel.
//
// Replaces the Pallas kernel gaussian_blur_fused_planar / gaussian_blur_fused
// (paintfe_tpu/ops/pallas_kernels.py, _make_blur2d_kernel and _blur2d_fn),
// and the XLA separable path it fell back to for more than 41 taps.
//
// What bounds it on the H100: the f32 multiplies and adds, 2 x nt a channel
// a pixel in each pass (4.1 ns of the card's 33.5e12 separate f32
// operations a second per 3840x2160 frame and tap), above one u8 read and
// one u8 write per pixel (2 x 33 MB a frame).  The staged tile
// (blur_tile.cuh) keeps everything else off the issue slots: the block's
// source region (th + 2r rows by kTileW + 2r columns, edges clamped) is
// staged once into shared memory with cp.async; the H pass converts each
// staged value u8 -> f32 once per thread that reads it, and each thread
// computes q = 8 adjacent H sums from a register window, so a loaded value
// serves up to 8 sums; the V pass does the same down the columns of the
// float4 sums in shared memory.  Taps live in constant memory and are read
// in a run-time loop: one kernel serves every radius (K-chain runs the
// same tile with its own taps and epilogue).  The wrapper
// (ops/kernels.py blur_tile_rows, blur_sums) runs 128-row tiles up to
// r = 140, and 64-row tiles of q = 4 sums a thread up to r = 4, where the
// short sums leave the SM idle between the staging and the passes unless
// twice the blocks (4, at 60-odd registers) share it.  Past r = 140 the
// sums leave too little room for staged rows, and the split pair runs (an
// H-pass kernel and a V-pass kernel over an f32 buffer in device memory),
// with the same tap order.
#include <mutex>

#include "blur_tile.cuh"

namespace pfe {

// Tap table of the tiled kernel.  A tile only fits shared memory up to a
// radius of (232448 / (kTileW * 16) - 8) / 2 = 223, i.e. 447 taps; larger
// radii take the split kernels, which read their taps from device memory.
constexpr int kMaxConstTaps = 512;

// `static`: this translation unit's own table, one per device and shared
// by every stream, set before each launch on the launching stream.  A
// rewrite must not land while a launch made earlier on another stream
// still reads it: each launch records taps_read[device] after itself on its
// stream, and the next rewrite, on whatever stream, waits for that event
// first.  taps_mutex keeps one call's wait, rewrite, launch and record
// together when host threads launch at once.
static __constant__ float c_taps[kMaxConstTaps];
constexpr int kMaxDevices = 64;
static std::mutex taps_mutex;
static cudaEvent_t taps_read[kMaxDevices] = {};

struct ConstTaps {
  __device__ __forceinline__ float operator()(int k) const { return c_taps[k]; }
};

// The V pass's epilogue: each sum rounded and packed into dst.
struct RoundStore {
  uint32_t* dst;
  struct Loaded {};
  __device__ __forceinline__ Loaded load(int, int) const { return {}; }
  __device__ __forceinline__ void store(float4 v, size_t o, const Loaded&, int) const {
    dst[o] = round_pack(v);
  }
};

// Q sums a thread; kMinBlocks blocks an SM bound the registers.
template <int Q, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blur_tiled_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                  int H, int W, int r, int nt, int th, int chunk) {
  extern __shared__ float4 smem[];
  float4* hs = smem;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + (th + 2 * r) * kTileW);
  const size_t plane = static_cast<size_t>(H) * W;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  blur_h_pass<Q>(src + blockIdx.z * plane, hs, stage, H, W, x0, y0, th, r, nt, chunk,
                 ConstTaps{});
  blur_v_pass<Q>(hs, H, W, x0, y0, th, r, nt, ConstTaps{}, RoundStore{dst + blockIdx.z * plane});
}

// The split route's plain conversions and rounding.
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

template <int Q, int kMinBlocks>
cudaError_t launch_tiled(const uint32_t* src, uint32_t* dst, int B, int H, int W, int r,
                         int nt, int th, int chunk, size_t smem, cudaStream_t s) {
  auto* kernel = blur_tiled_kernel<Q, kMinBlocks>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((W + kTileW - 1) / kTileW, (H + th - 1) / th, B);
  kernel<<<grid, kThreads, smem, s>>>(src, dst, H, W, r, nt, th, chunk);
  return cudaGetLastError();
}

}  // namespace pfe

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  src/dst: u8 [B, H, W, 4] as u32 [B, H, W].  The tiled one
// runs th-row tiles of q (8 or 4) sums a thread (ops/kernels.py
// blur_tile_rows and blur_sums choose both from the radius).

int pfe_blur_tiled(const void* src, void* dst, int B, int H, int W,
                   const float* taps_host, int nt, int th, int q, void* stream) {
  using namespace pfe;
  const int r = nt / 2;
  const int chunk = blur_chunk_rows(th, r);
  const size_t smem = blur_tile_bytes(th, r);
  if (nt < 1 || nt > kMaxConstTaps || (q != 8 && q != 4) || th < q || th % q != 0 ||
      chunk < 1 || smem > kBlurMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(taps_mutex);
  cudaEvent_t& read = taps_read[dev];
  e = read ? cudaStreamWaitEvent(s, read, 0)
           : cudaEventCreateWithFlags(&read, cudaEventDisableTiming);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbolAsync(c_taps, taps_host, nt * sizeof(float), 0,
                              cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint32_t* in = static_cast<const uint32_t*>(src);
  uint32_t* out = static_cast<uint32_t*>(dst);
  e = q == 8 ? launch_tiled<8, 2>(in, out, B, H, W, r, nt, th, chunk, smem, s)
             : launch_tiled<4, 4>(in, out, B, H, W, r, nt, th, chunk, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaEventRecord(read, s));
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
