// K-median: the per-channel median of the (2r+1)^2 window of u8 RGBA
// images, edges replicated.
//
// Replaces the Pallas kernel median_pallas (paintfe_tpu/ops/pallas_kernels.py,
// _make_median_kernel and _median_pallas_fn), which sorted each tile's
// window through a pruned Batcher network of (2r+1)^2 VMEM-resident taps.
//
// The median of integers is exact, so any correct selection gives the JAX
// package's bytes.  Here each thread finds it by a binary search on the
// value: the median of channel c is the least t with
// count(window_c <= t) > (2r+1)^2 / 2, and eight halvings of [0, 255] find
// it.  The four channels search together: one per-byte compare
// (__vsetleu4) of the packed u32 tap against the packed four midpoints
// adds 1 to each byte of a packed counter, flushed into four int counters
// every 255 taps.  Registers do not grow with r, so one kernel serves
// every radius.
//
// What bounds it on the H100: not memory (one u32 read and one written per
// pixel, 66 MB per 3840x2160 frame) but the 8 x (2r+1)^2 window reads and
// compares of each pixel.  The staged route keeps them in shared memory:
// one block stages its kTile x kTile output tile plus the 2r halo once, as
// u32 pixels, and a warp reads 32 consecutive words of one row (no bank
// conflict).  When the tile and halo overflow the 227 KB a block may use
// (r > 104), the global route reads the window through L1/L2 instead, with
// the row and column clamped per tap.  There is no radius cap.
#include <cstdint>
#include <cuda_runtime.h>

namespace pfe_med {

constexpr int kTile = 32;  // output tile: kTile x kTile pixels
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Median of the k x k window whose tap (j, i) is fetch(j, i), per byte
// channel of the packed u32 pixels.
template <typename Fetch>
__device__ __forceinline__ uint32_t window_median(const Fetch& fetch, int k,
                                                  long long rank) {
  int lo[4] = {0, 0, 0, 0};
  int hi[4] = {255, 255, 255, 255};
#pragma unroll 1
  for (int step = 0; step < 8; ++step) {
    uint32_t mid = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mid |= static_cast<uint32_t>((lo[c] + hi[c]) >> 1) << (8 * c);
    }
    long long cnt[4] = {0, 0, 0, 0};
    for (int j = 0; j < k; ++j) {
      for (int i0 = 0; i0 < k; i0 += 255) {
        const int i1 = min(i0 + 255, k);
        uint32_t acc = 0;  // four byte counters, at most 255 each
        for (int i = i0; i < i1; ++i) acc += __vsetleu4(fetch(j, i), mid);
#pragma unroll
        for (int c = 0; c < 4; ++c) cnt[c] += (acc >> (8 * c)) & 0xFFu;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = (lo[c] + hi[c]) >> 1;
      if (cnt[c] > rank) {
        hi[c] = m;
      } else {
        lo[c] = m + 1;
      }
    }
  }
  return static_cast<uint32_t>(lo[0]) | (static_cast<uint32_t>(lo[1]) << 8) |
         (static_cast<uint32_t>(lo[2]) << 16) |
         (static_cast<uint32_t>(lo[3]) << 24);
}

// One block per kTile x kTile output tile of one image (blockIdx.z).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
median_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
              int H, int W, int r) {
  extern __shared__ uint32_t tile[];
  const size_t plane = static_cast<size_t>(H) * W;
  const uint32_t* img = src + blockIdx.z * plane;
  uint32_t* out = dst + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int k = 2 * r + 1;
  const int pitch = kTile + 2 * r;
  const long long rank = static_cast<long long>(k) * k / 2;
  if (kStaged) {
    for (int i = threadIdx.x; i < pitch * pitch; i += blockDim.x) {
      const int row = i / pitch;
      const int col = i - row * pitch;
      const int gy = clampi(y0 - r + row, 0, H - 1);
      const int gx = clampi(x0 - r + col, 0, W - 1);
      tile[i] = __ldg(img + static_cast<size_t>(gy) * W + gx);
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < kTile * kTile; p += blockDim.x) {
    const int ly = p / kTile;
    const int lx = p - ly * kTile;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= H || x >= W) continue;
    uint32_t m;
    if (kStaged) {
      const uint32_t* base = tile + ly * pitch + lx;
      m = window_median([&](int j, int i) { return base[j * pitch + i]; }, k,
                        rank);
    } else {
      m = window_median(
          [&](int j, int i) {
            const int gy = clampi(y - r + j, 0, H - 1);
            const int gx = clampi(x - r + i, 0, W - 1);
            return __ldg(img + static_cast<size_t>(gy) * W + gx);
          },
          k, rank);
    }
    out[static_cast<size_t>(y) * W + x] = m;
  }
}

}  // namespace pfe_med

extern "C" {

// src/dst: u8 [B, H, W, 4] as u32 [B, H, W].  `staged` picks the route
// (ops/kernels.py median_route): 1 stages the tile and its halo,
// (kTile + 2r)^2 u32, in shared memory; 0 reads the window from global
// memory.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int pfe_median(const void* src, void* dst, int B, int H, int W, int r,
               int staged, void* stream) {
  using namespace pfe_med;
  if (r < 1 || B < 1 || B > 65535 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const uint32_t* in = static_cast<const uint32_t*>(src);
  uint32_t* out = static_cast<uint32_t*>(dst);
  if (staged) {
    const long long pitch = kTile + 2LL * r;
    const long long smem = pitch * pitch * static_cast<long long>(sizeof(uint32_t));
    if (smem > static_cast<long long>(kMaxSmem)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e = cudaFuncSetAttribute(
        median_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    median_kernel<true><<<grid, kThreads, static_cast<size_t>(smem), s>>>(
        in, out, H, W, r);
  } else {
    median_kernel<false><<<grid, kThreads, 0, s>>>(in, out, H, W, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
