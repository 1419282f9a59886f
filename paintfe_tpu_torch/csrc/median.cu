// K-median: the per-channel median of the (2r+1)^2 window of u8 RGBA
// images, edges replicated.
//
// Replaces the Pallas kernel median_pallas (paintfe_tpu/ops/pallas_kernels.py,
// _make_median_kernel and _median_pallas_fn), which sorted each tile's
// window through a pruned Batcher network of (2r+1)^2 VMEM-resident taps.
//
// The median of integers is exact, so any correct selection gives the JAX
// package's bytes.  Three routes, chosen by the wrapper from the radius
// (ops/kernels.py median_route):
//
// - network (r <= kNetMaxR): a block stages its 128 x 16 output tile and
//   the r halo in shared memory as packed u32 pixels; each thread takes
//   kNetTW = 4 horizontally adjacent outputs of a row, reads their
//   (4 + 2r) x (2r + 1) taps with 16-byte loads, and runs the selection
//   network of csrc/median_network.cuh on them: columns sorted once,
//   merged into sorted lists that neighbouring outputs share, pruned to
//   the medians (110 min/max operations an output at r = 2, against 202
//   for the pruned Batcher network of one output).  The network works on
//   channel pairs widened to 16 bits (R|B and G|A), two passes a pixel:
//   __vminu2/__vmaxu2 are one VIMNMX.U16 each on sm_90a (ptxas fuses some
//   pairs into VIMNMX3.U16), where the per-byte __vminu4/__vmaxu4 take
//   four instructions (cuobjdump -sass of a probe built for sm_90a).
// - staged / global (larger r): a binary search on the value.  The median
//   of channel c is the least t with count(window_c <= t) > (2r+1)^2 / 2,
//   and eight halvings of [0, 255] find it; the four channels search
//   together with one per-byte compare (__vsetleu4) a tap against the
//   packed midpoints, counted in packed bytes and flushed into 32-bit
//   counters every 255 taps (64-bit past r = 32767, where (2r+1)^2 no
//   longer fits 32 bits).  Registers do not grow with r.  The staged route
//   keeps a 32 x 32 output tile and its halo in shared memory; when that
//   overflows the 227 KB a block may use (r > 104), the global route reads
//   the window through L1/L2, with the row and column clamped per tap.
//   There is no radius cap.
//
// What bounds it on the H100: not memory (one u32 read and one written per
// pixel, 66 MB per 3840x2160 frame) but integer issue: the network's
// min/max operations (two a comparator on the halfword pairs), or the
// counting route's 8 x (2r+1)^2 window reads and compares a pixel.
#include <cstdint>
#include <cuda_runtime.h>

#include "median_network.cuh"

namespace pfe_med {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
// the largest radius whose window count (2r+1)^2 fits 32-bit counters
constexpr int kMaxRadius32 = 32767;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// Network route
// ---------------------------------------------------------------------------

constexpr int kNetCols = 32 * kNetTW;  // output columns of a block: one warp
constexpr int kNetRows = 16;           // output rows of a block: 8 warps x 2

// The min and max of the network on R|B (lo) or G|A (hi) halfword pairs.
template <int kShift>
struct HalfPairs {
  static __device__ __forceinline__ uint32_t prep(uint32_t px) {
    return (px >> kShift) & 0x00FF00FFu;
  }
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) {
    return __vminu2(a, b);
  }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) {
    return __vmaxu2(a, b);
  }
};

// Shared-memory geometry of radius R: kPad words left and right of the
// output columns keep every 16-byte load aligned.
template <int R>
struct NetTile {
  static constexpr int kPad = 4 * ((R + 3) / 4);
  static constexpr int kPitch = kNetCols + 2 * kPad;  // u32 words a row
  static constexpr int kRows = kNetRows + 2 * R;
  static constexpr int kVec = 1 + 2 * kPad / 4;  // uint4 loads a window row
};

// One pass of the network for the thread's kNetTW outputs; `row0` points
// at the top window row, at the first of the thread's kVec uint4.
template <int R, class Op>
__device__ __forceinline__ void net_pass(const uint32_t* row0, uint32_t* o) {
  using T = NetTile<R>;
  constexpr int kCols = kNetTW + 2 * R;
  uint32_t v[MedianNet<R>::kIn];
#pragma unroll
  for (int dy = 0; dy <= 2 * R; ++dy) {
    uint32_t w[4 * T::kVec];
    const uint4* src = reinterpret_cast<const uint4*>(row0 + dy * T::kPitch);
#pragma unroll
    for (int q = 0; q < T::kVec; ++q) {
      const uint4 u = src[q];
      w[4 * q] = u.x;
      w[4 * q + 1] = u.y;
      w[4 * q + 2] = u.z;
      w[4 * q + 3] = u.w;
    }
#pragma unroll
    for (int x = 0; x < kCols; ++x) v[dy * kCols + x] = Op::prep(w[T::kPad - R + x]);
  }
  MedianNet<R>::template run<Op>(v, o);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
median_net_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                  int H, int W) {
  using T = NetTile<R>;
  __shared__ __align__(16) uint32_t tile[T::kRows * T::kPitch];
  const size_t plane = static_cast<size_t>(H) * W;
  const uint32_t* img = src + blockIdx.z * plane;
  uint32_t* out = dst + blockIdx.z * plane;
  const int x0 = blockIdx.x * kNetCols;
  const int y0 = blockIdx.y * kNetRows;
  // stage: tile row i, column c holds pixel (y0 - R + i, x0 - kPad + c),
  // both clamped to the image
  for (int i = threadIdx.x; i < T::kRows * T::kPitch; i += kThreads) {
    const int row = i / T::kPitch;
    const int col = i - row * T::kPitch;
    const int gy = clampi(y0 - R + row, 0, H - 1);
    const int gx = clampi(x0 - T::kPad + col, 0, W - 1);
    tile[i] = __ldg(img + static_cast<size_t>(gy) * W + gx);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int x = x0 + kNetTW * lane;
  if (x >= W) return;
  for (int ly = threadIdx.x >> 5; ly < kNetRows; ly += kThreads / 32) {
    const int y = y0 + ly;
    if (y >= H) break;
    const uint32_t* row0 = tile + ly * T::kPitch + kNetTW * lane;
    uint32_t o[kNetTW], hi[kNetTW];
    net_pass<R, HalfPairs<0>>(row0, o);
    net_pass<R, HalfPairs<8>>(row0, hi);
#pragma unroll
    for (int j = 0; j < kNetTW; ++j) o[j] |= hi[j] << 8;
    uint32_t* p = out + static_cast<size_t>(y) * W + x;
    if (x + kNetTW <= W && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kNetTW; ++j) {
        if (x + j < W) p[j] = o[j];
      }
    }
  }
}

template <int R>
cudaError_t launch_net(const uint32_t* in, uint32_t* out, int B, int H, int W,
                       cudaStream_t s) {
  const dim3 grid((W + kNetCols - 1) / kNetCols, (H + kNetRows - 1) / kNetRows, B);
  median_net_kernel<R><<<grid, kThreads, 0, s>>>(in, out, H, W);
  return cudaGetLastError();
}

// The kernel of radius r, for r = R .. kNetMaxR.
template <int R>
cudaError_t net_route(const uint32_t* in, uint32_t* out, int B, int H, int W,
                      int r, cudaStream_t s) {
  if (r == R) return launch_net<R>(in, out, B, H, W, s);
  if constexpr (R < kNetMaxR) {
    return net_route<R + 1>(in, out, B, H, W, r, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Counting routes
// ---------------------------------------------------------------------------

constexpr int kTile = 32;  // output tile: kTile x kTile pixels

// Median of the k x k window whose tap (j, i) is fetch(j, i), per byte
// channel of the packed u32 pixels; `rank` is k * k / 2; Count holds k * k.
template <typename Count, typename Fetch>
__device__ __forceinline__ uint32_t window_median(const Fetch& fetch, int k, Count rank) {
  uint32_t lo[4] = {0, 0, 0, 0};
  uint32_t hi[4] = {255, 255, 255, 255};
  // the halvings stay a loop: unrolled (with the tap loop unrolled by 4)
  // they made the staged route slower than PR 3's at r = 40 on the H100,
  // though faster at r = 8 (PERF.md, PR 4)
#pragma unroll 1
  for (int step = 0; step < 8; ++step) {
    uint32_t mid = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) mid |= ((lo[c] + hi[c]) >> 1) << (8 * c);
    Count cnt[4] = {0, 0, 0, 0};
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
      const uint32_t m = (lo[c] + hi[c]) >> 1;
      if (cnt[c] > rank) {
        hi[c] = m;
      } else {
        lo[c] = m + 1;
      }
    }
  }
  return lo[0] | (lo[1] << 8) | (lo[2] << 16) | (lo[3] << 24);
}

// One block per kTile x kTile output tile of one image (blockIdx.z).
template <bool kStaged, typename Count>
__global__ void __launch_bounds__(kThreads)
median_count_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                    int H, int W, int r) {
  extern __shared__ uint32_t stage[];
  const size_t plane = static_cast<size_t>(H) * W;
  const uint32_t* img = src + blockIdx.z * plane;
  uint32_t* out = dst + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int k = 2 * r + 1;
  const int pitch = kTile + 2 * r;
  const Count rank = static_cast<Count>(static_cast<unsigned long long>(k) * k / 2);
  if (kStaged) {
    for (int i = threadIdx.x; i < pitch * pitch; i += blockDim.x) {
      const int row = i / pitch;
      const int col = i - row * pitch;
      const int gy = clampi(y0 - r + row, 0, H - 1);
      const int gx = clampi(x0 - r + col, 0, W - 1);
      stage[i] = __ldg(img + static_cast<size_t>(gy) * W + gx);
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
      const uint32_t* base = stage + ly * pitch + lx;
      m = window_median<Count>([&](int j, int i) { return base[j * pitch + i]; }, k,
                               rank);
    } else {
      m = window_median<Count>(
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

// src/dst: u8 [B, H, W, 4] as u32 [B, H, W].  `route` (ops/kernels.py
// median_route): 2 runs the selection network (r <= kNetMaxR), 1 the
// counting search on a tile and its halo, (kTile + 2r)^2 u32, staged in
// shared memory, 0 the counting search reading the window from global
// memory.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int pfe_median(const void* src, void* dst, int B, int H, int W, int r,
               int route, void* stream) {
  using namespace pfe_med;
  if (r < 1 || r >= (1 << 29) || B < 1 || B > 65535 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(src);
  uint32_t* out = static_cast<uint32_t*>(dst);
  if (route == 2) return static_cast<int>(net_route<1>(in, out, B, H, W, r, s));
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  if (route == 1) {
    const long long pitch = kTile + 2LL * r;
    const long long smem = pitch * pitch * static_cast<long long>(sizeof(uint32_t));
    if (smem > static_cast<long long>(kMaxSmem)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e = cudaFuncSetAttribute(median_count_kernel<true, uint32_t>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    median_count_kernel<true, uint32_t><<<grid, kThreads, static_cast<size_t>(smem), s>>>(
        in, out, H, W, r);
  } else if (route == 0 && r <= kMaxRadius32) {
    median_count_kernel<false, uint32_t><<<grid, kThreads, 0, s>>>(in, out, H, W, r);
  } else if (route == 0) {
    median_count_kernel<false, unsigned long long><<<grid, kThreads, 0, s>>>(in, out, H, W, r);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
