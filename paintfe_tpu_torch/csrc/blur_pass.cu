// K-pass: one edge-clamped separable Gaussian pass along the last axis of
// a contiguous f32 [C, H, W] tensor,
//   out[c, y, x] = sum_k src[c, y, clamp(x + k - r, 0, W - 1)] * taps[k],
// summed from 0 in tap order k = 0 .. nt-1 (r = nt / 2).
//
// Replaces the Pallas kernel _pass_fn / _make_conv_kernel
// (paintfe_tpu/ops/pallas_kernels.py), the pass of gaussian_blur_pallas.
// The TPU kernel padded each row to a power-of-two lane count (its dynamic
// lane roll was wrong on other widths), kept the taps in SMEM and rolled
// the tile once per tap; none of that carries over.
//
// The staged route: rows lie on blockIdx.y and a row's segments on
// blockIdx.x, so no thread divides.  A block stages one segment of `seg`
// values and its r-wide halo into shared memory once with cp.async (4 bytes
// a copy: the halo's offset breaks any wider alignment), each index clamped
// to the row while staging (so W <= r needs nothing special), and the taps
// beside them.  Staged index i holds x = seg0 - r + i, which puts the window
// of the thread that owns outputs seg0 + 4t .. 4t + 3 at the 16-byte
// aligned index 4t: each thread walks the taps four at a time with one
// 16-byte shared load of the next four window values and one warp-wide
// broadcast of four taps, and does 16 multiplies and 16 adds on a register
// window of eight values.  For each output the products are added in tap
// order k = 0 .. nt-1 from 0, each rounded separately (-fmad=false), as the
// plain version adds them; the last one to three taps run guarded, never
// padded with zero taps (0 * inf is not 0).  A thread stores its four sums
// as one float4 where W is a multiple of 4 and singly elsewhere.  The tap
// count is a run-time value, so one kernel serves every sigma; a radius
// whose halo does not fit shared memory (ops/kernels.py pass_route: past
// about 14,400) takes the global route: one thread an output, taps and
// window read through L1, still on the 2-D grid.
//
// What bounds it, on NVIDIA H100 80GB HBM3 at 700 W (PERF.md, K-pass; one
// pass over f32 [4, 2160, 3840]): at sigma 2 (13 taps) memory, one f32
// read and one f32 write a value, 0.079 ms; the kernel takes 0.11 ms of
// device time, 72% of that rate.  At sigma 25 (151 taps) the f32 rate
// without FMA bounds it, 0.30 ms; the kernel takes 0.46-0.50 ms, 2.1
// instructions an output and tap.  Staging through registers (plain loads,
// then stores to shared memory) was slower than cp.async in a one-off
// build; chip_smoke.time_route_limits times the wrapper's segments of 256
// outputs (64 threads) beside segments of 960 and beside the global route.
#include <cstdint>
#include <cuda_runtime.h>

namespace pfe_pass {

constexpr int kMaxThreads = 256;
constexpr int kQ = 4;  // outputs a thread (ops/kernels.py PASS_Q)
constexpr int kMaxSeg = kMaxThreads * kQ;  // the wrapper asks for at most PASS_MAX_SEG
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kMaxGridY = 65535;

__host__ __device__ constexpr int round_up4(int n) { return (n + 3) & ~3; }

// floats of shared memory: the staged span (seg values, the halo, and what
// the last 16-byte window load may touch past it), then the taps
__host__ __device__ constexpr int span_floats(int seg, int nt) {
  return seg + round_up4(nt) + 4;
}

// One tap for the thread's four outputs: acc[j] = acc[j] + v[j + T] * tap.
template <int T>
__device__ __forceinline__ void add_tap(float (&acc)[kQ], const float (&v)[7], float tap) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) acc[j] = acc[j] + v[j + T] * tap;
}

// One f32 from device memory to shared memory, past the registers.
__device__ __forceinline__ void copy_async(float* to_shared, const float* from) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(to_shared))),
               "l"(from)
               : "memory");
}

template <bool kVecStore>
__global__ void __launch_bounds__(kMaxThreads)
pass_staged_kernel(const float* __restrict__ src, const float* __restrict__ taps,
                   float* __restrict__ dst, long long rows, int W, int nt, int seg) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int span = span_floats(seg, nt);
  float* tp = s + span;
  const int r = nt / 2;
  const int seg0 = blockIdx.x * seg;
  const int len = min(seg, W - seg0);
  const int staged = round_up4(len) + 2 * r;
  const int t = threadIdx.x;
  for (int k = t; k < round_up4(nt); k += blockDim.x) {
    tp[k] = k < nt ? __ldg(taps + k) : 0.0f;  // the padding is never multiplied
  }
  const float4* w4 = reinterpret_cast<const float4*>(s) + t;
  const float4* tp4 = reinterpret_cast<const float4*>(tp);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* line = src + row * W;
    for (int i = t; i < staged; i += blockDim.x) {
      copy_async(s + i, line + min(max(seg0 - r + i, 0), W - 1));
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (kQ * t < len) {
      float acc[kQ] = {0.0f, 0.0f, 0.0f, 0.0f};
      float4 a = w4[0];
      int k = 0;
      for (; k + 4 <= nt; k += 4) {
        const float4 b = w4[k / 4 + 1];
        const float4 q = tp4[k / 4];
        const float v[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
        add_tap<0>(acc, v, q.x);
        add_tap<1>(acc, v, q.y);
        add_tap<2>(acc, v, q.z);
        add_tap<3>(acc, v, q.w);
        a = b;
      }
      if (k < nt) {
        const float4 b = w4[k / 4 + 1];
        const float4 q = tp4[k / 4];
        const float v[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
        add_tap<0>(acc, v, q.x);
        if (k + 1 < nt) add_tap<1>(acc, v, q.y);
        if (k + 2 < nt) add_tap<2>(acc, v, q.z);
      }
      float* out = dst + row * W + seg0 + kQ * t;
      if (kVecStore) {  // W % 4 == 0: len % 4 == 0 too, no partial group
        *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (kQ * t + j < len) out[j] = acc[j];
        }
      }
    }
    __syncthreads();  // the next row restages the span
  }
}

__global__ void __launch_bounds__(kMaxThreads)
pass_global_kernel(const float* __restrict__ src, const float* __restrict__ taps,
                   float* __restrict__ dst, long long rows, int W, int nt) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int r = nt / 2;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* line = src + row * W;
    float acc = 0.0f;
    for (int k = 0; k < nt; ++k) {
      acc = acc + __ldg(line + min(max(x + k - r, 0), W - 1)) * __ldg(taps + k);
    }
    dst[row * W + x] = acc;
  }
}

}  // namespace pfe_pass

extern "C" {

// src, dst: f32 [rows, W] (rows = C * H); taps: f32 [nt] in device
// memory, nt odd.  seg: outputs of one block's segment (a multiple of 4,
// at most 1024; ops/kernels.py pass_segment), or 0 for the global route.
// Launches on `stream` and returns cudaGetLastError().
int pfe_blur_pass(const void* src, const void* taps, void* dst, long long rows,
                  int W, int nt, int seg, void* stream) {
  using namespace pfe_pass;
  if (rows < 1 || W < 1 || nt < 1 || nt % 2 == 0 || seg < 0 || seg > kMaxSeg ||
      seg % kQ != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(src);
  const float* tp = static_cast<const float*>(taps);
  float* out = static_cast<float*>(dst);
  const unsigned gy = static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY);
  if (seg == 0) {
    dim3 grid((W + kMaxThreads - 1) / kMaxThreads, gy);
    pass_global_kernel<<<grid, kMaxThreads, 0, s>>>(in, tp, out, rows, W, nt);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(span_floats(seg, nt) + round_up4(nt)) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % kQ == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  auto* kernel = vec ? pass_staged_kernel<true> : pass_staged_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = ((seg / kQ + 31) / 32) * 32;
  dim3 grid((W + seg - 1) / seg, gy);
  kernel<<<grid, threads, smem, s>>>(in, tp, out, rows, W, nt, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
