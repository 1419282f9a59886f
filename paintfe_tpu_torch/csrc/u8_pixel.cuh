// Exact conversions between packed u8 RGBA pixels and f32 on the integer
// and f32 pipes, shared by K-blur, K-chain (blur_tile.cuh) and K-warp
// (warp_bilinear.cu).  The plain forms, static_cast<float> of each byte
// and floorf plus an f32 -> u32 conversion for the rounding, issue on the
// SM's 16-lane conversion pipe; these issue on the full-rate ones.
// tests/test_torch_blur.py mirrors each over every input that reaches it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pfe {

// 2^23 as an f32: a value v with 0 <= v < 2^23 added to it leaves
// floor(v) (or v rounded) in the low mantissa bits.
constexpr float kTwo23 = 8388608.0f;

// u8 RGBA to four f32, exactly: 0x4B0000bb is 2^23 + bb as an f32, and
// subtracting 2^23 is exact.
__device__ __forceinline__ float4 u8x4_to_f32(uint32_t p) {
  return make_float4(__uint_as_float(__byte_perm(p, 0x4B000000u, 0x7540)) - kTwo23,
                     __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7541)) - kTwo23,
                     __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7542)) - kTwo23,
                     __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7543)) - kTwo23);
}

// floor(x + 0.5) clipped to [0, 255] (0 for NaN: fmaxf returns the other
// operand) in the low byte: y + 2^23 rounded down holds floor(y) in its low
// bits for 0 <= y < 2^23.  The word is 2^23 + the byte as an f32.
__device__ __forceinline__ uint32_t round_byte(float x) {
  return __float_as_uint(__fadd_rd(fminf(fmaxf(x + 0.5f, 0.0f), 255.0f), kTwo23));
}

// The low bytes of four words as one RGBA word.
__device__ __forceinline__ uint32_t pack_low(uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
  return __byte_perm(__byte_perm(r, g, 0x0040), __byte_perm(b, a, 0x0040), 0x5410);
}

// round_byte of each channel, packed.
__device__ __forceinline__ uint32_t round_pack(float4 v) {
  return pack_low(round_byte(v.x), round_byte(v.y), round_byte(v.z), round_byte(v.w));
}

}  // namespace pfe
