// Exact int8 -> float for the decode kernels' int8 caches.
//
// A conversion instruction (I2F) runs at 16 results per clock per SM on
// sm_90, an eighth of the FMA rate, and the score passes convert every
// cached int8 element once per query row. Here each byte, flipped to
// x + 128, is placed in the low mantissa byte of 2^23 by one byte permute,
// and one subtraction of 2^23 + 128 gives x exactly.

#pragma once

#include <stdint.h>

__device__ __forceinline__ float4 int8x4_to_float4(uint32_t packed) {
  const uint32_t u = packed ^ 0x80808080u;  // each byte now x + 128, unsigned
  const float base = 8388736.0f;            // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - base,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - base,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - base,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - base);
}
