// Shared pieces of the float32 flash kernels (flash_attention_f32.cu, the
// forward with or without its log-sum-exp; flash_attention_bwd_f32.cu, dq
// and dk/dv): constants and the tile loader.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lss_f32 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;  // a masked score (never -inf)
constexpr int THREADS = 256;       // every float32 flash block: 16 x 16 threads

// rows [r0, r0 + R) of one head of a (B, T, H, DH) float32 tensor into
// shared memory at row stride S floats; rows at or past T are zeros. Rows
// are read as float4 (16-byte aligned, the wrappers check it).
template <int DH, int R, int S>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long st, int r0,
                                          int T) {
  constexpr int V4 = DH / 4;  // float4 per row
  for (int idx = threadIdx.x; idx < R * V4; idx += THREADS) {
    const int r = idx / V4, c = 4 * (idx % V4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * st + c);
    float* d = dst + r * S + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

}  // namespace lss_f32
