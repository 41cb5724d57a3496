// Shared by the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): tile sizes, the masked-score constant and the
// tile loader. Every tile is 64 rows of a (B, T, H, Dh) bf16 tensor read
// through its strides into a padded shared-memory tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lss_flash {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int NTHREADS = 128;  // 4 warps, 16 tile rows each
constexpr float NEG_INF = -1e30f;

// padded row stride of a bf16 (64, DH) tile: keeps WMMA pointers 32-byte
// aligned and spreads the rows over the banks
template <int DH>
__host__ __device__ constexpr int ldh() { return DH + 8; }

// copy 64 rows of DH bf16 (16 bytes per vector) starting at row0 into a
// padded tile, zero-filling rows at or past T
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int T) {
  constexpr int VPR = DH / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ldh<DH>() + c) = val;
  }
}

}  // namespace lss_flash
