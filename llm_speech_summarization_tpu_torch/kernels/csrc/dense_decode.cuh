// Decode attention over one layer of a dense (L, B, Hkv, S, Dh) KV cache,
// for Hopper (sm_90a): the body shared by the fused decode kernels B2 and B3
// (fused_decode.cu, which also write the fresh tokens in place) and the
// read-only decode attention B8 (decode_attention.cu).
//
// Each of the T >= 1 fresh queries of sample b attends the cache slots
// pad[b] <= s < offset[b] of layer `layer` plus the fresh keys causally
// (fresh key j <= query t). The cache is int8 with bf16 per-slot scales
// (keys dequantized by k_scale, values weighted by p * v_scale) or bf16.
// With WRITE, the fresh k/v rows are then written at slots
// [offset, offset + T): an int8 cache takes them quantized exactly like
// models/llama.py::_quantize_kv (absmax / 127 in float32, floor 1e-8, IEEE
// division, rintf = round half to even, clip to +-127) with their bf16
// scales written into the scale slab at the slot or returned as (B, Hkv, T)
// outputs; a bf16 cache takes the fresh bf16 values as they are.
//
// What bounds it on the H100: reading the cache bytes. A step reads
// B * Hkv * S * Dh values of k and of v per layer and does ~2 multiply-adds
// per value per query row, far below the tensor-core line, so the design is
// about keeping enough cache bytes in flight:
//   * one block (8 warps) per (sample, kv head) computes its G = Hq / Hkv
//     query heads for all T tokens (R = T * G rows, R <= 32), so each cache
//     row of a kv head is read once for the whole group;
//   * the valid slots are staged into shared memory a chunk at a time with
//     16-byte loads, 8 in flight per thread (64 KB per chunk for either
//     cache type), rows padded by 4 bytes so that per-thread word reads of
//     neighbouring slots hit distinct banks;
//   * scores: a thread per (row, slot) pair from shared memory; softmax per
//     row in float32; values: a thread per head dimension accumulates all R
//     rows in registers over a second staging pass of V.
// Later designs split S across blocks (the grid is B * Hkv blocks, fewer
// than the 132 SMs at small batch) and overlap the staging with compute.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace dense_decode {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename CT>
struct Cache;  // per cache element type: quantized or not, slots per chunk
template <>
struct Cache<int8_t> {
  static constexpr bool QUANT = true;
  static constexpr int CHUNK = 512;
};
template <>
struct Cache<__nv_bfloat16> {
  static constexpr bool QUANT = false;
  static constexpr int CHUNK = 256;
};

struct Args {
  const __nv_bfloat16* q;  // (B, T, Hq, Dh), strides below
  void* kc;                // (L, B, Hkv, S, Dh) cache values
  void* vc;
  __nv_bfloat16* ks;  // int8 cache: per-slot scales, (.., B, Hkv, S) at scale_layer
  __nv_bfloat16* vs;
  __nv_bfloat16* ks_new;  // int8 + WRITE: (B, Hkv, T) fresh scales, or null to write
  __nv_bfloat16* vs_new;  // them into ks/vs at the fresh slots
  const __nv_bfloat16* kn;  // (B, T, Hkv, Dh) fresh keys/values, strides below
  const __nv_bfloat16* vn;
  const int* pads;     // (B,)
  const int* offsets;  // (B,), or null: every row at `offset`
  int offset;
  __nv_bfloat16* out;  // contiguous (B, T, Hq, Dh)
  int B, T, Hq, Hkv, S, layer, scale_layer;
  long long q_sb, q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh;
  float scale;
};

inline int rows_bucket(int R) { return R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32; }

// shared memory: floats q R*DH | k_new T*DH | v_new T*DH | scores R*S |
// fresh R*T | denom R | partial value sums (NT/DH - 1)*MAXR*DH | scale
// chunk CHUNK; then the staged rows CHUNK*(DH*sizeof(CT)+4) bytes (16-aligned)
template <typename CT>
__host__ __device__ inline size_t smem_floats(int DH, int MAXR, int R, int T, int S) {
  return (size_t)R * DH + 2 * (size_t)T * DH + (size_t)R * S + (size_t)R * T + R +
         (size_t)(NT / DH - 1) * MAXR * DH + Cache<CT>::CHUNK;
}

template <typename CT>
__host__ __device__ inline size_t smem_bytes(int DH, int MAXR, int R, int T, int S) {
  const size_t f = (sizeof(float) * smem_floats<CT>(DH, MAXR, R, T, S) + 15) / 16 * 16;
  return f + (size_t)Cache<CT>::CHUNK * (DH * sizeof(CT) + 4);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// stage slots [s0, s0 + n) of a (S, DH) slab into `rows` (stride DH *
// sizeof(CT) + 4 bytes) and, for an int8 cache, their bf16 scales into `sc`
// as floats; 16-byte global loads, UNR of them in flight per thread before
// any store
template <typename CT, int DH>
__device__ __forceinline__ void stage_chunk(const CT* __restrict__ slab,
                                            const __nv_bfloat16* __restrict__ scales, int s0,
                                            int n, int8_t* rows, float* sc) {
  constexpr int RB = DH * (int)sizeof(CT);  // row bytes
  constexpr int V16 = RB / 16;
  constexpr int UNR = 8;
  const int8_t* src = reinterpret_cast<const int8_t*>(slab);
  const int total = n * V16;
  for (int base = threadIdx.x; base < total; base += NT * UNR) {
    uint4 buf[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        buf[u] = *reinterpret_cast<const uint4*>(src + (size_t)(s0 + i / V16) * RB +
                                                 (i % V16) * 16);
      }
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(rows + (i / V16) * (RB + 4) + (i % V16) * 16);
        dst[0] = buf[u].x;
        dst[1] = buf[u].y;
        dst[2] = buf[u].z;
        dst[3] = buf[u].w;
      }
    }
  }
  if constexpr (Cache<CT>::QUANT) {
    for (int j = threadIdx.x; j < n; j += NT) sc[j] = __bfloat162float(scales[s0 + j]);
  }
}

// q . k over one staged row, float32
template <typename CT, int DH>
__device__ __forceinline__ float row_dot(const int8_t* kr, const float* qr) {
  float acc = 0.f;
  if constexpr (Cache<CT>::QUANT) {
#pragma unroll 8
    for (int w = 0; w < DH / 4; ++w) {
      const float4 k = int8x4_to_float4(*reinterpret_cast<const uint32_t*>(kr + 4 * w));
      const float4 q = *reinterpret_cast<const float4*>(qr + 4 * w);
      acc += q.x * k.x + q.y * k.y + q.z * k.z + q.w * k.w;
    }
  } else {
#pragma unroll 8
    for (int w = 0; w < DH / 2; ++w) {
      const float2 k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + 4 * w));
      const float2 q = *reinterpret_cast<const float2*>(qr + 2 * w);
      acc += q.x * k.x + q.y * k.y;
    }
  }
  return acc;
}

template <typename CT>
__device__ __forceinline__ float elem(const int8_t* row, int d) {
  if constexpr (Cache<CT>::QUANT) {
    return (float)row[d];
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  }
}

template <typename CT, int DH, int MAXR, bool WRITE>
__global__ void __launch_bounds__(NT) dense_decode_kernel(const Args a) {
  constexpr bool QUANT = Cache<CT>::QUANT;
  constexpr int CHUNK = Cache<CT>::CHUNK;
  constexpr int EPL = DH / 32;                  // elements per lane in the write pass
  constexpr int NG = NT / DH;                   // slot groups in the value pass
  constexpr int RS = DH * (int)sizeof(CT) + 4;  // staged row stride (bytes)
  const int S = a.S, T = a.T, Hkv = a.Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = a.Hq / Hkv;
  const int R = T * G;  // query rows, ordered (t, g)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;
  float* kn_s = q_s + R * DH;
  float* vn_s = kn_s + T * DH;
  float* sc = vn_s + T * DH;
  float* pf = sc + (size_t)R * S;
  float* den = pf + R * T;
  float* red = den + R;
  float* ch_scale = red + (NG - 1) * MAXR * DH;
  int8_t* rows = reinterpret_cast<int8_t*>(sm) +
                 (sizeof(float) * smem_floats<CT>(DH, MAXR, R, T, S) + 15) / 16 * 16;

  const int pad = max(a.pads[b], 0);
  const int off = a.offsets ? a.offsets[b] : a.offset;
  const int c_end = min(off, S);  // valid cache slots [pad, c_end)
  const size_t row0 = ((size_t)(a.layer * a.B + b) * Hkv + h) * S;  // (L, B, Hkv, S) index
  const size_t srow0 = ((size_t)(a.scale_layer * a.B + b) * Hkv + h) * S;
  CT* kslab = static_cast<CT*>(a.kc) + row0 * DH;
  CT* vslab = static_cast<CT*>(a.vc) + row0 * DH;
  const __nv_bfloat16* kscales = QUANT ? a.ks + srow0 : nullptr;
  const __nv_bfloat16* vscales = QUANT ? a.vs + srow0 : nullptr;

  for (int i = tid; i < R * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    q_s[i] = __bfloat162float(a.q[b * a.q_sb + t * a.q_st + (h * G + g) * a.q_sh + d]);
  }
  for (int i = tid; i < T * DH; i += NT) {
    const int t = i / DH, d = i % DH;
    kn_s[i] = __bfloat162float(a.kn[b * a.kn_sb + t * a.kn_st + h * a.kn_sh + d]);
    vn_s[i] = __bfloat162float(a.vn[b * a.vn_sb + t * a.vn_st + h * a.vn_sh + d]);
  }

  // ---- scores over the cache, a staged chunk at a time:
  //      (q . k) [* k_scale] * Dh^-0.5, one (row, slot) pair per thread
  for (int s0 = pad; s0 < c_end; s0 += CHUNK) {
    const int n = min(CHUNK, c_end - s0);
    __syncthreads();  // the previous chunk's rows are consumed
    stage_chunk<CT, DH>(kslab, kscales, s0, n, rows, ch_scale);
    __syncthreads();
    for (int idx = tid; idx < R * n; idx += NT) {
      const int r = idx / n, j = idx % n;
      float s = row_dot<CT, DH>(rows + j * RS, q_s + r * DH);
      if constexpr (QUANT) s *= ch_scale[j];
      sc[(size_t)r * S + s0 + j] = s * a.scale;
    }
  }
  __syncthreads();
  // ---- scores over the fresh block, causal within it
  for (int i = tid; i < R * T; i += NT) {
    const int r = i / T, j = i % T;
    float s = NEG_INF;
    if (j <= r / G) {
      float acc = 0.f;
      for (int d = 0; d < DH; ++d) acc += q_s[r * DH + d] * kn_s[j * DH + d];
      s = acc * a.scale;
    }
    pf[i] = s;
  }
  __syncthreads();

  // ---- softmax per row (a warp per row), unnormalized p in place
  for (int r = warp; r < R; r += NW) {
    float* srow = sc + (size_t)r * S;
    float* frow = pf + r * T;
    float mx = NEG_INF;
    for (int s = pad + lane; s < c_end; s += 32) mx = fmaxf(mx, srow[s]);
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, frow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = pad + lane; s < c_end; s += 32) {
      const float p = expf(srow[s] - mx);
      sum += p;
      srow[s] = p;
    }
    for (int j = lane; j < T; j += 32) {
      const float p = expf(frow[j] - mx);  // masked: exp(-1e30 - mx) == 0
      sum += p;
      frow[j] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0) den[r] = sum;
  }

  // ---- values, a staged chunk at a time: thread (d, group) sums
  //      p [* v_scale] * v
  const int d = tid % DH;
  const int grp = tid / DH;
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  for (int s0 = pad; s0 < c_end; s0 += CHUNK) {
    const int n = min(CHUNK, c_end - s0);
    __syncthreads();
    stage_chunk<CT, DH>(vslab, vscales, s0, n, rows, ch_scale);
    __syncthreads();
    for (int j = grp; j < n; j += NG) {
      float w = elem<CT>(rows + j * RS, d);
      if constexpr (QUANT) w *= ch_scale[j];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) acc[r] += sc[(size_t)r * S + s0 + j] * w;
      }
    }
  }
  if (grp > 0) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) red[((grp - 1) * MAXR + r) * DH + d] = acc[r];
    }
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) {
        float v = acc[r];
        for (int g2 = 1; g2 < NG; ++g2) v += red[((g2 - 1) * MAXR + r) * DH + d];
        for (int j = 0; j < T; ++j) v += pf[r * T + j] * vn_s[j * DH + d];
        const int t = r / G, g = r % G;
        a.out[(((size_t)b * T + t) * a.Hq + h * G + g) * DH + d] = __float2bfloat16_rn(v / den[r]);
      }
    }
  }

  if constexpr (WRITE) {
    // ---- the fresh rows at [off, off + T), a warp per (token, k or v)
    for (int i = warp; i < 2 * T; i += NW) {
      const int t = i / 2;
      const bool is_v = (i % 2) == 1;
      const float* src = (is_v ? vn_s : kn_s) + t * DH + lane * EPL;
      const int slot = off + t;
      const bool inside = slot >= 0 && slot < S;  // the wrapper guarantees offsets + T <= S
      CT* dst = (is_v ? vslab : kslab) + (size_t)slot * DH + lane * EPL;
      if constexpr (QUANT) {
        float x[EPL];
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          x[e] = src[e];
          amax = fmaxf(amax, fabsf(x[e]));
        }
        amax = warp_max(amax);
        const float qs = fmaxf(amax / 127.0f, 1e-8f);
        if (inside) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            dst[e] = (int8_t)fminf(fmaxf(rintf(x[e] / qs), -127.f), 127.f);
          }
          if (lane == 0) {
            const __nv_bfloat16 s16 = __float2bfloat16_rn(qs);
            __nv_bfloat16* fresh = is_v ? a.vs_new : a.ks_new;
            if (fresh) {
              fresh[((size_t)b * Hkv + h) * T + t] = s16;
            } else {
              (is_v ? a.vs : a.ks)[srow0 + slot] = s16;
            }
          }
        }
      } else if (inside) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) dst[e] = __float2bfloat16_rn(src[e]);
      }
    }
  }
}

template <typename CT, int DH, int MAXR, bool WRITE>
int launch(const Args& a, cudaStream_t stream) {
  const int R = a.T * (a.Hq / a.Hkv);
  const size_t smem = smem_bytes<CT>(DH, MAXR, R, a.T, a.S);
  cudaError_t err = cudaFuncSetAttribute(dense_decode_kernel<CT, DH, MAXR, WRITE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_decode_kernel<CT, DH, MAXR, WRITE><<<a.B * a.Hkv, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instance for the cache type, head dim and query rows of `a`
template <typename CT, bool WRITE>
int dispatch(const Args& a, int Dh, cudaStream_t s) {
  const int maxr = rows_bucket(a.T * (a.Hq / a.Hkv));
#define LSS_DENSE_LAUNCH(DH_)                                  \
  switch (maxr) {                                              \
    case 4: return launch<CT, DH_, 4, WRITE>(a, s);            \
    case 8: return launch<CT, DH_, 8, WRITE>(a, s);            \
    case 16: return launch<CT, DH_, 16, WRITE>(a, s);          \
    default: return launch<CT, DH_, 32, WRITE>(a, s);          \
  }
  if (Dh == 128) LSS_DENSE_LAUNCH(128)
  if (Dh == 64) LSS_DENSE_LAUNCH(64)
#undef LSS_DENSE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// shared memory bytes of the instance for these sizes
inline long long smem_for(int Dh, int T, int G, int S, int cache_bytes) {
  const int R = T * G;
  const int maxr = rows_bucket(R);
  return cache_bytes == 1 ? (long long)smem_bytes<int8_t>(Dh, maxr, R, T, S)
                          : (long long)smem_bytes<__nv_bfloat16>(Dh, maxr, R, T, S);
}

}  // namespace dense_decode
