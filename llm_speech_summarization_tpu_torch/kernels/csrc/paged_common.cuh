// Paged decode attention over page-major KV pools, for Hopper (sm_90a):
// the kernel shared by paged_attention.cu (B4: attention only, T >= 1) and
// fused_paged.cu (B5: attention at T = 1 plus the in-place write of the
// fresh token into its page).
//
// Pools are (L, P, Hkv, ps, Dh), int8 with bf16 per-slot scales
// (L, P, Hkv, ps), or bf16 without scales; a (P, Hkv, ps, Dh) layer view is
// the L = 1, layer = 0 case. Row b's logical position `pos` lives at page
// page_table[b, pos / ps], slot pos % ps, and is valid iff
// pad <= pos < length. Each of the T >= 1 fresh queries attends the valid
// cached positions plus the fresh keys causally (fresh key j <= query t).
//
// What bounds it on the H100: reading the pages. A step reads the valid
// positions' k and v rows of every (sequence, kv head) once, Dh bytes each
// (int8), and does ~2 multiply-adds per byte per query row: far below the
// tensor-core line, so the design keeps page bytes in flight and reads each
// of them once for all T * G query rows of its kv head:
//   * one block (8 warps) per (sequence, kv head) owns its R = T * G query
//     rows (R <= 32); it walks the row's pages from pad / ps to
//     ceil(length / ps), reading each page id from the table itself;
//   * each page's valid slots of k and v for head h are one contiguous run
//     in the page-major pool: staged into shared memory with 16-byte loads,
//     rows padded by 4 bytes so that per-thread word reads hit distinct
//     banks;
//   * scores: a thread per (row, slot) pair, dequantized by folding the k
//     scale into the score; an online softmax in float32 (a warp per row)
//     rescales the running sums page by page; values: a thread per (head
//     dimension, row group) accumulates every (NT / DH)-th row in registers,
//     at most MAXR / (NT / DH) of them (a first build that kept all MAXR
//     rows in every thread was several times slower in its 16-row instance
//     than in its 8-row one), the v scale folded into the probability;
//   * the fresh block folds in last, causally, as in the TPU kernel.
// Later designs overlap the staging of page t+1 with the compute of page t
// and split long rows across blocks (the grid is B * Hkv blocks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace lss_paged {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16* q;   // (B, T, Hq, Dh), strides below
  void* k_pool;             // (L, P, Hkv, ps, Dh) int8 or bf16, contiguous
  void* v_pool;
  __nv_bfloat16* k_scale;   // (L, P, Hkv, ps) iff int8 pools
  __nv_bfloat16* v_scale;
  const int* page_table;    // (B, mp)
  const int* lengths;       // (B,)
  const int* pads;          // (B,)
  const __nv_bfloat16* k_new;  // (B, T, Hkv, Dh), strides below
  const __nv_bfloat16* v_new;
  __nv_bfloat16* out;       // (B, T, Hq, Dh) contiguous
  int T, Hq, Hkv, P, ps, mp, layer;
  long long q_sb, q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh;
  float scale;
};

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

__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// q row (float, 16-byte aligned) . staged cache row (4-byte aligned)
template <int DH>
__device__ __forceinline__ float dot_row(const float* q, const int8_t* k) {
  float acc = 0.f;
#pragma unroll 8
  for (int w = 0; w < DH / 4; ++w) {
    const float4 f = int8x4_to_float4(*reinterpret_cast<const uint32_t*>(k + 4 * w));
    const float4 x = *reinterpret_cast<const float4*>(q + 4 * w);
    acc += x.x * f.x + x.y * f.y + x.z * f.z + x.w * f.w;
  }
  return acc;
}

template <int DH>
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k) {
  float acc = 0.f;
#pragma unroll 8
  for (int w = 0; w < DH / 2; ++w) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + 2 * w));
    const float2 x = *reinterpret_cast<const float2*>(q + 2 * w);
    acc += x.x * f.x + x.y * f.y;
  }
  return acc;
}

// copy n rows of ROWB contiguous bytes from global `src` (16-byte aligned)
// into shared `dst` at a row stride of ROWB + 4 bytes; 16-byte loads, UNR of
// them in flight per thread before any store
template <int ROWB>
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ src, int n, uint8_t* dst) {
  constexpr int V16 = ROWB / 16;
  constexpr int RSB = ROWB + 4;
  constexpr int UNR = 4;
  const int total = n * V16;
  for (int base = threadIdx.x; base < total; base += NT * UNR) {
    uint4 buf[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < total) buf[u] = *reinterpret_cast<const uint4*>(src + (size_t)i * 16);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        uint32_t* d = reinterpret_cast<uint32_t*>(dst + (i / V16) * RSB + (i % V16) * 16);
        d[0] = buf[u].x;
        d[1] = buf[u].y;
        d[2] = buf[u].z;
        d[3] = buf[u].w;
      }
    }
  }
}

// shared memory: floats q R*DH | k_new T*DH | v_new T*DH | p R*ps | fresh
// p R*T | m, l, alpha 3R | k, v scales 2*ps; then the staged k and v rows,
// 2 * ps * (row + 4) bytes (16-aligned)
__host__ __device__ inline size_t smem_floats(int DH, int R, int T, int ps) {
  return (size_t)R * DH + 2 * (size_t)T * DH + (size_t)R * ps + (size_t)R * T + 3 * (size_t)R +
         2 * (size_t)ps;
}

__host__ __device__ inline size_t smem_bytes(int DH, int R, int T, int ps, int elem_bytes) {
  const size_t f = (sizeof(float) * smem_floats(DH, R, T, ps) + 15) / 16 * 16;
  return f + 2 * (size_t)ps * (DH * elem_bytes + 4);
}

inline int max_rows_for(int R) { return R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32; }

// WRITE (T == 1): after the attention, quantize the fresh k/v exactly like
// models/llama.py::_quantize_kv (absmax / 127 in float32 by IEEE division,
// floor 1e-8, rintf = round half to even, clip to +-127) and write values
// and bf16 scales at [layer, pid, h, length % ps], pid = page_table[b,
// length / ps] inside the table, else the null page 0 (the routing of
// infer/paged.py::write_tokens); bf16 pools take the fresh bf16 values.
template <typename CacheT, int DH, int MAXR, bool WRITE>
__global__ void __launch_bounds__(NT) paged_kernel(const Args a) {
  constexpr bool QUANT = sizeof(CacheT) == 1;
  constexpr int ROWB = DH * (int)sizeof(CacheT);
  constexpr int RSB = ROWB + 4;
  constexpr int NG = NT / DH;     // row groups in the value pass
  constexpr int RPT = MAXR / NG;  // rows a value-pass thread accumulates
  constexpr int EPL = DH / 32;
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int T = a.T, ps = a.ps;
  const int G = a.Hq / a.Hkv;
  const int R = T * G;  // query rows, ordered (t, g)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;
  float* kn_s = q_s + R * DH;
  float* vn_s = kn_s + T * DH;
  float* p_s = vn_s + T * DH;
  float* pf = p_s + (size_t)R * ps;
  float* m_s = pf + R * T;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  float* ksc = a_s + R;
  float* vsc = ksc + ps;
  uint8_t* krows = reinterpret_cast<uint8_t*>(sm) +
                   (sizeof(float) * smem_floats(DH, R, T, ps) + 15) / 16 * 16;
  uint8_t* vrows = krows + (size_t)ps * RSB;

  for (int i = tid; i < R * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    q_s[i] = __bfloat162float(a.q[b * a.q_sb + t * a.q_st + (h * G + g) * a.q_sh + d]);
  }
  for (int i = tid; i < T * DH; i += NT) {
    const int t = i / DH, d = i % DH;
    kn_s[i] = __bfloat162float(a.k_new[b * a.kn_sb + t * a.kn_st + h * a.kn_sh + d]);
    vn_s[i] = __bfloat162float(a.v_new[b * a.vn_sb + t * a.vn_st + h * a.vn_sh + d]);
  }
  for (int r = tid; r < R; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const CacheT* kp = static_cast<const CacheT*>(a.k_pool);
  const CacheT* vp = static_cast<const CacheT*>(a.v_pool);
  const int pad = max(a.pads[b], 0);
  const int len = a.lengths[b];
  const int c_end = min(len, a.mp * ps);  // valid cached positions [pad, c_end)
  const int d = tid % DH;
  const int grp = tid / DH;  // this thread's rows: grp, grp + NG, ... (balanced)
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int t = pad / ps; pad < c_end && t * ps < c_end; ++t) {
    const int j0 = max(pad - t * ps, 0);
    const int j1 = min(c_end - t * ps, ps);  // j0 < j1 since pad < c_end
    int pid = a.page_table[(size_t)b * a.mp + t];
    if (pid < 0 || pid >= a.P) pid = 0;
    const size_t slab = (((size_t)a.layer * a.P + pid) * a.Hkv + h) * ps;  // slot index
    __syncthreads();  // the previous page's rows and probabilities are consumed
    stage_rows<ROWB>(reinterpret_cast<const uint8_t*>(kp + slab * DH) + (size_t)j0 * ROWB,
                     j1 - j0, krows + (size_t)j0 * RSB);
    stage_rows<ROWB>(reinterpret_cast<const uint8_t*>(vp + slab * DH) + (size_t)j0 * ROWB,
                     j1 - j0, vrows + (size_t)j0 * RSB);
    if (QUANT) {
      for (int j = j0 + tid; j < j1; j += NT) {
        ksc[j] = __bfloat162float(a.k_scale[slab + j]);
        vsc[j] = __bfloat162float(a.v_scale[slab + j]);
      }
    }
    __syncthreads();
    const int n = j1 - j0;
    for (int idx = tid; idx < R * n; idx += NT) {
      const int r = idx / n, j = j0 + idx % n;
      float s = dot_row<DH>(q_s + r * DH, reinterpret_cast<const CacheT*>(krows + j * RSB));
      if (QUANT) s *= ksc[j];
      p_s[r * ps + j] = s * a.scale;
    }
    __syncthreads();
    // online softmax, a warp per row; p_s becomes p (times the v scale)
    for (int r = warp; r < R; r += NW) {
      float* prow = p_s + r * ps;
      const float m_old = m_s[r];
      float mx = NEG_INF;
      for (int j = j0 + lane; j < j1; j += 32) mx = fmaxf(mx, prow[j]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = j0 + lane; j < j1; j += 32) {
        const float p = expf(prow[j] - m_new);
        sum += p;
        prow[j] = QUANT ? p * vsc[j] : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (grp + NG * i < R) acc[i] *= a_s[grp + NG * i];
    }
    for (int j = j0; j < j1; ++j) {
      const float w = to_float(reinterpret_cast<const CacheT*>(vrows + j * RSB)[d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (grp + NG * i < R) acc[i] += p_s[(grp + NG * i) * ps + j] * w;
      }
    }
  }
  __syncthreads();

  // ---- the fresh block, causal within it, folds in last
  for (int i = tid; i < R * T; i += NT) {
    const int r = i / T, j = i % T;
    float s = NEG_INF;
    if (j <= r / G) {
      float dot = 0.f;
      for (int e = 0; e < DH; ++e) dot += q_s[r * DH + e] * kn_s[j * DH + e];
      s = dot * a.scale;
    }
    pf[i] = s;
  }
  __syncthreads();
  for (int r = warp; r < R; r += NW) {
    float* frow = pf + r * T;
    const float m_old = m_s[r];
    float mx = NEG_INF;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, frow[j]);
    const float m_new = fmaxf(m_old, warp_max(mx));  // finite: fresh key 0 is always valid
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float p = j <= r / G ? expf(frow[j] - m_new) : 0.f;
      sum += p;
      frow[j] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      a_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + sum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = grp + NG * i;
    if (r < R) {
      float v = acc[i] * a_s[r];
      for (int j = 0; j < T; ++j) v += pf[r * T + j] * vn_s[j * DH + d];
      const int t = r / G, g = r % G;
      a.out[(((size_t)b * T + t) * a.Hq + h * G + g) * DH + d] = __float2bfloat16_rn(v / l_s[r]);
    }
  }

  if (WRITE && warp < 2) {  // warp 0 writes k, warp 1 writes v (T == 1)
    const bool is_v = warp == 1;
    const float* src = (is_v ? vn_s : kn_s) + lane * EPL;
    const int tw = len >= 0 ? len / ps : -((-len + ps - 1) / ps);  // floor division
    const int slot = len - tw * ps;
    int pid = (tw >= 0 && tw < a.mp) ? a.page_table[(size_t)b * a.mp + tw] : 0;
    if (pid < 0 || pid >= a.P) pid = 0;
    const size_t dst = (((size_t)a.layer * a.P + pid) * a.Hkv + h) * ps + slot;
    CacheT* pool = static_cast<CacheT*>(is_v ? a.v_pool : a.k_pool);
    float x[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) x[e] = src[e];
    if (QUANT) {
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
      amax = warp_max(amax);
      const float qs = fmaxf(amax / 127.0f, 1e-8f);
      int8_t* row = reinterpret_cast<int8_t*>(pool) + dst * DH + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) row[e] = (int8_t)fminf(fmaxf(rintf(x[e] / qs), -127.f), 127.f);
      if (lane == 0) (is_v ? a.v_scale : a.k_scale)[dst] = __float2bfloat16_rn(qs);
    } else {
      __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(pool) + dst * DH + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) row[e] = __float2bfloat16_rn(x[e]);
    }
  }
}

template <typename CacheT, int DH, int MAXR, bool WRITE>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.T * (a.Hq / a.Hkv);
  const size_t smem = smem_bytes(DH, R, a.T, a.ps, (int)sizeof(CacheT));
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<CacheT, DH, MAXR, WRITE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_kernel<CacheT, DH, MAXR, WRITE><<<B * a.Hkv, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename CacheT, int DH, bool WRITE>
int dispatch_rows(const Args& a, int B, cudaStream_t stream) {
  switch (max_rows_for(a.T * (a.Hq / a.Hkv))) {
    case 4: return launch<CacheT, DH, 4, WRITE>(a, B, stream);
    case 8: return launch<CacheT, DH, 8, WRITE>(a, B, stream);
    case 16: return launch<CacheT, DH, 16, WRITE>(a, B, stream);
    default: return launch<CacheT, DH, 32, WRITE>(a, B, stream);
  }
}

// the wrapper has checked every shape: Dh in (64, 128), R <= 32, ps % 16 == 0
template <bool WRITE>
int dispatch(const Args& a, int B, int Dh, int int8_pools, cudaStream_t stream) {
  if (int8_pools) {
    if (Dh == 128) return dispatch_rows<int8_t, 128, WRITE>(a, B, stream);
    if (Dh == 64) return dispatch_rows<int8_t, 64, WRITE>(a, B, stream);
  } else {
    if (Dh == 128) return dispatch_rows<__nv_bfloat16, 128, WRITE>(a, B, stream);
    if (Dh == 64) return dispatch_rows<__nv_bfloat16, 64, WRITE>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

inline long long shared_bytes(int Dh, int T, int G, int ps, int int8_pools) {
  return (long long)smem_bytes(Dh, T * G, T, ps, int8_pools ? 1 : 2);
}

}  // namespace lss_paged
