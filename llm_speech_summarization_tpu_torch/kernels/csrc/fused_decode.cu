// Fused decode attention over an int8 KV cache plus the in-place quantized
// write of the fresh tokens, for Hopper (sm_90a).
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// fused_decode.py::_fused_kernel_aliased (reached through
// fused_decode_aliased_scales), the engine's default decode step. For layer
// `layer` of the (L, B, Hkv, S, Dh) int8 cache with (L, B, Hkv, S) bf16
// per-slot scales, each of the T >= 1 fresh queries attends the cache slots
// pad <= s < offset (keys dequantized by k_scale, values weighted by
// p * v_scale) plus the fresh keys causally (fresh key j <= query t,
// unquantized). Then the fresh k/v rows are quantized exactly like
// models/llama.py::_quantize_kv (absmax / 127 in float32, floor 1e-8, IEEE
// division, rintf = round half to even, clip to +-127) and written, values
// and bf16 scales, at slots [offset, offset + T) in place.
//
// The TPU's padded (Spad = pad128(S)) scale slabs and 32-row write windows
// were TPU layout rules; here the scales are plain (L, B, Hkv, S) and the
// write touches exactly the T fresh slots.
//
// What bounds it on the H100: reading the int8 cache bytes. A step reads
// B * Hkv * S * Dh * 2 bytes per layer and does ~2 multiply-adds per byte
// per query row, far below the tensor-core line, so the design is about
// keeping enough cache bytes in flight:
//   * one block (8 warps) per (sample, kv head) computes its G = Hq / Hkv
//     query heads for all T tokens (R = T * G rows, R <= 32), so each cache
//     row of a kv head is read once for the whole group;
//   * the valid slots are staged into shared memory CHUNK at a time with
//     16-byte loads, 8 in flight per thread (32 KB per block), rows padded
//     to DH + 4 bytes so that per-thread word reads hit distinct banks;
//   * scores: a thread per (row, slot) pair from shared memory; softmax
//     per row in float32; values: a thread per head dimension accumulates
//     all R rows in registers over a second staging pass of V.
// Later designs split S across blocks (the grid is B * Hkv blocks, fewer
// than the 132 SMs at small batch) and overlap the staging with compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int CHUNK = 512;  // cache slots staged in shared memory at a time
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// shared memory: floats q R*DH | k_new T*DH | v_new T*DH | scores R*S |
// fresh R*T | denom R | partial value sums (NT/DH - 1)*MAXR*DH | scale
// chunk CHUNK; then the staged int8 rows CHUNK*(DH+4) bytes (16-aligned)
__host__ __device__ inline size_t smem_floats(int DH, int MAXR, int R, int T, int S) {
  return (size_t)R * DH + 2 * (size_t)T * DH + (size_t)R * S + (size_t)R * T + R +
         (size_t)(NT / DH - 1) * MAXR * DH + CHUNK;
}

__host__ __device__ inline size_t smem_bytes(int DH, int MAXR, int R, int T, int S) {
  const size_t f = (sizeof(float) * smem_floats(DH, MAXR, R, T, S) + 15) / 16 * 16;
  return f + (size_t)CHUNK * (DH + 4);
}

// stage slots [s0, s0 + n) of a (S, DH) int8 slab into `rows` (stride DH+4
// bytes) and their bf16 scales into `sc` as floats; 16-byte global loads,
// UNR of them in flight per thread before any store
template <int DH>
__device__ __forceinline__ void stage_chunk(const int8_t* __restrict__ slab,
                                            const __nv_bfloat16* __restrict__ scales, int s0,
                                            int n, int8_t* rows, float* sc) {
  constexpr int V16 = DH / 16;
  constexpr int UNR = 8;
  const int total = n * V16;
  for (int base = threadIdx.x; base < total; base += NT * UNR) {
    uint4 buf[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        buf[u] = *reinterpret_cast<const uint4*>(slab + (size_t)(s0 + i / V16) * DH +
                                                 (i % V16) * 16);
      }
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(rows + (i / V16) * (DH + 4) + (i % V16) * 16);
        dst[0] = buf[u].x;
        dst[1] = buf[u].y;
        dst[2] = buf[u].z;
        dst[3] = buf[u].w;
      }
    }
  }
  for (int j = threadIdx.x; j < n; j += NT) sc[j] = __bfloat162float(scales[s0 + j]);
}

__device__ __forceinline__ float dot4(uint32_t packed, float4 q) {
  const float4 k = int8x4_to_float4(packed);
  return q.x * k.x + q.y * k.y + q.z * k.z + q.w * k.w;
}

template <int DH, int MAXR>
__global__ void __launch_bounds__(NT)
fused_decode_kernel(const __nv_bfloat16* __restrict__ q, int8_t* __restrict__ kc,
                    int8_t* __restrict__ vc, __nv_bfloat16* __restrict__ ks,
                    __nv_bfloat16* __restrict__ vs, const __nv_bfloat16* __restrict__ kn,
                    const __nv_bfloat16* __restrict__ vn, const int* __restrict__ pads,
                    const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out, int B,
                    int T, int Hq, int Hkv, int S, int layer, long long q_sb, long long q_st,
                    long long q_sh, long long kn_sb, long long kn_st, long long kn_sh,
                    long long vn_sb, long long vn_st, long long vn_sh, float scale) {
  constexpr int EPL = DH / 32;  // elements per lane in the quantize pass
  constexpr int NG = NT / DH;   // slot groups in the value pass
  constexpr int RS = DH + 4;    // staged row stride (bytes)
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
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
                 (sizeof(float) * smem_floats(DH, MAXR, R, T, S) + 15) / 16 * 16;

  const int pad = max(pads[b], 0);
  const int off = offsets[b];
  const int c_end = min(off, S);  // valid cache slots [pad, c_end)
  const size_t row0 = ((size_t)(layer * B + b) * Hkv + h) * S;  // (L, B, Hkv, S) index
  const int8_t* kslab = kc + row0 * DH;
  const int8_t* vslab = vc + row0 * DH;

  for (int i = tid; i < R * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    q_s[i] = __bfloat162float(q[b * q_sb + t * q_st + (h * G + g) * q_sh + d]);
  }
  for (int i = tid; i < T * DH; i += NT) {
    const int t = i / DH, d = i % DH;
    kn_s[i] = __bfloat162float(kn[b * kn_sb + t * kn_st + h * kn_sh + d]);
    vn_s[i] = __bfloat162float(vn[b * vn_sb + t * vn_st + h * vn_sh + d]);
  }

  // ---- scores over the cache, a staged chunk at a time:
  //      (q . k_int8) * k_scale * Dh^-0.5, one (row, slot) pair per thread
  for (int s0 = pad; s0 < c_end; s0 += CHUNK) {
    const int n = min(CHUNK, c_end - s0);
    __syncthreads();  // the previous chunk's rows are consumed
    stage_chunk<DH>(kslab, ks + row0, s0, n, rows, ch_scale);
    __syncthreads();
    for (int idx = tid; idx < R * n; idx += NT) {
      const int r = idx / n, j = idx % n;
      const float* qr = q_s + r * DH;
      const int8_t* kr = rows + j * RS;
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < DH / 4; ++w) {
        acc += dot4(*reinterpret_cast<const uint32_t*>(kr + 4 * w),
                    *reinterpret_cast<const float4*>(qr + 4 * w));
      }
      sc[(size_t)r * S + s0 + j] = acc * ch_scale[j] * scale;
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
      s = acc * scale;
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

  // ---- values, a staged chunk at a time: thread (d, group) sums p * v_scale * v
  const int d = tid % DH;
  const int grp = tid / DH;
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  for (int s0 = pad; s0 < c_end; s0 += CHUNK) {
    const int n = min(CHUNK, c_end - s0);
    __syncthreads();
    stage_chunk<DH>(vslab, vs + row0, s0, n, rows, ch_scale);
    __syncthreads();
    for (int j = grp; j < n; j += NG) {
      const float w = (float)rows[j * RS + d] * ch_scale[j];
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
        float a = acc[r];
        for (int g2 = 1; g2 < NG; ++g2) a += red[((g2 - 1) * MAXR + r) * DH + d];
        for (int j = 0; j < T; ++j) a += pf[r * T + j] * vn_s[j * DH + d];
        const int t = r / G, g = r % G;
        out[(((size_t)b * T + t) * Hq + h * G + g) * DH + d] = __float2bfloat16_rn(a / den[r]);
      }
    }
  }

  // ---- quantize the fresh rows and write values + scales at [off, off+T)
  for (int i = warp; i < 2 * T; i += NW) {
    const int t = i / 2;
    const bool is_v = (i % 2) == 1;
    const float* src = (is_v ? vn_s : kn_s) + t * DH + lane * EPL;
    float x[EPL];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      x[e] = src[e];
      amax = fmaxf(amax, fabsf(x[e]));
    }
    amax = warp_max(amax);
    const float qs = fmaxf(amax / 127.0f, 1e-8f);
    const int slot = off + t;
    if (slot >= 0 && slot < S) {  // the wrapper guarantees offsets + T <= S
      int8_t* dst = (is_v ? vc : kc) + (row0 + slot) * DH + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        dst[e] = (int8_t)fminf(fmaxf(rintf(x[e] / qs), -127.f), 127.f);
      }
      if (lane == 0) (is_v ? vs : ks)[row0 + slot] = __float2bfloat16_rn(qs);
    }
  }
}

template <int DH, int MAXR>
int launch(const void* q, void* kc, void* vc, void* ks, void* vs, const void* kn,
           const void* vn, const int* pads, const int* offsets, void* out, int B, int T,
           int Hq, int Hkv, int S, int layer, const long long* st, float scale,
           cudaStream_t stream) {
  const int R = T * (Hq / Hkv);
  const size_t smem = smem_bytes(DH, MAXR, R, T, S);
  cudaError_t err = cudaFuncSetAttribute(fused_decode_kernel<DH, MAXR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_decode_kernel<DH, MAXR><<<B * Hkv, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<int8_t*>(kc),
      static_cast<int8_t*>(vc), static_cast<__nv_bfloat16*>(ks),
      static_cast<__nv_bfloat16*>(vs), static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(vn), pads, offsets,
      static_cast<__nv_bfloat16*>(out), B, T, Hq, Hkv, S, layer, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch_rows(const void* q, void* kc, void* vc, void* ks, void* vs, const void* kn,
                  const void* vn, const int* pads, const int* offsets, void* out, int B,
                  int T, int Hq, int Hkv, int S, int layer, const long long* st, float scale,
                  cudaStream_t stream) {
  const int R = T * (Hq / Hkv);
#define LSS_LAUNCH(M)                                                                    \
  return launch<DH, M>(q, kc, vc, ks, vs, kn, vn, pads, offsets, out, B, T, Hq, Hkv, S, \
                       layer, st, scale, stream)
  if (R <= 4) LSS_LAUNCH(4);
  if (R <= 8) LSS_LAUNCH(8);
  if (R <= 16) LSS_LAUNCH(16);
  if (R <= 32) LSS_LAUNCH(32);
#undef LSS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory bytes the kernel needs (the wrapper checks it against the
// device limit before launching).
extern "C" long long lss_fused_decode_smem_bytes(int Dh, int T, int G, int S) {
  const int R = T * G;
  const int maxr = R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32;
  return (long long)smem_bytes(Dh, maxr, R, T, S);
}

// strides: 9 element strides (b, t, h) for q, k_new, v_new, in that order.
// The caches and scales are contiguous, out is contiguous (B, T, Hq, Dh).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_fused_decode(const void* q, void* k_cache, void* v_cache, void* k_scale,
                                void* v_scale, const void* k_new, const void* v_new,
                                const void* pad_lens, const void* offsets, void* out, int B,
                                int T, int Hq, int Hkv, int S, int Dh, int layer,
                                const long long* strides, float scale, void* stream) {
  const int* pads = static_cast<const int*>(pad_lens);
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return dispatch_rows<128>(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pads, offs,
                              out, B, T, Hq, Hkv, S, layer, strides, scale, s);
  if (Dh == 64)
    return dispatch_rows<64>(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pads, offs,
                             out, B, T, Hq, Hkv, S, layer, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
