// K2: absorbed latent (MLA) decode attention over an int8 latent cache, with
// the fresh latents written in place, for Hopper (sm_90a).
//
// The decode form of DeepSeek-V3's multi-head latent attention
// (Moonlight-16B-A3B: 16 heads, a 512-wide latent c and a 64-wide rope key
// shared by every head). Each of the 16 query heads arrives absorbed,
// q = [q_nope . W_uk (512) | q_pe (64)], and attends, with one latent row per
// slot as its key [c | k_pe] (576) and its value c (512):
//   * the cached slots pad <= s < offset of one layer of the (L, B, 1, S, 512)
//     int8 c cache and (L, B, 1, S, 64) int8 k_pe cache, each row with its
//     bf16 scale ((L, B, 1, S) each): score = (q_c . c_int8) * c_scale +
//     (q_pe . kpe_int8) * kpe_scale, p weighted by c_scale against c_int8;
//   * the T fresh latents (bf16, as computed), causally;
// at softmax scale 192^-0.5; the output is the latent (B, T, 16, 512), which
// the caller takes through W_uv. The fresh latents are then quantized like
// the JAX package's _quantize_kv (per-row absmax / 127, floor 1e-8, IEEE
// quotients, round half to even, bf16 scale) and written at slots
// [offset, offset + T), bit for bit.
//
// It replaces no TPU kernel (the JAX package has no latent attention); it is
// B2's analogue (csrc/dense_decode.cuh) for one latent "head" that 16 query
// heads share: B2 cannot take it, since its keys are 576 wide and its values
// 512 of the same row.
//
// What bounds it on the H100: bytes. A slot is 580 bytes (int8 c and k_pe,
// two bf16 scales) read once for all 16 heads, against 2 x 16 x 1,088 FLOPs:
// ~60 FLOPs a byte, below the card's ~295 on the tensor cores. The design:
// one block of 8 warps per (sample, fresh token, split) with the 16 heads as
// the 16 rows of mma.sync m16n8k16 tiles (bf16, float32 sums); each 64-slot
// chunk is converted from int8 to bf16 once into shared memory (int8 values
// are exact in bf16; the scales are applied to the float32 scores and to p),
// the scores of 8 slots a warp, an online softmax across the block in
// float32, then P (bf16) . V with each warp owning 64 of the 512 value
// columns (ldmatrix.trans on the same staged rows). As in B2, the window is
// split over up to 8 blocks where the batch leaves SMs idle, and a second
// kernel merges the splits in a fixed order; every sum has a fixed order,
// so repeats are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8.cuh"

namespace latent {

constexpr int H = 16;     // query heads: the m16 rows
constexpr int R = 512;    // latent width (the value)
constexpr int DR = 64;    // rope key width
constexpr int DQ = R + DR;
constexpr int LD = DQ + 8;  // padded row (1,168 bytes) so ldmatrix's 8 rows miss each other's banks
constexpr int CH = 64;      // slots a chunk
constexpr int PLD = CH + 8;
constexpr int THREADS = 256;
constexpr int MAX_SPLITS = 8;

struct Args {
  const __nv_bfloat16* q;  // (B, T, H, DQ) with strides
  int8_t* c_cache;         // (L, B, S, R)
  __nv_bfloat16* c_scale;  // (L, B, S)
  int8_t* pe_cache;        // (L, B, S, DR)
  __nv_bfloat16* pe_scale;
  const __nv_bfloat16* c_new;   // (B, T, R) contiguous
  const __nv_bfloat16* pe_new;  // (B, T, DR) contiguous
  const int* pads;
  const int* offsets;
  __nv_bfloat16* out;  // (B, T, H, R)
  float* part;         // (B * T, nsplit, H, R + 2) when nsplit > 1
  long long q_sb, q_st, q_sh;
  int B, T, S, layer, nsplit;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the warp's share of one fresh row quantized into the int8 cache: n values
// a lane (contiguous), the row's bf16 scale written by lane 0
template <int N>
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* x, int8_t* dst,
                                             __nv_bfloat16* scale_dst, int lane) {
  float v[N];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = __bfloat162float(x[lane * N + i]);
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
    dst[lane * N + i] = static_cast<int8_t>(r);
  }
  if (lane == 0) *scale_dst = __float2bfloat16_rn(s);
}

__global__ void __launch_bounds__(THREADS) latent_decode_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + H * LD;
  float* sS = reinterpret_cast<float*>(sK + CH * LD);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + H * CH);
  float* sCs = reinterpret_cast<float*>(sP + H * PLD);
  float* sPs = sCs + CH;
  float* sM = sPs + CH;
  float* sL = sM + H;
  float* sAlpha = sL + H;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bt = blockIdx.x, split = blockIdx.y;
  const int b = bt / a.T, t = bt % a.T;
  const int pad = a.pads[b], off = a.offsets[b];
  const size_t lb = static_cast<size_t>(a.layer) * a.B + b;  // (layer, sample) row of the cache

  if (split == 0 && warp < 2) {  // the fresh latent of token t, into slot off + t
    const size_t slot = lb * a.S + off + t;
    const size_t fresh = static_cast<size_t>(b) * a.T + t;
    if (warp == 0)
      quantize_row<R / 32>(a.c_new + fresh * R, a.c_cache + slot * R, a.c_scale + slot, lane);
    else
      quantize_row<DR / 32>(a.pe_new + fresh * DR, a.pe_cache + slot * DR, a.pe_scale + slot,
                            lane);
  }

  const __nv_bfloat16* qrow = a.q + b * a.q_sb + t * a.q_st;
  for (int i = tid; i < H * (DQ / 8); i += THREADS) {
    const int h = i / (DQ / 8), c = i % (DQ / 8);
    *reinterpret_cast<uint4*>(sQ + h * LD + c * 8) =
        *reinterpret_cast<const uint4*>(qrow + h * a.q_sh + c * 8);
  }
  if (tid < H) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  // the virtual window: cached slots [pad, off) (none where pad >= off),
  // then the fresh ones
  const int start = min(pad, off), end = off + a.T;
  const int per = (end - start + a.nsplit - 1) / a.nsplit;
  const int lo = start + split * per;
  const int hi = min(end, lo + per);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int c0 = lo; c0 < hi; c0 += CH) {
    __syncthreads();  // the previous chunk's readers are done with sK, sP
    // stage: 64 slots x 36 units of 16 values (32 of c, 4 of k_pe), as bf16
    for (int i = tid; i < CH * (DQ / 16); i += THREADS) {
      const int slot = i / (DQ / 16), u = i % (DQ / 16);
      const int s = c0 + slot;
      __nv_bfloat16* dst = sK + slot * LD + u * 16;
      uint4 lo4 = make_uint4(0, 0, 0, 0), hi4 = make_uint4(0, 0, 0, 0);
      float cs = 0.f, ps = 0.f;
      if (s < hi && s < off) {
        const int8_t* src = u < R / 16 ? a.c_cache + (lb * a.S + s) * R + u * 16
                                       : a.pe_cache + (lb * a.S + s) * DR + (u - R / 16) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 f = int8x4_to_float4(w[k]);
          __nv_bfloat162 p0 = __floats2bfloat162_rn(f.x, f.y), p1 = __floats2bfloat162_rn(f.z, f.w);
          o[2 * k] = *reinterpret_cast<uint32_t*>(&p0);
          o[2 * k + 1] = *reinterpret_cast<uint32_t*>(&p1);
        }
        lo4 = make_uint4(o[0], o[1], o[2], o[3]);
        hi4 = make_uint4(o[4], o[5], o[6], o[7]);
        if (u == 0) {
          cs = __bfloat162float(a.c_scale[lb * a.S + s]);
          ps = __bfloat162float(a.pe_scale[lb * a.S + s]);
        }
      } else if (s < hi && s - off <= t) {
        const size_t fresh = static_cast<size_t>(b) * a.T + (s - off);
        const __nv_bfloat16* src = u < R / 16 ? a.c_new + fresh * R + u * 16
                                              : a.pe_new + fresh * DR + (u - R / 16) * 16;
        lo4 = *reinterpret_cast<const uint4*>(src);
        hi4 = *reinterpret_cast<const uint4*>(src + 8);
        cs = ps = 1.f;
      }
      *reinterpret_cast<uint4*>(dst) = lo4;
      *reinterpret_cast<uint4*>(dst + 8) = hi4;
      if (u == 0) {
        sCs[slot] = cs;  // 0 marks a slot outside the window
        sPs[slot] = ps;
      }
    }
    __syncthreads();

    // scores: warp w takes slots 8w .. 8w + 7 against the 16 heads
    {
      float ac[4] = {0.f, 0.f, 0.f, 0.f}, ap[4] = {0.f, 0.f, 0.f, 0.f};
      const int krow = warp * 8 + (lane & 7);
#pragma unroll 4
      for (int k = 0; k < R / 16; ++k) {
        uint32_t af[4], bf[2];
        ldm_x4(af, sQ + (lane & 15) * LD + k * 16 + (lane >> 4) * 8);
        ldm_x2(bf, sK + krow * LD + k * 16 + ((lane >> 3) & 1) * 8);
        mma16816(ac, af, bf[0], bf[1]);
      }
#pragma unroll
      for (int k = R / 16; k < DQ / 16; ++k) {
        uint32_t af[4], bf[2];
        ldm_x4(af, sQ + (lane & 15) * LD + k * 16 + (lane >> 4) * 8);
        ldm_x2(bf, sK + krow * LD + k * 16 + ((lane >> 3) & 1) * 8);
        mma16816(ap, af, bf[0], bf[1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (lane >> 2) + (q >> 1) * 8;
        const int slot = warp * 8 + (lane & 3) * 2 + (q & 1);
        const float cs = sCs[slot];
        sS[row * CH + slot] = cs > 0.f ? (ac[q] * cs + ap[q] * sPs[slot]) * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 16 threads a head, 4 slots each
    {
      const int h = tid >> 4, sub = tid & 15;
      float s4[4], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s4[i] = sS[h * CH + sub * 4 + i];
        mx = fmaxf(mx, s4[i]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = sub * 4 + i;
        const float p = s4[i] == -INFINITY ? 0.f : expf(s4[i] - m_new);
        sum += p;
        sP[h * PLD + slot] = __float2bfloat16_rn(p * sCs[slot]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (sub == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        sAlpha[h] = alpha;
        sL[h] = sL[h] * alpha + sum;
        sM[h] = m_new;
      }
    }
    __syncthreads();

    // P . V: warp w owns value columns 64w .. 64w + 63
    {
      const float a0 = sAlpha[lane >> 2], a1 = sAlpha[(lane >> 2) + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
#pragma unroll
      for (int k = 0; k < CH / 16; ++k) {
        uint32_t af[4];
        ldm_x4(af, sP + (lane & 15) * PLD + k * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t bf[4];
          ldm_x4_t(bf, sK + (k * 16 + (lane & 15)) * LD + warp * 64 + j * 8 + (lane >> 4) * 8);
          mma16816(acc[j], af, bf[0], bf[1]);
          mma16816(acc[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();

  const int r0 = lane >> 2;
  if (a.nsplit == 1) {
    const float inv0 = 1.f / sL[r0], inv1 = 1.f / sL[r0 + 8];
    __nv_bfloat16* o = a.out + static_cast<size_t>(bt) * H * R;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = warp * 64 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(o + r0 * R + col) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(o + (r0 + 8) * R + col) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  } else {
    float* pp = a.part + (static_cast<size_t>(bt) * a.nsplit + split) * H * (R + 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = warp * 64 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(pp + r0 * (R + 2) + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(pp + (r0 + 8) * (R + 2) + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
    if (tid < H) {
      pp[tid * (R + 2) + R] = sM[tid];
      pp[tid * (R + 2) + R + 1] = sL[tid];
    }
  }
}

// the splits of each (sample, fresh token) merged in split order: a block a
// (token, head), 4 value columns a thread
constexpr int MERGE_THREADS = R / 4;

__global__ void __launch_bounds__(MERGE_THREADS) latent_merge_kernel(Args a) {
  const int bt = blockIdx.x, h = blockIdx.y;
  const float* base = a.part + (static_cast<size_t>(bt) * a.nsplit * H + h) * (R + 2);
  const size_t split_stride = static_cast<size_t>(H) * (R + 2);
  float m = -INFINITY;
  for (int s = 0; s < a.nsplit; ++s) m = fmaxf(m, base[s * split_stride + R]);
  float w[MAX_SPLITS], l = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float ms = base[s * split_stride + R];
    w[s] = ms == -INFINITY ? 0.f : expf(ms - m);
    l += w[s] * base[s * split_stride + R + 1];
  }
  const int d = threadIdx.x * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < a.nsplit; ++s) {
    const float2 x0 = *reinterpret_cast<const float2*>(base + s * split_stride + d);
    const float2 x1 = *reinterpret_cast<const float2*>(base + s * split_stride + d + 2);
    v[0] += w[s] * x0.x;
    v[1] += w[s] * x0.y;
    v[2] += w[s] * x1.x;
    v[3] += w[s] * x1.y;
  }
  __nv_bfloat16* o = a.out + (static_cast<size_t>(bt) * H + h) * R + d;
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0] / l, v[1] / l);
  *reinterpret_cast<__nv_bfloat162*>(o + 2) = __floats2bfloat162_rn(v[2] / l, v[3] / l);
}

size_t smem_bytes() {
  return (H * LD + CH * LD + H * PLD) * sizeof(__nv_bfloat16) +
         (H * CH + 2 * CH + 3 * H) * sizeof(float);
}

}  // namespace latent

extern "C" long long lss_latent_decode_smem_bytes() {
  return static_cast<long long>(latent::smem_bytes());
}

// strides: the query's element strides (b, t, h). Returns the cudaError_t of
// the launches (0 on success).
extern "C" int lss_latent_decode(const void* q, void* c_cache, void* c_scale, void* pe_cache,
                                 void* pe_scale, const void* c_new, const void* pe_new,
                                 const void* pads, const void* offsets, void* out, void* part,
                                 int nsplit, int B, int T, int S, int layer,
                                 const long long* strides, float scale, void* stream) {
  if (nsplit < 1 || nsplit > latent::MAX_SPLITS) return (int)cudaErrorInvalidValue;
  latent::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.c_cache = static_cast<int8_t*>(c_cache);
  a.c_scale = static_cast<__nv_bfloat16*>(c_scale);
  a.pe_cache = static_cast<int8_t*>(pe_cache);
  a.pe_scale = static_cast<__nv_bfloat16*>(pe_scale);
  a.c_new = static_cast<const __nv_bfloat16*>(c_new);
  a.pe_new = static_cast<const __nv_bfloat16*>(pe_new);
  a.pads = static_cast<const int*>(pads);
  a.offsets = static_cast<const int*>(offsets);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.q_sb = strides[0];
  a.q_st = strides[1];
  a.q_sh = strides[2];
  a.B = B;
  a.T = T;
  a.S = S;
  a.layer = layer;
  a.nsplit = nsplit;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = latent::smem_bytes();
  static bool sized = false;  // once: a later launch may be under graph capture
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(latent::latent_decode_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  latent::latent_decode_kernel<<<dim3(B * T, nsplit), latent::THREADS, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  latent::latent_merge_kernel<<<dim3(B * T, latent::H), latent::MERGE_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
