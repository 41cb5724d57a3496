// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv summed over
// the GQA group, from the forward's saved per-row log-sum-exp.
//
// Replaces the TPU kernels llm_speech_summarization_tpu/kernels/
// flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel (launched by
// _flash_bwd_impl, the backward of the flash_attention custom VJP). On the
// training path they differentiate the student's LLM attention (causal,
// GQA 24/8, Dh=128, window [pad, T)) and HuBERT's (bidirectional, 16/16,
// Dh=64, window [0, n_valid)).
//
// The function is FlashAttention-2's: with s = scale * q.k^T masked to the
// key window [start, end) (and causal: key <= query),
//   p = exp(s - lse),  dv = p^T.dO,  dp = dO.v^T,  ds = p * (dp - delta),
//   dq = scale * ds.k,  dk = scale * ds^T.q,
// where delta = rowsum(dO * O) comes in precomputed (an elementwise pass the
// TPU code also leaves outside its kernels). p and ds are rounded to bf16
// before their products, as the TPU kernels cast them to the operand dtype.
// A masked score gives p = 0 by selection, never by exp(-huge): a row with
// no valid key has lse = -1e30, where exp(s - lse) would overflow.
//
// What bounds it on the H100: five tile products per (q tile, k tile) pair
// over the valid causal region, recomputing the scores instead of storing
// the (T, T) probabilities, so at training lengths (T of 500-800) the
// tensor cores bound it, not the bytes (q/k/v/dO are read once per tile
// pair from L2). This first design keeps the products on the tensor cores
// through WMMA (bf16 in, float32 accumulate, 16x16x16 fragments):
//   * dq: one block of 4 warps per (64-row q tile, q head, sample). It
//     loops over k tiles from the window start to the causal frontier; each
//     warp owns 16 q rows and keeps its (16, Dh) dq accumulator in WMMA
//     fragments across the loop. No block writes another's rows: no
//     atomics.
//   * dk/dv: one block per (64-row k tile, KV head, sample). It loops over
//     the group's q heads and, for each, over q tiles from the causal
//     frontier to T; each warp owns 16 key rows and keeps both (16, Dh)
//     accumulators in fragments. The GQA group sum happens inside the
//     block, so there is no (B*Hq, T, Dh) per-q-head intermediate (the TPU
//     code writes one and group-sums it in XLA) and again no atomics.
// Both kernels sum in a fixed order, so two calls give bit-identical
// results. Later designs move to wgmma + TMA and split the dk/dv loop.

#include <mma.h>

#include "flash_common.cuh"

using namespace nvcuda;
using namespace lss_flash;

namespace {

struct Str3 {
  long long b, t, h;  // element strides of a (B, T, H, Dh) tensor
};

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;  // contiguous (B, Hq, T)
  __nv_bfloat16 *dq, *dk, *dv;
  const int *starts, *ends;
  Str3 sq, sk, sv, sdo, sdq, sdk, sdv;
  int T, Hq, Hkv, causal;
  float scale;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DH>
struct BwdLayout {
  static constexpr int LDH = ldh<DH>();  // bf16 (64, DH) tiles
  static constexpr int LDS = 64 + 4;  // float32 (64, 64) score tiles
  static constexpr int LDP = 64 + 8;  // bf16 (64, 64) p / ds tiles
  static constexpr int LDO = DH + 4;  // float32 (64, DH) epilogue tile
  static constexpr size_t tile = sizeof(__nv_bfloat16) * 64 * LDH;
  static constexpr size_t t0_off = 0;  // four bf16 (64, DH) tiles
  static constexpr size_t s_off = 4 * tile;  // scores, then dp
  static constexpr size_t dp_off = s_off + sizeof(float) * 64 * LDS;
  static constexpr size_t p_off = dp_off + sizeof(float) * 64 * LDS;  // p, then ds
  static constexpr size_t ds_off = p_off + sizeof(__nv_bfloat16) * 64 * LDP;
  static constexpr size_t row_off = ds_off + sizeof(__nv_bfloat16) * 64 * LDP;  // lse, delta
  static constexpr size_t bytes = row_off + 2 * sizeof(float) * 64;
  // the epilogue tile reuses the two score tiles
  static_assert(sizeof(float) * 64 * LDO <= 2 * sizeof(float) * 64 * LDS,
                "epilogue tile does not fit the score tiles");
};

// acc (16, n*16) of this warp = A (16, 64) . B (64, n*16), A row-major at
// `a` (ld lda), B row-major at `bm` (ld ldb)
template <int N>
__device__ __forceinline__ void mma_rows(FragC (&acc)[N], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* bm, int ldb) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, bm + (kk * 16) * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// out (16, 64) of this warp = A (16, DH) . B^T where B is (64, DH): A rows
// at `a`, B rows at `bm`, both bf16 tiles with stride LDH; stored float32
template <int DH>
__device__ __forceinline__ void mma_nt(float* out, int ldo, const __nv_bfloat16* a,
                                       const __nv_bfloat16* bm) {
  constexpr int LDH = ldh<DH>();
#pragma unroll
  for (int j = 0; j < 64 / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, bm + (j * 16) * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, ldo, wmma::mem_row_major);
  }
}

// write this warp's (16, DH) accumulator, times `mul`, as bf16 rows of a
// (B, T, H, Dh) tensor at `dst` (row 0 of the tile at position row0)
template <int DH>
__device__ __forceinline__ void store_rows(FragC (&acc)[DH / 16], float* scratch, float mul,
                                           __nv_bfloat16* dst, long long row_stride, int row0,
                                           int T) {
  using Lay = BwdLayout<DH>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = scratch + (warp * 16) * Lay::LDO;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::store_matrix_sync(mine + j * 16, acc[j], Lay::LDO, wmma::mem_row_major);
  }
  __syncwarp();
  const int r = lane / 2;
  const int pos = row0 + warp * 16 + r;
  if (pos < T) {
    const float* src = mine + r * Lay::LDO + (lane % 2) * (DH / 2);
    __nv_bfloat16* out = dst + (long long)pos * row_stride + (lane % 2) * (DH / 2);
#pragma unroll
    for (int c = 0; c < DH / 2; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(src[c] * mul, src[c + 1] * mul);
    }
  }
  __syncwarp();
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS) bwd_dq_kernel(const BwdArgs a) {
  using Lay = BwdLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::t0_off);
  __nv_bfloat16* dOs = Qs + 64 * Lay::LDH;
  __nv_bfloat16* Ks = dOs + 64 * Lay::LDH;
  __nv_bfloat16* Vs = Ks + 64 * Lay::LDH;
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp_off);
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::ds_off);

  const int T = a.T;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);

  load_tile<DH>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, T);
  load_tile<DH>(dOs, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, T);
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hk * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hk * a.sv.h;

  // lanes 2r and 2r+1 own q row r of this warp's 16, 32 key columns each
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int qpos = q0 + row;
  const bool row_ok = qpos < T;
  const long long lrow = ((long long)b * a.Hq + h) * T + qpos;
  const float lse_r = row_ok ? a.lse[lrow] : 0.f;
  const float delta_r = row_ok ? a.delta[lrow] : 0.f;

  int k_stop = end;
  if (a.causal) k_stop = min(k_stop, q0 + BQ);
  const int kt_begin = start / BK;
  const int kt_end = k_stop > 0 ? (k_stop + BK - 1) / BK : 0;

  FragC acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<DH>(Ks, kb, a.sk.t, k0, T);
    load_tile<DH>(Vs, vb, a.sv.t, k0, T);
    __syncthreads();

    mma_nt<DH>(Ss + (warp * 16) * Lay::LDS, Lay::LDS, Qs + (warp * 16) * Lay::LDH, Ks);
    mma_nt<DH>(dPs + (warp * 16) * Lay::LDS, Lay::LDS, dOs + (warp * 16) * Lay::LDH, Vs);
    __syncwarp();

    const float* srow = Ss + row * Lay::LDS + half * 32;
    const float* dprow = dPs + row * Lay::LDS + half * 32;
    __nv_bfloat16* dsrow = dSs + row * Lay::LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kp = k0 + half * 32 + c;
      const bool ok = row_ok && kp >= start && kp < end && (!a.causal || kp <= qpos);
      const float p = ok ? expf(srow[c] * a.scale - lse_r) : 0.f;
      dsrow[c] = __float2bfloat16_rn(p * (dprow[c] - delta_r));
    }
    __syncwarp();

    mma_rows<DH / 16>(acc, dSs + (warp * 16) * Lay::LDP, Lay::LDP, Ks, Lay::LDH);
  }

  __syncthreads();  // the epilogue tile overlaps every warp's score rows
  store_rows<DH>(acc, Ss, a.scale, a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.t, q0, T);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS) bwd_dkv_kernel(const BwdArgs a) {
  using Lay = BwdLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::t0_off);
  __nv_bfloat16* Vs = Ks + 64 * Lay::LDH;
  __nv_bfloat16* Qs = Vs + 64 * Lay::LDH;
  __nv_bfloat16* dOs = Qs + 64 * Lay::LDH;
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);  // (key, query)
  float* dPs = reinterpret_cast<float*>(smem + Lay::dp_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p_off);
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::row_off);
  float* delta_s = lse_s + 64;

  const int T = a.T;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);

  load_tile<DH>(Ks, a.k + b * a.sk.b + hk * a.sk.h, a.sk.t, k0, T);
  load_tile<DH>(Vs, a.v + b * a.sv.b + hk * a.sv.h, a.sv.t, k0, T);

  // lanes 2r and 2r+1 own key row r of this warp's 16, 32 query columns each
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int kpos = k0 + row;
  const bool key_ok = kpos >= start && kpos < end;

  FragC dk_acc[DH / 16], dv_acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  // a tile with no valid key has zero gradients (every p is masked)
  const bool any_key = k0 < end && k0 + BK > start;
  const int qt_begin = a.causal ? k0 / BQ : 0;
  const int qt_end = any_key ? (T + BQ - 1) / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const __nv_bfloat16* qb = a.q + b * a.sq.b + h * a.sq.h;
    const __nv_bfloat16* dob = a.dout + b * a.sdo.b + h * a.sdo.h;
    const float* lse_h = a.lse + ((long long)b * a.Hq + h) * T;
    const float* delta_h = a.delta + ((long long)b * a.Hq + h) * T;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tiles
      load_tile<DH>(Qs, qb, a.sq.t, q0, T);
      load_tile<DH>(dOs, dob, a.sdo.t, q0, T);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        const bool in = q0 + i < T;
        lse_s[i] = in ? lse_h[q0 + i] : 0.f;
        delta_s[i] = in ? delta_h[q0 + i] : 0.f;
      }
      __syncthreads();

      mma_nt<DH>(Ss + (warp * 16) * Lay::LDS, Lay::LDS, Ks + (warp * 16) * Lay::LDH, Qs);
      mma_nt<DH>(dPs + (warp * 16) * Lay::LDS, Lay::LDS, Vs + (warp * 16) * Lay::LDH, dOs);
      __syncwarp();

      const float* srow = Ss + row * Lay::LDS + half * 32;
      const float* dprow = dPs + row * Lay::LDS + half * 32;
      __nv_bfloat16* prow = Ps + row * Lay::LDP + half * 32;
      __nv_bfloat16* dsrow = dSs + row * Lay::LDP + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int qi = half * 32 + c;
        const int qpos = q0 + qi;
        const bool ok = key_ok && qpos < T && (!a.causal || kpos <= qpos);
        const float p = ok ? expf(srow[c] * a.scale - lse_s[qi]) : 0.f;
        prow[c] = __float2bfloat16_rn(p);
        dsrow[c] = __float2bfloat16_rn(p * (dprow[c] - delta_s[qi]));
      }
      __syncwarp();

      mma_rows<DH / 16>(dv_acc, Ps + (warp * 16) * Lay::LDP, Lay::LDP, dOs, Lay::LDH);
      mma_rows<DH / 16>(dk_acc, dSs + (warp * 16) * Lay::LDP, Lay::LDP, Qs, Lay::LDH);
    }
  }

  __syncthreads();  // the epilogue tile overlaps every warp's score rows
  store_rows<DH>(dk_acc, Ss, a.scale, a.dk + b * a.sdk.b + hk * a.sdk.h, a.sdk.t, k0, T);
  store_rows<DH>(dv_acc, Ss, 1.f, a.dv + b * a.sdv.b + hk * a.sdv.h, a.sdv.t, k0, T);
}

template <int DH>
int launch(BwdArgs a, int B, bool dkv, cudaStream_t stream) {
  const size_t smem = BwdLayout<DH>::bytes;
  auto kernel = dkv ? bwd_dkv_kernel<DH> : bwd_dq_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + 63) / 64, dkv ? a.Hkv : a.Hq, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, void* dk, void* dv, const void* starts,
             const void* ends, int B, int T, int Hq, int Hkv, int Dh, const long long* s,
             int causal, float scale, void* stream, bool dkv) {
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  Str3* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *st[i] = Str3{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch<128>(a, B, dkv, cs);
  if (Dh == 64) return launch<64>(a, B, dkv, cs);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 21 element strides (b, t, h) for q, k, v, dout, dq, dk, dv, in
// that order; lse and delta are contiguous (B, Hq, T) float32. dq is
// written by the first entry, dk and dv by the second (the other outputs'
// pointers are not touched). Each returns the cudaError_t of its launch.
extern "C" int lss_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, const void* starts, const void* ends, int B,
                                          int T, int Hq, int Hkv, int Dh,
                                          const long long* strides, int causal, float scale,
                                          void* stream) {
  return dispatch(q, k, v, dout, lse, delta, dq, nullptr, nullptr, starts, ends, B, T, Hq, Hkv,
                  Dh, strides, causal, scale, stream, false);
}

extern "C" int lss_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, const void* starts,
                                           const void* ends, int B, int T, int Hq, int Hkv,
                                           int Dh, const long long* strides, int causal,
                                           float scale, void* stream) {
  return dispatch(q, k, v, dout, lse, delta, nullptr, dk, dv, starts, ends, B, T, Hq, Hkv, Dh,
                  strides, causal, scale, stream, true);
}
