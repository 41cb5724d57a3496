// Flash-attention forward for Hopper (sm_90a): tiled online softmax, GQA,
// per-sample key window [start, end), causal or bidirectional.
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// flash_attention.py::_flash_kernel (reached through flash_attention ->
// _flash_impl). It serves the LLM prefill (causal, GQA 24/8, Dh=128, window
// [pad, T)) and the HuBERT self-attention (bidirectional, 16/16, Dh=64,
// window [0, n_valid)).
//
// What bounds it on the H100: at prefill lengths (T of a few hundred) the
// work is the two tile products Q.K^T and P.V, so the tensor cores bound
// it, not the bytes (q/k/v are read once per q tile). This first design
// keeps the products on the tensor cores through WMMA (bf16 in, float32
// accumulate, 16x16x16 fragments) and keeps it simple:
//   * one block of 4 warps per (64-row q tile, q head, sample); the kv
//     head is h / (Hq / Hkv);
//   * a loop over 64-row k tiles from the window start to the causal
//     frontier; K and V tiles are staged in shared memory by all warps;
//   * each warp owns 16 q rows: S = Q.K^T goes to shared memory, two lanes
//     per row run the online softmax in float32 and write P as bf16 (as the
//     TPU kernel casts p to v's dtype), P.V lands in shared memory and is
//     folded into the lane's float32 output row with the rescale factor;
//   * the ragged edge is masked (keys) or not stored (queries), so any T
//     runs without padding; q/k/v/out are read through their (B, T, H, Dh)
//     strides, so no transposes.
// Later designs move to wgmma + TMA with the accumulator kept in registers.
//
// Masked scores are NEG_INF = -1e30 (never -inf) and the denominator is
// floored at 1e-30, so rows with no valid key (pad queries) stay finite.
//
// Training: with a non-null ``lse`` the same launch also writes the float32
// per-row log-sum-exp m + log(max(l, 1e-30)) as (B, Hq, T), the TPU
// kernel's return_lse output, which the backward (flash_attention_bwd.cu)
// uses to recompute p = exp(s - lse). A row with no valid key keeps m =
// -1e30 and so gets lse = -1e30, as on the TPU. The kernel has no atomics
// and a fixed summation order, so a recompute (activation checkpointing)
// gives bitwise the same out and lse.

#include <mma.h>

#include "flash_common.cuh"

using namespace nvcuda;
using namespace lss_flash;

namespace {

template <int DH>
struct Layout {
  // padded row strides keep WMMA pointers 32-byte aligned and spread banks
  static constexpr int LDH = ldh<DH>();  // bf16 Q/K/V tiles
  static constexpr int LDS = BK + 4;  // float32 score tile
  static constexpr int LDP = BK + 8;  // bf16 probability tile
  static constexpr int LDO = DH + 4;  // float32 P.V tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t bytes = o_off + sizeof(float) * BQ * LDO;
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ starts,
                 const int* __restrict__ ends, int T, int Hq, int Hkv, long long q_sb,
                 long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
                 long long v_sh, long long o_sb, long long o_st, long long o_sh, int causal,
                 float scale) {
  using Lay = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::v_off);
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p_off);
  float* Os = reinterpret_cast<float*>(smem + Lay::o_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = max(starts[b], 0);
  const int end = min(ends[b], T);

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  load_tile<DH>(Qs, qb, q_st, q0, T);

  // keys in [start, k_stop); causal: no key past the tile's last query
  int k_stop = end;
  if (causal) k_stop = min(k_stop, q0 + BQ);
  const int kt_begin = start / BK;
  const int kt_end = k_stop > 0 ? (k_stop + BK - 1) / BK : 0;

  // lanes 2r and 2r+1 own q row r of this warp's 16: half the score
  // columns each, and half the output columns each
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int qpos = q0 + row;
  float m = NEG_INF;
  float l = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int c = 0; c < DH / 2; ++c) o[c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<DH>(Ks, kb, k_st, k0, T);
    load_tile<DH>(Vs, vb, v_st, k0, T);
    __syncthreads();

    // S (16 x BK) = Q_w (16 x DH) . K^T
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + (warp * 16) * Lay::LDH + kk * 16, Lay::LDH);
        wmma::load_matrix_sync(fb, Ks + (j * 16) * Lay::LDH + kk * 16, Lay::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + (warp * 16) * Lay::LDS + j * 16, acc, Lay::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's 32 columns of row `row`
    const float* srow = Ss + row * Lay::LDS + half * 32;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kp = k0 + half * 32 + c;
      const bool ok = kp >= start && kp < end && (!causal || kp <= qpos);
      sv[c] = ok ? srow[c] * scale : NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    __nv_bfloat16* prow = Ps + row * Lay::LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();

    // O_tile (16 x DH) = P_w (16 x BK) . V
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + (warp * 16) * Lay::LDP + kk * 16, Lay::LDP);
        wmma::load_matrix_sync(fb, Vs + (kk * 16) * Lay::LDH + j * 16, Lay::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + (warp * 16) * Lay::LDO + j * 16, acc, Lay::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
    const float* orow = Os + row * Lay::LDO + half * (DH / 2);
#pragma unroll
    for (int c = 0; c < DH / 2; ++c) o[c] = o[c] * alpha + orow[c];
  }

  if (qpos < T) {
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = out + b * o_sb + (long long)qpos * o_st + h * o_sh + half * (DH / 2);
#pragma unroll
    for (int c = 0; c < DH / 2; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(o[c] / denom, o[c + 1] / denom);
    }
    if (lse != nullptr && half == 0) lse[((long long)b * Hq + h) * T + qpos] = m + logf(denom);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const int* starts,
           const int* ends, int B, int T, int Hq, int Hkv, const long long* s, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, starts, ends, T,
      Hq, Hkv, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (b, t, h) for q, k, v, out, in that order.
// lse: null, or a contiguous (B, Hq, T) float32 buffer for the log-sum-exp.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const void* starts, const void* ends, int B, int T,
                                       int Hq, int Hkv, int Dh, const long long* strides,
                                       int causal, float scale, void* stream) {
  const int* st = static_cast<const int*>(starts);
  const int* en = static_cast<const int*>(ends);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (Dh == 128) return launch<128>(q, k, v, out, l, st, en, B, T, Hq, Hkv, strides, causal, scale, s);
  if (Dh == 64) return launch<64>(q, k, v, out, l, st, en, B, T, Hq, Hkv, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
