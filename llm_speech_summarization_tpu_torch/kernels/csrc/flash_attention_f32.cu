// Flash-attention forward in float32 for Hopper (sm_90a): tiled online
// softmax, GQA, per-sample key window [start, end), causal or
// bidirectional; scores, softmax, p and P.V all in float32, and a float32
// output.
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// flash_attention.py::_flash_kernel (reached through flash_attention ->
// _flash_impl) at float32 operands: that kernel accumulates in float32 and
// casts p to v's dtype, so at float32 nothing in it rounds below float32.
// It serves the HuBERT-CTC model, which the JAX package restores into a
// float32 template (data/preprocess.py::load_ctc_fn) and runs in float32:
// bidirectional 16/16 heads, Dh=64, B=1, window [0, n_valid), T <= 999
// frames (clips of at most 20 s). The bf16 instance is flash_attention.cu.
//
// What bounds it on the H100: the two products Q.K^T and P.V over the valid
// (query, key) pairs, in float32. The tensor cores run float32 only as
// TF32 (10 mantissa bits), which is not a float32 kernel; the float32-
// accurate route on them is 3xTF32 (each operand split into a TF32 high
// part and a TF32 residual, three products), which PERF.md takes as the
// bound (495 / 3 = 165 TFLOP/s). This design is the simple one: FFMA on
// the CUDA cores (67 TFLOP/s at most), operands from shared memory.
//   * one block of 256 threads per (64-row q tile, q head, sample); the kv
//     head is h / (Hq / Hkv). The threads form a 16 x 16 grid: thread
//     (ty, tx) owns q rows 4 ty .. 4 ty + 3 of the tile, score columns
//     tx + 16 j (j < 4) of each 64-key tile and output columns tx + 16 j
//     (j < Dh / 16), so a row's 16 threads are one half-warp and its max
//     and sum take four shuffles;
//   * Q, K and V tiles are read from global memory as float4 (16-byte
//     aligned rows) and stored to shared memory with Q and K rows padded to
//     Dh + 1 floats and the P tile's to 68, so the score and value loops
//     read shared memory without bank conflicts (a half-warp reads 16
//     banks, the other half-warp the same words or the 16 others);
//   * per k tile: S = Q.K^T as sequential FFMAs over Dh, scaled by
//     Dh^-0.5 * log2(e), masked to -1e30 outside the window and past the
//     causal frontier; the online softmax in base 2 (m, per-thread partial
//     l, alpha rescales O); p = 2^(s - m) goes to shared memory in float32;
//     O += P.V as sequential FFMAs over the tile's keys. Rows of K and V
//     past T are zero-filled, so a masked key never carries NaN or Inf;
//   * no atomics and a fixed order of every sum: repeats are bit-identical.
// A row that sees no key writes zeros (as the bf16 kernel). The output is
// o / max(l, 1e-30), as the TPU kernel divides.
//
// Training (B1 + LSE, and B7's forward): where the caller passes an lse
// buffer, the kernel also writes the float32 per-row log-sum-exp m +
// log(max(l, 1e-30)) as (B, Hq, T) (the TPU kernel's return_lse output;
// -1e30 for a row that sees no key). The global offsets (q_off, k_off) of
// the ring's interior make the causal rule k + k_off <= q + q_off, so the
// causal frontier of a q tile moves by q_off - k_off, as in the bf16 B7.
// The TPU kernel loops over every k block in offset mode and lets the mask
// decide; the tiles past the moved frontier are wholly masked for every
// row of the q tile, and such a tile changes neither m, l nor o of a row
// that has seen a key (p = 2^(-1e30 - m) = 0, alpha = 1), so skipping them
// gives the same bits. One entry serves B1 (no lse, offsets 0), B1 + LSE
// and B7's forward, as the bf16 entry does. flash_attention_bwd_f32.cu is
// the backward that reads the lse.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"

namespace {

using lss_f32::LN2;
using lss_f32::LOG2E;
using lss_f32::NEG_INF;
using lss_f32::load_rows;

template <int DH_>
struct F32Cfg {
  static constexpr int DH = DH_;
  static constexpr int BQ = 64;  // q rows per block
  static constexpr int BK = 64;  // keys per k tile
  static constexpr int THREADS = 256;
  static constexpr int RQ = 4;         // q rows per thread
  static constexpr int CK = BK / 16;   // score columns per thread
  static constexpr int CO = DH / 16;   // output columns per thread
  static constexpr int QS = DH + 1;    // padded row strides, in floats
  static constexpr int KS = DH + 1;
  static constexpr int VS = DH;
  static constexpr int PS = BK + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * QS;
  static constexpr int v_off = k_off + BK * KS;
  static constexpr int p_off = v_off + BK * VS;
  static constexpr int bytes = (p_off + BQ * PS) * 4;
};

struct F32Args {
  const float *q, *k, *v;
  float* out;
  float* lse;  // (B, Hq, T), or null: no lse
  const int *starts, *ends;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  int T, Hq, Hkv, causal;
  int diag;          // q_off - k_off
  float scale_log2;  // Dh^-0.5 * log2(e)
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 2) flash_f32_kernel(const F32Args a) {
  constexpr int DH = C::DH, BK = C::BK, BQ = C::BQ, RQ = C::RQ, CK = C::CK, CO = C::CO;
  extern __shared__ float smem[];
  float* qs = smem + C::q_off;
  float* ks = smem + C::k_off;
  float* vs = smem + C::v_off;
  float* ps = smem + C::p_off;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int T = a.T;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  const int diag = a.diag;
  int k_stop = end;  // keys in [start, k_stop); causal: none past the tile's frontier
  if (a.causal) k_stop = min(k_stop, q0 + BQ + diag);
  const int kt_begin = start / BK;
  const int kt_end = k_stop > 0 ? (k_stop + BK - 1) / BK : 0;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = RQ * ty;  // this thread's first row in the tile

  float o[RQ][CO];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CO; ++j) o[i][j] = 0.f;
  }

  if (kt_end > kt_begin) {
    load_rows<DH, BQ, C::QS>(qs, a.q + b * a.q_sb + h * a.q_sh, a.q_st, q0, T);
  }
  const float* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + b * a.v_sb + hk * a.v_sh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    load_rows<DH, BK, C::KS>(ks, kb, a.k_st, k0, T);
    load_rows<DH, BK, C::VS>(vs, vb, a.v_st, k0, T);
    __syncthreads();

    // S (RQ rows, CK keys) of this thread = Q . K^T, FFMA over Dh in order
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(r0 + i) * C::QS + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = ks[(tx + 16 * j) * C::KS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // scale into base 2, mask, and the online softmax per row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + r0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp >= start && kp < end && (!a.causal || kp <= qp + diag);
        s[i][j] = ok ? s[i][j] * a.scale_log2 : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = exp2f(s[i][j] - mn);
        ps[(r0 + i) * C::PS + tx + 16 * j] = p;
        ls += p;
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int j = 0; j < CO; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

    // O += P . V, FFMA over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[CO];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(r0 + i) * C::PS + c];
#pragma unroll
      for (int j = 0; j < CO; ++j) vv[j] = vs[c * C::VS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
#pragma unroll
        for (int j = 0; j < CO; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites K, V and P
  }

  // the row sums were kept per thread: reduce over the half-warp; a row that
  // saw no key (m still -1e30) writes zeros
  float* ob = a.out + b * a.o_sb + h * a.o_sh + tx;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 16; w *= 2) li += __shfl_xor_sync(0xffffffffu, li, w);
    const int qp = q0 + r0 + i;
    if (qp >= T) continue;
    const bool seen = m[i] != NEG_INF;
    const float den = fmaxf(li, 1e-30f);
#pragma unroll
    for (int j = 0; j < CO; ++j) ob[(long long)qp * a.o_st + 16 * j] = seen ? o[i][j] / den : 0.f;
    if (a.lse != nullptr && tx == 0) {
      a.lse[((long long)b * a.Hq + h) * T + qp] = seen ? m[i] * LN2 + logf(den) : NEG_INF;
    }
  }
}

template <class C>
int launch(const F32Args& a, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + C::BQ - 1) / C::BQ, a.Hq, B);
  flash_f32_kernel<C><<<grid, C::THREADS, C::bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (b, t, h) for q, k, v, out, in that order
// (multiples of 4, with 16-byte aligned bases: rows are read as float4);
// lse: a contiguous (B, Hq, T) float32 buffer, or null; q_off, k_off: the
// global offsets of the queries and the keys (0, 0 but in B7's offset
// mode). Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_flash_attention_f32_fwd(const void* q, const void* k, const void* v, void* out,
                                           void* lse, const void* starts, const void* ends,
                                           int B, int T, int Hq, int Hkv, int Dh,
                                           const long long* strides, int causal, int q_off,
                                           int k_off, float scale, void* stream) {
  F32Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  a.q_sb = strides[0];
  a.q_st = strides[1];
  a.q_sh = strides[2];
  a.k_sb = strides[3];
  a.k_st = strides[4];
  a.k_sh = strides[5];
  a.v_sb = strides[6];
  a.v_st = strides[7];
  a.v_sh = strides[8];
  a.o_sb = strides[9];
  a.o_st = strides[10];
  a.o_sh = strides[11];
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.diag = q_off - k_off;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch<F32Cfg<128>>(a, B, s);
  if (Dh == 64) return launch<F32Cfg<64>>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
