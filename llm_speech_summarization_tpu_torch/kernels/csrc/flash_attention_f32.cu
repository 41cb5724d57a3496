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
// bound (495 / 3 = 165 TFLOP/s), and which this design takes. FFMA on the
// CUDA cores peaks at 67 TFLOP/s, 40% of that bound.
//   * one block of 4 warps per (64-row q tile, q head, sample); the kv head
//     is h / (Hq / Hkv). Warp w owns q rows 16 w .. 16 w + 15 of the tile;
//   * Q (once) and each k tile of K and V (32 keys at Dh = 128, 64 at Dh =
//     64) go to shared memory by cp.async (16 B a thread-copy, rows at or
//     past T zero-filled), K and V double-buffered: tile i + 1 is in flight
//     while tile i is computed. Rows are padded to Dh + 4 floats, so every
//     fragment load below reads 32 distinct banks. Q at 64 rows and two
//     stages of K and V take 101,376 B at Dh = 128 (87,040 at 64), so two
//     blocks fit an SM;
//   * S = Q.K^T and O += P.V are mma.sync m16n8k8 TF32 products. Every
//     operand x is split into hi = tf32(x) and lo = x - hi as its fragment
//     is loaded; each k step of 8 adds lo.hi, hi.lo, then hi.hi into the
//     register accumulator (lss_f32::mma_3xtf32): S from zero for each
//     tile, O across every tile after alpha rescales it. hi + lo keeps 21 of
//     an operand's 24 bits and the dropped lo.lo is 2^-22 of a product:
//     tests/torch_f32_emulation.py models this arithmetic, with the tensor
//     cores' sums cut toward zero at every step, within an eighth of
//     chip_smoke's float32 bound, and single-pass TF32 over it;
//   * P feeds P.V from the score registers without shared memory: a
//     thread's accumulator holds keys 2t and 2t + 1 of each 8-key tile for
//     rows g and g + 8, which is the A fragment of an 8-key k step whose
//     k index t stands for key 2t and t + 4 for key 2t + 1; V's B fragment
//     is read at those keys, so no transpose of V is needed;
//   * per k tile: S scaled by Dh^-0.5 * log2(e), masked to -1e30 outside
//     the window and past the causal frontier; the online softmax in base 2
//     (the row's max over the quad of lanes that share it, a per-thread
//     partial l, alpha rescales O); p = 2^(s - m) in float32. Rows of K and
//     V past T are zeros, so a masked key never carries NaN or Inf;
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

template <int DH_>
struct F32Cfg {
  static constexpr int DH = DH_;
  static constexpr int BQ = 64;  // q rows per block: 16 per warp
  static constexpr int BK = DH == 64 ? 64 : 32;  // keys per k tile
  static constexpr int THREADS = 128;
  static constexpr int RS = DH + 4;  // padded row stride of Q, K and V, in floats
  static constexpr int NT = BK / 8;  // 8-key n tiles of S
  static constexpr int ND = DH / 8;  // 8-column n tiles of O
  static constexpr int q_off = 0;
  static constexpr int kv_off = BQ * RS;      // stage s: K at kv_off + s * 2 BK RS, V after
  static constexpr int bytes = (BQ * RS + 2 * 2 * BK * RS) * 4;
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
  constexpr int DH = C::DH, BK = C::BK, BQ = C::BQ, RS = C::RS, NT = C::NT, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + C::q_off;

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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' group and thread in group
  const int ra = 16 * warp + g;          // this thread's rows ra and ra + 8 of the tile

  float o[ND][4];  // O: rows ra (0, 1) and ra + 8 (2, 3), columns 8 nd + 2t, + 1
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  const float* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + b * a.v_sb + hk * a.v_sh;
  auto stage_k = [&](int s) { return smem + C::kv_off + s * 2 * BK * RS; };
  if (kt_end > kt_begin) {
    lss_f32::copy_rows<C, BQ>(qs, a.q + b * a.q_sb + h * a.q_sh, a.q_st, q0, T);
    lss_f32::copy_rows<C, BK>(stage_k(0), kb, a.k_st, kt_begin * BK, T);
    lss_f32::copy_rows<C, BK>(stage_k(0) + BK * RS, vb, a.v_st, kt_begin * BK, T);
  }
  lss_f32::cp_async_commit();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int i = kt - kt_begin;
    if (kt + 1 < kt_end) {  // the next tile into the other stage, freed at the end of i - 1
      float* nk = stage_k((i + 1) & 1);
      lss_f32::copy_rows<C, BK>(nk, kb, a.k_st, (kt + 1) * BK, T);
      lss_f32::copy_rows<C, BK>(nk + BK * RS, vb, a.v_st, (kt + 1) * BK, T);
    }
    lss_f32::cp_async_commit();
    lss_f32::cp_async_wait<1>();  // tile i (and Q) landed for this thread
    __syncthreads();              // ... and for every thread
    const float* ks = stage_k(i & 1);
    const float* vs = ks + BK * RS;
    const int k0 = kt * BK;

    // S (rows ra, ra + 8; keys 8 nt + 2t, + 1) = Q . K^T, 3xTF32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < DH; d0 += 8) {
      uint32_t ahi[4], alo[4];
      const float* qa = qs + ra * RS + d0 + t;
      lss_f32::split_tf32(qa[0], ahi[0], alo[0]);
      lss_f32::split_tf32(qa[8 * RS], ahi[1], alo[1]);
      lss_f32::split_tf32(qa[4], ahi[2], alo[2]);
      lss_f32::split_tf32(qa[8 * RS + 4], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bhi[2], blo[2];
        const float* kr = ks + (8 * nt + g) * RS + d0 + t;
        lss_f32::split_tf32(kr[0], bhi[0], blo[0]);
        lss_f32::split_tf32(kr[4], bhi[1], blo[1]);
        lss_f32::mma_3xtf32(s[nt], ahi, alo, bhi, blo);
      }
    }

    // scale into base 2, mask, and the online softmax of rows ra, ra + 8; a
    // tile inside the window and below every row's causal frontier takes no
    // mask
    const bool whole = k0 >= start && k0 + BK <= end && (!a.causal || k0 + BK - 1 <= q0 + diag);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qp = q0 + ra + 8 * rr;
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * nt + 2 * t + e;
          const bool ok =
              whole || (kp >= start && kp < end && (!a.causal || kp <= qp + diag));
          float& x = s[nt][2 * rr + e];
          x = ok ? x * a.scale_log2 : NEG_INF;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[rr], mx);
      const float alpha = exp2f(m[rr] - mn);
      m[rr] = mn;
      float ls = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * rr + e];
          x = exp2f(x - mn);
          ls += x;
        }
      }
      l[rr] = l[rr] * alpha + ls;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][2 * rr] *= alpha;
        o[nd][2 * rr + 1] *= alpha;
      }
    }

    // O += P . V, 3xTF32, a k step of 8 keys at a time: A is the score registers of
    // n tile kk (k index t: key 2t, t + 4: key 2t + 1), B is V at those keys
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ahi[4], alo[4];
      lss_f32::split_tf32(s[kk][0], ahi[0], alo[0]);
      lss_f32::split_tf32(s[kk][2], ahi[1], alo[1]);
      lss_f32::split_tf32(s[kk][1], ahi[2], alo[2]);
      lss_f32::split_tf32(s[kk][3], ahi[3], alo[3]);
      const float* vr = vs + (8 * kk + 2 * t) * RS + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t bhi[2], blo[2];
        lss_f32::split_tf32(vr[8 * nd], bhi[0], blo[0]);
        lss_f32::split_tf32(vr[RS + 8 * nd], bhi[1], blo[1]);
        lss_f32::mma_3xtf32(o[nd], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  lss_f32::cp_async_wait<0>();

  // the row sums were kept per thread: reduce over the quad; a row that saw
  // no key (m still -1e30) writes zeros
  float* ob = a.out + b * a.o_sb + h * a.o_sh + 2 * t;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float li = l[rr];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qp = q0 + ra + 8 * rr;
    if (qp >= T) continue;
    const bool seen = m[rr] != NEG_INF;
    const float den = fmaxf(li, 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float2 x = seen ? make_float2(o[nd][2 * rr] / den, o[nd][2 * rr + 1] / den)
                            : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(ob + (long long)qp * a.o_st + 8 * nd) = x;
    }
    if (a.lse != nullptr && t == 0) {
      a.lse[((long long)b * a.Hq + h) * T + qp] = seen ? m[rr] * LN2 + logf(den) : NEG_INF;
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
