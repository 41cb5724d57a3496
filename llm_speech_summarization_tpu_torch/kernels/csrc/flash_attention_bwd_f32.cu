// Flash-attention backward in float32 for Hopper (sm_90a): dq, and dk/dv
// summed over the GQA group, from the forward's saved float32 log-sum-exp,
// per-sample key window [start, end), causal or bidirectional, with the
// ring's offset mode. Every score, p, dp, ds and sum is float32, and so are
// the outputs.
//
// Replaces the TPU kernels llm_speech_summarization_tpu/kernels/
// flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel (launched by
// _flash_bwd_impl) at float32 operands: they accumulate in float32 and cast
// ds and p to the operands' dtype before their products (ds.astype(kb.dtype),
// p.T.astype(dob.dtype), ds.T.astype(qb.dtype)), so at float32 nothing in
// them rounds below float32. They serve KD training at compute_dtype
// float32: the student LLM (24/8 heads, Dh=128, causal, the spliced T=768)
// and HuBERT-large (16/16, Dh=64, bidirectional, T=499 frames), Whisper's
// encoder (16/16, Dh=64, T=500), and the ring's interior (offset mode).
// The bf16 instances are flash_attention_bwd.cu (dq) and
// flash_attention_bwd_dkv.cu (dk/dv); the forward is flash_attention_f32.cu.
//
// What it computes, per (query i, key j) of a head, s = Dh^-0.5 q_i.k_j:
//   p = exp(s - lse_i) inside the mask, exactly 0 outside it (selected,
//       never computed from lse = -1e30 of a row that sees no key);
//   dp = dO_i.v_j;  ds = p (dp - delta_i), delta = rowsum(dO * O);
//   dq_i = Dh^-0.5 sum_j ds k_j;  dv_j = sum_i p dO_i;
//   dk_j = Dh^-0.5 sum_i ds q_i.
// The mask: key j in [start, end), and, causal, j + k_off <= i + q_off.
//
// What bounds it on the H100: the five products over the valid (query, key)
// pairs, in float32 (q.k and dO.v in both kernels, ds.K in dq, p.dO and
// ds.Q in dk/dv). As for the forward, the tensor cores run float32 only as
// TF32 (10 mantissa bits), which is not a float32 kernel; PERF.md takes
// 3xTF32 (165 TFLOP/s) as the bound. This design is the simple one: FFMA
// on the CUDA cores (67 TFLOP/s at most), operands from shared memory, the
// forward's thread layout.
//   * 256 threads as a 16 x 16 grid; every tile is 64 rows, read from
//     global memory as float4 and stored to shared memory at a row stride
//     of Dh + 1 floats (the p and ds tiles at 68), so the product loops read
//     shared memory without bank conflicts;
//   * dq: one block per (64-row q tile, q head, sample); Q, dO, the tile's
//     lse (pre-scaled by log2(e)) and delta stay in shared memory; for each
//     64-key tile of K and V up to the causal frontier, thread (ty, tx)
//     computes s and dp of rows 4 ty .. 4 ty + 3 and keys tx + 16 j as
//     sequential FFMAs over Dh, p and ds in registers, ds to shared memory,
//     then dQ (registers: 4 rows x Dh / 16 columns) += dS.K over the tile's
//     keys in order; dq = Dh^-0.5 dQ;
//   * dk/dv: one block per (64-key tile, kv head, sample); K and V stay in
//     shared memory; for each q head of the group in order, and each 64-row
//     q tile from the causal frontier on, Q, dO, lse and delta are loaded,
//     thread (ty, tx) computes s and dp of keys 4 ty .. 4 ty + 3 and rows
//     tx + 16 j, p and ds go to shared memory transposed, and dV += P^T.dO,
//     dK += dS^T.Q (registers) over the tile's rows in order: the group is
//     summed in the block in a fixed order (JAX sums per-head float32 dk/dv
//     in XLA: the same sum in another order); dk = Dh^-0.5 dK;
//   * the causal frontier is the TPU kernels' (dq: no k tile past the q
//     tile's last query, _bwd_dq_kernel's num_k_blocks; dk/dv: no q tile
//     before the key tile's first key, _bwd_dkv_kernel's first_q_block),
//     moved by q_off - k_off in offset mode, as the bf16 B7 does: the TPU
//     kernels loop over every block in offset mode and let the mask decide,
//     and the tiles past the moved frontier are wholly masked (p = ds = 0,
//     an FFMA of 0 leaves a sum unchanged), so skipping them gives the same
//     bits. A key tile outside the window writes zeros without a loop.
//   * Query rows outside the window are not masked (the TPU kernels mask
//     keys only; their dO is 0 where callers mask the output), rows past T
//     are; keys past T are zero-filled and masked.
//   * no atomics and a fixed order of every sum: repeats are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"

namespace {

using lss_f32::LOG2E;
using lss_f32::NEG_INF;
using lss_f32::THREADS;
using lss_f32::load_rows;

template <int DH_>
struct BwdCfg {
  static constexpr int DH = DH_;
  static constexpr int BQ = 64;          // q rows per tile
  static constexpr int BK = 64;          // keys per tile
  static constexpr int R = 4;            // tile rows (dq: queries; dk/dv: keys) per thread
  static constexpr int NCOL = 4;         // score columns per thread: tx + 16 j
  static constexpr int CO = DH / 16;     // output columns per thread: tx + 16 j
  static constexpr int AS = DH + 1;      // padded row stride of the operand tiles, in floats
  static constexpr int PS = 64 + 4;      // padded row stride of the p and ds tiles
  static constexpr int TILE = 64 * AS;   // one operand tile
  static constexpr int PTILE = 64 * PS;  // one p or ds tile
  // dq: Q, dO, K, V, dS, then lse (base 2) and delta of the q tile
  static constexpr int dq_floats = 4 * TILE + PTILE + 2 * BQ;
  // dk/dv: K, V, Q, dO, P^T, dS^T, then lse (base 2) and delta of the q tile
  static constexpr int dkv_floats = 4 * TILE + 2 * PTILE + 2 * BQ;
  static constexpr int MIN_BLOCKS = DH == 64 ? 2 : 1;  // blocks an SM (shared memory)
};

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  const int *starts, *ends;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  long long dq_sb, dq_st, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
  int T, Hq, Hkv, causal, diag;  // diag = q_off - k_off
  float scale, scale_log2;       // Dh^-0.5, Dh^-0.5 * log2(e)
};

// lse (times log2(e)) and delta of q rows [r0, r0 + 64) of row ``row`` of
// the (B, Hq, T) buffers into shared memory; rows past T get 0 (masked)
__device__ __forceinline__ void load_row_stats(float* lse2, float* dl, const BwdArgs& a,
                                               long long row, int r0) {
  for (int i = threadIdx.x; i < 64; i += THREADS) {
    const bool in = r0 + i < a.T;
    lse2[i] = in ? a.lse[row * a.T + r0 + i] * LOG2E : 0.f;
    dl[i] = in ? a.delta[row * a.T + r0 + i] : 0.f;
  }
}

template <class C>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS) bwd_dq_f32_kernel(const BwdArgs a) {
  constexpr int DH = C::DH, BQ = C::BQ, BK = C::BK, R = C::R, NC = C::NCOL, CO = C::CO;
  constexpr int AS = C::AS, PS = C::PS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + C::TILE;
  float* ks = dos + C::TILE;
  float* vs = ks + C::TILE;
  float* dss = vs + C::TILE;
  float* lse2 = dss + C::PTILE;
  float* dl = lse2 + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int T = a.T;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  int k_stop = end;  // keys in [start, k_stop); causal: none past the tile's frontier
  if (a.causal) k_stop = min(k_stop, q0 + BQ + a.diag);
  const int kt_begin = start / BK;
  const int kt_end = k_stop > 0 ? (k_stop + BK - 1) / BK : 0;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = R * ty;  // this thread's first q row in the tile

  float acc[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;
  }

  if (kt_end > kt_begin) {
    load_rows<DH, BQ, AS>(qs, a.q + b * a.q_sb + h * a.q_sh, a.q_st, q0, T);
    load_rows<DH, BQ, AS>(dos, a.dout + b * a.o_sb + h * a.o_sh, a.o_st, q0, T);
    load_row_stats(lse2, dl, a, (long long)b * a.Hq + h, q0);
  }
  const float* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + b * a.v_sb + hk * a.v_sh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    load_rows<DH, BK, AS>(ks, kb, a.k_st, k0, T);
    load_rows<DH, BK, AS>(vs, vb, a.v_st, k0, T);
    __syncthreads();

    // s = Q.K^T and dp = dO.V^T of this thread's (row, key) pairs, FFMA over Dh in order
    float s[R][NC], dp[R][NC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[R], dv[R], kv[NC], vv[NC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = qs[(r0 + i) * AS + d];
        dv[i] = dos[(r0 + i) * AS + d];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        kv[j] = ks[(tx + 16 * j) * AS + d];
        vv[j] = vs[(tx + 16 * j) * AS + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
      }
    }

    // p by selection inside the mask, ds = p (dp - delta) to shared memory
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp >= start && kp < end && qp < T && (!a.causal || kp <= qp + a.diag);
        const float p = ok ? exp2f(s[i][j] * a.scale_log2 - lse2[r0 + i]) : 0.f;
        dss[(r0 + i) * PS + tx + 16 * j] = p * (dp[i][j] - dl[r0 + i]);
      }
    }
    __syncthreads();

    // dQ += dS.K, FFMA over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[R], kk[CO];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(r0 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < CO; ++j) kk[j] = ks[c * AS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < CO; ++j) acc[i][j] = fmaf(dsv[i], kk[j], acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites K, V and dS
  }

  // every row of the tile is written: zeros where it saw no key
  float* out = a.dq + b * a.dq_sb + h * a.dq_sh + tx;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= T) continue;
#pragma unroll
    for (int j = 0; j < CO; ++j) out[(long long)qp * a.dq_st + 16 * j] = acc[i][j] * a.scale;
  }
}

template <class C>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS) bwd_dkv_f32_kernel(const BwdArgs a) {
  constexpr int DH = C::DH, BQ = C::BQ, BK = C::BK, R = C::R, NC = C::NCOL, CO = C::CO;
  constexpr int AS = C::AS, PS = C::PS;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + C::TILE;
  float* qs = vs + C::TILE;
  float* dos = qs + C::TILE;
  float* pts = dos + C::TILE;  // P^T: (key, q row)
  float* dts = pts + C::PTILE;  // dS^T
  float* lse2 = dts + C::PTILE;
  float* dl = lse2 + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int T = a.T;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  // the first q tile whose rows can see key k0 (the causal frontier, moved
  // by diag in offset mode); none where the key tile is outside the window
  const bool keys_in = k0 < end && k0 + BK > start;
  const int qt_begin = a.causal ? max(k0 - a.diag, 0) / BQ : 0;
  const int qt_end = keys_in ? (T + BQ - 1) / BQ : 0;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = R * ty;  // this thread's first key in the tile

  float dk[R][CO], dv[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < CO; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  if (qt_end > qt_begin) {
    load_rows<DH, BK, AS>(ks, a.k + b * a.k_sb + hk * a.k_sh, a.k_st, k0, T);
    load_rows<DH, BK, AS>(vs, a.v + b * a.v_sb + hk * a.v_sh, a.v_st, k0, T);
  }
  for (int g = 0; g < G && qt_end > qt_begin; ++g) {  // the group's q heads, in order
    const int h = hk * G + g;
    const float* qb = a.q + b * a.q_sb + h * a.q_sh;
    const float* ob = a.dout + b * a.o_sb + h * a.o_sh;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      load_rows<DH, BQ, AS>(qs, qb, a.q_st, q0, T);
      load_rows<DH, BQ, AS>(dos, ob, a.o_st, q0, T);
      load_row_stats(lse2, dl, a, (long long)b * a.Hq + h, q0);
      __syncthreads();

      // s = K.Q^T and dp = V.dO^T of this thread's (key, row) pairs, FFMA over Dh in order
      float s[R][NC], dp[R][NC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float kv[R], vv[R], qv[NC], ov[NC];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = ks[(r0 + i) * AS + d];
          vv[i] = vs[(r0 + i) * AS + d];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          qv[j] = qs[(tx + 16 * j) * AS + d];
          ov[j] = dos[(tx + 16 * j) * AS + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
        }
      }

      // p by selection inside the mask, ds = p (dp - delta); both transposed
      // to shared memory
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + r0 + i;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int r = tx + 16 * j, qp = q0 + r;
          const bool ok = kp >= start && kp < end && qp < T && (!a.causal || kp <= qp + a.diag);
          const float p = ok ? exp2f(s[i][j] * a.scale_log2 - lse2[r]) : 0.f;
          pts[(r0 + i) * PS + r] = p;
          dts[(r0 + i) * PS + r] = p * (dp[i][j] - dl[r]);
        }
      }
      __syncthreads();

      // dV += P^T.dO and dK += dS^T.Q, FFMA over the tile's rows in order
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[R], dsv[R], ov[CO], qv[CO];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = pts[(r0 + i) * PS + r];
          dsv[i] = dts[(r0 + i) * PS + r];
        }
#pragma unroll
        for (int j = 0; j < CO; ++j) {
          ov[j] = dos[r * AS + tx + 16 * j];
          qv[j] = qs[r * AS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < CO; ++j) {
            dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
          }
        }
      }
      __syncthreads();  // the next tile overwrites Q, dO, P^T and dS^T
    }
  }

  // every key of the tile is written: zeros where no row saw it
  float* dkb = a.dk + b * a.dk_sb + hk * a.dk_sh + tx;
  float* dvb = a.dv + b * a.dv_sb + hk * a.dv_sh + tx;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + r0 + i;
    if (kp >= T) continue;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      dkb[(long long)kp * a.dk_st + 16 * j] = dk[i][j] * a.scale;
      dvb[(long long)kp * a.dv_st + 16 * j] = dv[i][j];
    }
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* starts, const void* ends,
                  int T, int Hq, int Hkv, const long long* st, int causal, int q_off, int k_off,
                  float scale) {
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = a.dk = a.dv = nullptr;
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  long long* f[21] = {&a.q_sb,  &a.q_st,  &a.q_sh,  &a.k_sb,  &a.k_st,  &a.k_sh,  &a.v_sb,
                      &a.v_st,  &a.v_sh,  &a.o_sb,  &a.o_st,  &a.o_sh,  &a.dq_sb, &a.dq_st,
                      &a.dq_sh, &a.dk_sb, &a.dk_st, &a.dk_sh, &a.dv_sb, &a.dv_st, &a.dv_sh};
  for (int i = 0; i < 21; ++i) *f[i] = st[i];
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.diag = q_off - k_off;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  return a;
}

template <class C, bool DKV>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const auto kernel = DKV ? bwd_dkv_f32_kernel<C> : bwd_dq_f32_kernel<C>;
  const int bytes = 4 * (DKV ? C::dkv_floats : C::dq_floats);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + 63) / 64, DKV ? a.Hkv : a.Hq, B);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch(const BwdArgs& a, int B, int Dh, cudaStream_t s) {
  if (Dh == 128) return launch<BwdCfg<128>, DKV>(a, B, s);
  if (Dh == 64) return launch<BwdCfg<64>, DKV>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The C entries take the bf16 backward's arguments (flash_attention_bwd.cu,
// flash_attention_bwd_dkv.cu) over float32 tensors. strides: 21 element
// strides (b, t, h) for q, k, v, dout, dq, dk, dv, in that order (the unused
// outputs' are 0), multiples of 4 with 16-byte aligned bases (rows are read
// as float4). lse, delta: contiguous (B, Hq, T) float32. q_off, k_off: the
// global offsets of the queries and the keys (0, 0 but in B7's offset
// mode). Each returns the cudaError_t of the launch (0 on success).
extern "C" int lss_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dq, const void* starts,
                                              const void* ends, int B, int T, int Hq, int Hkv,
                                              int Dh, const long long* strides, int causal,
                                              int q_off, int k_off, float scale, void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, starts, ends, T, Hq, Hkv, strides, causal,
                        q_off, k_off, scale);
  a.dq = static_cast<float*>(dq);
  return dispatch<false>(a, B, Dh, static_cast<cudaStream_t>(stream));
}

extern "C" int lss_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv,
                                               const void* starts, const void* ends, int B,
                                               int T, int Hq, int Hkv, int Dh,
                                               const long long* strides, int causal, int q_off,
                                               int k_off, float scale, void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, starts, ends, T, Hq, Hkv, strides, causal,
                        q_off, k_off, scale);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return dispatch<true>(a, B, Dh, static_cast<cudaStream_t>(stream));
}
