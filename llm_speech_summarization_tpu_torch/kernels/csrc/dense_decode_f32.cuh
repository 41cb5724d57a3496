// Decode attention in float32 over one layer of a dense (L, B, Hkv, S, Dh)
// KV cache or of page-major (L, P, Hkv, ps, Dh) pools, for Hopper
// (sm_90a): the body of the float32 instances of B2 and B3 (dense, with the
// in-place write of the fresh tokens), B8 (dense, read only), B4 (paged,
// read only) and B5 (paged, with the page write), and of the mixed
// instances of B3, B8, B4 and B5 (a bf16 query over a float32 cache), all
// in decode_f32.cu.
//
// Replaces the TPU kernels of llm_speech_summarization_tpu/kernels/
// fused_decode.py (_fused_kernel_aliased, _fused_kernel),
// decode_attention.py (_decode_kernel), paged_attention.py (_paged_kernel)
// and fused_paged.py (_fused_paged_kernel) at a float32 query: those
// kernels cast the cache to q's dtype, accumulate in float32 and cast p to
// q's dtype, so at float32 nothing in them rounds below float32. The bf16
// instances are dense_decode.cuh's; it stays as it is.
//
// The mixed instances (QT = bf16; the query type is a template parameter)
// replace the same TPU kernels at a bf16 query over a float32 cache, the
// mix the JAX engine decodes at with bf16 parameters at compute_dtype
// float32 (the decode steps run in the norms' dtype, the cache in
// float32). What those kernels compute there, and so these instances:
//   * q and the fresh k/v are read as bf16 and widened exactly;
//   * each cached k and v is rounded to bf16 (round to nearest even) as it
//     is staged, before any product: the kernels cast the cache to q's
//     dtype. The products of two bf16 values are exact in float32, so FFMA
//     over them is a bf16 x bf16 -> float32 MMA up to the order of the sums;
//   * p over the cache is rounded to bf16 before P . V (the kernels cast p
//     to q's dtype); the denominator sums it unrounded;
//   * the fresh block's p and values are attended unrounded, as the Pallas
//     kernels do (the port's plain versions follow fused_reference, which
//     rounds the fresh p to bf16 too; the test bound covers both);
//   * the output is rounded to bf16 once, after the split merge (the merge
//     kernel writes bf16);
//   * the write (B3, B5) widens the bf16 fresh values into the float32
//     cache or pages, bit for bit.
// What bounds them: the float32 cache bytes, 512 B a row at Dh = 128 (k
// and v: 1 KiB a slot), as for the float32 instances over a float32 cache;
// their products are the float32 instances' less the q rounding. The FFMA
// design is the simple one; tensor cores (bf16 mma over the rounded tiles)
// and asynchronous copies are left to a later change.
//
// What it computes, per (sample b, kv head h): the R = T * G query rows
// (ordered (t, g), G = Hq / Hkv) attend the cache slots pad[b] <= s <
// offset[b] of layer `layer` plus the T fresh keys causally (fresh key
// j <= t):
//   * the cache is int8 with bf16 per-slot scales, float32, or bf16 (a bf16
//     cache under a float32 query, which the JAX kernels take by casting
//     the keys up); every cached value is exact in float32;
//   * s = (q . k) * k_scale * Dh^-0.5, q . k in float32 (FFMA over Dh), the
//     slot's k scale multiplying the product, as the TPU kernel does;
//   * p = exp(s - m) in float32, never rounded; p . v in float32, with the
//     slot's v scale folded into p for an int8 cache; the denominator sums
//     p without it;
//   * the fresh keys and values are attended from their float32 values;
//   * the output (B, T, Hq, Dh) is float32.
// With WRITE the fresh rows then go to slots [offset, offset + T): an int8
// cache takes them quantized exactly like models/llama.py::_quantize_kv
// (absmax / 127 in float32, floor 1e-8, IEEE division, rintf = round half
// to even, clip to +-127), their bf16 scales into the scale slab at the
// slot or into (B, Hkv, T) outputs; a float32 cache takes the float32
// values bit for bit; a bf16 cache takes them rounded to nearest even.
// Paged (the PAGED parameter), position pos of row b lives at page
// page_table[b, pos / ps] (an id outside [0, P) reads the null page 0),
// slot pos % ps; `offsets` holds the lengths, the window is [pad,
// min(length, mp * ps)), and the write (T = 1) goes to position `length`
// through the table, or to the null page 0 outside it, as dense_decode.cuh
// routes it (kernels/fused_paged.py::_write_targets).
//
// What bounds it on the H100: the cache bytes in principle (a float32 row
// is 512 B at Dh = 128, four times an int8 row), and the float32 products
// (2 FMAs per cached value per query row) against the float32-accurate
// tensor-core route (3xTF32, 165 TFLOP/s; chip_smoke.py takes that as the
// bound). Single-pass TF32 or bf16 mma would round the operands, which is
// not a float32 kernel. This design is the simple one: FFMA on the CUDA
// cores from shared-memory tiles, no tensor cores, no asynchronous copies.
//   * the grid is (B * Hkv, nsplit) blocks of 256 threads; the wrapper picks
//     nsplit as for the bf16 body (fused_decode.dense_splits), each split
//     taking an even share of the window, the last one also the fresh keys
//     and the write;
//   * a split walks its share in chunks of CH = 64 slots. Each thread
//     fetches its groups of the next chunk's K and V rows (any cache type,
//     converted to float32 exactly; each slot through its page when paged,
//     so a chunk may cross pages and shared memory does not grow with the
//     page size) and the slots' k / v scales into registers a step ahead,
//     so that the loads are in flight while the block computes; then, per
//     step: the rows go to shared memory (K padded to Dh + 1 floats: no
//     bank conflicts); scores, a thread per (query row, key) with FFMA over
//     Dh in four interleaved partial sums, a warp's lanes on consecutive
//     keys of one row (the query row a broadcast); the online softmax in
//     base 2, a warp per query row (max and sum by shuffles); P . V, a
//     thread per (row, head dim) over the step's keys in four partial sums,
//     added to its accumulator in shared memory rescaled by alpha. The
//     loops run over the R = T * G rows the call has, not a bucket, so
//     one instance per cache type, Dh and layout serves every row count;
//   * the fresh block is one more step of T keys in the last split, with
//     the causal rule (a key the rule masks takes p = 0 by selection); no
//     loop reads past a step's keys;
//   * one split writes out = acc / l; several write (max, sum,
//     accumulator) per row to a float32 scratch from the wrapper and a
//     second kernel merges them in split order into the float32 output.
//     No atomics and a fixed order of every sum: repeats are bit-identical.
// The writes touch only slots >= offset (paged: position length, or the
// null page 0, which no valid row attends), which no split reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace decode_f32 {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int CH = 64;     // slots per chunk
constexpr int MAXR = 32;   // query rows T * G a block takes
constexpr int MAX_SPLITS = 8;      // the most splits the merge takes
constexpr int MERGE_THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// per cache element type: quantized or not, and the word that holds 4
// consecutive values as loaded (kept so in registers until they are stored)
template <typename CT>
struct Cache {
  static constexpr bool QUANT = false;
  using Quad = float4;
};
template <>
struct Cache<int8_t> {
  static constexpr bool QUANT = true;
  using Quad = uint32_t;
};
template <>
struct Cache<__nv_bfloat16> {
  static constexpr bool QUANT = false;
  using Quad = uint2;
};

struct Args {
  const void* q;   // (B, T, Hq, Dh) of the query type QT, strides below
  void* kc;        // dense (L, B, Hkv, S, Dh), paged (L, P, Hkv, ps, Dh) values
  void* vc;
  __nv_bfloat16* ks;  // int8: per-slot scales, dense (.., B, Hkv, S) at scale_layer,
  __nv_bfloat16* vs;  // paged (L, P, Hkv, ps) at layer
  __nv_bfloat16* ks_new;  // int8 + WRITE: (B, Hkv, T) fresh scales, or null to write
  __nv_bfloat16* vs_new;  // them into ks / vs at the fresh slots
  const void* kn;  // (B, T, Hkv, Dh) fresh keys / values of type QT, strides below
  const void* vn;
  const int* pads;     // (B,)
  const int* offsets;  // (B,) offsets (paged: lengths), or null: every row at `offset`
  int offset;
  void* out;    // contiguous (B, T, Hq, Dh) of type QT
  float* part;  // nsplit > 1: (B * Hkv, nsplit, R, Dh + 2), else null
  int nsplit;
  int B, T, Hq, Hkv, S, layer, scale_layer;
  const int* page_table;  // paged: (B, mp); S = mp * ps
  int P, ps, mp;
  long long q_sb, q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh;
  float scale;
};

// shared-memory layout in floats: V rows first (16-byte aligned for the
// float4 stores), K rows padded to DH + 1, the R query rows, P (R x CH), the
// rows' accumulators (R x DH), the chunk's k / v scales, and per row alpha,
// max and sum
template <int DH>
struct Layout {
  int v, k, q, p, acc, ksc, vsc, al, m, l, bytes;
  __host__ __device__ explicit Layout(int R) {
    v = 0;
    k = v + CH * DH;
    q = k + CH * (DH + 1);  // 16-byte aligned: rows are read as float4
    p = q + R * DH;
    acc = p + R * CH;
    ksc = acc + R * DH;
    vsc = ksc + CH;
    al = vsc + CH;
    m = al + MAXR;
    l = m + MAXR;
    bytes = (l + MAXR) * 4;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// 4 consecutive cache values as loaded, and as floats (exact for every
// cache type)
template <typename CT>
__device__ __forceinline__ typename Cache<CT>::Quad quad_at(const CT* p) {
  return *reinterpret_cast<const typename Cache<CT>::Quad*>(p);
}
template <typename CT>
__device__ __forceinline__ float4 quad_to_float(typename Cache<CT>::Quad w) {
  if constexpr (Cache<CT>::QUANT) {
    return int8x4_to_float4(w);
  } else if constexpr (sizeof(CT) == 4) {
    return w;
  } else {  // a bf16 is a float's top half
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
}

// a query, fresh or output element of type QT as a float (exact), and a
// float into one (bf16: round to nearest even)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename QT>
__device__ __forceinline__ QT from_float(float x) {
  if constexpr (sizeof(QT) == 4) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// x rounded to bf16 (nearest even) and widened back: the mixed instances'
// cached values and p over the cache
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a float32 value into a cache slot of type CT (int8 is quantized apart)
template <typename CT>
__device__ __forceinline__ CT store_as(float x) {
  if constexpr (sizeof(CT) == 4) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// the slot index in the (L, P, Hkv, ps) pools of slot j of page `pid`
__device__ __forceinline__ size_t page_slot(const Args& a, int pid, int h, int j) {
  return ((size_t)(a.layer * a.P + pid) * a.Hkv + h) * a.ps + j;
}

// the page id of row b's page t (t < mp), the null page 0 for an id outside [0, P)
__device__ __forceinline__ int page_id(const Args& a, int b, int t) {
  const int pid = a.page_table[(size_t)b * a.mp + t];
  return pid < 0 || pid >= a.P ? 0 : pid;
}

template <typename CT, typename QT, int DH, bool WRITE, bool PAGED>
__global__ void __launch_bounds__(THREADS, 2) decode_f32_kernel(const Args a) {
  constexpr bool QUANT = Cache<CT>::QUANT;
  constexpr bool MIXED = sizeof(QT) == 2;  // a bf16 query: cache values and p rounded to bf16
  const QT* qp = static_cast<const QT*>(a.q);
  const QT* knp = static_cast<const QT*>(a.kn);
  const QT* vnp = static_cast<const QT*>(a.vn);
  constexpr int Q4 = DH / 4;              // float4 groups of a row
  constexpr int PER = CH * Q4 / THREADS;  // groups of a K (or V) chunk per thread
  constexpr int RPW = MAXR / NWARP;       // softmax: rows per warp
  constexpr int EPL = DH / 32;            // write pass: elements per lane
  const int T = a.T, Hkv = a.Hkv, S = a.S;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = a.Hq / Hkv;
  const int R = T * G;
  const int split = blockIdx.y;
  const int nsplit = a.nsplit;
  const bool last = split == nsplit - 1;  // takes the fresh block and the write
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) float sm[];
  const Layout<DH> lay(R);
  float* v_s = sm + lay.v;      // [CH][DH]
  float* k_s = sm + lay.k;      // [CH][DH + 1]
  float* q_s = sm + lay.q;      // [R][DH]
  float* p_s = sm + lay.p;      // [R][CH] scores, then p (times the v scale)
  float* acc_s = sm + lay.acc;  // [R][DH] the rows' P . V accumulators
  float* ksc = sm + lay.ksc;    // [CH]
  float* vsc = sm + lay.vsc;    // [CH]
  float* al_s = sm + lay.al;    // [MAXR] alpha of the step
  float* m_s = sm + lay.m;      // [MAXR] final max (base 2)
  float* l_s = sm + lay.l;      // [MAXR] final sum

  for (int i = tid; i < R * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    q_s[i] = to_float(qp[b * a.q_sb + t * a.q_st + (h * G + g) * a.q_sh + d]);
    acc_s[i] = 0.f;
  }
  const int pad = max(a.pads[b], 0);
  const int off = a.offsets ? a.offsets[b] : a.offset;
  const int c_end = min(off, S);  // valid cache slots [pad, c_end)
  const int n_all = max(c_end - pad, 0);
  const int per = (n_all + nsplit - 1) / nsplit;
  const int lo = pad + split * per;
  const int hi = min(lo + per, c_end);  // this split's slots [lo, hi)
  const int n_chunks = hi > lo ? (hi - lo + CH - 1) / CH : 0;
  const int n_steps = n_chunks + (last ? 1 : 0);  // + the fresh block
  // dense: the (L, B, Hkv, S) index of this (layer, sample, kv head)'s slot 0
  const size_t row0 = ((size_t)(a.layer * a.B + b) * Hkv + h) * S;
  const size_t srow0 = ((size_t)(a.scale_layer * a.B + b) * Hkv + h) * S;
  const CT* kslab = PAGED ? nullptr : static_cast<const CT*>(a.kc) + row0 * DH;
  const CT* vslab = PAGED ? nullptr : static_cast<const CT*>(a.vc) + row0 * DH;
  const float scale2 = a.scale * LOG2E;

  float m_run[RPW], l_run[RPW];  // the softmax warp's rows warp + NWARP i
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }

  // the next cache chunk's K and V groups as loaded (row-contiguous, so
  // that a warp reads whole rows) and, thread tid < CH, slot tid's scales:
  // fetched into registers one step ahead, in flight while the block
  // computes, and converted to float32 as they are stored
  typename Cache<CT>::Quad kq[PER], vq[PER];
  float ksr = 1.f, vsr = 1.f;
  auto fetch = [&](int c0, int n) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + THREADS * u;
      const int j = i / Q4, c = 4 * (i % Q4);
      if (j < n) {
        const int pos = c0 + j;
        if constexpr (PAGED) {
          const int t = pos / a.ps;
          const size_t x = page_slot(a, page_id(a, b, t), h, pos - t * a.ps) * DH + c;
          kq[u] = quad_at<CT>(static_cast<const CT*>(a.kc) + x);
          vq[u] = quad_at<CT>(static_cast<const CT*>(a.vc) + x);
        } else {
          kq[u] = quad_at<CT>(kslab + (size_t)pos * DH + c);
          vq[u] = quad_at<CT>(vslab + (size_t)pos * DH + c);
        }
      }
    }
    if constexpr (QUANT) {
      if (tid < n) {
        const int pos = c0 + tid;
        size_t x = srow0 + pos;
        if constexpr (PAGED) {
          const int t = pos / a.ps;
          x = page_slot(a, page_id(a, b, t), h, pos - t * a.ps);
        }
        ksr = __bfloat162float(a.ks[x]);
        vsr = __bfloat162float(a.vs[x]);
      }
    }
  };
  if (n_chunks > 0) fetch(lo, min(CH, hi - lo));

  for (int step = 0; step < n_steps; ++step) {
    const bool fresh = step == n_chunks;
    const int c0 = lo + step * CH;
    const int n = fresh ? T : min(CH, hi - c0);  // keys of this step
    __syncthreads();  // the previous step is done with K, V and P
    // ---- the step's K and V rows [0, n) and their scales
    if (fresh) {
      for (int i = tid; i < T * DH; i += THREADS) {
        const int j = i / DH, d = i % DH;
        k_s[j * (DH + 1) + d] = to_float(knp[b * a.kn_sb + j * a.kn_st + h * a.kn_sh + d]);
        v_s[i] = to_float(vnp[b * a.vn_sb + j * a.vn_st + h * a.vn_sh + d]);
      }
      if (tid < T) ksc[tid] = vsc[tid] = 1.f;
    } else {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + THREADS * u;
        const int j = i / Q4, c = 4 * (i % Q4);
        if (j < n) {
          float4 kx = quad_to_float<CT>(kq[u]);
          float4 vx = quad_to_float<CT>(vq[u]);
          if constexpr (MIXED) {
            kx = make_float4(bf16_round(kx.x), bf16_round(kx.y), bf16_round(kx.z),
                             bf16_round(kx.w));
            vx = make_float4(bf16_round(vx.x), bf16_round(vx.y), bf16_round(vx.z),
                             bf16_round(vx.w));
          }
          float* kr = k_s + j * (DH + 1) + c;
          kr[0] = kx.x;
          kr[1] = kx.y;
          kr[2] = kx.z;
          kr[3] = kx.w;
          *reinterpret_cast<float4*>(v_s + j * DH + c) = vx;
        }
      }
      if (tid < n) {
        ksc[tid] = ksr;
        vsc[tid] = vsr;
      }
      if (step + 1 < n_chunks) fetch(c0 + CH, min(CH, hi - c0 - CH));
    }
    __syncthreads();

    // ---- scores (base 2), a thread per (row, key): Q . K^T as FFMA over Dh
    // in four interleaved partial sums; a warp shares one query row
    for (int pr = tid; pr < R * n; pr += THREADS) {
      const int r = pr / n, j = pr - r * n;
      const float* qr = q_s + r * DH;
      const float* kr = k_s + j * (DH + 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; d += 4) {
        const float4 qd = *reinterpret_cast<const float4*>(qr + d);
        s0 = fmaf(qd.x, kr[d], s0);
        s1 = fmaf(qd.y, kr[d + 1], s1);
        s2 = fmaf(qd.z, kr[d + 2], s2);
        s3 = fmaf(qd.w, kr[d + 3], s3);
      }
      p_s[r * CH + j] = ((s0 + s1) + (s2 + s3)) * ksc[j] * scale2;
    }
    __syncthreads();

    // ---- the online softmax, a warp per row: p = 2^(s - m) by selection;
    // the mixed instances round p over the cache to bf16 for P . V
    const bool round_p = MIXED && !fresh;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NWARP * i;
      if (r < R) {  // warp-uniform
        const int tq = r / G;
        const int j0 = lane, j1 = lane + 32;
        const bool ok0 = fresh ? j0 < T && j0 <= tq : j0 < n;
        const bool ok1 = fresh ? j1 < T && j1 <= tq : j1 < n;
        const float s0 = ok0 ? p_s[r * CH + j0] : NEG_INF;
        const float s1 = ok1 ? p_s[r * CH + j1] : NEG_INF;
        const float mx = warp_max(fmaxf(s0, s1));
        const float m_new = fmaxf(m_run[i], mx);
        const float alpha = exp2f(m_run[i] - m_new);
        const float p0 = ok0 ? exp2f(s0 - m_new) : 0.f;
        const float p1 = ok1 ? exp2f(s1 - m_new) : 0.f;
        l_run[i] = l_run[i] * alpha + warp_sum(p0 + p1);
        m_run[i] = m_new;
        if (j0 < n) {
          const float w = p0 * vsc[j0];
          p_s[r * CH + j0] = round_p ? bf16_round(w) : w;
        }
        if (j1 < n) {
          const float w = p1 * vsc[j1];
          p_s[r * CH + j1] = round_p ? bf16_round(w) : w;
        }
        if (lane == 0) al_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P . V, a thread per (row, head dim), the
    // step's keys in four interleaved partial sums; a warp shares one row
    for (int e = tid; e < R * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      const float* pr = p_s + r * CH;
      const float* vc = v_s + d;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        x0 = fmaf(pr[j], vc[j * DH], x0);
        x1 = fmaf(pr[j + 1], vc[(j + 1) * DH], x1);
        x2 = fmaf(pr[j + 2], vc[(j + 2) * DH], x2);
        x3 = fmaf(pr[j + 3], vc[(j + 3) * DH], x3);
      }
      for (; j < n; ++j) x0 = fmaf(pr[j], vc[j * DH], x0);
      acc_s[e] = fmaf(acc_s[e], al_s[r], (x0 + x1) + (x2 + x3));
    }
  }

  // ---- the block's rows: normalised out, or this split's (max, sum, acc)
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARP * i;
    if (r < R && lane == 0) {
      m_s[r] = m_run[i];
      l_s[r] = l_run[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < R * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH;
    if (nsplit == 1) {
      const int t = r / G, g = r % G;
      static_cast<QT*>(a.out)[(((size_t)b * T + t) * a.Hq + h * G + g) * DH + d] =
          from_float<QT>(acc_s[e] / l_s[r]);
    } else {
      float* part = a.part + (((size_t)blockIdx.x * nsplit + split) * R + r) * (DH + 2);
      part[2 + d] = acc_s[e];
      if (d == 0) {
        part[0] = m_s[r];
        part[1] = l_s[r];
      }
    }
  }

  if constexpr (WRITE) {
    // ---- the fresh rows at [off, off + T), a warp per (token, k or v);
    // paged (T = 1), position off = length through the table
    if (last) {
      for (int i = warp; i < 2 * T; i += NWARP) {
        const int t = i / 2;
        const bool is_v = (i % 2) == 1;
        const QT* src = is_v ? vnp + b * a.vn_sb + t * a.vn_st + h * a.vn_sh
                             : knp + b * a.kn_sb + t * a.kn_st + h * a.kn_sh;
        const int slot = off + t;
        bool inside = slot >= 0 && slot < S;  // the wrapper guarantees offsets + T <= S
        CT* dst = const_cast<CT*>(is_v ? vslab : kslab) + (size_t)slot * DH;
        size_t sx = srow0 + slot;  // the scale's index
        if constexpr (PAGED) {  // always written: the null page 0 outside the table
          const int tw = slot >= 0 ? slot / a.ps : -((a.ps - 1 - slot) / a.ps);  // floor
          sx = page_slot(a, tw >= 0 && tw < a.mp ? page_id(a, b, tw) : 0, h, slot - tw * a.ps);
          dst = static_cast<CT*>(is_v ? a.vc : a.kc) + sx * DH;
          inside = true;
        }
        float x[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) x[e] = to_float(src[lane * EPL + e]);
        if constexpr (QUANT) {
          float amax = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
          amax = warp_max(amax);
          const float qs = fmaxf(amax / 127.0f, 1e-8f);  // IEEE division
          if (inside) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              dst[lane * EPL + e] = (int8_t)fminf(fmaxf(rintf(x[e] / qs), -127.f), 127.f);
            }
            if (lane == 0) {
              const __nv_bfloat16 s16 = __float2bfloat16_rn(qs);
              __nv_bfloat16* fresh_s = is_v ? a.vs_new : a.ks_new;
              if (fresh_s) {
                fresh_s[((size_t)b * Hkv + h) * T + t] = s16;
              } else {
                (is_v ? a.vs : a.ks)[sx] = s16;
              }
            }
          }
        } else if (inside) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) dst[lane * EPL + e] = store_as<CT>(x[e]);
        }
      }
    }
  }
}

// the splits of each (sample, kv head) merged in split order into the
// output of type QT (rounded once, here): a block per (sample, kv head), a
// thread per (row, head dim); a split without a slot has max -1e30 and sum
// 0 and adds nothing
template <typename QT, int DH>
__global__ void __launch_bounds__(MERGE_THREADS) decode_f32_merge_kernel(const Args a) {
  const int Hkv = a.Hkv, T = a.T, G = a.Hq / Hkv, R = T * G, n = a.nsplit;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  for (int idx = threadIdx.x; idx < R * DH; idx += MERGE_THREADS) {
    const int r = idx / DH, d = idx % DH;
    float mi[MAX_SPLITS], li[MAX_SPLITS], ai[MAX_SPLITS];
#pragma unroll
    for (int i = 0; i < MAX_SPLITS; ++i) {
      if (i < n) {
        const float* part = a.part + (((size_t)blockIdx.x * n + i) * R + r) * (DH + 2);
        mi[i] = part[0];
        li[i] = part[1];
        ai[i] = part[2 + d];
      }
    }
    float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS; ++i) {
      if (i < n) {
        const float Mn = fmaxf(M, mi[i]);
        const float w_old = exp2f(M - Mn), w_new = exp2f(mi[i] - Mn);
        L = L * w_old + li[i] * w_new;
        A = A * w_old + ai[i] * w_new;
        M = Mn;
      }
    }
    const int t = r / G, g = r % G;
    static_cast<QT*>(a.out)[(((size_t)b * T + t) * a.Hq + h * G + g) * DH + d] =
        from_float<QT>(A / L);
  }
}

template <typename CT, typename QT, int DH, bool WRITE, bool PAGED>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = Layout<DH>(a.T * (a.Hq / a.Hkv)).bytes;
  auto kernel = decode_f32_kernel<CT, QT, DH, WRITE, PAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.B * a.Hkv, a.nsplit), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return (int)err;
  decode_f32_merge_kernel<QT, DH><<<a.B * a.Hkv, MERGE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instance for the cache type, query type, head dim and layout of `a`
template <typename CT, typename QT, bool WRITE, bool PAGED>
int dispatch(const Args& a, int Dh, cudaStream_t s) {
  if (a.nsplit < 1 || a.nsplit > MAX_SPLITS || a.T * (a.Hq / a.Hkv) > MAXR) {
    return (int)cudaErrorInvalidValue;
  }
  if (Dh == 128) return launch<CT, QT, 128, WRITE, PAGED>(a, s);
  if (Dh == 64) return launch<CT, QT, 64, WRITE, PAGED>(a, s);
  return (int)cudaErrorInvalidValue;
}

// shared memory bytes for R = T * G query rows; they grow with neither S
// nor the page size
inline long long smem_for(int Dh, int R) {
  return Dh == 128 ? Layout<128>(R).bytes : Layout<64>(R).bytes;
}

}  // namespace decode_f32
