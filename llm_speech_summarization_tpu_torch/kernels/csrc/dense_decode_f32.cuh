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
//     is read from shared memory, before any product: the kernels cast the
//     cache to q's dtype. The products of two bf16 values are exact in
//     float32, so FFMA over them is a bf16 x bf16 -> float32 MMA up to the
//     order of the sums;
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
// their products are the float32 instances' less the q rounding.
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
// What bounds it on the H100: the cache bytes (a float32 row is 512 B at
// Dh = 128, four times an int8 row); the products are 2 FMAs per cached
// value per query row, about 1.5 FLOP a byte at G = 3, far below the
// card's ridge, so FFMA on the CUDA cores stays (tensor cores would add
// nothing a byte-bound body can use, and single-pass TF32 or bf16 would
// round the operands). The design streams the cache:
//   * the grid is (B * Hkv, nsplit) blocks of 256 threads, two an SM; the
//     wrapper picks nsplit with the float32 body's own rule
//     (fused_decode.f32_splits: a float32 slot carries four times an int8
//     slot's bytes, so it splits where the bf16 body's rule would not),
//     each split taking an even share of the window, the last one also the
//     fresh keys and the write;
//   * a split walks its share in chunks of CH = 32 slots through a ring of
//     STAGES shared-memory stages (3 for a float32 cache at Dh = 128, up to
//     8 for smaller rows: ~100 KB a block, ~200 KB in flight an SM, where
//     Little's law asks ~25 KB to approach 3.35 TB/s). Each stage takes a
//     chunk's K and V rows as stored (int8, bf16 or float32), by cp.async
//     at 16 B a thread-copy, slot by slot (paged: each slot through its
//     page, so a chunk may cross pages and shared memory does not grow
//     with the page size); an int8 chunk's scales follow a step later
//     through registers. STAGES - 1 chunks are in flight while one is
//     computed. Rows are padded by 16 B, so the score loop's 16-byte reads
//     of 8 consecutive rows hit 32 distinct banks;
//   * values are converted at use, from shared memory: int8 and bf16
//     widened exactly (the k scale multiplies the score, the v scale p),
//     the mixed instances' rounded to bf16; the fresh keys and values sit
//     in float32 rows of their own, loaded when the block starts;
//   * per chunk: scores, a lane pair per (query row, key), each lane FFMA
//     over its half of Dh in four interleaved partial sums (element d into
//     sum d % 4, combined (s0 + s1) + (s2 + s3)), the halves added by a
//     shuffle, the query row a broadcast; the online softmax in base 2, a
//     warp per query row, a lane per key (max and sum by shuffles); P . V,
//     a thread per (query row, four consecutive head dims), p read four
//     keys at a time, summing the chunk's keys in order into registers,
//     then acc = acc * alpha + that sum in shared memory. Each step is a
//     chain of short latencies, so every loop is laid out for independent
//     loads and products; the loops run over the R = T * G rows the call
//     has, so one instance per cache type, Dh and layout serves every row
//     count;
//   * the fresh block is one more step of T keys in the last split, with
//     the causal rule (a key the rule masks takes p = 0 by selection); no
//     loop reads past a step's keys;
//   * one split writes out = acc / l; several write (max, sum,
//     accumulator) per row to a float32 scratch from the wrapper and a
//     second kernel merges them in split order into the output. No atomics
//     and a fixed order of every sum: repeats are bit-identical.
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
constexpr int CH = 32;     // slots per chunk: a lane per key in the softmax
constexpr int MAXR = 32;   // query rows T * G a block takes
constexpr int MAX_SPLITS = 16;     // the most splits the merge takes
constexpr int MERGE_THREADS = 256;
constexpr int RING_BYTES = 104 * 1024;  // a block's ring: two blocks an SM
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// a ring of chunks of cache type CT at head dim DH: a slot's K (or V) row
// as stored, padded by 16 B; a stage holds CH K rows, CH V rows and, for
// int8, the chunk's k and v scales as floats
template <typename CT, int DH>
struct Ring {
  static constexpr bool QUANT = sizeof(CT) == 1;
  static constexpr int SEGS = DH * (int)sizeof(CT) / 16;  // 16-byte copies a row
  static constexpr int ROWB = DH * (int)sizeof(CT) + 16;
  static constexpr int SCB = QUANT ? 2 * CH * 4 : 0;
  static constexpr int STAGE = 2 * CH * ROWB + SCB;
  static constexpr int STAGES =
      RING_BYTES / STAGE < 3 ? 3 : (RING_BYTES / STAGE > 8 ? 8 : RING_BYTES / STAGE);
  static constexpr int BYTES = STAGES * STAGE;
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

// shared-memory layout in bytes: the ring, the fresh K and V rows (float32,
// padded by 16 B), the R query rows, their P . V accumulators, P (R x CH),
// and per row alpha, max and sum
template <typename CT, int DH>
struct Layout {
  int fresh, q, acc, p, al, m, l, bytes;
  __host__ __device__ Layout(int T, int R) {
    fresh = Ring<CT, DH>::BYTES;
    q = fresh + 2 * T * (DH * 4 + 16);
    acc = q + R * DH * 4;
    p = acc + R * DH * 4;
    al = p + R * CH * 4;
    m = al + MAXR * 4;
    l = m + MAXR * 4;
    bytes = l + MAXR * 4;
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

// the 16 / sizeof(ST) values of a 16-byte word of a row of type ST, as
// floats (exact), rounded to bf16 when ROUND
template <typename ST, bool ROUND>
__device__ __forceinline__ void widen16(const uint4 w, float* x) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(ST) == 1) {
      const float4 f = int8x4_to_float4(u[i]);
      x[4 * i] = f.x;
      x[4 * i + 1] = f.y;
      x[4 * i + 2] = f.z;
      x[4 * i + 3] = f.w;
    } else if constexpr (sizeof(ST) == 2) {  // a bf16 is a float's top half
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
      x[i] = ROUND ? bf16_round(__uint_as_float(u[i])) : __uint_as_float(u[i]);
    }
  }
}

// values d .. d + 3 of a row of type ST as floats (exact), rounded to bf16
// when ROUND
template <typename ST, bool ROUND>
__device__ __forceinline__ float4 widen4(const unsigned char* row, int d) {
  if constexpr (sizeof(ST) == 1) {
    return int8x4_to_float4(*reinterpret_cast<const uint32_t*>(row + d));
  } else if constexpr (sizeof(ST) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 2 * d);
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  } else {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * d);
    return ROUND ? make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                               bf16_round(x.w))
                 : x;
  }
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one step over n keys whose K and V rows (type ST, row stride rowb bytes)
// start at kb and vb: the scores into p_s, the online softmax (a warp per
// row), then P . V into the accumulators acc_s. SCALED: an int8 chunk,
// whose k / v scales are ksc / vsc; ROUND: the mixed instances' rounding
// of the cached values and of p; FRESH: the fresh block, under the causal
// rule. The caller synchronised the block before the step.
template <typename ST, int DH, bool SCALED, bool ROUND, bool FRESH>
__device__ __forceinline__ void attend_step(const unsigned char* kb, const unsigned char* vb,
                                            int rowb, const float* ksc, const float* vsc, int n,
                                            int R, int G, float scale2, const float* q_s,
                                            float* p_s, float* al_s, float* m_run, float* l_run,
                                            float* acc_s) {
  constexpr int VPW = 16 / (int)sizeof(ST);  // values a 16-byte word holds
  constexpr int RPW = MAXR / NWARP;          // softmax: rows per warp
  constexpr int D4 = DH / 4;                 // P . V: four head dims a thread
  constexpr int HALF = DH / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- scores (base 2), a lane pair per (row, key): the even lane sums the
  // first half of Dh, the odd lane the second, each in four interleaved
  // partial sums (element d into d % 4); a warp shares one query row
  const int items = 2 * R * n;
  for (int base = warp * 32; base < items; base += THREADS) {  // warp-uniform
    const int it = base + lane;
    const int pr = min(it, items - 1) >> 1, hf = it & 1;
    const int r = pr / n, j = pr - r * n;
    const float* qr = q_s + r * DH + hf * HALF;
    const unsigned char* kr = kb + j * rowb + hf * HALF * (int)sizeof(ST);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < HALF; c += VPW) {
      float x[VPW];
      widen16<ST, ROUND>(*reinterpret_cast<const uint4*>(kr + c * (int)sizeof(ST)), x);
#pragma unroll
      for (int e = 0; e < VPW; e += 4) {
        const float4 qd = *reinterpret_cast<const float4*>(qr + c + e);
        s[0] = fmaf(qd.x, x[e], s[0]);
        s[1] = fmaf(qd.y, x[e + 1], s[1]);
        s[2] = fmaf(qd.z, x[e + 2], s[2]);
        s[3] = fmaf(qd.w, x[e + 3], s[3]);
      }
    }
    float dot = (s[0] + s[1]) + (s[2] + s[3]);
    dot += __shfl_xor_sync(FULL, dot, 1);  // the two halves (the same sum on both lanes)
    if (it < items && hf == 0) p_s[r * CH + j] = (SCALED ? dot * ksc[j] : dot) * scale2;
  }
  __syncthreads();

  // ---- the online softmax, a warp per row, a lane per key: p = 2^(s - m)
  // by selection; the mixed instances round p over the cache to bf16
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARP * i;
    if (r < R) {  // warp-uniform
      const bool ok = FRESH ? lane < n && lane <= r / G : lane < n;
      const float s = ok ? p_s[r * CH + lane] : NEG_INF;
      const float m_new = fmaxf(m_run[i], warp_max(s));
      const float alpha = exp2f(m_run[i] - m_new);
      const float p = ok ? exp2f(s - m_new) : 0.f;
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
      if (lane < n) {
        const float w = SCALED ? p * vsc[lane] : p;
        p_s[r * CH + lane] = ROUND ? bf16_round(w) : w;
      }
      if (lane == 0) al_s[r] = alpha;
    }
  }
  __syncthreads();

  // ---- acc = acc * alpha + P . V: a thread per (row, four consecutive head
  // dims), the step's keys summed in order, p read four keys at a time
  for (int it = tid; it < R * D4; it += THREADS) {
    const int r = it / D4, d = 4 * (it - r * D4);
    const float* pr = p_s + r * CH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
      const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
      float4 v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[jj] = widen4<ST, ROUND>(vb + (j + jj) * rowb, d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        x[0] = fmaf(pj[jj], v[jj].x, x[0]);
        x[1] = fmaf(pj[jj], v[jj].y, x[1]);
        x[2] = fmaf(pj[jj], v[jj].z, x[2]);
        x[3] = fmaf(pj[jj], v[jj].w, x[3]);
      }
    }
    for (; j < n; ++j) {
      const float4 v = widen4<ST, ROUND>(vb + j * rowb, d);
      x[0] = fmaf(pr[j], v.x, x[0]);
      x[1] = fmaf(pr[j], v.y, x[1]);
      x[2] = fmaf(pr[j], v.z, x[2]);
      x[3] = fmaf(pr[j], v.w, x[3]);
    }
    float4* a4 = reinterpret_cast<float4*>(acc_s + r * DH + d);
    float4 acc = *a4;
    const float al = al_s[r];
    acc.x = fmaf(acc.x, al, x[0]);
    acc.y = fmaf(acc.y, al, x[1]);
    acc.z = fmaf(acc.z, al, x[2]);
    acc.w = fmaf(acc.w, al, x[3]);
    *a4 = acc;
  }
}

template <typename CT, typename QT, int DH, bool WRITE, bool PAGED>
__global__ void __launch_bounds__(THREADS, 2) decode_f32_kernel(const Args a) {
  using RingT = Ring<CT, DH>;
  constexpr bool QUANT = RingT::QUANT;
  constexpr bool MIXED = sizeof(QT) == 2;  // a bf16 query: cache values and p rounded to bf16
  constexpr int STAGES = RingT::STAGES, ROWB = RingT::ROWB, SEGS = RingT::SEGS;
  constexpr int RPW = MAXR / NWARP;            // softmax: rows per warp
  constexpr int EPL = DH / 32;                 // write pass: elements per lane
  constexpr int FROWB = DH * 4 + 16;           // a fresh row, float32
  static_assert(STAGES >= 3, "an int8 chunk's scales land a step after its rows");
  const QT* qp = static_cast<const QT*>(a.q);
  const QT* knp = static_cast<const QT*>(a.kn);
  const QT* vnp = static_cast<const QT*>(a.vn);
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

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<CT, DH> lay(T, R);
  unsigned char* fresh_k = smem + lay.fresh;            // [T][FROWB]
  unsigned char* fresh_v = fresh_k + T * FROWB;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);  // [R][DH]
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);  // [R][DH] the rows' P . V
  float* p_s = reinterpret_cast<float*>(smem + lay.p);  // [R][CH] scores, then p
  float* al_s = reinterpret_cast<float*>(smem + lay.al);  // [MAXR] alpha of the step
  float* m_s = reinterpret_cast<float*>(smem + lay.m);    // [MAXR] final max (base 2)
  float* l_s = reinterpret_cast<float*>(smem + lay.l);    // [MAXR] final sum

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

  // the (L, B, Hkv, S) or (L, P, Hkv, ps) slot index of cache position pos
  auto slot_of = [&](int pos) -> size_t {
    if constexpr (PAGED) {
      const int t = pos / a.ps;
      return page_slot(a, page_id(a, b, t), h, pos - t * a.ps);
    } else {
      return row0 + pos;
    }
  };
  // chunk c's K and V rows into ring stage c % STAGES by cp.async (no
  // commit); an empty chunk copies nothing
  auto issue = [&](int c) {
    const int c0 = lo + c * CH;
    const int n = c < n_chunks ? min(CH, hi - c0) : 0;
    unsigned char* st = smem + (c % STAGES) * RingT::STAGE;
    for (int i = tid; i < n * SEGS; i += THREADS) {
      const int j = i / SEGS, sg = i - j * SEGS;
      const size_t x = slot_of(c0 + j) * DH * sizeof(CT) + 16 * sg;
      cp_async16(st + j * ROWB + 16 * sg, static_cast<const unsigned char*>(a.kc) + x);
      cp_async16(st + CH * ROWB + j * ROWB + 16 * sg,
                 static_cast<const unsigned char*>(a.vc) + x);
    }
  };
  // int8: chunk c's k scale (threads [0, CH)) or v scale ([CH, 2 CH)) of
  // slot tid % CH, loaded into a register, and its place in the stage
  auto scale_load = [&](int c) -> float {
    const int c0 = lo + c * CH, j = tid % CH;
    if (tid >= 2 * CH || c >= n_chunks || c0 + j >= hi) return 1.f;
    size_t x = srow0 + c0 + j;
    if constexpr (PAGED) x = slot_of(c0 + j);
    return __bfloat162float((tid < CH ? a.ks : a.vs)[x]);
  };
  auto scale_store = [&](int c, float s) {
    if (tid < 2 * CH) {
      reinterpret_cast<float*>(smem + (c % STAGES) * RingT::STAGE + 2 * CH * ROWB)[tid] = s;
    }
  };

  // ---- the ring's first STAGES - 1 chunks in flight, then the query and
  // fresh rows as floats while they land
#pragma unroll 1
  for (int c = 0; c < STAGES - 1; ++c) {
    issue(c);
    cp_async_commit();
  }
  if constexpr (QUANT) {
#pragma unroll 1
    for (int c = 0; c < STAGES - 1; ++c) scale_store(c, scale_load(c));
  }
  for (int i = tid; i < R * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    q_s[i] = to_float(qp[b * a.q_sb + t * a.q_st + (h * G + g) * a.q_sh + d]);
    acc_s[i] = 0.f;
  }
  if (last) {
    for (int i = tid; i < T * DH; i += THREADS) {
      const int j = i / DH, d = i % DH;
      reinterpret_cast<float*>(fresh_k + j * FROWB)[d] =
          to_float(knp[b * a.kn_sb + j * a.kn_st + h * a.kn_sh + d]);
      reinterpret_cast<float*>(fresh_v + j * FROWB)[d] =
          to_float(vnp[b * a.vn_sb + j * a.vn_st + h * a.vn_sh + d]);
    }
  }

  float m_run[RPW], l_run[RPW];  // the softmax warp's rows warp + NWARP i
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }
  float pend = 1.f;  // int8: the scale of chunk step + STAGES - 2, loaded a step ago

#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    if (step == n_chunks) {  // the fresh block (last split)
      __syncthreads();       // the previous step is done with P
      attend_step<float, DH, false, false, true>(fresh_k, fresh_v, FROWB, nullptr, nullptr, T,
                                                 R, G, scale2, q_s, p_s, al_s, m_run, l_run,
                                                 acc_s);
      continue;
    }
    cp_async_wait<STAGES - 2>();  // chunk `step` landed for this thread
    __syncthreads();  // ... for every thread, and stage (step - 1) % STAGES is free
    if constexpr (QUANT) {
      if (step > 0) scale_store(step + STAGES - 2, pend);
      pend = scale_load(step + STAGES - 1);
    }
    issue(step + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (step % STAGES) * RingT::STAGE;
    const float* sc = reinterpret_cast<const float*>(st + 2 * CH * ROWB);
    const int n = min(CH, hi - (lo + step * CH));
    attend_step<CT, DH, QUANT, MIXED, false>(st, st + CH * ROWB, ROWB, sc, sc + CH, n, R, G,
                                             scale2, q_s, p_s, al_s, m_run, l_run, acc_s);
  }
  cp_async_wait<0>();

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
  const int smem = Layout<CT, DH>(a.T, a.T * (a.Hq / a.Hkv)).bytes;
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

// shared memory bytes for T fresh tokens and R = T * G query rows of a
// cache of cache_bytes per value; they grow with neither S nor the page size
inline long long smem_for(int Dh, int T, int R, int cache_bytes) {
#define LSS_F32_SMEM(CT)                                                        \
  return Dh == 128 ? Layout<CT, 128>(T, R).bytes : Layout<CT, 64>(T, R).bytes;
  if (cache_bytes == 1) LSS_F32_SMEM(int8_t)
  if (cache_bytes == 2) LSS_F32_SMEM(__nv_bfloat16)
  LSS_F32_SMEM(float)
#undef LSS_F32_SMEM
}

}  // namespace decode_f32
