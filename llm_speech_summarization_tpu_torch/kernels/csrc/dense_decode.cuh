// Decode attention over one layer of a dense (L, B, Hkv, S, Dh) KV cache or
// of page-major (L, P, Hkv, ps, Dh) pools, for Hopper (sm_90a): the body
// shared by the fused decode kernels B2 and B3 (fused_decode.cu, which also
// write the fresh tokens in place), the read-only decode attention B8
// (decode_attention.cu), the paged decode attention B4 (paged_attention.cu)
// and the fused paged decode B5 (fused_paged.cu, which writes its fresh
// token into its page).
//
// Each of the T >= 1 fresh queries of sample b attends the cache slots
// pad[b] <= s < offset[b] of layer `layer` plus the fresh keys causally
// (fresh key j <= query t). The cache is int8 with bf16 per-slot scales
// (keys dequantized by k_scale, values weighted by p * v_scale) or bf16.
// p stays in float32. With WRITE, the fresh k/v rows are then written at
// slots [offset, offset + T): an int8 cache takes them quantized exactly
// like models/llama.py::_quantize_kv (absmax / 127 in float32, floor 1e-8,
// IEEE division, rintf = round half to even, clip to +-127) with their bf16
// scales written into the scale slab at the slot or returned as (B, Hkv, T)
// outputs; a bf16 cache takes the fresh bf16 values as they are.
//
// The two layouts (the kernel's PAGED parameter) differ only in where a
// slot lives:
//   * dense: slot s of (layer, b, h) is row s of one contiguous slab; the
//     window is [pad, min(offset, S)); the write goes to slots offset + t;
//   * paged: position pos of row b lives at page page_table[b, pos / ps]
//     (an id outside [0, P) reads the null page 0), slot pos % ps, of
//     (layer, page, h); `offsets` holds the rows' lengths and S is mp * ps,
//     so the window is [pad, min(length, mp * ps)); the write (T = 1) goes
//     to position `length`: page page_table[b, length / ps] inside the
//     table, else the null page 0 (a length < 0 or >= mp * ps; a released
//     row's zeroed table row writes page 0 too), the routing of
//     infer/paged.py::write_tokens and kernels/fused_paged.py::
//     _write_targets.
// A chunk starts anywhere in the window (the split shares start at pad),
// so a paged chunk may cross pages. The producer issues one bulk copy per
// page segment of the chunk, every copy completing on the chunk's `full`
// mbarrier, whose expect_tx takes the chunk's total bytes. (Chunks aligned
// to absolute positions would still cross pages wherever 64 or 128 does
// not divide ps, and would add a masked part chunk at every split edge.)
// Lane k of the producer warp owns the chunk's k-th page (at most CH / 16
// + 1 = 9 of them) and loads that page's id from the table two chunks
// ahead, so neither a copy nor a scale load waits on a table load.
//
// What bounds it on the H100: reading the cache bytes, in principle. A
// step reads B * Hkv * S * Dh values of k and of v per layer and does ~2
// multiply-adds per value per query row, far below the tensor-core line.
// The first designs (one block per (sample, kv head) with the R x S scores
// in shared memory, or with one page of K and V at a time staged
// synchronously through registers and its scores on the CUDA cores, every
// int8 key converted once per query row) ran at 3.6-21% of that bound: no
// byte in flight while a block computed, long dependent chains, and an S
// (or ps) limit set by the score buffer. This one (flash-decoding):
//   * the grid is (B * Hkv, NSPLIT): the wrapper picks NSPLIT (1 to 8,
//     fused_decode.dense_splits) so that the grid takes the SMs a (B * Hkv)
//     grid leaves idle where that shortens each block's walk enough to pay
//     for the merge, and each split block takes an even share of its
//     sample's window [pad, offset);
//   * a block (8 or 16 consumer warps and a producer warp) streams its
//     share in chunks of 8 slots a consumer warp: the producer copies a
//     chunk's K rows and V rows with one cp.async.bulk each (one per page
//     segment, paged) into a ring of 2 or 3 shared-memory stages completed
//     on mbarriers, and stores the chunk's k/v scales beside them (loaded
//     a chunk ahead), while the consumers work on earlier chunks. No R x S
//     buffer remains, so neither S nor ps is limited;
//   * each consumer warp takes 8 keys of every chunk and runs its own
//     online softmax in float32 (base 2): the scores of its R = T * G <= 32
//     query rows (each cache row read once for the whole GQA group) come
//     from mma.sync m16n8k16 on the tensor cores, q as bf16 A fragments
//     held for the whole split, the keys as B fragments (an int8 key is
//     exact in bf16), with the head dims permuted so that each lane reads
//     one contiguous quarter of its key row; the per-slot k scale
//     multiplies the float32 scores. p stays float32: the value pass runs
//     on the CUDA cores, a lane per 4 head dims, p times the slot's v scale
//     from a per-warp table;
//   * at the end the warps are merged in warp order inside the block; with
//     NSPLIT > 1 each split writes its rows' (max, sum, accumulator) to a
//     float32 scratch from the wrapper and a second kernel merges the
//     splits in split order (a cluster merge through distributed shared
//     memory measured slower: PERF.md §6). No atomics, a fixed summation
//     order: repeats are bit-identical. A split with no slot keeps max
//     -1e30 and sum 0 and adds nothing; the last split also takes the
//     fresh block and the write.
// What holds it back now is instructions, not bytes: every int8 element is
// converted twice (k, v) and every v element costs R float32 FMAs, so one
// block keeps an SM busy, and its time grows with the slots it walks;
// splitting helps where B * Hkv leaves SMs idle (the trainers' B = 1
// generations: PERF.md §6 times every split count, `chip_smoke.py
// --split-sweep`). The writes touch only slots >= offset (paged: position
// length, or the null page 0, which no valid row attends), which no split
// reads, so the splits need no ordering between the reads and the write.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"
#include "int8.cuh"

namespace dense_decode {

constexpr int MERGE_THREADS = 256;
constexpr int MAX_SPLITS = 8;  // the most splits the merge takes
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename CT>
struct Cache;  // per cache element type: quantized or not
template <>
struct Cache<int8_t> {
  static constexpr bool QUANT = true;
};
template <>
struct Cache<__nv_bfloat16> {
  static constexpr bool QUANT = false;
};

struct Args {
  const __nv_bfloat16* q;  // (B, T, Hq, Dh), strides below
  void* kc;                // (L, B, Hkv, S, Dh) cache values
  void* vc;
  __nv_bfloat16* ks;  // int8 cache: per-slot scales, (.., B, Hkv, S) at scale_layer
  __nv_bfloat16* vs;
  __nv_bfloat16* ks_new;  // int8 + WRITE: (B, Hkv, T) fresh scales, or null to write
  __nv_bfloat16* vs_new;  // them into ks/vs at the fresh slots
  const __nv_bfloat16* kn;  // (B, T, Hkv, Dh) fresh keys/values, strides below
  const __nv_bfloat16* vn;
  const int* pads;     // (B,)
  const int* offsets;  // (B,), or null: every row at `offset`
  int offset;
  __nv_bfloat16* out;  // contiguous (B, T, Hq, Dh)
  float* part;  // nsplit > 1: (B * Hkv, nsplit, R, DH + 2) split results, else null
  int nsplit;
  int B, T, Hq, Hkv, S, layer, scale_layer;
  // paged: kc/vc are (L, P, Hkv, ps, Dh) pools, ks/vs (L, P, Hkv, ps) scales
  // read and written at `layer`, offsets the lengths, S = mp * ps
  const int* page_table;  // (B, mp)
  int P, ps, mp;
  long long q_sb, q_st, q_sh, kn_sb, kn_st, kn_sh, vn_sb, vn_st, vn_sh;
  float scale;
};

inline int rows_bucket(int R) { return R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32; }

// the SMs of the current device: a grid of at most this many blocks takes
// 16 consumer warps a block (one block an SM), a larger one 8 (two blocks
// an SM, so that one block's prologue and merge overlap the other's chunks)
inline int device_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// a kernel instance's shape: NW consumer warps of 8 keys each per chunk,
// STAGES chunk stages, and its shared-memory layout, in bytes from a
// 16-byte aligned base
template <typename CT, int DH, int MAXR, int NW_>
struct Cfg {
  static constexpr bool QUANT = Cache<CT>::QUANT;
  static constexpr int NW = NW_;
  static constexpr int NCT = NW * 32;  // consumer threads
  static constexpr int NT = NCT + 32;  // + the producer warp
  static constexpr int MINB = NW == 8 ? 2 : 1;  // blocks an SM, for the register budget
  static constexpr int KPW = 8;  // keys of a chunk per warp: one mma n8 tile
  static constexpr int CH = KPW * NW;  // slots per chunk
  static constexpr int RB = DH * (int)sizeof(CT);  // cache row bytes
  static constexpr int ROWS = CH * RB;  // K (or V) rows of one stage
  static constexpr int STAGE = 2 * ROWS + (QUANT ? 2 * CH * 4 : 0);
  static constexpr int STAGES = 3 * STAGE <= 112 * 1024 ? 3 : 2;
  struct Layout {
    int q, kn, vn, mw, lw, pw, xw, bars, bytes;
    __host__ __device__ Layout(int R, int T) {
      // the warps' (R, DH) accumulators take the place of the stages once
      // every chunk is done
      xw = 0;
      int o = STAGES * STAGE > NW * R * DH * 4 ? STAGES * STAGE : NW * R * DH * 4;
      q = o;  // bf16 query rows over whole m16 tiles, rows padded by 16 bytes
      o += (MAXR + 15) / 16 * 16 * (DH + 8) * 2;
      kn = o;
      o += T * DH * 4;
      vn = o;
      o += T * DH * 4;
      mw = o;  // per warp: running max and sum of each row, a step's p and alpha
      o += NW * MAXR * 4;
      lw = o;
      o += NW * MAXR * 4;
      pw = o;
      o += NW * (KPW + 1) * MAXR * 4;
      bars = o;
      o += 2 * STAGES * 8;
      bytes = o;
    }
  };
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// ---- PTX: the mbarriers come from flash_sm90.cuh; bulk copies and the
// consumer barrier here

using lss_sm90::mbar_arrive;
using lss_sm90::mbar_expect_tx;
using lss_sm90::mbar_init;
using lss_sm90::mbar_wait;
using lss_sm90::smem_u32;

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared `dst`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// the NCT consumer threads only (the producer warp runs on its own)
template <int NCT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}
// two bf16 in a word as floats (exact: a bf16 is the top half of a float)
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// 4 consecutive cache values at byte `off` of a staged row, as floats
template <typename CT>
__device__ __forceinline__ float4 quad_to_float(const uint8_t* row, int off) {
  if constexpr (Cache<CT>::QUANT) {
    return int8x4_to_float4(*reinterpret_cast<const uint32_t*>(row + off));
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row + off);
    const float2 a = bf16x2_to_float2(w.x);
    const float2 b = bf16x2_to_float2(w.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

// S (16 rows, 8 keys) += A . B on the tensor cores, bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of this lane's key row for every k step: 16-byte pieces
// of the row's head-dim quarter, as bf16 pairs (an int8 value is exact in
// bf16); a key past the chunk gives zeros, never the stale bytes there
template <typename CT, int DH>
__device__ __forceinline__ void key_fragments(const uint8_t* row, bool valid,
                                              uint32_t (&bf)[DH / 8]) {
  constexpr int QB = DH / 4 * (int)sizeof(CT);  // bytes of a head-dim quarter
#pragma unroll
  for (int p = 0; p < QB / 16; ++p) {
    const uint4 w = valid ? *reinterpret_cast<const uint4*>(row + 16 * p) : make_uint4(0, 0, 0, 0);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (Cache<CT>::QUANT) {
        const float4 f = int8x4_to_float4(u[i]);
        bf[2 * (4 * p + i)] = lss_sm90::pack_bf16(f.x, f.y);
        bf[2 * (4 * p + i) + 1] = lss_sm90::pack_bf16(f.z, f.w);
      } else {
        bf[4 * p + i] = u[i];
      }
    }
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

template <typename CT, int DH, int MAXR, bool WRITE, int NW_, bool PAGED>
__global__ void __launch_bounds__(Cfg<CT, DH, MAXR, NW_>::NT, Cfg<CT, DH, MAXR, NW_>::MINB)
    dense_decode_kernel(const Args a) {
  using C = Cfg<CT, DH, MAXR, NW_>;
  using Lay = typename C::Layout;
  constexpr bool QUANT = C::QUANT;
  constexpr int CH = C::CH, RB = C::RB, NW = C::NW, KPW = C::KPW;
  constexpr int NCT = C::NCT, NT = C::NT, STAGES = C::STAGES;
  constexpr int MT = (MAXR + 15) / 16;  // m16 tiles of query rows
  constexpr int KS = DH / 16;  // mma k steps
  constexpr int QD = DH / 4;  // head dims of one lane's quarter (score pass)
  constexpr int NQ = DH / 4;  // value pass: lanes per key (4 head dims each)
  constexpr int VKG = 32 / NQ;  // keys a warp takes at once in the value pass
  constexpr int EPL = DH / 32;  // elements per lane in the write pass
  const int T = a.T, Hkv = a.Hkv, S = a.S;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = a.Hq / Hkv;
  const int R = T * G;  // query rows, ordered (t, g)
  const int split = blockIdx.y;
  const int nsplit = a.nsplit;
  const bool last = split == nsplit - 1;  // takes the fresh block and the write
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) uint8_t smem[];
  const Lay lay(R, T);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);  // [MT * 16][DH + 8]
  float* kn_s = reinterpret_cast<float*>(smem + lay.kn);
  float* vn_s = reinterpret_cast<float*>(smem + lay.vn);
  float* mw_s = reinterpret_cast<float*>(smem + lay.mw);  // [NW][MAXR] warps' running max
  float* lw_s = reinterpret_cast<float*>(smem + lay.lw);  // [NW][MAXR] warps' running sum
  float* pw_s = reinterpret_cast<float*>(smem + lay.pw);  // [NW][KPW + 1][MAXR] p, alpha
  float* xw_s = reinterpret_cast<float*>(smem + lay.xw);  // [NW][R][DH] warp accumulators
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + STAGES;

  // the query rows (bf16, zero past R) and the fresh keys / values, by
  // every thread, in flight with the window's loads below
  for (int i = tid; i < MT * 16 * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    q_s[r * (DH + 8) + d] = r < R ? a.q[b * a.q_sb + t * a.q_st + (h * G + g) * a.q_sh + d]
                                  : __float2bfloat16_rn(0.f);
  }
  if (last) {
    for (int i = tid; i < T * DH; i += NT) {
      const int t = i / DH, d = i % DH;
      kn_s[i] = __bfloat162float(a.kn[b * a.kn_sb + t * a.kn_st + h * a.kn_sh + d]);
      vn_s[i] = __bfloat162float(a.vn[b * a.vn_sb + t * a.vn_st + h * a.vn_sh + d]);
    }
  }
  const int pad = max(a.pads[b], 0);
  const int off = a.offsets ? a.offsets[b] : a.offset;
  const int c_end = min(off, S);  // valid cache slots [pad, c_end)
  const int n_all = max(c_end - pad, 0);
  const int per = (n_all + nsplit - 1) / nsplit;
  const int lo = pad + split * per;
  const int hi = min(lo + per, c_end);  // this split's slots [lo, hi)
  const int n_chunks = hi > lo ? (hi - lo + CH - 1) / CH : 0;
  // dense: the (L, B, Hkv, S) index of this (layer, sample, kv head)'s slot 0
  const size_t row0 = ((size_t)(a.layer * a.B + b) * Hkv + h) * S;
  const size_t srow0 = ((size_t)(a.scale_layer * a.B + b) * Hkv + h) * S;
  CT* kslab = static_cast<CT*>(a.kc) + row0 * DH;
  CT* vslab = static_cast<CT*>(a.vc) + row0 * DH;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], QUANT ? 1 + 32 : 1);  // the copies' arrival (+ the scale stores)
      mbar_init(&empty[s], NCT);
    }
    lss_sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NW) {
    // ---- producer warp: the bulk copies of a chunk (dense: lane 0 issues
    // one for its K rows and one for its V rows; paged: lane k those of the
    // chunk's k-th page segment), then every lane stores its share of the
    // chunk's scales, loaded one chunk ahead so that no chunk waits on its
    // own scale loads. Paged, each lane holds the id of its page of this
    // chunk (pid_c) and of the next (pid_n), and loads the one after.
    const int ps = a.ps;
    auto seg_pid = [&](int i) {  // the id of this lane's page of chunk i
      const int s0 = lo + i * CH;
      const int t = s0 / ps + lane;
      return i < n_chunks && t * ps < min(s0 + CH, hi) ? page_id(a, b, t) : 0;
    };
    int pid_c = 0, pid_n = 0;
    if constexpr (PAGED) {
      pid_c = seg_pid(0);
      pid_n = seg_pid(1);
    }
    float nk[CH / 32], nv[CH / 32];
    auto load_scales = [&](int i, int pids) {  // pids: chunk i's page ids (paged)
      const int s0 = lo + i * CH;
      const int n = min(CH, hi - s0);
#pragma unroll
      for (int u = 0; u < CH / 32; ++u) {
        const int j = lane + 32 * u;
        size_t x = srow0 + s0 + j;
        if constexpr (PAGED) {
          const int t = (s0 + j) / ps;
          x = page_slot(a, __shfl_sync(FULL, pids, (t - s0 / ps) & 31), h, s0 + j - t * ps);
        }
        nk[u] = j < n ? __bfloat162float(a.ks[x]) : 0.f;
        nv[u] = j < n ? __bfloat162float(a.vs[x]) : 0.f;
      }
    };
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % STAGES;
      const int s0 = lo + i * CH;
      const int n = min(CH, hi - s0);
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      uint8_t* st = smem + s * C::STAGE;
      if constexpr (PAGED) {
        if (lane == 0) mbar_expect_tx(&full[s], 2 * n * RB);
        __syncwarp();  // the chunk's bytes are expected before any copy lands
        const int t = s0 / ps + lane;  // this lane's page: positions [j0, j1) of the chunk
        const int j0 = max(s0, t * ps), j1 = min(s0 + n, t * ps + ps);
        if (j0 < j1) {
          const size_t x = page_slot(a, pid_c, h, j0 - t * ps) * DH;
          bulk_load(st + (j0 - s0) * RB, static_cast<const CT*>(a.kc) + x, (j1 - j0) * RB,
                    &full[s]);
          bulk_load(st + C::ROWS + (j0 - s0) * RB, static_cast<const CT*>(a.vc) + x,
                    (j1 - j0) * RB, &full[s]);
        }
      } else if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * n * RB);
        bulk_load(st, kslab + (size_t)s0 * DH, n * RB, &full[s]);
        bulk_load(st + C::ROWS, vslab + (size_t)s0 * DH, n * RB, &full[s]);
      }
      if constexpr (QUANT) {
        if (i == 0) load_scales(0, pid_c);
        float ck[CH / 32], cv[CH / 32];
#pragma unroll
        for (int u = 0; u < CH / 32; ++u) {
          ck[u] = nk[u];
          cv[u] = nv[u];
        }
        if (i + 1 < n_chunks) load_scales(i + 1, pid_n);
        float* ksc = reinterpret_cast<float*>(st + 2 * C::ROWS);
#pragma unroll
        for (int u = 0; u < CH / 32; ++u) {
          ksc[lane + 32 * u] = ck[u];
          ksc[CH + lane + 32 * u] = cv[u];
        }
        mbar_arrive(&full[s]);  // release: the stores above are seen by the waiters
      }
      if constexpr (PAGED) {
        const int pid_nn = seg_pid(i + 2);
        pid_c = pid_n;
        pid_n = pid_nn;
      }
    }
  } else {
    // ---- consumers: each warp runs its own online softmax over its 8 keys
    // of every chunk, then the warps are merged in warp order
    const float scale2 = a.scale * LOG2E;
    float* pw = pw_s + warp * (KPW + 1) * MAXR;  // p of the warp's keys [row][key], then alpha
    float* aw = pw + KPW * MAXR;
    // the score pass: rows gq and gq + 8 of each m tile, keys 2 kq + {0, 1}
    // of the warp's n tile; the k axis of the products runs over the head
    // dims permuted so that lane kq holds the quarter [kq QD, kq QD + QD):
    // k step s takes dims kq QD + 4 s + {0, 1} (k = 2 kq + {0, 1}) and
    // + {2, 3} (k = 2 kq + 8 + {0, 1}), for q and k alike
    const int gq = lane / 4;
    const int kq = lane % 4;
    const int quad = lane % NQ;  // the value pass: head dims 4 quad..+3 of keys vk, vk + VKG..
    const int vk = lane / NQ;
    float m_run[MT][2], l_run[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      m_run[mt][0] = m_run[mt][1] = NEG_INF;
      l_run[mt][0] = l_run[mt][1] = 0.f;
    }
    float acc[MAXR][4];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    uint32_t qa[MT][KS][4];  // q as mma A fragments, for the whole split
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q_s + (mt * 16 + gq) * (DH + 8) + kq * QD);
      const uint32_t* q1 = q0 + 8 * (DH + 8) / 2;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        qa[mt][s][0] = q0[2 * s];
        qa[mt][s][1] = q1[2 * s];
        qa[mt][s][2] = q0[2 * s + 1];
        qa[mt][s][3] = q1[2 * s + 1];
      }
    }

    // rescale the accumulator by aw and add p (pw, [row][key]) times the
    // values of the first n keys (v(key) gives 4 head dims as floats)
    auto values = [&](int n, auto vq) {
      float4 v[KPW / VKG];
#pragma unroll
      for (int u = 0; u < KPW / VKG; ++u) {  // every load in flight at once
        const int kk = vk + VKG * u;
        v[u] = kk < n ? vq(kk) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float al = aw[r];
          float4 p[KPW / 4];
#pragma unroll
          for (int u = 0; u < KPW / 4; ++u) p[u] = *reinterpret_cast<const float4*>(pw + r * KPW + 4 * u);
          const float* pr = reinterpret_cast<const float*>(p);
          float x0 = acc[r][0] * al, x1 = acc[r][1] * al, x2 = acc[r][2] * al, x3 = acc[r][3] * al;
#pragma unroll
          for (int u = 0; u < KPW / VKG; ++u) {
            float pk = pr[VKG * u];  // key vk + VKG u, without a runtime index
            if constexpr (VKG == 2) pk = vk ? pr[2 * u + 1] : pk;
            x0 += pk * v[u].x;
            x1 += pk * v[u].y;
            x2 += pk * v[u].z;
            x3 += pk * v[u].w;
          }
          acc[r][0] = x0;
          acc[r][1] = x1;
          acc[r][2] = x2;
          acc[r][3] = x3;
        }
      }
      __syncwarp();  // pw and aw are read before the next step rewrites them
    };

    if (last && warp == NW - 1) {
      // ---- the fresh block, causal within it (key j <= query t), one key
      // at a time, the lanes splitting the head dim
      for (int j = 0; j < T; ++j) {
        const float* kj = kn_s + j * DH;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mt * 16 + gq + 8 * hr;
            float dot = 0.f;
            if (r < R) {
              const __nv_bfloat16* qr = q_s + r * (DH + 8);
#pragma unroll 8
              for (int d = kq; d < DH; d += 4) dot += __bfloat162float(qr[d]) * kj[d];
            }
            dot += __shfl_xor_sync(FULL, dot, 1);
            dot += __shfl_xor_sync(FULL, dot, 2);
            const bool ok = r < R && j <= r / G;
            const float m_new = ok ? fmaxf(m_run[mt][hr], dot * scale2) : m_run[mt][hr];
            const float alpha = exp2f(m_run[mt][hr] - m_new);
            const float p = ok ? exp2f(dot * scale2 - m_new) : 0.f;  // p = 0 by selection
            l_run[mt][hr] = l_run[mt][hr] * alpha + p;
            m_run[mt][hr] = m_new;
            if (kq == 0 && r < R) {
              pw[r * KPW] = p;
#pragma unroll
              for (int u = 1; u < KPW; ++u) pw[r * KPW + u] = 0.f;
              aw[r] = alpha;
            }
          }
        }
        __syncwarp();
        values(1, [&](int) { return *reinterpret_cast<const float4*>(vn_s + j * DH + 4 * quad); });
      }
    }

    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % STAGES;
      const int n = min(CH, hi - (lo + c * CH));
      const uint8_t* st = smem + s * C::STAGE;
      const uint8_t* krows = st;
      const uint8_t* vrows = st + C::ROWS;
      const float* ksc = reinterpret_cast<const float*>(st + 2 * C::ROWS);
      const int j0 = warp * KPW;  // the warp's first key in the chunk
      mbar_wait(&full[s], (c / STAGES) & 1);
      if (j0 < n) {  // warp-uniform
        // S (rows, 8 keys) = Q . K^T on the tensor cores: this lane's B
        // fragments are its key row's head-dim quarter
        uint32_t kb[DH / 8];
        key_fragments<CT, DH>(krows + (j0 + gq) * RB + kq * QD * (int)sizeof(CT), j0 + gq < n,
                              kb);
        float sc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sc[mt][0] = sc[mt][1] = sc[mt][2] = sc[mt][3] = 0.f;
#pragma unroll
          for (int k = 0; k < KS; ++k) mma_bf16(sc[mt], qa[mt][k], kb[2 * k], kb[2 * k + 1]);
        }
        // online softmax on the fragments: a row's two keys in this lane,
        // its 8 keys over the quad
        const int key0 = j0 + 2 * kq;
        const bool ok0 = key0 < n, ok1 = key0 + 1 < n;
        float ks0 = scale2, ks1 = scale2, vs0 = 1.f, vs1 = 1.f;
        if constexpr (QUANT) {
          ks0 = ok0 ? ksc[key0] * scale2 : 0.f;
          ks1 = ok1 ? ksc[key0 + 1] * scale2 : 0.f;
          vs0 = ok0 ? ksc[CH + key0] : 0.f;
          vs1 = ok1 ? ksc[CH + key0 + 1] : 0.f;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mt * 16 + gq + 8 * hr;
            const float s0 = sc[mt][2 * hr] * ks0, s1 = sc[mt][2 * hr + 1] * ks1;
            float mx = fmaxf(ok0 ? s0 : NEG_INF, ok1 ? s1 : NEG_INF);
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            const float m_new = fmaxf(m_run[mt][hr], mx);
            const float alpha = exp2f(m_run[mt][hr] - m_new);
            const float p0 = ok0 ? exp2f(s0 - m_new) : 0.f;  // p = 0 by selection
            const float p1 = ok1 ? exp2f(s1 - m_new) : 0.f;
            float ps = p0 + p1;
            ps += __shfl_xor_sync(FULL, ps, 1);
            ps += __shfl_xor_sync(FULL, ps, 2);
            l_run[mt][hr] = l_run[mt][hr] * alpha + ps;
            m_run[mt][hr] = m_new;
            if (r < R) {
              *reinterpret_cast<float2*>(pw + r * KPW + 2 * kq) = make_float2(p0 * vs0, p1 * vs1);
              if (kq == 0) aw[r] = alpha;
            }
          }
        }
        __syncwarp();
        values(n - j0, [&](int kk) {
          return quad_to_float<CT>(vrows + (j0 + kk) * RB, 4 * quad * (int)sizeof(CT));
        });
      }
      mbar_arrive(&empty[s]);
    }

    // ---- this warp's state (the value groups' halves added), then the
    // warps merged in warp order; the warps' accumulators take the place
    // of the stages, which every warp must be done with
    consumer_sync<NCT>();
    if constexpr (VKG == 2) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], 16);
      }
    }
    if (vk == 0) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          *reinterpret_cast<float4*>(xw_s + (warp * R + r) * DH + 4 * quad) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + gq + 8 * hr;
        if (kq == 0 && r < R) {
          mw_s[warp * MAXR + r] = m_run[mt][hr];
          lw_s[warp * MAXR + r] = l_run[mt][hr];
        }
      }
    }
    consumer_sync<NCT>();
    for (int idx = tid; idx < R * DH; idx += NCT) {
      const int r = idx / DH;
      float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < NW; ++w2) {
        const float mi = mw_s[w2 * MAXR + r];
        const float Mn = fmaxf(M, mi);
        const float w_old = exp2f(M - Mn), w_new = exp2f(mi - Mn);
        L = L * w_old + lw_s[w2 * MAXR + r] * w_new;
        A = A * w_old + xw_s[(w2 * R + r) * DH + idx % DH] * w_new;
        M = Mn;
      }
      if (nsplit == 1) {  // the only split: normalise and write
        const int d = idx % DH;
        const int t = r / G, g = r % G;
        a.out[(((size_t)b * T + t) * a.Hq + h * G + g) * DH + d] = __float2bfloat16_rn(A / L);
      } else {  // this split's row result: (max, sum, accumulator)
        float* part = a.part + (((size_t)blockIdx.x * nsplit + split) * R + r) * (DH + 2);
        part[2 + idx % DH] = A;
        if (idx % DH == 0) {
          part[0] = M;
          part[1] = L;
        }
      }
    }

    if constexpr (WRITE) {
      // ---- the fresh rows at [off, off + T), a warp per (token, k or v);
      // paged (T = 1), position off = length through the table
      if (last) {
        for (int i = warp; i < 2 * T; i += NCT / 32) {
          const int t = i / 2;
          const bool is_v = (i % 2) == 1;
          const float* src = (is_v ? vn_s : kn_s) + t * DH + lane * EPL;
          const int slot = off + t;
          bool inside = slot >= 0 && slot < S;  // the wrapper guarantees offsets + T <= S
          CT* dst = (is_v ? vslab : kslab) + (size_t)slot * DH + lane * EPL;
          size_t sx = srow0 + slot;  // the scale's index
          if constexpr (PAGED) {  // always written: the null page 0 outside the table
            const int tw = slot >= 0 ? slot / a.ps : -((a.ps - 1 - slot) / a.ps);  // floor
            sx = page_slot(a, tw >= 0 && tw < a.mp ? page_id(a, b, tw) : 0, h, slot - tw * a.ps);
            dst = static_cast<CT*>(is_v ? a.vc : a.kc) + sx * DH + lane * EPL;
            inside = true;
          }
          if constexpr (QUANT) {
            float x[EPL];
            float amax = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              x[e] = src[e];
              amax = fmaxf(amax, fabsf(x[e]));
            }
            amax = warp_max(amax);
            const float qs = fmaxf(amax / 127.0f, 1e-8f);
            if (inside) {
#pragma unroll
              for (int e = 0; e < EPL; ++e) {
                dst[e] = (int8_t)fminf(fmaxf(rintf(x[e] / qs), -127.f), 127.f);
              }
              if (lane == 0) {
                const __nv_bfloat16 s16 = __float2bfloat16_rn(qs);
                __nv_bfloat16* fresh = is_v ? a.vs_new : a.ks_new;
                if (fresh) {
                  fresh[((size_t)b * Hkv + h) * T + t] = s16;
                } else {
                  (is_v ? a.vs : a.ks)[sx] = s16;
                }
              }
            }
          } else if (inside) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) dst[e] = __float2bfloat16_rn(src[e]);
          }
        }
      }
    }
  }

}

// the splits of each (sample, kv head) merged in split order: a block per
// (sample, kv head), a thread per (row, head dim), every split's loads in
// flight at once; a split without a slot has max -1e30 and sum 0 and adds
// nothing
template <int DH>
__global__ void __launch_bounds__(MERGE_THREADS) dense_merge_kernel(const Args a) {
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
    a.out[(((size_t)b * T + t) * a.Hq + h * G + g) * DH + d] = __float2bfloat16_rn(A / L);
  }
}

template <typename CT, int DH, int MAXR, bool WRITE, bool PAGED, int NW>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<CT, DH, MAXR, NW>;
  const int R = a.T * (a.Hq / a.Hkv);
  const int smem = typename C::Layout(R, a.T).bytes;
  auto kernel = dense_decode_kernel<CT, DH, MAXR, WRITE, NW, PAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.B * a.Hkv, a.nsplit), C::NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return (int)err;
  dense_merge_kernel<DH><<<a.B * a.Hkv, MERGE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// 16 consumer warps where the grid leaves an SM to each block and the
// warps' accumulators fit (MAXR <= 16), else 8
template <typename CT, int DH, int MAXR, bool WRITE, bool PAGED>
int launch_for_grid(const Args& a, cudaStream_t s) {
  if constexpr (MAXR <= 16) {
    if (a.B * a.Hkv * a.nsplit <= device_sms()) {
      return launch<CT, DH, MAXR, WRITE, PAGED, 16>(a, s);
    }
  }
  return launch<CT, DH, MAXR, WRITE, PAGED, 8>(a, s);
}

// the instance for the cache type, layout, head dim and query rows of `a`
template <typename CT, bool WRITE, bool PAGED = false>
int dispatch(const Args& a, int Dh, cudaStream_t s) {
  if (a.nsplit < 1 || a.nsplit > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const int maxr = rows_bucket(a.T * (a.Hq / a.Hkv));
#define LSS_DENSE_LAUNCH(DH_)                                            \
  switch (maxr) {                                                        \
    case 4: return launch_for_grid<CT, DH_, 4, WRITE, PAGED>(a, s);      \
    case 8: return launch_for_grid<CT, DH_, 8, WRITE, PAGED>(a, s);      \
    case 16: return launch_for_grid<CT, DH_, 16, WRITE, PAGED>(a, s);    \
    default: return launch_for_grid<CT, DH_, 32, WRITE, PAGED>(a, s);    \
  }
  if (Dh == 128) LSS_DENSE_LAUNCH(128)
  if (Dh == 64) LSS_DENSE_LAUNCH(64)
#undef LSS_DENSE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// shared memory bytes of the larger of the two instances (8 or 16 warps,
// the grid picks one) for these rows
template <typename CT, int DH, int MAXR>
long long instance_bytes(int R, int T) {
  const long long b8 = typename Cfg<CT, DH, MAXR, 8>::Layout(R, T).bytes;
  const long long b16 = typename Cfg<CT, DH, MAXR, 16>::Layout(R, T).bytes;
  return MAXR > 16 || b8 > b16 ? b8 : b16;
}

template <typename CT, int DH>
long long rows_bytes(int R, int T) {
  switch (rows_bucket(R)) {
    case 4: return instance_bytes<CT, DH, 4>(R, T);
    case 8: return instance_bytes<CT, DH, 8>(R, T);
    case 16: return instance_bytes<CT, DH, 16>(R, T);
    default: return instance_bytes<CT, DH, 32>(R, T);
  }
}

// shared memory bytes for these sizes; they do not grow with S (kept in
// the signature: the wrappers pass it)
inline long long smem_for(int Dh, int T, int G, int /*S*/, int cache_bytes) {
  const int R = T * G;
  if (cache_bytes == 1) return Dh == 128 ? rows_bytes<int8_t, 128>(R, T) : rows_bytes<int8_t, 64>(R, T);
  return Dh == 128 ? rows_bytes<__nv_bfloat16, 128>(R, T) : rows_bytes<__nv_bfloat16, 64>(R, T);
}

}  // namespace dense_decode
