// Flash-attention backward in float32 for Hopper (sm_90a): dq, and dk/dv
// summed over the GQA group, from the forward's saved float32 log-sum-exp,
// per-sample key window [start, end), causal or bidirectional, with the
// ring's offset mode. Every score, p, dp, ds and sum is float32 (products
// at float32 accuracy, 3xTF32), and so are the outputs.
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
// ds.Q in dk/dv). The tensor cores run float32 only as TF32 (10 mantissa
// bits), which is not a float32 kernel; the float32-accurate route on them
// is 3xTF32, which PERF.md takes as the bound (495 / 3 = 165 TFLOP/s), and
// which this design takes, as the forward does (FFMA on the CUDA cores
// peaks at 67 TFLOP/s, 40% of it):
//   * every product is mma.sync m16n8k8 with TF32 operands and float32
//     sums in registers; each operand x is split into hi = tf32(x) and lo =
//     x - hi as its fragment is loaded, and each k step of 8 adds lo.hi,
//     hi.lo, then hi.hi (lss_f32::mma_3xtf32). tests/torch_f32_emulation.py
//     (emulate_bwd_3xtf32) models this arithmetic, with the tensor cores'
//     sums cut toward zero at every step, within a sixth of chip_smoke's
//     float32 bounds, and single-pass TF32 over them;
//   * each warp owns 16 rows of the block's own tile; rows of every shared
//     tile are padded to Dh + 4 floats, so every fragment load reads 32
//     distinct banks; the streamed tiles go to shared memory by cp.async
//     (16 B a thread-copy, rows at or past T zero-filled) through two
//     stages, tile i + 1 in flight while tile i is computed. The tile sizes
//     (DqCfg, DkvCfg below) are the fastest of those timed on the card;
//   * dq: one block per (q tile, q head, sample), 4 warps and 64-key tiles
//     at Dh = 64 (two blocks an SM), 8 warps and 32-key tiles at Dh = 128
//     (one); warp w owns q rows 16 w .. 16 w + 15. Q and dO stay in shared
//     memory, lse and delta of the thread's two rows in registers; K/V
//     tiles stream. Per tile: S = Q.K^T and dP = dO.V^T into register
//     accumulators, p selected inside the mask and ds = p (dp - delta) in
//     those registers, then dQ += dS.K with dS as the A fragment straight
//     from the score registers (a thread's accumulator holds keys 2t and
//     2t + 1 of each 8-key tile for rows g and g + 8: the A fragment of a k
//     step whose index t stands for key 2t and t + 4 for key 2t + 1; K's B
//     fragment is read at those keys, so K needs no transpose); dq =
//     Dh^-0.5 dQ;
//   * dk/dv: one block per (64-key tile, kv head, sample), 4 warps, q tiles
//     of 64 rows at Dh = 64 and 16 at Dh = 128 (two blocks an SM at both);
//     warp w owns keys 16 w .. 16 w + 15. K and V stay in shared memory;
//     for each q head of the group in order and each q tile from the causal
//     frontier on, Q, dO, lse and delta stream through the same two stages
//     (the next head's first tile follows the last head's last). Per tile:
//     S^T = K.Q^T and dP^T = V.dO^T, p and ds in those registers, then dV
//     += P^T.dO and dK += dS^T.Q with P^T and dS^T as A fragments from the
//     registers, as in dq; the group is summed in the block in a fixed
//     order (JAX sums per-head float32 dk/dv in XLA: the same sum in another
//     order); dk = Dh^-0.5 dK;
//   * the causal frontier is the TPU kernels' (dq: no k tile past the q
//     tile's last query, _bwd_dq_kernel's num_k_blocks; dk/dv: no q tile
//     before the key tile's first key, _bwd_dkv_kernel's first_q_block),
//     moved by q_off - k_off in offset mode, as the bf16 B7 does: the TPU
//     kernels loop over every block in offset mode and let the mask decide,
//     and the tiles past the moved frontier are wholly masked (p = ds = 0,
//     and a k step of zero products leaves a sum's bits as they are), so
//     skipping them gives the same bits; so does a warp that skips a tile
//     wholly past its own rows' frontier. A key tile outside the window
//     writes zeros without a loop. Under a causal mask the blocks start in
//     order of decreasing work (the tile the slowest index of the launch
//     order), which shortens the last wave; bidirectional launches keep
//     the plain order, where the samples' windows set the work;
//   * Query rows outside the window are not masked (the TPU kernels mask
//     keys only; their dO is 0 where callers mask the output), rows past T
//     are; keys past T are zero-filled and masked. Rows of K and V past T
//     are zeros, so a masked key never carries NaN or Inf into a product.
//   * no atomics and a fixed order of every sum: repeats are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_f32.cuh"

namespace {

using lss_f32::LOG2E;
using lss_f32::copy_rows;
using lss_f32::mma_3xtf32;
using lss_f32::split_tf32;

// one kernel's tiles: Dh, warps a block (NW), rows of a streamed tile (BS)
template <int DH_, int NW_, int BS_, bool DKV_>
struct BwdCfg {
  static constexpr int DH = DH_;
  static constexpr int NW = NW_;
  static constexpr int THREADS = 32 * NW;
  static constexpr int BT = 16 * NW;  // the block's own rows: q rows (dq), keys (dk/dv)
  static constexpr int BS = BS_;      // rows of a streamed tile: keys (dq), q rows (dk/dv)
  static constexpr int RS = DH + 4;   // padded row stride of every shared tile, in floats
  static constexpr int NS = BS / 8;   // 8-wide n tiles of S (dq) or S^T (dk/dv)
  static constexpr int ND = DH / 8;   // 8-column n tiles of dQ, dK, dV
  static constexpr int OWN = 2 * BT * RS;  // Q and dO (dq), K and V (dk/dv)
  // one stage: K and V (dq); Q, dO, then the tile's lse and delta (dk/dv)
  static constexpr int STAGE = 2 * BS * RS + (DKV_ ? 2 * BS : 0);
  static constexpr int bytes = (OWN + 2 * STAGE) * 4;
  static constexpr int MIN_BLOCKS = bytes <= 113 * 1024 ? 2 : 1;  // blocks an SM
};
// dq: at Dh = 128, 8 warps and 32-key tiles, one block an SM (202,752 B);
// dk/dv: 4 warps and 16-row tiles, two blocks an SM (101,632 B); at Dh = 64
// both 4 warps and 64-row tiles, two blocks an SM (104,448 and 105,472 B):
// the fastest of the layouts timed at the training and ring shapes (PERF.md)
template <int DH>
using DqCfg = BwdCfg<DH, DH == 64 ? 4 : 8, DH == 64 ? 64 : 32, false>;
template <int DH>
using DkvCfg = BwdCfg<DH, 4, DH == 64 ? 64 : 16, true>;

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  const int *starts, *ends;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh;
  long long dq_sb, dq_st, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
  int T, Hq, Hkv, causal, diag;  // diag = q_off - k_off
  float scale, scale_log2;       // Dh^-0.5, Dh^-0.5 * log2(e)
};

// acc[n] += A . B over the n tiles of one k step of 8, 3xTF32: A (16 x 8)
// is (rows g, g + 8) x (k 2t, 2t + 1) of the score registers ``c`` (a
// thread's accumulator of one 8-wide n tile: the k index t stands for 2t
// and t + 4 for 2t + 1), B is row 8 kk + 2t (and + 1) of ``src`` at the
// columns 8 n + g
template <class C>
__device__ __forceinline__ void mma_from_scores(float (&acc)[C::ND][4], const float (&c)[4],
                                                const float* src) {
  uint32_t ahi[4], alo[4];
  split_tf32(c[0], ahi[0], alo[0]);
  split_tf32(c[2], ahi[1], alo[1]);
  split_tf32(c[1], ahi[2], alo[2]);
  split_tf32(c[3], ahi[3], alo[3]);
#pragma unroll
  for (int nd = 0; nd < C::ND; ++nd) {
    uint32_t bhi[2], blo[2];
    split_tf32(src[8 * nd], bhi[0], blo[0]);
    split_tf32(src[C::RS + 8 * nd], bhi[1], blo[1]);
    mma_3xtf32(acc[nd], ahi, alo, bhi, blo);
  }
}

// x = A1 . B1^T and y = A2 . B2^T over Dh, 3xTF32, from zero: A1, A2 are
// the warp's 16 rows (a1, a2 at its row g, column 0) and B1, B2 the
// streamed tile's BS rows (b1, b2 at row 0, column 0), all at row stride RS
template <class C>
__device__ __forceinline__ void scores(float (&x)[C::NS][4], float (&y)[C::NS][4],
                                       const float* a1, const float* a2, const float* b1,
                                       const float* b2) {
  constexpr int RS = C::RS;
#pragma unroll
  for (int nt = 0; nt < C::NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = y[nt][e] = 0.f;
  }
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll 2
  for (int d0 = 0; d0 < C::DH; d0 += 8) {
    uint32_t xhi[4], xlo[4], yhi[4], ylo[4];
    const float* p1 = a1 + d0 + t;
    const float* p2 = a2 + d0 + t;
    split_tf32(p1[0], xhi[0], xlo[0]);
    split_tf32(p1[8 * RS], xhi[1], xlo[1]);
    split_tf32(p1[4], xhi[2], xlo[2]);
    split_tf32(p1[8 * RS + 4], xhi[3], xlo[3]);
    split_tf32(p2[0], yhi[0], ylo[0]);
    split_tf32(p2[8 * RS], yhi[1], ylo[1]);
    split_tf32(p2[4], yhi[2], ylo[2]);
    split_tf32(p2[8 * RS + 4], yhi[3], ylo[3]);
#pragma unroll
    for (int nt = 0; nt < C::NS; ++nt) {
      uint32_t bhi[2], blo[2];
      const float* r1 = b1 + (8 * nt + g) * RS + d0 + t;
      split_tf32(r1[0], bhi[0], blo[0]);
      split_tf32(r1[4], bhi[1], blo[1]);
      mma_3xtf32(x[nt], xhi, xlo, bhi, blo);
      const float* r2 = b2 + (8 * nt + g) * RS + d0 + t;
      split_tf32(r2[0], bhi[0], blo[0]);
      split_tf32(r2[4], bhi[1], blo[1]);
      mma_3xtf32(y[nt], yhi, ylo, bhi, blo);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) bwd_dq_f32_kernel(const BwdArgs a) {
  constexpr int BT = C::BT, BS = C::BS, RS = C::RS, NS = C::NS, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + BT * RS;
  auto stage = [&](int s) { return smem + C::OWN + s * C::STAGE; };  // K, then V

  // (q tile, q head, sample); under a causal mask the blocks start in order
  // of decreasing work: the q tile is the slowest index, the last (most
  // keys) first
  int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  if (a.causal) {
    const int L = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const int heads = gridDim.y * gridDim.z;
    q0 = (gridDim.x - 1 - L / heads) * BT;
    h = L % heads % gridDim.y;
    b = L % heads / gridDim.y;
  }
  const int hk = h / (a.Hq / a.Hkv);
  const int T = a.T;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  const int diag = a.diag;
  int k_stop = end;  // keys in [start, k_stop); causal: none past the tile's frontier
  if (a.causal) k_stop = min(k_stop, q0 + BT + diag);
  const int kt_begin = start / BS;
  const int kt_end = k_stop > 0 ? (k_stop + BS - 1) / BS : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' group and thread in group
  const int ra = 16 * warp + g;          // this thread's rows ra and ra + 8 of the tile

  // lse (times log2(e)) and delta of rows ra, ra + 8; rows past T: 0 (masked)
  float l2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = q0 + ra + 8 * rr;
    const long long i = ((long long)b * a.Hq + h) * T + qp;
    l2[rr] = qp < T ? a.lse[i] * LOG2E : 0.f;
    dl[rr] = qp < T ? a.delta[i] : 0.f;
  }
  float acc[ND][4];  // dQ: rows ra (0, 1) and ra + 8 (2, 3), columns 8 nd + 2t, + 1
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const float* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + b * a.v_sb + hk * a.v_sh;
  if (kt_end > kt_begin) {
    copy_rows<C, BT>(qs, a.q + b * a.q_sb + h * a.q_sh, a.q_st, q0, T);
    copy_rows<C, BT>(dos, a.dout + b * a.o_sb + h * a.o_sh, a.o_st, q0, T);
    copy_rows<C, BS>(stage(0), kb, a.k_st, kt_begin * BS, T);
    copy_rows<C, BS>(stage(0) + BS * RS, vb, a.v_st, kt_begin * BS, T);
  }
  lss_f32::cp_async_commit();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int i = kt - kt_begin;
    if (kt + 1 < kt_end) {  // the next tile into the other stage, freed at the end of i - 1
      float* nk = stage((i + 1) & 1);
      copy_rows<C, BS>(nk, kb, a.k_st, (kt + 1) * BS, T);
      copy_rows<C, BS>(nk + BS * RS, vb, a.v_st, (kt + 1) * BS, T);
    }
    lss_f32::cp_async_commit();
    lss_f32::cp_async_wait<1>();  // tile i (and Q, dO) landed for this thread
    __syncthreads();              // ... and for every thread
    const float* ks = stage(i & 1);
    const float* vs = ks + BS * RS;
    const int k0 = kt * BS;

    // a tile wholly past this warp's causal frontier adds only zeros: skipped
    if (!a.causal || k0 <= q0 + 16 * warp + 15 + diag) {
      // S and dP (rows ra, ra + 8; keys 8 nt + 2t, + 1)
      float s[NS][4], dp[NS][4];
      scores<C>(s, dp, qs + ra * RS, dos + ra * RS, ks, vs);

      // p selected inside the mask, ds = p (dp - delta) into s; a tile inside
      // the window, below every row's causal frontier and before T takes no mask
      const bool whole = k0 >= start && k0 + BS <= end && q0 + BT <= T &&
                         (!a.causal || k0 + BS - 1 <= q0 + diag);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int qp = q0 + ra + 8 * rr;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * nt + 2 * t + e;
            const bool ok = whole || (kp >= start && kp < end && qp < T &&
                                      (!a.causal || kp <= qp + diag));
            const float p = ok ? exp2f(fmaf(s[nt][2 * rr + e], a.scale_log2, -l2[rr])) : 0.f;
            s[nt][2 * rr + e] = p * (dp[nt][2 * rr + e] - dl[rr]);
          }
        }
      }

      // dQ += dS . K, a k step of 8 keys at a time (K at those keys)
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        mma_from_scores<C>(acc, s[kk], ks + (8 * kk + 2 * t) * RS + g);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  lss_f32::cp_async_wait<0>();

  // every row of the tile is written: zeros where it saw no key
  float* out = a.dq + b * a.dq_sb + h * a.dq_sh + 2 * t;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = q0 + ra + 8 * rr;
    if (qp >= T) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<float2*>(out + (long long)qp * a.dq_st + 8 * nd) =
          make_float2(acc[nd][2 * rr] * a.scale, acc[nd][2 * rr + 1] * a.scale);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) bwd_dkv_f32_kernel(const BwdArgs a) {
  constexpr int BT = C::BT, BS = C::BS, RS = C::RS, NS = C::NS, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + BT * RS;
  // Q, dO, lse, delta
  auto stage = [&](int s) { return smem + C::OWN + s * C::STAGE; };

  // (key tile, kv head, sample); under a causal mask the blocks start in
  // order of decreasing work: the key tile is the slowest index, the first
  // (most rows) first
  int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  if (a.causal) {
    const int L = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const int heads = gridDim.y * gridDim.z;
    k0 = L / heads * BT;
    hk = L % heads % gridDim.y;
    b = L % heads / gridDim.y;
  }
  const int G = a.Hq / a.Hkv;
  const int T = a.T;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  const int diag = a.diag;
  // the first q tile whose rows can see key k0 (the causal frontier, moved
  // by diag in offset mode); none where the key tile is outside the window
  const bool keys_in = k0 < end && k0 + BT > start;
  const int qt_begin = a.causal ? max(k0 - diag, 0) / BS : 0;
  const int qt_end = keys_in ? (T + BS - 1) / BS : 0;
  const int nqt = max(qt_end - qt_begin, 0);
  const int items = G * nqt;  // (head of the group, q tile), heads outer

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ka = 16 * warp + g;  // this thread's keys ka and ka + 8 of the tile

  float dk[ND][4], dv[ND][4];  // keys ka (0, 1) and ka + 8 (2, 3), columns 8 nd + 2t, + 1
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  }

  auto issue = [&](int item, float* st) {  // item's Q, dO, lse and delta into stage st
    const int h = hk * G + item / nqt;
    const int q0 = (qt_begin + item % nqt) * BS;
    copy_rows<C, BS>(st, a.q + b * a.q_sb + h * a.q_sh, a.q_st, q0, T);
    copy_rows<C, BS>(st + BS * RS, a.dout + b * a.o_sb + h * a.o_sh, a.o_st, q0, T);
    const long long row = ((long long)b * a.Hq + h) * T;
    for (int r = threadIdx.x; r < BS; r += C::THREADS) {
      const bool in = q0 + r < T;
      lss_f32::cp_async4(st + 2 * BS * RS + r, a.lse + (in ? row + q0 + r : 0), in);
      lss_f32::cp_async4(st + 2 * BS * RS + BS + r, a.delta + (in ? row + q0 + r : 0), in);
    }
  };
  if (items > 0) {
    copy_rows<C, BT>(ks, a.k + b * a.k_sb + hk * a.k_sh, a.k_st, k0, T);
    copy_rows<C, BT>(vs, a.v + b * a.v_sb + hk * a.v_sh, a.v_st, k0, T);
    issue(0, stage(0));
  }
  lss_f32::cp_async_commit();

  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) issue(i + 1, stage((i + 1) & 1));  // freed at the end of i - 1
    lss_f32::cp_async_commit();
    lss_f32::cp_async_wait<1>();  // item i (and K, V) landed for this thread
    __syncthreads();              // ... and for every thread
    const float* qs = stage(i & 1);
    const float* dos = qs + BS * RS;
    const float* lse = dos + BS * RS;
    const float* dl = lse + BS;
    const int q0 = (qt_begin + i % nqt) * BS;

    // a tile wholly before this warp's causal frontier adds only zeros: skipped
    if (!a.causal || k0 + 16 * warp <= q0 + BS - 1 + diag) {
      // S^T and dP^T (keys ka, ka + 8; q rows 8 nt + 2t, + 1)
      float s[NS][4], dp[NS][4];
      scores<C>(s, dp, ks + ka * RS, vs + ka * RS, qs, dos);

      // p selected inside the mask into s, ds = p (dp - delta) into dp; a
      // tile inside the window, below every row's causal frontier and before T
      // takes no mask
      const bool whole = k0 >= start && k0 + BT <= end && q0 + BS <= T &&
                         (!a.causal || k0 + BT - 1 <= q0 + diag);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * nt + 2 * t + e, qp = q0 + r;
          const float l2 = lse[r] * LOG2E;
          const float dlt = dl[r];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int kp = k0 + ka + 8 * rr;
            const bool ok = whole || (kp >= start && kp < end && qp < T &&
                                      (!a.causal || kp <= qp + diag));
            const float p = ok ? exp2f(fmaf(s[nt][2 * rr + e], a.scale_log2, -l2)) : 0.f;
            s[nt][2 * rr + e] = p;
            dp[nt][2 * rr + e] = p * (dp[nt][2 * rr + e] - dlt);
          }
        }
      }

      // dV += P^T . dO and dK += dS^T . Q, a k step of 8 q rows at a time
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const int r = (8 * kk + 2 * t) * RS + g;
        mma_from_scores<C>(dv, s[kk], dos + r);
        mma_from_scores<C>(dk, dp[kk], qs + r);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  lss_f32::cp_async_wait<0>();

  // every key of the tile is written: zeros where no row saw it
  float* dkb = a.dk + b * a.dk_sb + hk * a.dk_sh + 2 * t;
  float* dvb = a.dv + b * a.dv_sb + hk * a.dv_sh + 2 * t;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kp = k0 + ka + 8 * rr;
    if (kp >= T) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<float2*>(dkb + (long long)kp * a.dk_st + 8 * nd) =
          make_float2(dk[nd][2 * rr] * a.scale, dk[nd][2 * rr + 1] * a.scale);
      *reinterpret_cast<float2*>(dvb + (long long)kp * a.dv_st + 8 * nd) =
          make_float2(dv[nd][2 * rr], dv[nd][2 * rr + 1]);
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

template <bool DKV, int DH>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  using C = std::conditional_t<DKV, DkvCfg<DH>, DqCfg<DH>>;
  void (*kernel)(const BwdArgs) = nullptr;
  if constexpr (DKV) {
    kernel = bwd_dkv_f32_kernel<C>;
  } else {
    kernel = bwd_dq_f32_kernel<C>;
  }
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + C::BT - 1) / C::BT, DKV ? a.Hkv : a.Hq, B);
  kernel<<<grid, C::THREADS, C::bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch(const BwdArgs& a, int B, int Dh, cudaStream_t s) {
  if (Dh == 128) return launch<DKV, 128>(a, B, s);
  if (Dh == 64) return launch<DKV, 64>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The C entries take the bf16 backward's arguments (flash_attention_bwd.cu,
// flash_attention_bwd_dkv.cu) over float32 tensors. strides: 21 element
// strides (b, t, h) for q, k, v, dout, dq, dk, dv, in that order (the unused
// outputs' are 0), multiples of 4 with 16-byte aligned bases (rows are
// copied 16 bytes at a time). lse, delta: contiguous (B, Hq, T) float32. q_off, k_off: the
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
