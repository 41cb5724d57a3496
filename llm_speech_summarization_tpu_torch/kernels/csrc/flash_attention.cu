// Flash-attention forward for Hopper (sm_90a): tiled online softmax, GQA,
// per-sample key window [start, end), causal or bidirectional.
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// flash_attention.py::_flash_kernel (reached through flash_attention ->
// _flash_impl), in all three of its modes: B1 (inference), B1 + LSE
// (training) and B7 (offset mode, the ring-attention interior). It serves
// the LLM prefill and training (causal, GQA 24/8, Dh=128, window [pad, T)),
// the HuBERT and Whisper self-attention (bidirectional, 16/16, Dh=64, window
// [0, n_valid)) and the ring's blocks.
//
// What bounds it on the H100: the two tile products Q.K^T and P.V over the
// valid (query, key) pairs; q/k/v are read once per q tile, so at every
// length the port runs (T of 300-3000) the tensor cores bound it, not the
// bytes. The first design (WMMA 16x16x16 fragments, every score and P.V
// tile through shared memory in float32, synchronous K/V loads) ran at
// 5-10% of that bound. This one keeps the products and the softmax in
// registers and overlaps the loads:
//   * one block per (64-row q tile, q head, sample); the kv head is
//     h / (Hq / Hkv). One consumer warpgroup owns the 64 rows; one producer
//     warp issues TMA loads: Q once, then K and V tiles of BK keys (64 at
//     Dh=128, 128 at Dh=64) into a ring of 2 shared-memory stages, each with
//     a "full" mbarrier (TMA bytes landed) and an "empty" one (every
//     consumer thread is done with it). Two blocks fit an SM, so one
//     block's softmax overlaps the other's products; 128-row tiles (two
//     consumer warpgroups), 3 stages and issuing the next tile's Q.K^T
//     before the softmax were each slower at the port's shapes (PERF.md
//     §6);
//   * S = Q.K^T is one wgmma.m64nBKk16 chain, Q and K from
//     shared memory (both K-major), S in registers. The online softmax runs
//     on the accumulator fragment: a thread holds two rows, each spread over
//     a quad of threads, so a row max takes two shuffles and the row sum is
//     kept per thread and reduced once at the end;
//   * p is rounded to bf16 in registers (as the TPU kernel casts p to v's
//     dtype) and fed to O += P.V as wgmma's A operand from registers, with
//     V from shared memory as an MN-major B operand. O stays in registers
//     for the whole loop;
//   * the window and causal masks are applied only on the tiles at a window
//     edge or on the diagonal; interior tiles skip them;
//   * the output and the lse are written from registers; q tiles are
//     scheduled last-first, so the causal tiles with the most keys start
//     first.
// Masked scores are -1e30 (never -inf); a row that sees no key writes
// zeros and lse = -1e30. The softmax runs in base 2 (scores pre-scaled by
// log2(e)); the lse is converted back to natural log.
//
// Offset mode (B7): the local queries and the visiting key block live at
// global offsets q_off and k_off, and the causal rule becomes k + k_off <=
// q + q_off. With d = q_off - k_off the frontier moves by d: a q tile stops
// at key q0 + BQ + d, and a q tile that sees no key of the block loops over
// no k tile at all, writing finite zeros and lse = -1e30 (never -inf: the
// ring's log-sum-exp merge of two -inf would give NaN weights). Offsets
// (0, 0) are plain B1.
//
// Training: with a non-null ``lse`` the same launch also writes the float32
// per-row log-sum-exp m + log(l) as (B, Hq, T), the TPU kernel's return_lse
// output, which the backward uses to recompute p = exp(s - lse). The kernel
// has no atomics and a fixed summation order, so a recompute (activation
// checkpointing) gives bitwise the same out and lse.

#include "flash_sm90.cuh"

using namespace lss_sm90;

namespace {

// one consumer warpgroup (64 q rows) and one producer warp per block, so
// two blocks share an SM; BK keys per k tile, STAGES K/V stages
template <int DH_>
struct FwdCfg {
  static constexpr int DH = DH_;
  static constexpr int BQ = 64;
  static constexpr int BK = DH == 128 ? 64 : 128;
  static constexpr int STAGES = 2;
  static constexpr int NSUB = DH / 64;  // 64-column boxes per row
  static constexpr int THREADS = 128 + 32;
  static constexpr uint32_t Q_BYTES = BQ * DH * 2;
  static constexpr uint32_t KV_BYTES = BK * DH * 2;  // one K or V tile
  __host__ __device__ static constexpr uint32_t k_off(int s) { return Q_BYTES + s * 2 * KV_BYTES; }
  __host__ __device__ static constexpr uint32_t v_off(int s) { return k_off(s) + KV_BYTES; }
  static constexpr uint32_t bar_off = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr uint32_t bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

struct FwdArgs {
  __nv_bfloat16* out;
  float* lse;
  const int *starts, *ends;
  long long o_sb, o_st, o_sh;
  int T, Hq, Hkv, causal, diag;  // diag = q_off - k_off
  float scale_log2;  // Dh^-0.5 * log2(e)
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  constexpr int DH = C::DH, BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last q tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int T = a.T;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  // keys in [start, k_stop); causal: no key past the tile's last query,
  // shifted by diag in offset mode
  int k_stop = end;
  if (a.causal) k_stop = min(k_stop, q0 + BQ + a.diag);
  const int kt_begin = start / BK;
  const int kt_end = k_stop > 0 ? (k_stop + BK - 1) / BK : 0;
  const int n_tiles = max(kt_end - kt_begin, 0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: one thread issues every TMA load
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NSUB; ++c) {
        tma_load(smem + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        const int k0 = (kt_begin + i) * BK;
        for (int c = 0; c < C::NSUB; ++c) {
          tma_load(smem + C::k_off(s) + c * BK * 128, &tk, &full[s], c * 64, hk, k0, b);
          tma_load(smem + C::v_off(s) + c * BK * 128, &tv, &full[s], c * 64, hk, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: this thread holds q rows qp0 and qp0 + 8 of the tile,
  // columns 8 j + 2 (lane % 4) + {0, 1} of every n8 block of each
  // accumulator
  const int qp0 = q0 + warp * 16 + lane / 4;
  const int qp1 = qp0 + 8;
  const int col = 2 * (lane % 4);

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (kt_begin + i) * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t k_s = sbase + C::k_off(s);
    const uint32_t v_s = sbase + C::v_off(s);

    // S (64, BK) = Q . K^T
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss<BK>(sc, desc_k(sbase + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                   desc_k(k_s + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale into base 2; mask only at a window edge or the diagonal
    const bool interior =
        k0 >= start && k0 + BK <= end && (!a.causal || k0 + BK - 1 <= q0 + a.diag);
    if (interior) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] *= a.scale_log2;
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + col + e;
          const bool in = kp >= start && kp < end;
          const bool ok0 = in && (!a.causal || kp <= qp0 + a.diag);
          const bool ok1 = in && (!a.causal || kp <= qp1 + a.diag);
          sc[4 * j + e] = ok0 ? sc[4 * j + e] * a.scale_log2 : NEG_INF;
          sc[4 * j + 2 + e] = ok1 ? sc[4 * j + 2 + e] * a.scale_log2 : NEG_INF;
        }
      }
    }

    // online softmax: row max over the quad, rescale, p = 2^(s - m)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = exp2f(sc[4 * j] - mn0);
      sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
      sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
      sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
      ls0 += sc[4 * j] + sc[4 * j + 1];
      ls1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P.V with P (bf16) as the A operand from registers
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_tb<DH>(o, pa[kk], desc_mn(v_s + kk * 16 * 128, BK * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

  // the row sums were kept per thread: reduce over the quad
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row that saw no key (m still -1e30) writes zeros and lse = -1e30
  const float inv0 = m0 == NEG_INF ? 0.f : 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = m1 == NEG_INF ? 0.f : 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = a.out + b * a.o_sb + h * a.o_sh + col;
  if (qp0 < T) {
    __nv_bfloat16* dst = ob + (long long)qp0 * a.o_st;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
  }
  if (qp1 < T) {
    __nv_bfloat16* dst = ob + (long long)qp1 * a.o_st;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if (a.lse != nullptr && lane % 4 == 0) {
    float* lrow = a.lse + ((long long)b * a.Hq + h) * T;
    if (qp0 < T) lrow[qp0] = m0 == NEG_INF ? NEG_INF : m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (qp1 < T) lrow[qp1] = m1 == NEG_INF ? NEG_INF : m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
}

template <class C>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a, int B,
           const long long* s, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, C::DH, a.Hq, a.T, B, s[0], s[1], s[2], C::BQ);
  if (!err) err = make_map(&tk, k, C::DH, a.Hkv, a.T, B, s[3], s[4], s[5], C::BK);
  if (!err) err = make_map(&tv, v, C::DH, a.Hkv, a.T, B, s[6], s[7], s[8], C::BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + C::BQ - 1) / C::BQ, a.Hq, B);
  flash_fwd_kernel<C><<<grid, C::THREADS, C::bytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (b, t, h) for q, k, v, out, in that order.
// lse: null, or a contiguous (B, Hq, T) float32 buffer for the log-sum-exp.
// q_off, k_off: the global offsets of the queries and keys (0, 0 but in the
// ring interior). Returns the cudaError_t of the launch (0 on success), or
// a nonzero code when a tensor map cannot be encoded.
extern "C" int lss_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const void* starts, const void* ends, int B, int T,
                                       int Hq, int Hkv, int Dh, const long long* strides,
                                       int causal, int q_off, int k_off, float scale,
                                       void* stream) {
  FwdArgs a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
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
  if (Dh == 128) return launch<FwdCfg<128>>(q, k, v, a, B, strides, s);
  if (Dh == 64) return launch<FwdCfg<64>>(q, k, v, a, B, strides, s);
  return (int)cudaErrorInvalidValue;
}
