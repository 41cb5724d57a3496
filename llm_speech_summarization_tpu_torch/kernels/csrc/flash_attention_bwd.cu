// Flash-attention backward for Hopper (sm_90a): dq, from the forward's
// saved per-row log-sum-exp. dk/dv is flash_attention_bwd_dkv.cu's.
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// flash_attention.py::_bwd_dq_kernel (launched by _flash_bwd_impl, the
// backward of the flash_attention custom VJP), as B6 dq (training: the
// student's LLM attention, causal, GQA 24/8, Dh=128, window [pad, T);
// HuBERT's, bidirectional, 16/16, Dh=64, window [0, n_valid)) and B7 dq
// (offset mode, the ring interior).
//
// The function is FlashAttention-2's: with s = scale * q.k^T masked to the
// key window [start, end) (and causal: key <= query),
//   p = exp(s - lse),  dp = dO.v^T,  ds = p * (dp - delta),  dq = scale * ds.k,
// where delta = rowsum(dO * O) comes in precomputed (an elementwise pass the
// TPU code also leaves outside its kernels). ds is rounded to bf16 before
// its product, as the TPU kernel casts it to the operand dtype. A masked
// score gives p = 0 by selection, never by exp(-huge): a row with no valid
// key has lse = -1e30, where exp(s - lse) would overflow.
//
// What bounds it on the H100: three tile products per (q tile, k tile)
// pair over the valid causal region (the scores and dp are recomputed, not
// stored), so at training lengths the tensor cores bound it, not the bytes.
// The first design (WMMA 16x16x16 fragments, S and dP through shared memory
// in float32, dS back through shared memory in bf16, K and V loaded
// synchronously between two barriers) ran at 6-7% of that bound, the
// slowest flash kernel left. This one is the forward's shape with a third
// product:
//   * one block per (64-row q tile, q head, sample); the kv head is
//     h / (Hq / Hkv). One consumer warpgroup owns the 64 rows and keeps
//     their (64, Dh) float32 dq accumulator in registers for the whole
//     loop; one producer warp loads Q and dO once by TMA, then streams K
//     and V tiles of 64 keys from the window start to the causal frontier
//     into a ring of 2 shared-memory stages, each with a "full" mbarrier
//     (TMA bytes landed) and an "empty" one (every consumer thread is done
//     with it). The block takes 96 KB at Dh=128 and 48 KB at Dh=64, and
//     two blocks share an SM (bound by the registers: three at Dh=64 spill
//     at 128 registers a thread), so one block's softmax gradient overlaps
//     another's products;
//   * per k tile, S = Q.K^T and dP = dO.V^T are two wgmma chains from
//     shared memory (K-major operands) with the results in registers, issued
//     back to back: p is made while dP is still in flight;
//   * p = 2^(s scale log2 e - lse log2 e) and ds = p (dp - delta) are made
//     in registers on the accumulator fragment (a thread holds two rows,
//     each spread over a quad), rounded to bf16, and fed to dq += dS.K as
//     wgmma's A operand from registers: per 16 keys the m64nNk16
//     accumulator holds exactly the A fragment's pairs. K is the MN-major B
//     operand, since the contraction runs over keys, as V in the forward's
//     P.V;
//   * the masks are applied only on edge tiles (a window edge, the
//     diagonal or the frontier, past T); interior tiles skip them.
// 128-row q tiles (two consumer warpgroups sharing each K/V stage) and 3
// stages were slower at the port's shapes (PERF.md §6); one block per (q
// tile, KV head) that walks the GQA group would need three consumer
// warpgroups of ~165 registers each at Dh=128, more than an SM has. No
// block writes another's rows: no atomics, and a fixed summation order, so
// two calls give bit-identical results.
// Offset mode (B7): with the queries at global offset q_off and the keys at
// k_off, the causal rule becomes key + k_off <= query + q_off. With d =
// q_off - k_off, a q tile stops at key q0 + BQ + d, and a tile past the
// frontier loops over no k tile and writes zeros. lse and delta are the
// global ones of the whole ring, so p is the global softmax restricted to
// the visiting block. Offsets (0, 0) are plain B6.

#include "flash_sm90.cuh"

using namespace lss_sm90;

namespace {

// one consumer warpgroup of 64 q rows and one producer warp; BK keys per k
// tile, 2 K/V stages, two blocks an SM for the register budget (128-row
// tiles and 3 stages measured slower, three blocks an SM spilled)
template <int DH_>
struct DqCfg {
  static constexpr int DH = DH_, NWG = 1, STAGES = 2, MINB = 2;
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = 64;
  static constexpr int NSUB = DH / 64;  // 64-column boxes per row
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr uint32_t Q_BYTES = BQ * DH * 2;  // the Q or the dO tile
  static constexpr uint32_t KV_BYTES = BK * DH * 2;  // one K or V tile
  __host__ __device__ static constexpr uint32_t k_off(int s) { return 2 * Q_BYTES + s * 2 * KV_BYTES; }
  __host__ __device__ static constexpr uint32_t v_off(int s) { return k_off(s) + KV_BYTES; }
  static constexpr uint32_t bar_off = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr uint32_t bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

struct DqArgs {
  const float *lse, *delta;  // contiguous (B, Hq, T)
  __nv_bfloat16* dq;
  const int *starts, *ends;
  long long dq_sb, dq_st, dq_sh;
  int T, Hq, Hkv, causal, diag;  // diag = q_off - k_off
  float scale, scale_log2;
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const DqArgs a) {
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
      mbar_init(&empty[s], C::NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::NWG * 4) {
    // ---- producer: one thread issues every TMA load
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < C::NSUB; ++c) {
        tma_load(smem + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
        tma_load(smem + C::Q_BYTES + c * BQ * 128, &tdo, q_full, c * 64, h, q0, b);
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

  // ---- consumers: warpgroup w owns q rows [q0 + 64 w, q0 + 64 w + 64);
  // this thread holds rows qp0 and qp0 + 8, columns 8 j + 2 (lane % 4) +
  // {0, 1} of every n8 block of each accumulator
  const int w = warp / 4;
  const int q0w = q0 + w * 64;
  const int qp0 = q0w + (warp % 4) * 16 + lane / 4;
  const int qp1 = qp0 + 8;
  const int col = 2 * (lane % 4);
  const uint32_t q_s = sbase + w * 64 * 128;
  const uint32_t do_s = q_s + C::Q_BYTES;
  const long long lrow = ((long long)b * a.Hq + h) * T;
  const float lse0 = qp0 < T ? a.lse[lrow + qp0] * LOG2E : 0.f;
  const float lse1 = qp1 < T ? a.lse[lrow + qp1] * LOG2E : 0.f;
  const float dl0 = qp0 < T ? a.delta[lrow + qp0] : 0.f;
  const float dl1 = qp1 < T ? a.delta[lrow + qp1] : 0.f;

  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (kt_begin + i) * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t k_s = sbase + C::k_off(s);
    const uint32_t v_s = sbase + C::v_off(s);

    // S (64, BK) = Q . K^T and dP = dO . V^T, back to back
    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss<BK>(sc, desc_k(q_s + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                   desc_k(k_s + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss<BK>(dp, desc_k(do_s + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                   desc_k(v_s + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // p = 2^(s * scale * log2 e - lse * log2 e), 0 where masked
    const bool interior = k0 >= start && k0 + BK <= end && q0w + 64 <= T &&
                          (!a.causal || k0 + BK - 1 <= q0w + a.diag);
    if (interior) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] * a.scale_log2 - lse0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] * a.scale_log2 - lse0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] * a.scale_log2 - lse1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] * a.scale_log2 - lse1);
      }
    } else {
      const bool in0 = qp0 < T, in1 = qp1 < T;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + col + e;
          const bool key = kp >= start && kp < end;
          const bool ok0 = key && in0 && (!a.causal || kp <= qp0 + a.diag);
          const bool ok1 = key && in1 && (!a.causal || kp <= qp1 + a.diag);
          sc[4 * j + e] = ok0 ? exp2f(sc[4 * j + e] * a.scale_log2 - lse0) : 0.f;
          sc[4 * j + 2 + e] = ok1 ? exp2f(sc[4 * j + 2 + e] * a.scale_log2 - lse1) : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // ds = p * (dp - delta), rounded to bf16 as wgmma A fragments
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i0 = 8 * kk + 2 * r;
        const float d = (r & 1) ? dl1 : dl0;  // registers 2, 3 of each n8 block: row qp1
        da[kk][r] = pack_bf16(sc[i0] * (dp[i0] - d), sc[i0 + 1] * (dp[i0 + 1] - d));
      }
    }

    // dQ += dS . K with K as the MN-major B operand
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_tb<DH>(dq, da[kk], desc_mn(k_s + kk * 16 * 128, BK * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[s]);
  }

  // bf16 rows of dq times the scale, straight from the registers; a tile
  // that saw no key writes zeros
  __nv_bfloat16* ob = a.dq + b * a.dq_sb + h * a.dq_sh + col;
  if (qp0 < T) {
    __nv_bfloat16* dst = ob + (long long)qp0 * a.dq_st;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    }
  }
  if (qp1 < T) {
    __nv_bfloat16* dst = ob + (long long)qp1 * a.dq_st;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
    }
  }
}

template <class C>
int launch(const void* q, const void* k, const void* v, const void* dout, const DqArgs& a,
           int B, const long long* s, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, C::DH, a.Hq, a.T, B, s[0], s[1], s[2], C::BQ);
  if (!err) err = make_map(&tk, k, C::DH, a.Hkv, a.T, B, s[3], s[4], s[5], C::BK);
  if (!err) err = make_map(&tv, v, C::DH, a.Hkv, a.T, B, s[6], s[7], s[8], C::BK);
  if (!err) err = make_map(&tdo, dout, C::DH, a.Hq, a.T, B, s[9], s[10], s[11], C::BQ);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(bwd_dq_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + C::BQ - 1) / C::BQ, a.Hq, B);
  bwd_dq_kernel<C><<<grid, C::THREADS, C::bytes, stream>>>(tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 21 element strides (b, t, h) for q, k, v, dout, dq, dk, dv, in
// that order (dk's and dv's are not read); lse and delta are contiguous
// (B, Hq, T) float32. q_off and k_off are the global offsets of the queries
// and keys (0, 0 but in the ring interior). Returns the cudaError_t of the
// launch, or a nonzero code when a tensor map cannot be encoded.
extern "C" int lss_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, const void* starts, const void* ends, int B,
                                          int T, int Hq, int Hkv, int Dh,
                                          const long long* strides, int causal, int q_off,
                                          int k_off, float scale, void* stream) {
  DqArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  a.dq_sb = strides[12];
  a.dq_st = strides[13];
  a.dq_sh = strides[14];
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.diag = q_off - k_off;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch<DqCfg<128>>(q, k, v, dout, a, B, strides, s);
  if (Dh == 64) return launch<DqCfg<64>>(q, k, v, dout, a, B, strides, s);
  return (int)cudaErrorInvalidValue;
}
