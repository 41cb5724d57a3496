// Flash-attention backward, dk/dv summed over the GQA group, for Hopper
// (sm_90a), from the forward's saved per-row log-sum-exp.
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// flash_attention.py::_bwd_dkv_kernel (launched by _flash_bwd_impl, the
// backward of the flash_attention custom VJP), as B6 (training: the
// student's LLM attention, causal, GQA 24/8, Dh=128; HuBERT's,
// bidirectional, 16/16, Dh=64) and B7 (offset mode, the ring interior).
// dq is flash_attention_bwd.cu's.
//
// The function is FlashAttention-2's: with s = scale * q.k^T masked to the
// key window [start, end) (and causal: key <= query),
//   p = exp(s - lse),  dv = p^T.dO,  dp = dO.v^T,  ds = p * (dp - delta),
//   dk = scale * ds^T.q,
// summed over the q heads of the KV head's group, where delta = rowsum(dO *
// O) comes in precomputed. p and ds are rounded to bf16 before their
// products, as the TPU kernel casts them to the operand dtype. A masked
// score gives p = 0 by selection, never by exp(-huge): a row with no valid
// key has lse = -1e30, where exp(s - lse) would overflow.
//
// What bounds it on the H100: four tile products per (q tile, k tile)
// pair over the valid causal region (the scores and dp are recomputed, not
// stored), so at training lengths the tensor cores bound it, not the bytes.
// The first design (WMMA fragments, the scores and dp through shared memory
// in float32, synchronous loads, 255 registers with a spill at Dh=128) ran
// at 4-7% of that bound. This one:
//   * one block per (128-key tile, KV head, sample); two consumer
//     warpgroups own 64 keys each and keep their dK and dV
//     accumulators (64, Dh) in registers across the whole loop; one
//     producer warp loads K and V once by TMA, then streams the (q head of
//     the group, q tile) steps through a ring of 2 stages: Q and dO by
//     TMA, lse (times log2 e) and delta by plain loads, each stage with a
//     "full" and an "empty" mbarrier. At Dh=128 a consumer thread holds
//     2 x 64 accumulator registers plus the step's S^T and dP^T (2 x 32):
//     the producer is a whole warpgroup that gives its registers away
//     (setmaxnreg 40) so the consumers get 232 without a spill (one
//     consumer warpgroup at 234 registers, one block an SM, ran slower);
//   * per step, S^T = K.Q^T and dP^T = V.dO^T are two wgmma chains from
//     shared memory (K-major operands) with the results in registers; p and
//     ds are made in registers and rounded to bf16, and dV += P^T.dO and
//     dK += dS^T.Q take them as wgmma A operands from registers with dO and
//     Q as MN-major B operands;
//   * the masks are applied only at a window edge, past T or on the
//     diagonal; interior steps skip them;
//   * the GQA group sum happens inside the block, in a fixed order, with no
//     atomics: two calls give bit-identical results (remat relies on it).
// Offset mode (B7): with the queries at global offset q_off and the keys at
// k_off, the causal rule becomes key + k_off <= query + q_off; with d =
// q_off - k_off the first q tile is max(0, k0 - d) / BQ. lse and delta are
// the global ones of the whole ring, so p is the global softmax restricted
// to the visiting block. Offsets (0, 0) are plain B6.

#include "flash_sm90.cuh"

using namespace lss_sm90;

namespace {

// two consumer warpgroups (64 keys each) and a producer, 2 Q/dO stages
template <int DH_>
struct DkvCfg {
  static constexpr int DH = DH_, NWG = 2, STAGES = 2;
  static constexpr int BQ = 64;  // q rows per step
  static constexpr int BKV = 64 * NWG;  // keys per block
  static constexpr int NSUB = DH / 64;
  // at Dh=128 a consumer thread holds 2 x 64 accumulator registers: the
  // producer becomes a whole warpgroup that gives its registers to the
  // consumers (setmaxnreg), else it is one warp
  static constexpr bool SPLIT_REGS = DH == 128;
  static constexpr int THREADS = NWG * 128 + (SPLIT_REGS ? 128 : 32);
  static constexpr uint32_t KV_BYTES = BKV * DH * 2;  // the K or the V tile
  static constexpr uint32_t QT_BYTES = BQ * DH * 2;  // a Q or a dO tile
  static constexpr uint32_t STAGE_BYTES = 2 * QT_BYTES + 1024;  // + lse, delta (2 x 256 B)
  __host__ __device__ static constexpr uint32_t stage_off(int s) { return 2 * KV_BYTES + s * STAGE_BYTES; }
  static constexpr uint32_t bar_off = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr uint32_t bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

struct DkvArgs {
  const float *lse, *delta;  // contiguous (B, Hq, T)
  __nv_bfloat16 *dk, *dv;
  const int *starts, *ends;
  long long dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
  int T, Hq, Hkv, causal, diag;
  float scale, scale_log2;
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const DkvArgs a) {
  constexpr int DH = C::DH, BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int T = a.T;
  const int k0 = (gridDim.x - 1 - blockIdx.x) * BKV;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int start = max(a.starts[b], 0);
  const int end = min(a.ends[b], T);
  // a tile with no valid key has zero gradients (every p is masked)
  const bool any_key = k0 < end && k0 + BKV > start;
  const int qt_begin = a.causal ? max(k0 - a.diag, 0) / BQ : 0;
  const int n_qt = any_key ? max((T + BQ - 1) / BQ - qt_begin, 0) : 0;
  const int n_steps = group * n_qt;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and the warp's lse/delta stores
      mbar_init(&empty[s], C::NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= C::NWG * 4) {
    // ---- producer warp: lane 0 issues the TMA loads, every lane stores
    // its share of lse and delta
    if constexpr (C::SPLIT_REGS) setmaxnreg_dec<40>();
    if (warp != C::NWG * 4 || n_steps == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < C::NSUB; ++c) {
        tma_load(smem + c * BKV * 128, &tk, kv_full, c * 64, hk, k0, b);
        tma_load(smem + C::KV_BYTES + c * BKV * 128, &tv, kv_full, c * 64, hk, k0, b);
      }
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % STAGES;
      const int h = hk * group + i / n_qt;
      const int q0 = (qt_begin + i % n_qt) * BQ;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      uint8_t* st = smem + C::stage_off(s);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::QT_BYTES);
        for (int c = 0; c < C::NSUB; ++c) {
          tma_load(st + c * BQ * 128, &tq, &full[s], c * 64, h, q0, b);
          tma_load(st + C::QT_BYTES + c * BQ * 128, &tdo, &full[s], c * 64, h, q0, b);
        }
      }
      float* lse_s = reinterpret_cast<float*>(st + 2 * C::QT_BYTES);
      float* delta_s = lse_s + BQ;
      const long long row = ((long long)b * a.Hq + h) * T;
      for (int c = lane; c < BQ; c += 32) {
        const bool in = q0 + c < T;
        lse_s[c] = in ? a.lse[row + q0 + c] * LOG2E : 0.f;
        delta_s[c] = in ? a.delta[row + q0 + c] : 0.f;
      }
      mbar_arrive(&full[s]);  // release: the stores above are seen by the waiters
    }
    return;
  }

  // ---- consumers: warpgroup w owns keys [k0 + 64 w, k0 + 64 w + 64); this
  // thread holds key rows kr0 and kr0 + 8, and q columns 8 j + 2 (lane % 4)
  // + {0, 1} of each step's tile
  if constexpr (C::SPLIT_REGS) setmaxnreg_inc<232>();
  const int w = warp / 4;
  const int k0w = k0 + w * 64;
  const int kr0 = k0w + (warp % 4) * 16 + lane / 4;
  const int kr1 = kr0 + 8;
  const bool key0 = kr0 >= start && kr0 < end;
  const bool key1 = kr1 >= start && kr1 < end;
  const bool keys_in = k0w >= start && k0w + 64 <= end;
  const int col = 2 * (lane % 4);
  const uint32_t k_s = sbase + w * 64 * 128;
  const uint32_t v_s = sbase + C::KV_BYTES + w * 64 * 128;

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_steps > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt_begin + i % n_qt) * BQ;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t q_st = sbase + C::stage_off(s);
    const uint32_t do_st = q_st + C::QT_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(smem + C::stage_off(s) + 2 * C::QT_BYTES);
    const float* delta_s = lse_s + BQ;

    // S^T (64 keys, BQ) = K_w . Q^T and dP^T = V_w . dO^T, back to back
    float st[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss<BQ>(st, desc_k(k_s + (kk / 4) * BKV * 128 + (kk % 4) * 32),
                   desc_k(q_st + (kk / 4) * BQ * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss<BQ>(dp, desc_k(v_s + (kk / 4) * BKV * 128 + (kk % 4) * 32),
                   desc_k(do_st + (kk / 4) * BQ * 128 + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // p = 2^(s * scale * log2 e - lse * log2 e), 0 where masked
    const bool interior =
        keys_in && q0 + BQ <= T && (!a.causal || k0w + 63 <= q0 + a.diag);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + col + e;
        const int qp = q0 + c;
        const float l2 = lse_s[c];
        bool ok0 = true, ok1 = true;
        if (!interior) {
          const bool q_in = qp < T;
          ok0 = key0 && q_in && (!a.causal || kr0 <= qp + a.diag);
          ok1 = key1 && q_in && (!a.causal || kr1 <= qp + a.diag);
        }
        st[4 * j + e] = ok0 ? exp2f(st[4 * j + e] * a.scale_log2 - l2) : 0.f;
        st[4 * j + 2 + e] = ok1 ? exp2f(st[4 * j + 2 + e] * a.scale_log2 - l2) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // ds = p * (dp - delta)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = delta_s[8 * j + col + e];
        dp[4 * j + e] = st[4 * j + e] * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = st[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // dV += P^T.dO, dK += dS^T.Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs_tb<DH>(dv, pa[kk], desc_mn(do_st + kk * 16 * 128, BQ * 128));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs_tb<DH>(dk, da[kk], desc_mn(q_st + kk * 16 * 128, BQ * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[s]);
  }

  // bf16 rows of dk (times scale) and dv, straight from the registers
  __nv_bfloat16* dkb = a.dk + b * a.dk_sb + hk * a.dk_sh + col;
  __nv_bfloat16* dvb = a.dv + b * a.dv_sb + hk * a.dv_sh + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = half ? kr1 : kr0;
    if (kr >= T) continue;
    __nv_bfloat16* kdst = dkb + (long long)kr * a.dk_st;
    __nv_bfloat16* vdst = dvb + (long long)kr * a.dv_st;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int i0 = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(kdst + 8 * j) =
          __floats2bfloat162_rn(dk[i0] * a.scale, dk[i0 + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vdst + 8 * j) = __floats2bfloat162_rn(dv[i0], dv[i0 + 1]);
    }
  }
}

template <class C>
int launch(const void* q, const void* k, const void* v, const void* dout, const DkvArgs& a,
           int B, const long long* s, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, C::DH, a.Hq, a.T, B, s[0], s[1], s[2], C::BQ);
  if (!err) err = make_map(&tk, k, C::DH, a.Hkv, a.T, B, s[3], s[4], s[5], C::BKV);
  if (!err) err = make_map(&tv, v, C::DH, a.Hkv, a.T, B, s[6], s[7], s[8], C::BKV);
  if (!err) err = make_map(&tdo, dout, C::DH, a.Hq, a.T, B, s[9], s[10], s[11], C::BQ);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(bwd_dkv_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + C::BKV - 1) / C::BKV, a.Hkv, B);
  bwd_dkv_kernel<C><<<grid, C::THREADS, C::bytes, stream>>>(tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 21 element strides (b, t, h) for q, k, v, dout, dq, dk, dv, in
// that order (dq's are not read); lse and delta are contiguous (B, Hq, T)
// float32. q_off and k_off are the global offsets of the queries and keys
// (0, 0 but in the ring interior). Returns the cudaError_t of the launch,
// or a nonzero code when a tensor map cannot be encoded.
extern "C" int lss_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, const void* starts,
                                           const void* ends, int B, int T, int Hq, int Hkv,
                                           int Dh, const long long* strides, int causal,
                                           int q_off, int k_off, float scale, void* stream) {
  DkvArgs a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  a.dk_sb = strides[15];
  a.dk_st = strides[16];
  a.dk_sh = strides[17];
  a.dv_sb = strides[18];
  a.dv_st = strides[19];
  a.dv_sh = strides[20];
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.causal = causal;
  a.diag = q_off - k_off;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128) return launch<DkvCfg<128>>(q, k, v, dout, a, B, strides, s);
  if (Dh == 64) return launch<DkvCfg<64>>(q, k, v, dout, a, B, strides, s);
  return (int)cudaErrorInvalidValue;
}
