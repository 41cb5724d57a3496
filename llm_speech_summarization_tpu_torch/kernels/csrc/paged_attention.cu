// Paged decode attention (kernel B4), for Hopper (sm_90a).
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// paged_attention.py::_paged_kernel (reached through paged_decode_attention):
// attention of T >= 1 fresh queries over one layer's page-major
// (P, Hkv, ps, Dh) pools through the page table, plus the fresh block
// causally; no write (the caller scatters the fresh tokens afterwards,
// infer/paged.py::write_tokens). The serving path runs it for every
// speculative verification forward (T = spec_k + 1) of the paged decoder.
//
// It is the paged, read-only instance of the decode body the dense kernels
// share (dense_decode.cuh, whose header note says what bounds it on the
// H100 and how its split-S design meets that): the producer warp copies
// each chunk's page segments with cp.async.bulk, the scores run on
// mma.sync with each int8 key converted once for the whole GQA group, and
// where B * Hkv leaves SMs idle up to 8 blocks share each row's window,
// merged in split order by a second kernel. The TPU design's sequence
// blocking (bs = 8 / Hkv), its float32 (P, Hkv, 1, ps) scale slabs and its
// double-buffered page DMAs were TPU layout rules.

#include "dense_decode.cuh"

// Shared memory bytes the kernel needs (the wrapper checks it against the
// device limit before launching); it does not grow with ps.
extern "C" long long lss_paged_attention_smem_bytes(int Dh, int T, int G, int /*ps*/,
                                                    int int8_pools) {
  return dense_decode::smem_for(Dh, T, G, 0, int8_pools ? 1 : 2);
}

// Pools (P, Hkv, ps, Dh) and scales (P, Hkv, ps) are one layer's contiguous
// views (scales null for bf16 pools); strides: 9 element strides (b, t, h)
// of q, k_new, v_new. part and nsplit as lss_fused_decode's: nsplit blocks
// share each row's window, their results merged from the float32 scratch
// `part` (B * Hkv, nsplit, T * G, Dh + 2), null for one split. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lss_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* lengths,
                                   const void* pad_lens, const void* k_new, const void* v_new,
                                   void* out, void* part, int nsplit, int B, int T, int Hq,
                                   int Hkv, int P, int ps, int mp, int Dh, int int8_pools,
                                   const long long* strides, float scale, void* stream) {
  dense_decode::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  // WRITE is off: the kernel only reads through these
  a.kc = const_cast<void*>(k_pool);
  a.vc = const_cast<void*>(v_pool);
  a.ks = static_cast<__nv_bfloat16*>(const_cast<void*>(k_scale));
  a.vs = static_cast<__nv_bfloat16*>(const_cast<void*>(v_scale));
  a.kn = static_cast<const __nv_bfloat16*>(k_new);
  a.vn = static_cast<const __nv_bfloat16*>(v_new);
  a.pads = static_cast<const int*>(pad_lens);
  a.offsets = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.B = B;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = mp * ps;
  a.page_table = static_cast<const int*>(page_table);
  a.P = P;
  a.ps = ps;
  a.mp = mp;
  a.q_sb = strides[0];
  a.q_st = strides[1];
  a.q_sh = strides[2];
  a.kn_sb = strides[3];
  a.kn_st = strides[4];
  a.kn_sh = strides[5];
  a.vn_sb = strides[6];
  a.vn_st = strides[7];
  a.vn_sh = strides[8];
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_pools) return dense_decode::dispatch<int8_t, false, true>(a, Dh, s);
  return dense_decode::dispatch<__nv_bfloat16, false, true>(a, Dh, s);
}
