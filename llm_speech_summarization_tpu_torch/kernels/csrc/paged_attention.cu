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
// The TPU design's sequence blocking (bs = 8 / Hkv), its float32
// (P, Hkv, 1, ps) scale slabs and its double-buffered page DMAs were TPU
// layout rules; the design here, and what bounds it, is in paged_common.cuh.

#include "paged_common.cuh"

// Shared memory bytes the kernel needs (the wrapper checks it against the
// device limit before launching).
extern "C" long long lss_paged_attention_smem_bytes(int Dh, int T, int G, int ps,
                                                    int int8_pools) {
  return lss_paged::shared_bytes(Dh, T, G, ps, int8_pools);
}

// Pools (P, Hkv, ps, Dh) and scales (P, Hkv, ps) are one layer's contiguous
// views; strides: 9 element strides (b, t, h) of q, k_new, v_new. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lss_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* lengths,
                                   const void* pad_lens, const void* k_new, const void* v_new,
                                   void* out, int B, int T, int Hq, int Hkv, int P, int ps,
                                   int mp, int Dh, int int8_pools, const long long* strides,
                                   float scale, void* stream) {
  lss_paged::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pool = const_cast<void*>(k_pool);
  a.v_pool = const_cast<void*>(v_pool);
  a.k_scale = static_cast<__nv_bfloat16*>(const_cast<void*>(k_scale));
  a.v_scale = static_cast<__nv_bfloat16*>(const_cast<void*>(v_scale));
  a.page_table = static_cast<const int*>(page_table);
  a.lengths = static_cast<const int*>(lengths);
  a.pads = static_cast<const int*>(pad_lens);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.P = P;
  a.ps = ps;
  a.mp = mp;
  a.layer = 0;
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
  return lss_paged::dispatch<false>(a, B, Dh, int8_pools, static_cast<cudaStream_t>(stream));
}
