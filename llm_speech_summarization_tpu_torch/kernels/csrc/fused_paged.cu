// Fused paged decode attention + in-place page write (kernel B5), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// fused_paged.py::_fused_paged_kernel (reached through
// fused_paged_decode_write), every T = 1 step of the paged decoder: B4's
// attention over layer `layer` of the (L, P, Hkv, ps, Dh) pools, then the
// fresh token quantized bit-exactly like _quantize_kv and written, values
// and bf16 scales, at [layer, page_table[b, length / ps], h, length % ps].
//
// Page routing follows the oracle, fused_paged_reference: a length past the
// table (length == ps * mp) writes the null page 0, where the TPU kernel
// dropped the token. The TPU kernel returned the fresh scales for one
// scatter after the layer scan and wrote 32-row windows through a VMEM
// snapshot of the page; here the scales are written in place like the
// values, which leaves the same final state. Rows of released slots have a
// zeroed table row and write page 0, which no valid row attends. It is the
// paged, writing instance of the decode body the dense kernels share
// (dense_decode.cuh, whose header note says what bounds it on the H100 and
// how its split-S design meets that).

#include "dense_decode.cuh"

extern "C" long long lss_fused_paged_smem_bytes(int Dh, int G, int /*ps*/, int int8_pools) {
  return dense_decode::smem_for(Dh, 1, G, 0, int8_pools ? 1 : 2);
}

// Pools (L, P, Hkv, ps, Dh) and scales (L, P, Hkv, ps) contiguous (scales
// null for bf16 pools); strides: 9 element strides (b, t, h) of q, k_new,
// v_new; part and nsplit as lss_paged_attention's (T = 1). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lss_fused_paged(const void* q, void* k_pool, void* v_pool, void* k_scale,
                               void* v_scale, const void* page_table, const void* lengths,
                               const void* pad_lens, const void* k_new, const void* v_new,
                               void* out, void* part, int nsplit, int B, int Hq, int Hkv, int P,
                               int ps, int mp, int Dh, int int8_pools, int layer,
                               const long long* strides, float scale, void* stream) {
  dense_decode::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = k_pool;
  a.vc = v_pool;
  a.ks = static_cast<__nv_bfloat16*>(k_scale);
  a.vs = static_cast<__nv_bfloat16*>(v_scale);
  a.kn = static_cast<const __nv_bfloat16*>(k_new);
  a.vn = static_cast<const __nv_bfloat16*>(v_new);
  a.pads = static_cast<const int*>(pad_lens);
  a.offsets = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.B = B;
  a.T = 1;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = mp * ps;
  a.layer = layer;
  a.scale_layer = layer;
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
  if (int8_pools) return dense_decode::dispatch<int8_t, true, true>(a, Dh, s);
  return dense_decode::dispatch<__nv_bfloat16, true, true>(a, Dh, s);
}
