// Single-token decode attention over one layer's dense (B, Hkv, S, Dh) KV
// cache, read in place, for Hopper (sm_90a): kernel B8.
//
// Replaces the TPU kernel llm_speech_summarization_tpu/kernels/
// decode_attention.py::_decode_kernel (reached through decode_attention),
// which runs when a caller asks for attn_impl="pallas". One query token per
// sample attends the cache slots pad[b] <= s < offset (one scalar offset for
// the batch) plus its own fresh key, over a bf16 cache or an int8 cache with
// (B, Hkv, S) per-slot scales. It writes nothing: the caller writes the
// fresh k/v into the cache after the kernel.
//
// It is the read-only instance of the fused decode kernels' split-S body
// (dense_decode.cuh, whose header note says what bounds it on the H100 and
// how the design meets that), at T = 1 with WRITE off.

#include "dense_decode.cuh"

// Shared memory bytes the kernel needs; cache_bytes is 1 (int8) or 2 (bf16).
extern "C" long long lss_decode_attention_smem_bytes(int Dh, int G, int S, int cache_bytes) {
  return dense_decode::smem_for(Dh, 1, G, S, cache_bytes);
}

// strides: 9 element strides (b, t, h) for q, k_new, v_new, in that order.
// The cache and scales are contiguous (B, Hkv, S, Dh) and (B, Hkv, S); out
// is contiguous (B, 1, Hq, Dh). A bf16 cache takes null scale pointers.
// nsplit and part as lss_fused_decode's (T = 1).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                    const void* k_scale, const void* v_scale,
                                    const void* k_new, const void* v_new, const void* pad_lens,
                                    int offset, void* out, void* part, int nsplit, int B, int Hq,
                                    int Hkv, int S, int Dh, int cache_bytes,
                                    const long long* strides, float scale, void* stream) {
  dense_decode::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  // WRITE is off: the kernel only reads through these
  a.kc = const_cast<void*>(k_cache);
  a.vc = const_cast<void*>(v_cache);
  a.ks = static_cast<__nv_bfloat16*>(const_cast<void*>(k_scale));
  a.vs = static_cast<__nv_bfloat16*>(const_cast<void*>(v_scale));
  a.ks_new = nullptr;
  a.vs_new = nullptr;
  a.kn = static_cast<const __nv_bfloat16*>(k_new);
  a.vn = static_cast<const __nv_bfloat16*>(v_new);
  a.pads = static_cast<const int*>(pad_lens);
  a.offsets = nullptr;
  a.offset = offset;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.B = B;
  a.T = 1;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.layer = 0;
  a.scale_layer = 0;
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
  if (cache_bytes == 1) return dense_decode::dispatch<int8_t, false>(a, Dh, s);
  if (cache_bytes == 2) return dense_decode::dispatch<__nv_bfloat16, false>(a, Dh, s);
  return (int)cudaErrorInvalidValue;
}
