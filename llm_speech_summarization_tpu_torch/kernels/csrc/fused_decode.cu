// Fused decode attention plus the in-place write of the fresh tokens, over
// one layer of a dense (L, B, Hkv, S, Dh) KV cache, for Hopper (sm_90a).
//
// Two kernels of the JAX package in one instance set of dense_decode.cuh
// (its header note gives the computation, what bounds it on the H100 and the
// split-S design: the window of each (sample, kv head) streamed by up to 8
// blocks through cp.async.bulk stages, the scores on the tensor cores, an
// online softmax per warp in float32, the splits merged in a fixed order by
// a second kernel over a scratch the wrapper allocates):
//   * B2, llm_speech_summarization_tpu/kernels/fused_decode.py::
//     _fused_kernel_aliased (fused_decode_aliased_scales), the engine's
//     default step over an int8 cache: T >= 1 fresh tokens, the fresh
//     values quantized and written with their bf16 scales into the
//     (L, B, Hkv, S) scale tensors in place;
//   * B3, the same file's _fused_kernel (fused_decode_attention_write): the
//     step over a bf16 cache, whose fresh values are written as they are,
//     or over an int8 cache with one layer's (B, Hkv, S) scales read-only
//     and the fresh (B, Hkv) scales returned. The TPU kernel takes T = 1;
//     this one takes T >= 1, so a speculative verification forward over a
//     bf16 cache runs it too.
//
// The TPU's padded (Spad = pad128(S)) scale slabs and 32-row write windows
// were TPU layout rules; here the scales are plain (.., B, Hkv, S) and the
// write touches exactly the T fresh slots.

#include "dense_decode.cuh"

// Shared memory bytes the kernel needs (the wrapper checks it against the
// device limit before launching); cache_bytes is 1 (int8) or 2 (bf16).
extern "C" long long lss_fused_decode_smem_bytes(int Dh, int T, int G, int S, int cache_bytes) {
  return dense_decode::smem_for(Dh, T, G, S, cache_bytes);
}

// strides: 9 element strides (b, t, h) for q, k_new, v_new, in that order.
// The caches and scales are contiguous, out is contiguous (B, T, Hq, Dh).
// An int8 cache (cache_bytes 1) reads its scales at layer `scale_layer` of
// k_scale / v_scale; with ks_new / vs_new null the fresh scales go into
// them at the fresh slots, else into ks_new / vs_new (B, Hkv, T). A bf16
// cache (cache_bytes 2) takes null scale pointers.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_fused_decode(const void* q, void* k_cache, void* v_cache, void* k_scale,
                                void* v_scale, void* ks_new, void* vs_new, const void* k_new,
                                const void* v_new, const void* pad_lens, const void* offsets,
                                void* out, void* part, int nsplit, int B, int T, int Hq,
                                int Hkv, int S, int Dh, int layer, int scale_layer,
                                int cache_bytes, const long long* strides, float scale,
                                void* stream) {
  dense_decode::Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = k_cache;
  a.vc = v_cache;
  a.ks = static_cast<__nv_bfloat16*>(k_scale);
  a.vs = static_cast<__nv_bfloat16*>(v_scale);
  a.ks_new = static_cast<__nv_bfloat16*>(ks_new);
  a.vs_new = static_cast<__nv_bfloat16*>(vs_new);
  a.kn = static_cast<const __nv_bfloat16*>(k_new);
  a.vn = static_cast<const __nv_bfloat16*>(v_new);
  a.pads = static_cast<const int*>(pad_lens);
  a.offsets = static_cast<const int*>(offsets);
  a.offset = 0;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.B = B;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.layer = layer;
  a.scale_layer = scale_layer;
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
  if (cache_bytes == 1) return dense_decode::dispatch<int8_t, true>(a, Dh, s);
  if (cache_bytes == 2) return dense_decode::dispatch<__nv_bfloat16, true>(a, Dh, s);
  return (int)cudaErrorInvalidValue;
}
