// The float32 decode attention kernels, for Hopper (sm_90a): the float32
// instances of B2 and B3 (fused dense decode + in-place write), B8 (dense
// decode, read only), B4 (paged decode) and B5 (fused paged decode + page
// write), and the mixed instances of B3, B8, B4 and B5 (a bf16 query over a
// float32 cache or pools), one library over the body in
// dense_decode_f32.cuh, whose header note gives the computation, the TPU
// kernels it replaces, what bounds it on the H100 and its design (the cache
// streamed through a cp.async ring of shared-memory stages, FFMA, split-S
// with a float32 merge).
//
// The wrappers (kernels/fused_decode.py, decode_attention.py,
// paged_attention.py, fused_paged.py) send a float32 query here, and a bf16
// query over a float32 cache: each instance has its own launch count, and
// each picks its instance by the flags below.

#include "dense_decode_f32.cuh"

// Shared memory bytes a launch needs for Dh, T fresh tokens, R = T * G
// query rows and a cache of cache_bytes per value (the wrapper checks it
// against the device limit before launching); they grow with neither the
// cache length nor the page size.
extern "C" long long lss_decode_f32_smem_bytes(int Dh, int T, int R, int cache_bytes) {
  return decode_f32::smem_for(Dh, T, R, cache_bytes);
}

// q, k_new, v_new float32 (q_bytes 4) or bf16 (q_bytes 2, over a float32
// cache only) with the 9 element strides (b, t, h) of q, k_new, v_new in
// `strides`, unit last strides; out contiguous (B, T, Hq, Dh) of q's type.
// cache_bytes: 1 (int8 with bf16 scales), 2 (bf16) or 4 (float32).
// Dense (paged 0): caches (L, B, Hkv, S, Dh) contiguous, read at `layer`,
// the int8 scales at `scale_layer` of (.., B, Hkv, S); offsets (B,) or null
// (every row at `offset`). Paged (paged 1): pools (L, P, Hkv, ps, Dh) and
// scales (L, P, Hkv, ps) at `layer`, page_table (B, mp), offsets the
// lengths, S = mp * ps. write 1: the fresh rows are written (dense: at
// [offset, offset + T); int8 scales into ks_new / vs_new (B, Hkv, T) when
// they are not null, else in place; paged: T = 1 at position length).
// part: the (B * Hkv, nsplit, T * G, Dh + 2) float32 scratch, null for one
// split. Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_decode_f32(const void* q, void* k_cache, void* v_cache, void* k_scale,
                              void* v_scale, void* ks_new, void* vs_new, const void* k_new,
                              const void* v_new, const void* pad_lens, const void* offsets,
                              const void* page_table, void* out, void* part, int nsplit,
                              int offset, int B, int T, int Hq, int Hkv, int S, int Dh,
                              int layer, int scale_layer, int P, int ps, int mp,
                              int cache_bytes, int paged, int write, int q_bytes,
                              const long long* strides, float scale, void* stream) {
  decode_f32::Args a{};
  a.q = q;
  a.kc = k_cache;
  a.vc = v_cache;
  a.ks = static_cast<__nv_bfloat16*>(k_scale);
  a.vs = static_cast<__nv_bfloat16*>(v_scale);
  a.ks_new = static_cast<__nv_bfloat16*>(ks_new);
  a.vs_new = static_cast<__nv_bfloat16*>(vs_new);
  a.kn = k_new;
  a.vn = v_new;
  a.pads = static_cast<const int*>(pad_lens);
  a.offsets = static_cast<const int*>(offsets);
  a.offset = offset;
  a.page_table = static_cast<const int*>(page_table);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.nsplit = nsplit;
  a.B = B;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.layer = layer;
  a.scale_layer = scale_layer;
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
  using decode_f32::dispatch;
#define LSS_F32_LAYOUT(CT, QT)                                         \
  if (paged && write) return dispatch<CT, QT, true, true>(a, Dh, s);   \
  if (paged) return dispatch<CT, QT, false, true>(a, Dh, s);           \
  if (write) return dispatch<CT, QT, true, false>(a, Dh, s);           \
  return dispatch<CT, QT, false, false>(a, Dh, s);
  if (q_bytes == 2) {  // the mixed instances: a bf16 query over a float32 cache
    if (cache_bytes == 4) {
      LSS_F32_LAYOUT(float, __nv_bfloat16)
    }
    return (int)cudaErrorInvalidValue;
  }
  if (q_bytes != 4) return (int)cudaErrorInvalidValue;
  if (cache_bytes == 1) {
    LSS_F32_LAYOUT(int8_t, float)
  }
  if (cache_bytes == 2) {
    LSS_F32_LAYOUT(__nv_bfloat16, float)
  }
  if (cache_bytes == 4) {
    LSS_F32_LAYOUT(float, float)
  }
#undef LSS_F32_LAYOUT
  return (int)cudaErrorInvalidValue;
}
