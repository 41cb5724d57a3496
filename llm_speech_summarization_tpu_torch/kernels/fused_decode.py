"""Fused decode attention + in-place cache write over a dense KV cache
(kernels B2 and B3): wrappers, plain versions, launch counts.

Ports of ``llm_speech_summarization_tpu/kernels/fused_decode.py``:

* ``fused_decode`` (B2, ``fused_decode_aliased_scales``): the int8 cache
  with its ``(L, B, Hkv, S)`` scale tensors, both written in place;
* ``fused_decode_attention_write`` (B3): a bf16 cache, or an int8 cache
  with one layer's ``(B, Hkv, S)`` scales that are only read, the fresh
  ``(B, Hkv)`` scales being returned (the TPU function's
  ``LSS_FUSED_ALIASED_SCALES=0`` mode).

Both are one CUDA library, ``csrc/fused_decode.cu`` over the body in
``csrc/dense_decode.cuh``, whose header note says what bounds it on the
H100 and how its split-S design meets that: the wrapper picks the number
of blocks per (sample, kv head) window (``dense_splits``) and allocates
the float32 scratch their results are merged from (``split_scratch``).

A float32 query takes the float32 instances, ``fused_decode_f32`` and
``fused_decode_attention_write_f32`` (each with its own launch count): the
library ``csrc/decode_f32.cu`` over ``csrc/dense_decode_f32.cuh``, which
B4, B5 and B8 share at float32 too (``launch_f32``). They take an int8, a
float32 or a bfloat16 cache, float32 fresh k/v, and return a float32
output; the int8 cache's scales stay bfloat16.

A bfloat16 query over a float32 cache (bf16 parameters at
``compute_dtype: float32``: the prefill fills a float32 cache, the decode
steps run in the norms' bf16) takes B3's mixed instance,
``fused_decode_attention_write_mixed`` (its own launch count): the same
library's bf16-query instance, which rounds each cached value and p over
the cache to bf16 as the TPU kernel casts them to q's dtype, returns a
bfloat16 output and widens the fresh values into the cache bit for bit.
``decode_route`` picks the route from the query's dtype and the cache's;
a float32 query with bfloat16 fresh values, and float16, raise.

For layer ``layer`` of the cache, each of the T >= 1 fresh queries attends
the slots ``pad <= s < offset`` plus the fresh block causally; then the
fresh k/v are written in place at ``[offset, offset + T)``: quantized like
``_quantize_kv`` into an int8 cache, as they are into a bf16 one. The caller
owns the cache tensors; both versions mutate them and return the attention
output.

The TPU kernel's lane-padded ``(L, B, Hkv, Spad)`` scale slabs and 32-row
write windows were TPU layout rules: here the scales are plain tensors
written at exactly the fresh slots. Where the TPU wrappers quietly ran
their oracle for a cache shorter than their window, these raise when
``offsets + T > S``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .build import check_status, count_launch, load_library

SOURCES = ("fused_decode.cu", "dense_decode.cuh", "int8.cuh", "flash_sm90.cuh")
F32_SOURCES = ("decode_f32.cu", "dense_decode_f32.cuh", "int8.cuh")
NEG_INF = -1e30
MAX_ROWS = 32  # T * (Hq / Hkv) query rows per block
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may use on sm_90
# the split of each (sample, kv head) window over blocks (PERF.md §6, B2
# at B = 1-8 with the split count forced): as many splits as keep the grid
# within one block an SM (a block keeps its SM busy), at most 8, and only
# where that takes SPLIT_GAIN_SLOTS or more of the window off each block's
# path (~0.014 us a slot against ~2-3 us for the merge kernel and the
# extra blocks)
MAX_SPLITS = 8  # the most the merge kernel takes (csrc/dense_decode.cuh)
SPLIT_GAIN_SLOTS = 256
# the float32 body's split (csrc/dense_decode_f32.cuh; PERF.md §6, chip_smoke
# --split-sweep f32 over its float32 and mixed instances): a float32 slot
# moves four times an int8 slot's bytes, and an SM holds F32_BLOCKS_PER_SM
# of its blocks (each streams its share through a ~100 KB ring), so the
# body splits as far as the grid stays one wave of that many blocks an SM
# (a second wave cost 1.3-1.5x in the sweep), at most F32_MAX_SPLITS, each
# split keeping F32_SPLIT_SLOTS slots or more (one chunk)
F32_MAX_SPLITS = 16  # the most its merge kernel takes
F32_BLOCKS_PER_SM = 2
F32_SPLIT_SLOTS = 32
CACHE_BYTES = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}
# each route's query dtype and the cache types it takes: the bf16 body's,
# the float32 body's, and the float32 body's bf16-query (mixed) instances
ROUTE_QUERY = {"bf16": torch.bfloat16, "f32": torch.float32, "mixed": torch.bfloat16}
CACHE_TYPES = {"bf16": (torch.int8, torch.bfloat16),
               "f32": (torch.int8, torch.bfloat16, torch.float32),
               "mixed": (torch.float32,)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) → (int8 values, bf16 per-row scale): symmetric absmax,
    scale = max(absmax / 127, 1e-8) in float32, round half to even, clip
    to ±127 (``models/llama.py::_quantize_kv`` of the JAX package)."""
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient the cache contract needs
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _check_offsets(offsets_max: int, T: int, S: int) -> None:
    if offsets_max + T > S:
        raise ValueError(
            f"fused_decode: offsets + T = {offsets_max} + {T} exceeds the cache length "
            f"S = {S}; the fresh tokens would not fit"
        )


def dense_attention_reference(q, kc, vc, ks, vs, k_new, v_new, pad_lens, offsets):
    """Plain PyTorch attention over one layer of a dense cache: q (B, T, Hq,
    Dh) attends the slots ``pad <= s < offset`` of kc/vc (B, Hkv, S, Dh),
    keys dequantized by ks and p weighted by vs (B, Hkv, S) when the cache
    is int8, plus the fresh block (B, T, Hkv, Dh) causally. The JAX
    ``fused_reference`` math, which is ``decode_xla_q``'s."""
    B, T, Hq, Dh = q.shape
    Hkv, S = kc.shape[1], kc.shape[2]
    group = Hq // Hkv
    dev = q.device
    qg = q.reshape(B, T, Hkv, group, Dh).float()
    s_c = torch.einsum("bthgd,bhsd->bthgs", qg, kc.to(q.dtype).float())
    if ks is not None:
        s_c = s_c * ks[:, None, :, None, :].float()
    s_c = s_c * (Dh ** -0.5)
    slot = torch.arange(S, device=dev)
    valid = (slot[None, :] >= pad_lens[:, None]) & (slot[None, :] < offsets[:, None])
    s_c = torch.where(valid[:, None, None, None, :], s_c, torch.full((), NEG_INF, device=dev))
    s_f = torch.einsum("bthgd,bshd->bthgs", qg, k_new.to(q.dtype).float()) * (Dh ** -0.5)
    causal = torch.arange(T, device=dev)[:, None] >= torch.arange(T, device=dev)[None, :]
    s_f = torch.where(causal[None, :, None, None, :], s_f, torch.full((), NEG_INF, device=dev))
    m = torch.maximum(torch.amax(s_c, -1, keepdim=True), torch.amax(s_f, -1, keepdim=True))
    p_c = torch.exp(s_c - m)
    p_f = torch.exp(s_f - m)
    denom = p_c.sum(-1, keepdim=True) + p_f.sum(-1, keepdim=True)
    p_eff = p_c * vs[:, None, :, None, :].float() if vs is not None else p_c
    pv = torch.einsum("bthgs,bhsd->bthgd", p_eff.to(q.dtype).float(), vc.to(q.dtype).float())
    pv = pv + torch.einsum("bthgs,bshd->bthgd", p_f.to(q.dtype).float(),
                           v_new.to(q.dtype).float())
    return (pv / denom).reshape(B, T, Hq, Dh).to(q.dtype)


def _write_fresh(kc, vc, k_new, v_new, offsets, scales=None):
    """Fresh (B, T, Hkv, Dh) k/v → slots [offset, offset + T) of one layer's
    kc/vc (B, Hkv, S, Dh) in place: quantized into an int8 cache, their
    scales written into ``scales`` (k, v) when given; cast into a float
    one. Returns the fresh (k, v) scales (B, T, Hkv), or None."""
    B, T = k_new.shape[:2]
    dev = k_new.device
    rows = torch.arange(B, device=dev)[:, None]
    cols = offsets.long()[:, None] + torch.arange(T, device=dev)[None, :]
    if kc.dtype != torch.int8:
        kc[rows, :, cols] = k_new.to(kc.dtype)
        vc[rows, :, cols] = v_new.to(vc.dtype)
        return None
    fresh = []
    for i, (new, cache) in enumerate(((k_new, kc), (v_new, vc))):
        vals, sc = _quantize_kv(new)  # (B, T, Hkv, Dh), (B, T, Hkv)
        cache[rows, :, cols] = vals
        if scales is not None:
            scales[i][rows, :, cols] = sc
        fresh.append(sc)
    return tuple(fresh)


def fused_decode_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pad_lens: torch.Tensor,
    offsets: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """Plain PyTorch version of B2: dense masked attention over the cache
    window plus the causal fresh block, then the fresh tokens written in
    place, values and (L, B, Hkv, S) scales. Takes an int8 cache with
    scales, or a float cache with ``k_scale=None``."""
    _check_offsets(int(offsets.max()), q.shape[1], k_cache.shape[3])
    scales = None if k_scale is None else (k_scale[layer], v_scale[layer])
    kc, vc = k_cache[layer], v_cache[layer]  # (B, Hkv, S, Dh) views
    out = dense_attention_reference(q, kc, vc, *(scales or (None, None)), k_new, v_new,
                                    pad_lens, offsets)
    _write_fresh(kc, vc, k_new, v_new, offsets, scales)
    return out


def fused_decode_attention_write_reference(
    q, k_cache, v_cache, k_new, v_new, pad_lens, offsets, layer,
    k_scale_layer=None, v_scale_layer=None,
):
    """Plain PyTorch version of B3: the attention of ``fused_decode_
    reference``, then the fresh values written in place; an int8 cache's
    layer scales (B, Hkv, S) are only read and the fresh (B, Hkv) scales
    returned (the JAX ``fused_reference`` with ``k_scale_layer``)."""
    B, T = q.shape[:2]
    _check_offsets(int(offsets.max()), T, k_cache.shape[3])
    kc, vc = k_cache[layer], v_cache[layer]
    out = dense_attention_reference(q, kc, vc, k_scale_layer, v_scale_layer, k_new, v_new,
                                    pad_lens, offsets)
    fresh = _write_fresh(kc, vc, k_new, v_new, offsets)
    if k_scale_layer is None:
        return out
    return out, fresh[0][:, 0], fresh[1][:, 0]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (the kernels read the same count)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense_splits(B: int, Hkv: int, max_offset: int, sms: int) -> int:
    """Blocks that share each (sample, kv head) window of the dense decode
    kernels, from the batch, the host-side bound of the offsets and the
    card's ``sms``."""
    n = max(1, min(sms // (B * Hkv), MAX_SPLITS))
    return n if int(max_offset) * (n - 1) >= SPLIT_GAIN_SLOTS * n else 1


def f32_splits(B: int, Hkv: int, max_offset: int, sms: int) -> int:
    """Blocks that share each (sample, kv head) window of the float32 decode
    body (its float32 and mixed instances), from the batch, the host-side
    bound of the offsets and the card's ``sms``."""
    n = F32_BLOCKS_PER_SM * sms // (B * Hkv)
    return max(1, min(n, F32_MAX_SPLITS, int(max_offset) // F32_SPLIT_SLOTS))


def split_scratch(nsplit: int, B: int, Hkv: int, rows: int, Dh: int, device):
    """float32 scratch for the split results, (B * Hkv, nsplit, rows, Dh +
    2), or None for one split."""
    if nsplit == 1:
        return None
    return torch.empty((B * Hkv, nsplit, rows, Dh + 2), dtype=torch.float32, device=device)


def _devices(what, tensors) -> str:
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"cuda"}):
        return devices.pop()
    raise ValueError(f"{what}: tensors on {sorted(devices)}; need all cpu or all cuda")


def fused_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pad_lens: torch.Tensor,
    offsets: torch.Tensor,
    layer: int,
    *,
    max_offset: Optional[int] = None,
) -> torch.Tensor:
    """B2: decode attention for layer ``layer`` of the int8 cache + in-place
    write of the fresh k/v and their scales; returns out (B, T, Hq, Dh).

    q (B, T, Hq, Dh); caches (L, B, Hkv, S, Dh); scales (L, B, Hkv, S);
    k_new/v_new (B, T, Hkv, Dh); pad_lens/offsets (B,) int32. On CUDA the
    wrapper does not read device values, so ``max_offset`` (the host-side
    bound of ``offsets``) is required to check ``offsets + T <= S``."""
    what = "fused_decode"
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens, offsets)) == "cpu":
        return fused_decode_reference(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                                      pad_lens, offsets, layer)
    _check_int8_cache(what, k_cache, k_scale, v_scale)
    if decode_route(what, q, k_new, v_new, k_cache.dtype) == "f32":
        return fused_decode_f32(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
                                offsets, layer, max_offset=max_offset)
    return _launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens, offsets,
                   layer, max_offset)


def fused_decode_f32(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens, offsets,
                     layer, *, max_offset=None):
    """B2's float32 instance: float32 q and fresh k/v over the int8 cache
    with its bf16 (L, B, Hkv, S) scales, written in place; returns a float32
    out (B, T, Hq, Dh). Arguments as ``fused_decode``."""
    what = "fused_decode_f32"
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens, offsets)) == "cpu":
        return fused_decode_reference(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                                      pad_lens, offsets, layer)
    _check_int8_cache(what, k_cache, k_scale, v_scale)
    return _launch_dense(fused_decode_f32, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                         pad_lens, offsets, layer, max_offset, per_layer_scales=False,
                         route="f32")


def _check_int8_cache(what, k_cache, k_scale, v_scale):
    if k_cache.dtype != torch.int8 or k_scale is None or v_scale is None:
        raise ValueError(f"{what}: the kernel takes the int8 cache with its (L, B, Hkv, S) "
                         "scales; a bfloat16 or float32 cache goes to "
                         "fused_decode_attention_write")


def decode_route(what, q, k_new, v_new, cache_dtype) -> str:
    """The route of a CUDA call, from the query's dtype and the cache's:
    "f32" (the float32 body) for a float32 query; "mixed" (the float32
    body's bf16-query instances) for a bfloat16 query over a float32 cache
    or pools; "bf16" (the bf16 body) for a bfloat16 query over any other.
    The fresh k/v must share the query's dtype."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: a {q.dtype} query is not ported; the kernels take bfloat16 "
                         "or float32")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError(f"{what}: mixed dtypes are not ported: a {q.dtype} query with "
                         f"{k_new.dtype} / {v_new.dtype} fresh values")
    if q.dtype == torch.float32:
        return "f32"
    return "mixed" if cache_dtype == torch.float32 else "bf16"


def fused_decode_attention_write(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pad_lens: torch.Tensor,
    offsets: torch.Tensor,
    layer: int,
    k_scale_layer: Optional[torch.Tensor] = None,
    v_scale_layer: Optional[torch.Tensor] = None,
    *,
    max_offset: Optional[int] = None,
):
    """B3: decode attention for layer ``layer`` of a dense cache + in-place
    write of the fresh values. A bfloat16 cache (no scales) returns out
    (B, T, Hq, Dh); an int8 cache with that layer's (B, Hkv, S) scales,
    which are only read, returns (out, ks_new, vs_new), the fresh (B, Hkv)
    scales. Shapes and ``max_offset`` as ``fused_decode``.

    The TPU kernel takes T = 1 only and the JAX package sends a speculative
    verification forward over a float cache to XLA; this wrapper takes
    T >= 1 over a bfloat16 cache, so that forward launches the kernel too.
    The int8 mode keeps the TPU signature: T = 1. A float32 query goes to
    ``fused_decode_attention_write_f32``, a bfloat16 one over a float32
    cache to ``fused_decode_attention_write_mixed``."""
    what = "fused_decode_attention_write"
    if (k_scale_layer is None) != (v_scale_layer is None):
        raise ValueError(f"{what}: pass both layer scales or neither")
    if k_scale_layer is not None and q.shape[1] != 1:
        raise ValueError(f"{what}: the int8 mode with layer scales takes T = 1, got T = "
                         f"{q.shape[1]}")
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens, offsets)) == "cpu":
        return fused_decode_attention_write_reference(q, k_cache, v_cache, k_new, v_new,
                                                      pad_lens, offsets, layer, k_scale_layer,
                                                      v_scale_layer)
    route = decode_route(what, q, k_new, v_new, k_cache.dtype)
    if route == "f32":
        return fused_decode_attention_write_f32(q, k_cache, v_cache, k_new, v_new, pad_lens,
                                                offsets, layer, k_scale_layer, v_scale_layer,
                                                max_offset=max_offset)
    if route == "mixed":
        return fused_decode_attention_write_mixed(q, k_cache, v_cache, k_new, v_new, pad_lens,
                                                  offsets, layer, k_scale_layer, v_scale_layer,
                                                  max_offset=max_offset)
    return _launch_dense(fused_decode_attention_write, q, k_cache, v_cache, k_scale_layer,
                         v_scale_layer, k_new, v_new, pad_lens, offsets, layer, max_offset,
                         per_layer_scales=True)


def fused_decode_attention_write_f32(q, k_cache, v_cache, k_new, v_new, pad_lens, offsets,
                                     layer, k_scale_layer=None, v_scale_layer=None, *,
                                     max_offset=None):
    """B3's float32 instance: float32 q and fresh k/v over a float32 or
    bfloat16 cache (T >= 1), or an int8 one with that layer's (B, Hkv, S)
    scales (T = 1; the fresh (B, Hkv) scales returned, bf16); the output is
    float32. Arguments as ``fused_decode_attention_write``."""
    what = "fused_decode_attention_write_f32"
    if (k_scale_layer is None) != (v_scale_layer is None):
        raise ValueError(f"{what}: pass both layer scales or neither")
    if k_scale_layer is not None and q.shape[1] != 1:
        raise ValueError(f"{what}: the int8 mode with layer scales takes T = 1, got T = "
                         f"{q.shape[1]}")
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens, offsets)) == "cpu":
        return fused_decode_attention_write_reference(q, k_cache, v_cache, k_new, v_new,
                                                      pad_lens, offsets, layer, k_scale_layer,
                                                      v_scale_layer)
    return _launch_dense(fused_decode_attention_write_f32, q, k_cache, v_cache, k_scale_layer,
                         v_scale_layer, k_new, v_new, pad_lens, offsets, layer, max_offset,
                         per_layer_scales=True, route="f32")


def fused_decode_attention_write_mixed(q, k_cache, v_cache, k_new, v_new, pad_lens, offsets,
                                       layer, k_scale_layer=None, v_scale_layer=None, *,
                                       max_offset=None):
    """B3's mixed instance: a bfloat16 q and fresh k/v (T >= 1) over a
    float32 cache (which takes no scales), each cached value and p over the
    cache rounded to bf16 as the TPU kernel casts them, the fresh values
    widened into the cache bit for bit; returns a bfloat16 out (B, T, Hq,
    Dh). Arguments as ``fused_decode_attention_write``."""
    what = "fused_decode_attention_write_mixed"
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens, offsets)) == "cpu":
        return fused_decode_attention_write_reference(q, k_cache, v_cache, k_new, v_new,
                                                      pad_lens, offsets, layer, k_scale_layer,
                                                      v_scale_layer)
    return _launch_dense(fused_decode_attention_write_mixed, q, k_cache, v_cache, k_scale_layer,
                         v_scale_layer, k_new, v_new, pad_lens, offsets, layer, max_offset,
                         per_layer_scales=True, route="mixed")


for _wrapper in (fused_decode, fused_decode_f32, fused_decode_attention_write,
                 fused_decode_attention_write_f32, fused_decode_attention_write_mixed):
    _wrapper.launches = 0


def _lib():
    lib = load_library("fused_decode", SOURCES)
    fn = lib.lss_fused_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 10 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_fused_decode_smem_bytes.argtypes = [i] * 5
        lib.lss_fused_decode_smem_bytes.restype = ctypes.c_longlong
    return lib


def _f32_lib():
    """The float32 decode library (B2, B3, B4, B5 and B8 at float32; B3,
    B4, B5 and B8 at a bf16 query over a float32 cache)."""
    lib = load_library("decode_f32", F32_SOURCES)
    fn = lib.lss_decode_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 17 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_decode_f32_smem_bytes.argtypes = [i] * 4
        lib.lss_decode_f32_smem_bytes.restype = ctypes.c_longlong
    return lib


def launch_f32(wrapper, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens, nsplit,
               part, *, offsets=None, offset=0, layer=0, scale_layer=0, page_table=None, P=0,
               ps=0, mp=0, write=False, fresh_scales=(None, None)):
    """One launch of the float32 decode library for ``wrapper`` (its count
    goes up by one), on operands its checks passed: returns the out (B, T,
    Hq, Dh) in q's dtype (float32, or bfloat16 for the mixed instances over
    a float32 cache). Dense caches are (L, B, Hkv, S, Dh) read at ``layer``
    (B8's one-layer view: L = 1); paged pools (L, P, Hkv, ps, Dh) through
    ``page_table``. ``nsplit`` from ``f32_splits``, ``part`` as the bf16
    launches take it (``split_scratch``). ``fresh_scales``: the (B, Hkv, T)
    bf16 outputs of B3's int8 mode, else the int8 scales are written in
    place."""
    what = wrapper.__name__
    B, T, Hq, Dh = q.shape
    Hkv = k_cache.shape[-3]
    paged = page_table is not None
    S = mp * ps if paged else k_cache.shape[-2]
    lib = _f32_lib()
    smem = lib.lss_decode_f32_smem_bytes(Dh, T, T * (Hq // Hkv), CACHE_BYTES[k_cache.dtype])
    if smem > MAX_SMEM:
        raise ValueError(f"{what}: T={T} Hq/Hkv={Hq // Hkv} needs {smem} bytes of shared "
                         f"memory (limit {MAX_SMEM})")
    out = torch.empty((B, T, Hq, Dh), dtype=q.dtype, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_decode_f32(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
            *(ptr(f) for f in fresh_scales), k_new.data_ptr(), v_new.data_ptr(),
            pad_lens.data_ptr(), ptr(offsets), ptr(page_table), out.data_ptr(), ptr(part),
            nsplit, int(offset), B, T, Hq, Hkv, S, Dh, int(layer), int(scale_layer), P, ps, mp,
            CACHE_BYTES[k_cache.dtype], int(paged), int(write), q.element_size(), strides,
            Dh ** -0.5, stream)
    count_launch(wrapper)
    check_status(status, what)
    return out


def _storage_span(t: torch.Tensor) -> Tuple[int, int]:
    start = t.untyped_storage().data_ptr()
    return start, start + t.untyped_storage().nbytes()


def check_separate_storage(what: str, tensors) -> None:
    """Raise if two of ``tensors`` share storage: a kernel writes them in
    place, and two that overlap would corrupt each other."""
    spans = [_storage_span(t) for t in tensors]
    for i in range(len(spans)):
        for j in range(i + 1, len(spans)):
            if spans[i][0] < spans[j][1] and spans[j][0] < spans[i][1]:
                raise ValueError(f"{what}: the caches and scale tensors must not share "
                                 "storage (in-place writes would corrupt each other)")


def cache_type_error(what, route, k_cache, v_cache, kind="cache"):
    """The refusal of a cache (or pools) the ``route`` does not take."""
    if route == "bf16":
        return ValueError(f"{what}: the kernel takes a bfloat16 or int8 {kind} under a "
                          f"bfloat16 query, got {k_cache.dtype} and {v_cache.dtype} (a "
                          f"bfloat16 query over a float32 {kind} takes the mixed instance)")
    if route == "mixed":
        return ValueError(f"{what}: the mixed kernel takes a float32 {kind} under a bfloat16 "
                          f"query, got {k_cache.dtype} and {v_cache.dtype}")
    return ValueError(f"{what}: the float32 kernel takes an int8, bfloat16 or float32 {kind}, "
                      f"got {k_cache.dtype} and {v_cache.dtype}")


def check_decode_operands(what, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                          pad_lens, scale_shape, route="bf16"):
    """The checks the dense decode kernels share: shapes, caches of the
    types the ``route`` takes (int8 with bf16 scales of ``scale_shape``,
    the others without), q and fresh k/v of the route's query dtype with a
    unit last stride, int32 pads and one device. Returns (B, T, Hq, Hkv, S,
    Dh)."""
    if q.dim() != 4 or k_cache.dim() < 4:
        raise ValueError(f"{what}: q must be (B, T, Hq, Dh), the cache (.., B, Hkv, S, Dh)")
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[-3], k_cache.shape[-2]
    if k_cache.shape[-4] != B or k_cache.shape[-1] != Dh or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv or Dh not in (64, 128) or T < 1 or T * (Hq // Hkv) > MAX_ROWS:
        raise ValueError(f"{what}: the kernel takes Dh in (64, 128) and "
                         f"1 <= T * Hq / Hkv <= {MAX_ROWS}; got T={T} Hq={Hq} Hkv={Hkv} "
                         f"Dh={Dh}")
    if k_cache.dtype not in CACHE_TYPES[route] or v_cache.dtype != k_cache.dtype:
        raise cache_type_error(what, route, k_cache, v_cache)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or any(
            t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError(f"{what}: caches must be contiguous with a 16-byte aligned base")
    quantized = k_cache.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: an int8 cache takes its k/v scales, a float cache none")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and (t.dtype != torch.bfloat16 or tuple(t.shape) != scale_shape
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {scale_shape} bfloat16 "
                             f"tensor")
    dtype = ROUTE_QUERY[route]
    for name, t, heads in (("q", q, Hq), ("k_new", k_new, Hkv), ("v_new", v_new, Hkv)):
        if t.dtype != dtype or t.shape != (B, T, heads, Dh) or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be ({B}, {T}, {heads}, {Dh}) "
                             f"{str(dtype)[6:]} with a unit last stride")
    if pad_lens.dtype != torch.int32 or pad_lens.shape != (B,) or not pad_lens.is_contiguous():
        raise ValueError(f"{what}: pad_lens must be a contiguous ({B},) int32 tensor")
    tensors = [t for t in (q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: all tensors must be on one device")
    return B, T, Hq, Hkv, S, Dh


def _launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens, offsets, layer,
            max_offset):
    """B2's launch: the (L, B, Hkv, S) scales written in place."""
    return _launch_dense(fused_decode, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                         pad_lens, offsets, layer, max_offset, per_layer_scales=False)


def _launch_dense(wrapper, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
                  offsets, layer, max_offset, per_layer_scales, route="bf16"):
    """B2 (``per_layer_scales`` off) or B3 on CUDA tensors: the bf16 body
    (``route`` "bf16"), or the float32 body's float32 ("f32") or
    bf16-query ("mixed") instance."""
    what = wrapper.__name__
    if k_cache.dim() != 5:
        raise ValueError(f"{what}: caches must be (L, B, Hkv, S, Dh)")
    L = k_cache.shape[0]
    B, T, Hq, Hkv, S, Dh = check_decode_operands(
        what, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
        tuple(k_cache.shape[1:4]) if per_layer_scales else tuple(k_cache.shape[:4]), route)
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    check_separate_storage(what, [t for t in (k_cache, v_cache, k_scale, v_scale)
                                  if t is not None])
    if offsets.dtype != torch.int32 or offsets.shape != (B,) or not offsets.is_contiguous():
        raise ValueError(f"{what}: offsets must be a contiguous ({B},) int32 tensor")
    if offsets.device != q.device:
        raise ValueError(f"{what}: all tensors must be on one device")
    if max_offset is None:
        raise ValueError(f"{what}: pass max_offset (host-side bound of offsets) on CUDA")
    _check_offsets(int(max_offset), T, S)
    rule = dense_splits if route == "bf16" else f32_splits
    nsplit = rule(B, Hkv, max_offset, sm_count(q.device.index))
    part = split_scratch(nsplit, B, Hkv, T * (Hq // Hkv), Dh, q.device)
    fresh = None
    if per_layer_scales and k_scale is not None:
        fresh = [torch.empty((B, Hkv, T), dtype=torch.bfloat16, device=q.device)
                 for _ in range(2)]
    if route != "bf16":
        out = launch_f32(wrapper, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
                         nsplit, part, offsets=offsets, layer=layer,
                         scale_layer=0 if per_layer_scales else layer, write=True,
                         fresh_scales=fresh or (None, None))
    else:
        out = _launch_bf16(wrapper, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                           pad_lens, offsets, layer, per_layer_scales, nsplit, part, fresh)
    if fresh is not None:
        return out, fresh[0][..., 0], fresh[1][..., 0]
    return out


def _launch_bf16(wrapper, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
                 offsets, layer, per_layer_scales, nsplit, part, fresh):
    """The bf16 body's launch for ``_launch_dense``; returns out."""
    what = wrapper.__name__
    B, T, Hq, Dh = q.shape
    Hkv, S = k_cache.shape[2], k_cache.shape[3]
    cache_bytes = CACHE_BYTES[k_cache.dtype]
    lib = _lib()
    smem = lib.lss_fused_decode_smem_bytes(Dh, T, Hq // Hkv, S, cache_bytes)
    if smem > MAX_SMEM:
        raise ValueError(f"{what}: S={S} needs {smem} bytes of shared memory "
                         f"(limit {MAX_SMEM})")
    out = torch.empty((B, T, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_fused_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
            *(ptr(f) for f in (fresh or (None, None))), k_new.data_ptr(), v_new.data_ptr(),
            pad_lens.data_ptr(), offsets.data_ptr(), out.data_ptr(), ptr(part), nsplit, B, T,
            Hq, Hkv, S, Dh, int(layer), 0 if per_layer_scales else int(layer), cache_bytes,
            strides, Dh ** -0.5, stream)
    count_launch(wrapper)
    check_status(status, what)
    return out
