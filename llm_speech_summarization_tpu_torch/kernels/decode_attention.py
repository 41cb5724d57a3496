"""Single-token decode attention over one layer of a dense KV cache, read in
place (kernel B8): wrapper, plain version, launch count.

Port of ``llm_speech_summarization_tpu/kernels/decode_attention.py::
decode_attention``, which the JAX decoder runs when a caller asks for
``attn_impl="pallas"``. The CUDA kernel is ``csrc/decode_attention.cu``, the
read-only instance of the fused decode kernels' body
(``csrc/dense_decode.cuh``, whose header note says what bounds it on the
H100 and how its split-S design meets that).

q (B, 1, Hq, Dh) attends the slots ``pad_lens[b] <= s < offset`` of one
layer's (B, Hkv, S, Dh) cache (a view of the ``(L, B, Hkv, S, Dh)`` cache,
read in place), bf16 or int8 with (B, Hkv, S) scales, plus the fresh key.
``offset`` is one host-side integer for the whole batch: the kernel takes
no per-row offsets, no T > 1, and writes nothing; the caller writes the
fresh k/v into the cache after it.

A float32 query takes ``decode_attention_f32`` (its own launch count), the
read-only dense instance of the float32 decode library (``csrc/
decode_f32.cu``, ``fused_decode.launch_f32``, split by
``fused_decode.f32_splits``), over a float32, int8 or bfloat16 cache; its
output is float32. A bfloat16 query over a float32
cache takes ``decode_attention_mixed`` (its own launch count), the same
library's bf16-query instance (each cached value and p over the cache
rounded to bf16, as the TPU kernel casts them; a bfloat16 output).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import fused_decode
from .build import check_status, count_launch, load_library
from .fused_decode import (
    CACHE_BYTES,
    MAX_SMEM,
    _devices,
    check_decode_operands,
    decode_route,
    dense_attention_reference,
    dense_splits,
    launch_f32,
    sm_count,
    split_scratch,
)

SOURCES = ("decode_attention.cu", "dense_decode.cuh", "int8.cuh", "flash_sm90.cuh")


def _check_offset(offset, S: int) -> int:
    if isinstance(offset, torch.Tensor) or not 0 <= int(offset) <= S:
        raise ValueError(f"decode_attention: offset must be one host-side integer in [0, {S}], "
                         f"got {offset!r}")
    return int(offset)


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pad_lens: torch.Tensor,
    offset: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the dense masked attention of the fused
    decode kernels' plain version at T = 1, every row at ``offset``."""
    offset = _check_offset(offset, k_cache.shape[2])
    offsets = torch.full((q.shape[0],), offset, dtype=torch.int32, device=q.device)
    return dense_attention_reference(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                                     pad_lens, offsets)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pad_lens: torch.Tensor,
    offset: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention of one query token per sample over one layer's
    cache; returns out (B, 1, Hq, Dh). q (B, 1, Hq, Dh); caches (B, Hkv, S,
    Dh); k_new/v_new (B, 1, Hkv, Dh); pad_lens (B,) int32; ``offset`` a
    Python int; scales (B, Hkv, S) iff the cache is int8."""
    what = "decode_attention"
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens)) == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, k_new, v_new, pad_lens, offset,
                                          k_scale, v_scale)
    route = decode_route(what, q, k_new, v_new, k_cache.dtype)
    if route != "bf16":
        wrapper = decode_attention_f32 if route == "f32" else decode_attention_mixed
        return wrapper(q, k_cache, v_cache, k_new, v_new, pad_lens, offset, k_scale, v_scale)
    B, Hq, Hkv, S, Dh, offset = _check_call(what, q, k_cache, v_cache, k_new, v_new, pad_lens,
                                            offset, k_scale, v_scale, "bf16")
    cache_bytes = CACHE_BYTES[k_cache.dtype]
    lib = _lib()
    smem = lib.lss_decode_attention_smem_bytes(Dh, Hq // Hkv, S, cache_bytes)
    if smem > MAX_SMEM:
        raise ValueError(f"{what}: S={S} needs {smem} bytes of shared memory "
                         f"(limit {MAX_SMEM})")
    out = torch.empty((B, 1, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    nsplit = dense_splits(B, Hkv, offset, sm_count(q.device.index))
    part = split_scratch(nsplit, B, Hkv, Hq // Hkv, Dh, q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
            k_new.data_ptr(), v_new.data_ptr(), pad_lens.data_ptr(), offset, out.data_ptr(),
            ptr(part), nsplit, B, Hq, Hkv, S, Dh, cache_bytes, strides, Dh ** -0.5, stream)
    count_launch(decode_attention)
    check_status(status, what)
    return out


def decode_attention_f32(q, k_cache, v_cache, k_new, v_new, pad_lens, offset, k_scale=None,
                         v_scale=None):
    """B8's float32 instance: float32 q (B, 1, Hq, Dh) and fresh k/v over
    one layer's float32, bfloat16 or int8 cache; returns a float32 out.
    Arguments as ``decode_attention``."""
    return _launch_body(decode_attention_f32, "f32", q, k_cache, v_cache, k_new, v_new, pad_lens,
                        offset, k_scale, v_scale)


def decode_attention_mixed(q, k_cache, v_cache, k_new, v_new, pad_lens, offset, k_scale=None,
                           v_scale=None):
    """B8's mixed instance: a bfloat16 q (B, 1, Hq, Dh) and fresh k/v over
    one layer's float32 cache, each cached value and p over the cache
    rounded to bf16 as the TPU kernel casts them; returns a bfloat16 out.
    Arguments as ``decode_attention``."""
    return _launch_body(decode_attention_mixed, "mixed", q, k_cache, v_cache, k_new, v_new,
                        pad_lens, offset, k_scale, v_scale)


def _launch_body(wrapper, route, q, k_cache, v_cache, k_new, v_new, pad_lens, offset, k_scale,
                 v_scale):
    """B8 through the float32 decode library on the ``route`` ("f32" or
    "mixed"): the plain version for CPU tensors."""
    what = wrapper.__name__
    if _devices(what, (q, k_cache, v_cache, k_new, v_new, pad_lens)) == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, k_new, v_new, pad_lens, offset,
                                          k_scale, v_scale)
    B, Hq, Hkv, S, Dh, offset = _check_call(what, q, k_cache, v_cache, k_new, v_new, pad_lens,
                                            offset, k_scale, v_scale, route)
    # looked up on fused_decode at each call, where a caller may force it
    nsplit = fused_decode.f32_splits(B, Hkv, offset, sm_count(q.device.index))
    part = split_scratch(nsplit, B, Hkv, Hq // Hkv, Dh, q.device)
    # the one-layer view as a cache of one layer, every row at `offset`
    return launch_f32(wrapper, q, k_cache[None], v_cache[None],
                      None if k_scale is None else k_scale[None],
                      None if v_scale is None else v_scale[None], k_new, v_new, pad_lens,
                      nsplit, part, offset=offset)


def _check_call(what, q, k_cache, v_cache, k_new, v_new, pad_lens, offset, k_scale, v_scale,
                route):
    """The checks of a CUDA call of the ``route``; returns (B, Hq, Hkv, S,
    Dh, offset)."""
    if k_cache.dim() != 4 or q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{what}: the kernel takes q (B, 1, Hq, Dh) and one layer's "
                         f"(B, Hkv, S, Dh) cache; got q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}")
    B, _, Hq, Hkv, S, Dh = check_decode_operands(
        what, q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
        tuple(k_cache.shape[:3]), route)
    return B, Hq, Hkv, S, Dh, _check_offset(offset, S)


decode_attention.launches = 0
decode_attention_f32.launches = 0
decode_attention_mixed.launches = 0


def _lib():
    lib = load_library("decode_attention", SOURCES)
    fn = lib.lss_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i, p, p] + [i] * 7 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_decode_attention_smem_bytes.argtypes = [i] * 4
        lib.lss_decode_attention_smem_bytes.restype = ctypes.c_longlong
    return lib
