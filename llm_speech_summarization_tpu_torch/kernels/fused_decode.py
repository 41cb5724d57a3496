"""Fused decode attention + in-place quantized cache write (kernel B2):
wrapper, plain version, launch count.

Port of ``llm_speech_summarization_tpu/kernels/fused_decode.py::
fused_decode_aliased_scales``. The CUDA kernel is ``csrc/fused_decode.cu``;
its header note says what bounds it on the H100 and how this first design
meets that.

For layer ``layer`` of the cache, each of the T >= 1 fresh queries attends
the slots ``pad <= s < offset`` plus the fresh block causally; then the
fresh k/v are quantized like ``_quantize_kv`` and written in place at
``[offset, offset + T)``, values and scales. The caller owns the cache
tensors; both versions mutate them and return the attention output.

The TPU kernel's lane-padded ``(L, B, Hkv, Spad)`` scale slabs and 32-row
write windows were TPU layout rules: here the scales are plain
``(L, B, Hkv, S)`` tensors written at exactly the fresh slots. Where the
TPU wrapper quietly ran its oracle for a cache shorter than its window,
this wrapper raises when ``offsets + T > S``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import check_status, count_launch, load_library

SOURCES = ("fused_decode.cu", "int8.cuh")
NEG_INF = -1e30
MAX_ROWS = 32  # T * (Hq / Hkv) query rows per block
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may use on sm_90


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
    """Plain PyTorch version (the JAX ``fused_reference`` math, which is
    ``decode_xla_q``'s): dense masked attention over the cache window plus
    the causal fresh block, then the fresh tokens written in place. Takes
    an int8 cache with scales, or a float cache with ``k_scale=None``."""
    B, T, Hq, Dh = q.shape
    L, _, Hkv, S, _ = k_cache.shape
    _check_offsets(int(offsets.max()), T, S)
    group = Hq // Hkv
    quantized = k_scale is not None
    dev = q.device
    kc, vc = k_cache[layer], v_cache[layer]  # (B, Hkv, S, Dh) views

    qg = q.reshape(B, T, Hkv, group, Dh).float()
    s_c = torch.einsum("bthgd,bhsd->bthgs", qg, kc.to(q.dtype).float())
    if quantized:
        s_c = s_c * k_scale[layer][:, None, :, None, :].float()
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
    p_eff = p_c * v_scale[layer][:, None, :, None, :].float() if quantized else p_c
    pv = torch.einsum("bthgs,bhsd->bthgd", p_eff.to(q.dtype).float(), vc.to(q.dtype).float())
    pv = pv + torch.einsum("bthgs,bshd->bthgd", p_f.to(q.dtype).float(),
                           v_new.to(q.dtype).float())
    out = (pv / denom).reshape(B, T, Hq, Dh).to(q.dtype)

    # fresh tokens → slots [offset, offset + T) of this layer, in place
    rows = torch.arange(B, device=dev)[:, None]
    cols = offsets.long()[:, None] + torch.arange(T, device=dev)[None, :]
    for new, cache, scales in ((k_new, kc, None if not quantized else k_scale[layer]),
                               (v_new, vc, None if not quantized else v_scale[layer])):
        if quantized:
            vals, sc = _quantize_kv(new)  # (B, T, Hkv, Dh), (B, T, Hkv)
            cache[rows, :, cols] = vals
            scales[rows, :, cols] = sc
        else:
            cache[rows, :, cols] = new.to(cache.dtype)
    return out


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
    """Decode attention for layer ``layer`` + in-place write of the fresh
    k/v; returns out (B, T, Hq, Dh).

    q (B, T, Hq, Dh); caches (L, B, Hkv, S, Dh); scales (L, B, Hkv, S);
    k_new/v_new (B, T, Hkv, Dh); pad_lens/offsets (B,) int32. On CUDA the
    wrapper does not read device values, so ``max_offset`` (the host-side
    bound of ``offsets``) is required to check ``offsets + T <= S``."""
    devices = {t.device.type for t in (q, k_cache, v_cache, k_new, v_new, pad_lens, offsets)}
    if devices == {"cpu"}:
        return fused_decode_reference(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                                      pad_lens, offsets, layer)
    if devices == {"cuda"}:
        return _launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens,
                       offsets, layer, max_offset)
    raise ValueError(f"fused_decode: tensors on {sorted(devices)}; need all cpu or all cuda")


fused_decode.launches = 0


def _lib():
    lib = load_library("fused_decode", SOURCES)
    fn = lib.lss_fused_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 7 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_fused_decode_smem_bytes.argtypes = [i, i, i, i]
        lib.lss_fused_decode_smem_bytes.restype = ctypes.c_longlong
    return lib


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


def _launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens, offsets, layer,
            max_offset):
    if k_cache.dtype != torch.int8 or k_scale is None or v_scale is None:
        raise NotImplementedError(
            "fused_decode on CUDA takes the int8 cache with scales; a float cache needs "
            "kernel B3 (ROADMAP queue B), not ported yet"
        )
    if q.dim() != 4 or k_cache.dim() != 5:
        raise ValueError("fused_decode: q must be (B, T, Hq, Dh), caches (L, B, Hkv, S, Dh)")
    B, T, Hq, Dh = q.shape
    L, _, Hkv, S, _ = k_cache.shape
    if k_cache.shape[1] != B or k_cache.shape[4] != Dh or v_cache.shape != k_cache.shape:
        raise ValueError(f"fused_decode: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv or Dh not in (64, 128) or T < 1 or T * (Hq // Hkv) > MAX_ROWS:
        raise ValueError(f"fused_decode: the kernel takes Dh in (64, 128) and "
                         f"1 <= T * Hq / Hkv <= {MAX_ROWS}; got T={T} Hq={Hq} Hkv={Hkv} Dh={Dh}")
    if not 0 <= layer < L:
        raise ValueError(f"fused_decode: layer {layer} outside [0, {L})")
    if v_cache.dtype != torch.int8 or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("fused_decode: caches must be contiguous int8")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.bfloat16 or t.shape != (L, B, Hkv, S) or not t.is_contiguous():
            raise ValueError(f"fused_decode: {name} must be a contiguous ({L}, {B}, {Hkv}, {S}) "
                             f"bfloat16 tensor")
    check_separate_storage("fused_decode", (k_cache, v_cache, k_scale, v_scale))
    for name, t, heads in (("q", q, Hq), ("k_new", k_new, Hkv), ("v_new", v_new, Hkv)):
        if t.dtype != torch.bfloat16 or t.shape != (B, T, heads, Dh) or t.stride(-1) != 1:
            raise ValueError(f"fused_decode: {name} must be ({B}, {T}, {heads}, {Dh}) bfloat16 "
                             f"with a unit last stride")
    for name, t in (("pad_lens", pad_lens), ("offsets", offsets)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"fused_decode: {name} must be a contiguous ({B},) int32 tensor")
    if max_offset is None:
        raise ValueError("fused_decode: pass max_offset (host-side bound of offsets) on CUDA")
    _check_offsets(int(max_offset), T, S)
    if len({t.device for t in (q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                               pad_lens, offsets)}) != 1:
        raise ValueError("fused_decode: all tensors must be on one device")
    lib = _lib()
    smem = lib.lss_fused_decode_smem_bytes(Dh, T, Hq // Hkv, S)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_decode: S={S} needs {smem} bytes of shared memory "
                         f"(limit {MAX_SMEM})")
    out = torch.empty((B, T, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_fused_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pad_lens.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, S, Dh, int(layer), strides,
            Dh ** -0.5, stream)
    count_launch(fused_decode)
    check_status(status, "fused_decode")
    return out
