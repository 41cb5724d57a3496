"""Absorbed latent (MLA) decode attention over an int8 latent cache with the
fresh latents written in place (kernel K2): wrapper, plain version, launch
count.

K2 replaces no TPU kernel (the JAX package has no latent attention); it is
B2's analogue (``fused_decode``) for DeepSeek-V3's latent cache, and its
CUDA source, ``csrc/latent_decode.cu``, says what bounds it on the H100 and
how its design meets that (``latent_splits`` sets its split).

For layer ``layer``, each of the T >= 1 fresh tokens' Hq absorbed queries
q = [q_c (R) | q_pe (Dr)] attends the cached slots ``pad <= s < offset``
(key [c | k_pe] dequantized per row, value c) plus the fresh latents
causally, at softmax scale ``scale``; p over the cache is weighted by the
c scale and rounded to q's dtype, as B2 rounds it. The fresh c (B, T, R)
and k_pe (B, T, Dr) are then quantized like ``_quantize_kv`` and written
at slots [offset, offset + T) with their scales. The cache is (L, B, 1, S,
R) and (L, B, 1, S, Dr) int8 with (L, B, 1, S) bf16 scales; the output is
the latent (B, T, Hq, R) in q's dtype. On the card: bfloat16, Hq = 16, R =
512, Dr = 64 (Moonlight-16B-A3B); the plain version takes any widths and
float32 too.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_status, count_launch, load_library
from .fused_decode import MAX_SMEM, NEG_INF, _devices, _quantize_kv, sm_count

SOURCES = ("latent_decode.cu", "int8.cuh")
HEADS, LATENT, ROPE = 16, 512, 64  # the kernel's widths
MAX_SPLITS = 8  # the most its merge kernel takes
BLOCKS_PER_SM = 2  # ~100 KB of shared memory a block
CHUNK = 64  # slots a block stages at a time


def latent_splits(windows: int, max_offset: int, sms: int) -> int:
    """Blocks that share each (sample, fresh token) window: as many as keep
    the grid within one wave of ``BLOCKS_PER_SM`` blocks an SM, at most
    ``MAX_SPLITS``, each split keeping a chunk of slots or more."""
    return max(1, min(MAX_SPLITS, BLOCKS_PER_SM * sms // windows, int(max_offset) // CHUNK))


def _check_bound(max_offset: int, T: int, S: int) -> None:
    if max_offset + T > S:
        raise ValueError(f"latent_decode: offsets + T = {max_offset} + {T} exceeds the cache "
                         f"length S = {S}; the fresh tokens would not fit")


def latent_decode_reference(q, c_cache, c_scale, pe_cache, pe_scale, c_new, pe_new, pad_lens,
                            offsets, layer: int, scale: float):
    """Plain PyTorch version of K2 (see the module docstring); reads no
    device value on the host."""
    B, T, H, _ = q.shape
    R, S = c_cache.shape[-1], c_cache.shape[3]
    dev = q.device
    qf = q.float()
    q_c, q_pe = qf[..., :R], qf[..., R:]
    cc, pc = c_cache[layer, :, 0], pe_cache[layer, :, 0]  # (B, S, .) views
    cs, ps = c_scale[layer, :, 0].float(), pe_scale[layer, :, 0].float()  # (B, S)
    s_c = (torch.einsum("bthr,bsr->bths", q_c, cc.float()) * cs[:, None, None, :]
           + torch.einsum("bthd,bsd->bths", q_pe, pc.float()) * ps[:, None, None, :]) * scale
    slot = torch.arange(S, device=dev)[None, :]
    valid = (slot >= pad_lens[:, None]) & (slot < offsets[:, None])  # (B, S)
    s_c = torch.where(valid[:, None, None, :], s_c, torch.full((), NEG_INF, device=dev))
    cn, pn = c_new.float(), pe_new.float()
    s_f = (torch.einsum("bthr,bjr->bthj", q_c, cn)
           + torch.einsum("bthd,bjd->bthj", q_pe, pn)) * scale
    causal = torch.arange(T, device=dev)[:, None] >= torch.arange(T, device=dev)[None, :]
    s_f = torch.where(causal[None, :, None, :], s_f, torch.full((), NEG_INF, device=dev))
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_f.amax(-1, keepdim=True))
    p_c, p_f = torch.exp(s_c - m), torch.exp(s_f - m)
    denom = p_c.sum(-1, keepdim=True) + p_f.sum(-1, keepdim=True)
    p_eff = (p_c * cs[:, None, None, :]).to(q.dtype).float()
    pv = (torch.einsum("bths,bsr->bthr", p_eff, cc.float())
          + torch.einsum("bthj,bjr->bthr", p_f.to(q.dtype).float(), cn))
    out = (pv / denom).to(q.dtype)
    rows = torch.arange(B, device=dev)[:, None]
    cols = offsets.long()[:, None] + torch.arange(T, device=dev)[None, :]
    for new, cache, scales in ((c_new, cc, c_scale[layer, :, 0]),
                               (pe_new, pc, pe_scale[layer, :, 0])):
        vals, sc = _quantize_kv(new)
        cache[rows, cols] = vals
        scales[rows, cols] = sc
    return out


def _lib():
    lib = load_library("latent_decode", SOURCES)
    fn = lib.lss_latent_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 5 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_latent_decode_smem_bytes.argtypes = []
        lib.lss_latent_decode_smem_bytes.restype = ctypes.c_longlong
    return lib


def latent_decode(q, c_cache, c_scale, pe_cache, pe_scale, c_new, pe_new, pad_lens, offsets,
                  layer: int, *, max_offset: int, scale: float) -> torch.Tensor:
    """K2 (see the module docstring). ``max_offset``: a host-side bound of
    ``offsets``, which the wrapper checks against the cache length (no
    device value is read)."""
    what = "latent_decode"
    B, T, H, DQ = q.shape
    L, S = c_cache.shape[0], c_cache.shape[3]
    _check_bound(int(max_offset), T, S)
    if _devices(what, (q, c_cache, c_scale, pe_cache, pe_scale, c_new, pe_new, pad_lens,
                       offsets)) == "cpu":
        return latent_decode_reference(q, c_cache, c_scale, pe_cache, pe_scale, c_new, pe_new,
                                       pad_lens, offsets, layer, scale)
    if (H, DQ) != (HEADS, LATENT + ROPE) or q.dtype != torch.bfloat16 or q.stride(-1) != 1:
        raise ValueError(f"{what}: the kernel takes a bfloat16 q (B, T, {HEADS}, "
                         f"{LATENT + ROPE}) with a unit last stride, got {q.dtype} "
                         f"{tuple(q.shape)}")
    shapes = {"c_cache": (c_cache, (L, B, 1, S, LATENT), torch.int8),
              "pe_cache": (pe_cache, (L, B, 1, S, ROPE), torch.int8),
              "c_scale": (c_scale, (L, B, 1, S), torch.bfloat16),
              "pe_scale": (pe_scale, (L, B, 1, S), torch.bfloat16),
              "c_new": (c_new, (B, T, LATENT), torch.bfloat16),
              "pe_new": (pe_new, (B, T, ROPE), torch.bfloat16),
              "pad_lens": (pad_lens, (B,), torch.int32), "offsets": (offsets, (B,), torch.int32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte aligned {shape} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    lib = _lib()
    if lib.lss_latent_decode_smem_bytes() > MAX_SMEM:
        raise ValueError(f"{what}: the kernel's shared memory exceeds {MAX_SMEM} bytes")
    nsplit = latent_splits(B * T, max_offset, sm_count(q.device.index))
    part = None
    if nsplit > 1:
        part = torch.empty((B * T, nsplit, HEADS, LATENT + 2), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((B, T, HEADS, LATENT), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 3)(*q.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_latent_decode(
            q.data_ptr(), c_cache.data_ptr(), c_scale.data_ptr(), pe_cache.data_ptr(),
            pe_scale.data_ptr(), c_new.data_ptr(), pe_new.data_ptr(), pad_lens.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
            nsplit, B, T, S, int(layer), strides, float(scale), stream)
    count_launch(latent_decode)
    check_status(status, what)
    return out


latent_decode.launches = 0
