"""Fused paged decode attention + in-place page write (kernel B5): wrapper,
plain version, launch count.

Port of ``llm_speech_summarization_tpu/kernels/fused_paged.py::
fused_paged_decode_write``. The CUDA kernel is ``csrc/fused_paged.cu``
(its attention is B4's, ``csrc/paged_common.cuh``).

For layer ``layer`` of the (L, P, Hkv, ps, Dh) pools, the T == 1 fresh
query attends the row's cached positions [pad, length) plus the fresh token
(B4 at T = 1); then the fresh k/v are quantized like ``_quantize_kv`` and
written in place, values and bf16 scales, at ``[layer, pid, :, length %
ps]`` with ``pid = page_table[b, length // ps]`` inside the table and the
null page 0 outside it (the routing of ``fused_paged_reference``: at
``length == ps * mp`` the token goes to page 0). ``lengths`` are not
advanced: the decoder owns progression.

The JAX kernel returns the fresh scales for one scatter after the layer
scan; both versions here write them in place like the values, which leaves
the same final state. bf16 pools take the fresh bf16 values and no scales.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import check_status, count_launch, load_library
from .fused_decode import MAX_SMEM, _quantize_kv
from .paged_attention import check_paged_operands, paged_reference

SOURCES = ("fused_paged.cu", "paged_common.cuh", "int8.cuh")


def _write_targets(page_table: torch.Tensor, lengths: torch.Tensor, ps: int):
    """(pid, slot) of each row's fresh token: the page of ``length`` in the
    row's table, or the null page 0 when ``length // ps`` is outside it."""
    mp = page_table.shape[1]
    page_idx = torch.div(lengths.long(), ps, rounding_mode="floor")
    slot = lengths.long() - page_idx * ps
    pid = page_table.long().gather(1, page_idx.clamp(0, mp - 1)[:, None])[:, 0]
    pid = torch.where((page_idx >= 0) & (page_idx < mp), pid, torch.zeros_like(pid))
    return pid, slot


def fused_paged_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    pad_lens: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``fused_paged_reference``):
    ``paged_reference`` over layer ``layer``, then the fresh token written
    in place. Returns the attention output (B, 1, Hq, Dh)."""
    quantized = k_scale is not None
    kp, vp = k_pool[layer], v_pool[layer]  # (P, Hkv, ps, Dh) views
    out = paged_reference(q, kp, vp, page_table, lengths, pad_lens, k_new, v_new,
                          k_scale[layer] if quantized else None,
                          v_scale[layer] if quantized else None)
    pid, slot = _write_targets(page_table, lengths, kp.shape[2])
    for new, pool, scales in ((k_new, kp, k_scale), (v_new, vp, v_scale)):
        x = new[:, 0].float()  # (B, Hkv, Dh)
        if quantized:
            vals, sc = _quantize_kv(x)
            pool[pid, :, slot] = vals
            scales[layer][pid, :, slot] = sc
        else:
            pool[pid, :, slot] = x.to(pool.dtype)
    return out


def fused_paged_decode(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    pad_lens: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """One paged decode step's attention for layer ``layer`` + the in-place
    write of the fresh token; returns out (B, 1, Hq, Dh).

    q (B, 1, Hq, Dh); pools (L, P, Hkv, ps, Dh); scales (L, P, Hkv, ps) or
    None for bf16 pools; page_table (B, mp) int32; lengths/pad_lens (B,)
    int32; k_new/v_new (B, 1, Hkv, Dh). The wrapper never reads device
    values."""
    tensors = [q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new]
    devices = {t.device.type for t in tensors + [s for s in (k_scale, v_scale) if s is not None]}
    if devices == {"cpu"}:
        return fused_paged_reference(q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
                                     pad_lens, k_new, v_new, layer)
    if devices == {"cuda"}:
        return _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, pad_lens,
                       k_new, v_new, layer)
    raise ValueError(
        f"fused_paged_decode: tensors on {sorted(devices)}; need all cpu or all cuda")


fused_paged_decode.launches = 0


def _lib():
    lib = load_library("fused_paged", SOURCES)
    fn = lib.lss_fused_paged
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 9 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_fused_paged_smem_bytes.argtypes = [i] * 4
        lib.lss_fused_paged_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, pad_lens, k_new, v_new,
            layer):
    L = k_pool.shape[0] if k_pool.dim() == 5 else 0
    B, T, Hq, Hkv, P, ps, mp, Dh, int8_pools = check_paged_operands(
        "fused_paged_decode", q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
        pad_lens, k_new, v_new, pool_lead=(L,))
    if T != 1:
        raise ValueError(f"fused_paged_decode: the kernel takes T == 1, got T={T}")
    if not 0 <= layer < L:
        raise ValueError(f"fused_paged_decode: layer {layer} outside [0, {L})")
    lib = _lib()
    smem = lib.lss_fused_paged_smem_bytes(Dh, Hq // Hkv, ps, int(int8_pools))
    if smem > MAX_SMEM:
        raise ValueError(f"fused_paged_decode: ps={ps} needs {smem} bytes of shared memory "
                         f"(limit {MAX_SMEM})")
    out = torch.empty((B, 1, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_fused_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8_pools else None, v_scale.data_ptr() if int8_pools else None,
            page_table.data_ptr(), lengths.data_ptr(), pad_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), B, Hq, Hkv, P, ps, mp, Dh, int(int8_pools),
            int(layer), strides, Dh ** -0.5, stream)
    count_launch(fused_paged_decode)
    check_status(status, "fused_paged_decode")
    return out
