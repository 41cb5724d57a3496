"""Paged decode attention (kernel B4): wrapper, plain version, launch count.

Port of ``llm_speech_summarization_tpu/kernels/paged_attention.py::
paged_decode_attention``. The CUDA kernel is ``csrc/paged_attention.cu``
(its design is in ``csrc/paged_common.cuh``, shared with B5).

q (B, T, Hq, Dh) with T >= 1 fresh queries; one layer's page-major pools
(P, Hkv, ps, Dh), int8 with bf16 per-slot scales (P, Hkv, ps) or bf16
without; page_table (B, mp) int32; lengths/pad_lens (B,) int32; k_new/v_new
(B, T, Hkv, Dh). Every query attends its row's cached positions
``pad <= pos < length`` (position ``pos`` at page ``page_table[b, pos //
ps]``, slot ``pos % ps``) plus the fresh block causally. Nothing is
written: the caller scatters the fresh tokens (``infer/paged.py::
write_tokens``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import check_status, count_launch, load_library
from .fused_decode import MAX_ROWS, MAX_SMEM, NEG_INF, check_separate_storage

SOURCES = ("paged_attention.cu", "paged_common.cuh", "int8.cuh")


def paged_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    pad_lens: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``paged_reference``): gather each
    row's pages into a dense cache, dequantize int8 through the gathered
    scales, and run masked attention over [pad, length) plus the causal
    fresh block. Products of ``q.dtype`` operands are summed in float32."""
    B, T, Hq, Dh = q.shape
    P, Hkv, ps, _ = k_pool.shape
    mp = page_table.shape[1]
    S = mp * ps
    G = Hq // Hkv
    dev = q.device
    table = page_table.long()
    kd = k_pool[table].transpose(1, 2).reshape(B, Hkv, S, Dh)  # (B, Hkv, S, Dh)
    vd = v_pool[table].transpose(1, 2).reshape(B, Hkv, S, Dh)
    if k_scale is not None:
        ksg = k_scale[table].transpose(1, 2).reshape(B, Hkv, S)
        vsg = v_scale[table].transpose(1, 2).reshape(B, Hkv, S)
        kd = (kd.float() * ksg[..., None].float()).to(q.dtype)
        vd = (vd.float() * vsg[..., None].float()).to(q.dtype)
    # merged (T, G) query rows per kv head
    qg = q.reshape(B, T, Hkv, G, Dh).transpose(1, 2).reshape(B, Hkv, T * G, Dh)
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), kd.to(q.dtype).float()) * (Dh ** -0.5)
    pos = torch.arange(S, device=dev)
    valid = (pos[None, :] >= pad_lens[:, None]) & (pos[None, :] < lengths[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, device=dev))
    kn = k_new.transpose(1, 2).float()  # (B, Hkv, T, Dh)
    vn = v_new.transpose(1, 2).float()
    s_new = torch.einsum("bhgd,bhtd->bhgt", qg.float(), kn) * (Dh ** -0.5)
    tq = torch.arange(T * G, device=dev) // G
    causal = tq[:, None] >= torch.arange(T, device=dev)[None, :]
    s_new = torch.where(causal[None, None], s_new, torch.full((), NEG_INF, device=dev))
    m = torch.maximum(s.amax(-1, keepdim=True), s_new.amax(-1, keepdim=True))
    p = torch.exp(s - m)
    p_new = torch.exp(s_new - m)
    denom = p.sum(-1, keepdim=True) + p_new.sum(-1, keepdim=True)
    pv = torch.einsum("bhgs,bhsd->bhgd", p.to(q.dtype).float(), vd.to(q.dtype).float())
    pv = pv + torch.einsum("bhgt,bhtd->bhgd", p_new, vn)
    out = (pv / denom).reshape(B, Hkv, T, G, Dh).transpose(1, 2)
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    pad_lens: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over a paged KV cache for T >= 1 fresh queries; returns
    (B, T, Hq, Dh). CPU tensors take the plain version, CUDA tensors the
    kernel; the wrapper never reads device values."""
    tensors = [q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new]
    devices = {t.device.type for t in tensors + [s for s in (k_scale, v_scale) if s is not None]}
    if devices == {"cpu"}:
        return paged_reference(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                               k_scale, v_scale)
    if devices == {"cuda"}:
        return _launch(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                       k_scale, v_scale)
    raise ValueError(
        f"paged_decode_attention: tensors on {sorted(devices)}; need all cpu or all cuda")


paged_decode_attention.launches = 0


def _lib():
    lib = load_library("paged_attention", SOURCES)
    fn = lib.lss_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 9 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_paged_attention_smem_bytes.argtypes = [i] * 5
        lib.lss_paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def check_paged_operands(what, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
                         pad_lens, k_new, v_new, pool_lead):
    """Shape, type and layout checks shared by B4 and B5. ``pool_lead`` is
    the pools' leading shape, () for B4's layer views and (L,) for B5.
    Returns (B, T, Hq, Hkv, P, ps, mp, Dh, int8_pools)."""
    if q.dim() != 4 or k_pool.dim() != 4 + len(pool_lead):
        raise ValueError(f"{what}: q must be (B, T, Hq, Dh), pools {pool_lead} + (P, Hkv, ps, Dh)")
    B, T, Hq, Dh = q.shape
    P, Hkv, ps = k_pool.shape[-4:-1]
    if tuple(k_pool.shape[:len(pool_lead)]) != tuple(pool_lead) or k_pool.shape[-1] != Dh \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"{what}: pool shapes {tuple(k_pool.shape)}, {tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hq % Hkv or Dh not in (64, 128) or T < 1 or T * (Hq // Hkv) > MAX_ROWS:
        raise ValueError(f"{what}: the kernel takes Dh in (64, 128) and 1 <= T * Hq / Hkv <= "
                         f"{MAX_ROWS}; got T={T} Hq={Hq} Hkv={Hkv} Dh={Dh}")
    if ps % 16 or not 16 <= ps <= 256:
        raise ValueError(f"{what}: the kernel takes page sizes 16..256 in steps of 16, got {ps}")
    int8_pools = k_pool.dtype == torch.int8
    if k_pool.dtype not in (torch.int8, torch.bfloat16) or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{what}: pools must be int8 or bfloat16, got {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{what}: pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{what}: pools must start 16-byte aligned")
    if int8_pools:
        shape = tuple(k_pool.shape[:-1])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                    or not t.is_contiguous():
                raise ValueError(f"{what}: int8 pools need a contiguous {shape} bfloat16 {name}")
        check_separate_storage(what, (k_pool, v_pool, k_scale, v_scale))
    else:
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"{what}: bfloat16 pools take no scales")
        check_separate_storage(what, (k_pool, v_pool))
    for name, t, heads in (("q", q, Hq), ("k_new", k_new, Hkv), ("v_new", v_new, Hkv)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (B, T, heads, Dh) or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be ({B}, {T}, {heads}, {Dh}) bfloat16 with a "
                             f"unit last stride")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != B \
            or not page_table.is_contiguous():
        raise ValueError(f"{what}: page_table must be a contiguous ({B}, mp) int32 tensor")
    for name, t in (("lengths", lengths), ("pad_lens", pad_lens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({B},) int32 tensor")
    operands = [q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new]
    if len({t.device for t in operands + ([k_scale, v_scale] if int8_pools else [])}) != 1:
        raise ValueError(f"{what}: all tensors must be on one device")
    return B, T, Hq, Hkv, P, ps, page_table.shape[1], Dh, int8_pools


def _launch(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new, k_scale, v_scale):
    B, T, Hq, Hkv, P, ps, mp, Dh, int8_pools = check_paged_operands(
        "paged_decode_attention", q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
        pad_lens, k_new, v_new, pool_lead=())
    lib = _lib()
    smem = lib.lss_paged_attention_smem_bytes(Dh, T, Hq // Hkv, ps, int(int8_pools))
    if smem > MAX_SMEM:
        raise ValueError(f"paged_decode_attention: T={T} ps={ps} needs {smem} bytes of shared "
                         f"memory (limit {MAX_SMEM})")
    out = torch.empty((B, T, Hq, Dh), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    null = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8_pools else null, v_scale.data_ptr() if int8_pools else null,
            page_table.data_ptr(), lengths.data_ptr(), pad_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, P, ps, mp, Dh, int(int8_pools),
            strides, Dh ** -0.5, stream)
    count_launch(paged_decode_attention)
    check_status(status, "paged_decode_attention")
    return out
