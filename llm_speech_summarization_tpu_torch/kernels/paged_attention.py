"""Paged decode attention (kernel B4): wrapper, plain version, launch count.

Port of ``llm_speech_summarization_tpu/kernels/paged_attention.py::
paged_decode_attention``. The CUDA kernel is ``csrc/paged_attention.cu``,
the paged instance of the split-S decode body that B2, B3, B5 and B8 share
(``csrc/dense_decode.cuh``): as for the dense kernels, the wrapper picks the
number of blocks per (sample, kv head) window with ``fused_decode.
dense_splits``, from the host-side bound ``mp * ps`` of the windows, and
allocates the float32 scratch their results are merged from.

q (B, T, Hq, Dh) with T >= 1 fresh queries; one layer's page-major pools
(P, Hkv, ps, Dh), int8 with bf16 per-slot scales (P, Hkv, ps) or bf16
without; page_table (B, mp) int32; lengths/pad_lens (B,) int32; k_new/v_new
(B, T, Hkv, Dh). Every query attends its row's cached positions
``pad <= pos < length`` (position ``pos`` at page ``page_table[b, pos //
ps]``, slot ``pos % ps``) plus the fresh block causally. Nothing is
written: the caller scatters the fresh tokens (``infer/paged.py::
write_tokens``).

A float32 query takes ``paged_decode_attention_f32`` (its own launch
count), the paged read-only instance of the float32 decode library
(``csrc/decode_f32.cu``, ``fused_decode.launch_f32``), over int8, float32
or bfloat16 pools; its output is float32, its split count the float32
body's rule (``fused_decode.f32_splits``). Its shared memory does not grow
with the page size: it streams chunks of 32 slots, each slot through its
page. A bfloat16 query over float32 pools takes
``paged_decode_attention_mixed`` (its own launch count), the same
library's bf16-query instance (each cached value and p over the pages
rounded to bf16, as the TPU kernel casts them; a bfloat16 output).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import fused_decode
from .build import check_status, count_launch, load_library
from .fused_decode import (
    CACHE_TYPES,
    MAX_ROWS,
    MAX_SMEM,
    NEG_INF,
    _devices,
    ROUTE_QUERY,
    cache_type_error,
    check_separate_storage,
    decode_route,
    launch_f32,
)

SOURCES = ("paged_attention.cu", "dense_decode.cuh", "int8.cuh", "flash_sm90.cuh")


def _operands(*tensors):
    """The tensors of a paged call (scales may be None)."""
    return [t for t in tensors if t is not None]


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
    what = "paged_decode_attention"
    if _devices(what, _operands(q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
                                pad_lens, k_new, v_new)) == "cpu":
        return paged_reference(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                               k_scale, v_scale)
    route = decode_route(what, q, k_new, v_new, k_pool.dtype)
    if route != "bf16":
        wrapper = paged_decode_attention_f32 if route == "f32" else paged_decode_attention_mixed
        return wrapper(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new, k_scale,
                       v_scale)
    return _launch(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new, k_scale,
                   v_scale)


def paged_decode_attention_f32(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                               k_scale=None, v_scale=None):
    """B4's float32 instance: float32 q and fresh k/v over one layer's int8,
    float32 or bfloat16 pools; returns a float32 (B, T, Hq, Dh). Arguments
    as ``paged_decode_attention``."""
    return _launch_body(paged_decode_attention_f32, "f32", q, k_pool, v_pool, page_table,
                        lengths, pad_lens, k_new, v_new, k_scale, v_scale)


def paged_decode_attention_mixed(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                                 k_scale=None, v_scale=None):
    """B4's mixed instance: a bfloat16 q and fresh k/v over one layer's
    float32 pools, each cached value and p over the pages rounded to bf16
    as the TPU kernel casts them; returns a bfloat16 (B, T, Hq, Dh).
    Arguments as ``paged_decode_attention``."""
    return _launch_body(paged_decode_attention_mixed, "mixed", q, k_pool, v_pool, page_table,
                        lengths, pad_lens, k_new, v_new, k_scale, v_scale)


def _launch_body(wrapper, route, q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                 k_scale, v_scale):
    """B4 through the float32 decode library on the ``route`` ("f32" or
    "mixed"): the plain version for CPU tensors."""
    what = wrapper.__name__
    if _devices(what, _operands(q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
                                pad_lens, k_new, v_new)) == "cpu":
        return paged_reference(q, k_pool, v_pool, page_table, lengths, pad_lens, k_new, v_new,
                               k_scale, v_scale)
    B, T, Hq, Hkv, P, ps, mp, Dh, int8_pools = check_paged_operands(
        what, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, pad_lens, k_new, v_new,
        pool_lead=(), route=route)
    nsplit, part = paged_splits(B, T, Hq, Hkv, ps, mp, Dh, q.device, route)
    # one layer's pools as pools of one layer
    return launch_f32(wrapper, q, k_pool[None], v_pool[None],
                      k_scale[None] if int8_pools else None,
                      v_scale[None] if int8_pools else None, k_new, v_new, pad_lens, nsplit,
                      part, offsets=lengths, page_table=page_table, P=P, ps=ps, mp=mp)


paged_decode_attention.launches = 0
paged_decode_attention_f32.launches = 0
paged_decode_attention_mixed.launches = 0


def _lib():
    lib = load_library("paged_attention", SOURCES)
    fn = lib.lss_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 10 + [p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.lss_paged_attention_smem_bytes.argtypes = [i] * 5
        lib.lss_paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def check_paged_operands(what, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
                         pad_lens, k_new, v_new, pool_lead, route="bf16"):
    """Shape, type and layout checks shared by B4 and B5 on the ``route``
    (q and fresh k/v of its query dtype, pools of a type it takes).
    ``pool_lead`` is the pools' leading shape, () for B4's layer views and
    (L,) for B5. Returns (B, T, Hq, Hkv, P, ps, mp, Dh, int8_pools)."""
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
    if k_pool.dtype not in CACHE_TYPES[route] or v_pool.dtype != k_pool.dtype:
        raise cache_type_error(what, route, k_pool, v_pool, kind="pool")
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
            raise ValueError(f"{what}: {k_pool.dtype} pools take no scales")
        check_separate_storage(what, (k_pool, v_pool))
    dtype = ROUTE_QUERY[route]
    for name, t, heads in (("q", q, Hq), ("k_new", k_new, Hkv), ("v_new", v_new, Hkv)):
        if t.dtype != dtype or tuple(t.shape) != (B, T, heads, Dh) or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be ({B}, {T}, {heads}, {Dh}) "
                             f"{str(dtype)[6:]} with a unit last stride")
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


def paged_splits(B: int, T: int, Hq: int, Hkv: int, ps: int, mp: int, Dh: int, device,
                 route: str = "bf16"):
    """(nsplit, scratch) of a B4 or B5 launch: the dense kernels' rule of
    the ``route`` (the bf16 body's ``dense_splits``, the float32 body's
    ``f32_splits`` for "f32" and "mixed") with the windows' host-side bound
    ``mp * ps`` (looked up on ``fused_decode`` at each call, where a caller
    may force it), and the float32 scratch for the split results (None for
    one split)."""
    sms = fused_decode.sm_count(device.index)
    rule = fused_decode.dense_splits if route == "bf16" else fused_decode.f32_splits
    nsplit = rule(B, Hkv, mp * ps, sms)
    return nsplit, fused_decode.split_scratch(nsplit, B, Hkv, T * (Hq // Hkv), Dh, device)


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
    nsplit, part = paged_splits(B, T, Hq, Hkv, ps, mp, Dh, q.device)
    strides = (ctypes.c_longlong * 9)(*(q.stride()[:3] + k_new.stride()[:3]
                                        + v_new.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.lss_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8_pools else None, v_scale.data_ptr() if int8_pools else None,
            page_table.data_ptr(), lengths.data_ptr(), pad_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(), nsplit,
            B, T, Hq, Hkv, P, ps, mp, Dh, int(int8_pools), strides, Dh ** -0.5, stream)
    count_launch(paged_decode_attention)
    check_status(status, "paged_decode_attention")
    return out
