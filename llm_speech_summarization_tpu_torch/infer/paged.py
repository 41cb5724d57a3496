"""Paged KV cache: fixed-size pages, a host-side allocator, device pools
(port of ``infer/paged.py``).

Pools are (L, P, Hkv, ps, Dh), page-major like the JAX package's: one page
slab holds every kv head of that page, and row b's position ``pos`` lives
at page ``page_table[b, pos // ps]``, slot ``pos % ps``. int8 pools carry
bf16 per-slot scales (L, P, Hkv, ps). Every pool and scale tensor is its
own allocation: the kernels write them in place.

Where the JAX functions return a new cache, these update the tensors in
place and return the same cache. Page 0 is the null page: tables are
0-padded, and writes for rows or positions outside a table go there.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels.fused_decode import _quantize_kv


class PagedKVCache(NamedTuple):
    k_pool: torch.Tensor  # (L, P, Hkv, ps, Dh) float/bf16, or int8 quantized
    v_pool: torch.Tensor
    page_table: torch.Tensor  # (B, max_pages) int32, 0-padded
    lengths: torch.Tensor  # (B,) int32 tokens written per row
    pad_lens: torch.Tensor  # (B,) int32 left pad inside the logical sequence
    k_scale: Optional[torch.Tensor] = None  # (L, P, Hkv, ps) bf16 iff int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pool.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_cache(
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    num_pages: int,
    page_size: int = 64,
    batch: int,
    max_pages_per_seq: int,
    dtype=torch.bfloat16,
    device=None,
) -> PagedKVCache:
    shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
    quantized = dtype == torch.int8

    def zeros(s, dt):
        return torch.zeros(s, dtype=dt, device=device)

    return PagedKVCache(
        k_pool=zeros(shape, dtype),
        v_pool=zeros(shape, dtype),
        page_table=zeros((batch, max_pages_per_seq), torch.int32),
        lengths=zeros((batch,), torch.int32),
        pad_lens=zeros((batch,), torch.int32),
        k_scale=zeros(shape[:-1], torch.bfloat16) if quantized else None,
        v_scale=zeros(shape[:-1], torch.bfloat16) if quantized else None,
    )


class PageAllocator:
    """Host-side free-list allocator over pool page ids. Page 0 is the null
    page, so allocation starts at id 1."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() -> 1 first

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"paged cache exhausted: want {n}, free {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if p:  # never recycle the null page
                self._free.append(int(p))


def pages_needed(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


def write_tokens(
    cache: PagedKVCache,
    k_new: torch.Tensor,  # (L, B, T, Hkv, Dh)
    v_new: torch.Tensor,
    positions: Optional[torch.Tensor] = None,  # (B, T); default lengths + [0..T)
    active: Optional[torch.Tensor] = None,  # (B,) bool; inactive rows → null page
) -> PagedKVCache:
    """Write T fresh tokens per row into its pages at ``positions`` (the
    speculative verification write). Lengths are not advanced; inactive
    rows and positions outside the table go to the null page 0; each token
    routes through the row's table on its own, across page boundaries."""
    L, B, T, Hkv, Dh = k_new.shape
    ps = cache.page_size
    mp = cache.page_table.shape[1]
    dev = k_new.device
    if positions is None:
        positions = cache.lengths[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None]
    positions = positions.long()
    page_idx = torch.div(positions, ps, rounding_mode="floor")  # (B, T)
    slot = positions - page_idx * ps
    pid = cache.page_table.long().gather(1, page_idx.clamp(0, mp - 1))
    # out of the table either way: a negative position would otherwise land
    # on the row's first real page and corrupt prompt K/V
    pid = torch.where((page_idx >= 0) & (page_idx < mp), pid, torch.zeros_like(pid))
    if active is not None:
        pid = torch.where(active[:, None], pid, torch.zeros_like(pid))
    # (B, T) indices on pool axes 1 and 3 are split by the head slice, so
    # the indexed view is (B, T, L, Hkv, Dh), as in numpy
    kt = k_new.permute(1, 2, 0, 3, 4)
    vt = v_new.permute(1, 2, 0, 3, 4)
    if cache.quantized:
        kq, ks = _quantize_kv(kt)
        vq, vs = _quantize_kv(vt)
        cache.k_pool[:, pid, :, slot] = kq
        cache.v_pool[:, pid, :, slot] = vq
        cache.k_scale[:, pid, :, slot] = ks
        cache.v_scale[:, pid, :, slot] = vs
    else:
        cache.k_pool[:, pid, :, slot] = kt.to(cache.k_pool.dtype)
        cache.v_pool[:, pid, :, slot] = vt.to(cache.v_pool.dtype)
    return cache


def write_prefill_pages_batch(
    cache: PagedKVCache,
    rows: Sequence[int],  # (n,) page-table rows; rows >= B are dropped
    pages: torch.Tensor,  # (n, n_pages) int32 page ids per sequence
    k_toks: torch.Tensor,  # (L, n, T, Hkv, Dh), T = n_pages * ps
    v_toks: torch.Tensor,
    pad_lens: torch.Tensor,  # (n,) int32
    k_scales: Optional[torch.Tensor] = None,  # (L, n, T, Hkv): k_toks already int8
    v_scales: Optional[torch.Tensor] = None,
) -> PagedKVCache:
    """Batched prefill write of n sequences into their pages, plus their
    table rows, lengths (T) and pads. For int8 pools pass pre-quantized
    values and scales, or raw tokens that quantize here. ``rows`` are host
    integers: a row past the table (the JAX scatter's ``mode="drop"``
    padding) writes its pages but no table entry."""
    L, n, T, Hkv, Dh = k_toks.shape
    ps = cache.page_size
    np_ = pages.shape[1]
    B, mp = cache.page_table.shape
    dev = cache.page_table.device

    def to_pages(x):  # (L, n, T, Hkv, Dh) -> (L, n*np_, Hkv, ps, Dh)
        return x.reshape(L, n, np_, ps, Hkv, Dh).transpose(3, 4).reshape(L, n * np_, Hkv, ps, Dh)

    def to_pages_s(x):  # (L, n, T, Hkv) -> (L, n*np_, Hkv, ps)
        return x.reshape(L, n, np_, ps, Hkv).transpose(3, 4).reshape(L, n * np_, Hkv, ps)

    flat = pages.reshape(-1).long().to(dev)
    kp, vp = to_pages(k_toks), to_pages(v_toks)
    if cache.quantized:
        if k_scales is not None:  # already quantized upstream
            kq, vq, ks, vs = kp, vp, to_pages_s(k_scales), to_pages_s(v_scales)
        else:
            kq, ks = _quantize_kv(kp)
            vq, vs = _quantize_kv(vp)
        cache.k_pool[:, flat] = kq
        cache.v_pool[:, flat] = vq
        cache.k_scale[:, flat] = ks
        cache.v_scale[:, flat] = vs
    else:
        cache.k_pool[:, flat] = kp.to(cache.k_pool.dtype)
        cache.v_pool[:, flat] = vp.to(cache.v_pool.dtype)
    keep = [i for i, r in enumerate(rows) if 0 <= int(r) < B]
    if keep:
        kept = torch.tensor([int(rows[i]) for i in keep], dtype=torch.long, device=dev)
        sel = torch.tensor(keep, dtype=torch.long, device=dev)
        table_rows = torch.zeros((len(keep), mp), dtype=torch.int32, device=dev)
        table_rows[:, :np_] = pages.to(device=dev, dtype=torch.int32)[sel]
        cache.page_table[kept] = table_rows
        cache.lengths[kept] = T
        cache.pad_lens[kept] = pad_lens.to(device=dev, dtype=torch.int32)[sel]
    return cache


def grow_pages(
    cache: PagedKVCache,
    allocator: PageAllocator,
    active_rows: List[int],
    lookahead: int = 1,
) -> Tuple[PagedKVCache, bool]:
    """Between decode chunks: give every active row pages covering
    positions [length, length + lookahead). Reads lengths and the table
    from the device. Returns (cache, grew); on MemoryError the partial
    grow is rolled back before the error propagates."""
    lengths = cache.lengths.cpu().numpy()
    table = None
    fresh: List[int] = []  # pids placed only in the local copy so far
    ps = cache.page_size
    try:
        for b in active_rows:
            first = int(lengths[b]) // ps
            last = (int(lengths[b]) + max(lookahead, 1) - 1) // ps
            for page_idx in range(first, min(last + 1, cache.page_table.shape[1])):
                if table is None:
                    table = cache.page_table.cpu().numpy().copy()
                if table[b, page_idx] == 0:
                    (pid,) = allocator.alloc(1)
                    fresh.append(pid)
                    table[b, page_idx] = pid
    except MemoryError:
        allocator.free(fresh)
        raise
    if not fresh:
        return cache, False
    cache.page_table.copy_(torch.from_numpy(table))
    return cache, True


def free_row(cache: PagedKVCache, allocator: PageAllocator, row: int) -> PagedKVCache:
    """Return a finished row's pages to the allocator and clear its table
    row, length and pad."""
    table = cache.page_table[row].cpu().numpy()
    allocator.free(table[table != 0].tolist())
    cache.page_table[row] = 0
    cache.lengths[row] = 0
    cache.pad_lens[row] = 0
    return cache
