"""The port's paged KV cache against the JAX package: the plain versions of
kernels B4 (paged decode attention) and B5 (fused paged decode + page
write) against the JAX kernels run in Pallas interpret mode and against
their XLA oracles, and ``infer/paged.py`` (allocator, token and prefill
writes, growth, release) bit for bit. Marked ``cuda``: each CUDA kernel
against its plain version on the card.

Tolerances are float32 (atol 1e-5): the same algorithm summed in another
order. Page writes are held bit-exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.infer import paged as jpaged
from llm_speech_summarization_tpu.kernels.fused_paged import (
    fused_paged_decode_write,
    fused_paged_reference as jax_fused_paged_reference,
)
from llm_speech_summarization_tpu.kernels.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
    paged_reference as jax_paged_reference,
)
from llm_speech_summarization_tpu_torch.bridge import tensor_from_numpy, tensor_to_numpy
from llm_speech_summarization_tpu_torch.infer import paged
from llm_speech_summarization_tpu_torch.kernels.fused_paged import (
    fused_paged_decode,
    fused_paged_reference,
)
from llm_speech_summarization_tpu_torch.kernels.paged_attention import (
    paged_decode_attention,
    paged_reference,
)

torch.set_num_threads(1)


def _pools(rng, shape, pools):
    """Random pools and per-slot scales: int8 with bf16 scales small enough
    that |int8 x scale| <= ~1.5 (a float32 atol of 1e-5 then measures the
    algorithm), or bf16 pools without scales."""
    if pools == "int8":
        kp = rng.randint(-127, 128, size=shape).astype(np.int8)
        vp = rng.randint(-127, 128, size=shape).astype(np.int8)
        ks = (0.002 + 0.01 * rng.rand(*shape[:-1])).astype(ml_dtypes.bfloat16)
        vs = (0.002 + 0.01 * rng.rand(*shape[:-1])).astype(ml_dtypes.bfloat16)
        return kp, vp, ks, vs
    kp = rng.randn(*shape).astype(ml_dtypes.bfloat16)
    vp = rng.randn(*shape).astype(ml_dtypes.bfloat16)
    return kp, vp, None, None


def _attn_case(seed, T, pools, B=4, Hq=6, Hkv=2, Dh=128, ps=128, mp=2):
    """The JAX tests' geometry (Dh 128, ps 128); rows: pad inside the first
    page, length % ps == 0, only the fresh block (length == pad), and a
    window starting on the second page."""
    rng = np.random.RandomState(seed)
    P = 1 + B * mp
    kp, vp, ks, vs = _pools(rng, (P, Hkv, ps, Dh), pools)
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads = np.array([5, 0, 3, ps + 7], np.int32)
    lengths = np.array([2 * ps - 9, ps, 3, mp * ps - T], np.int32)
    q = rng.randn(B, T, Hq, Dh).astype(np.float32)
    kn = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    vn = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    return q, kp, vp, table, lengths, pads, kn, vn, ks, vs


def _t(a):
    return None if a is None else tensor_from_numpy(a)


@pytest.mark.parametrize("oracle", ["interpret", "xla"])
@pytest.mark.parametrize("pools", ["int8", "bf16"])
@pytest.mark.parametrize("T", [1, 3])
def test_paged_plain_matches_jax(T, pools, oracle):
    case = _attn_case(T, T, pools)
    got = paged_decode_attention(*map(_t, case[:8]), k_scale=_t(case[8]), v_scale=_t(case[9]))
    args = [None if a is None else jnp.asarray(a) for a in case]
    if oracle == "interpret":
        want = jax_paged_decode_attention(*args[:8], k_scale=args[8], v_scale=args[9],
                                          interpret=True)
    else:
        want = jax_paged_reference(*args[:8], k_scale=args[8], v_scale=args[9])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _fused_case(seed, pools, L=2, B=5, Hq=6, Hkv=2, Dh=128, ps=128, mp=3):
    """Distinct pages per row (page 0 = null); lengths hit a page interior,
    a page's first slot (length % ps == 0), the last slot of the table, and
    the boundary length == ps * mp (the oracle writes it to page 0)."""
    rng = np.random.RandomState(seed)
    P = 1 + B * mp
    kp, vp, ks, vs = _pools(rng, (L, P, Hkv, ps, Dh), pools)
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads = rng.randint(0, 5, size=(B,)).astype(np.int32)
    lengths = np.array([17, ps, 2 * ps, mp * ps - 1, mp * ps], np.int32)
    q = rng.randn(B, 1, Hq, Dh).astype(np.float32)
    kn = rng.randn(B, 1, Hkv, Dh).astype(np.float32)
    vn = rng.randn(B, 1, Hkv, Dh).astype(np.float32)
    return q, kp, vp, ks, vs, table, lengths, pads, kn, vn


def _jax_fused(case, layer, oracle):
    """The JAX fused step as final (out, k_pool, v_pool, k_scale, v_scale)
    numpy arrays: the kernel's (or oracle's) fresh scales scattered after
    the call the way llama_forward does after its layer scan."""
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = case
    a = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    kw = dict(k_scale_layer=None if ks is None else a(ks[layer]),
              v_scale_layer=None if vs is None else a(vs[layer]))
    call_args = (a(q), a(kp), a(vp), a(table), a(lengths), a(pads), a(kn), a(vn),
                 jnp.int32(layer))
    if oracle == "interpret":
        res = fused_paged_decode_write(*call_args, interpret=True, **kw)
    else:
        res = jax_fused_paged_reference(*call_args, **kw)
    out, kp2, vp2 = (np.asarray(x) for x in res[:3])
    if ks is None:
        return out, kp2, vp2, None, None
    ps, mp = kp.shape[3], table.shape[1]
    page_idx = lengths // ps
    pid = np.where((page_idx >= 0) & (page_idx < mp),
                   table[np.arange(len(lengths)), np.clip(page_idx, 0, mp - 1)], 0)
    slot = lengths % ps
    ks2, vs2 = np.array(ks), np.array(vs)
    for b in range(len(lengths)):
        if oracle == "interpret" and page_idx[b] >= mp:
            continue  # the TPU kernel drops the boundary token; page 0 is not compared
        ks2[layer, pid[b], :, slot[b]] = np.asarray(res[3])[b]
        vs2[layer, pid[b], :, slot[b]] = np.asarray(res[4])[b]
    return out, kp2, vp2, ks2, vs2


def _as_f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("oracle", ["interpret", "xla"])
@pytest.mark.parametrize("pools", ["int8", "bf16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_fused_paged_plain_matches_jax(layer, pools, oracle):
    case = _fused_case(layer, pools)
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = case
    bufs = [_t(x) for x in (kp, vp, ks, vs)]
    out = fused_paged_decode(_t(q), *bufs, _t(table), _t(lengths), _t(pads), _t(kn), _t(vn),
                             layer)
    want = _jax_fused(case, layer, oracle)
    np.testing.assert_allclose(out.numpy(), want[0], atol=1e-5, rtol=0)
    for got, w, name in zip(bufs, want[1:], ("k_pool", "v_pool", "k_scale", "v_scale")):
        if got is None:
            continue
        # outside the null page, bit for bit
        np.testing.assert_array_equal(_as_f32(tensor_to_numpy(got))[:, 1:], _as_f32(w)[:, 1:],
                                      err_msg=name)


@pytest.mark.parametrize("pools", ["int8", "bf16"])
def test_fused_paged_plain_writes_only_fresh_slots(pools):
    layer = 1
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = _fused_case(7, pools)
    bufs = [_t(x) for x in (kp, vp, ks, vs)]
    snap = [None if b is None else b.clone() for b in bufs]
    fused_paged_decode(_t(q), *bufs, _t(table), _t(lengths), _t(pads), _t(kn), _t(vn), layer)
    ps, mp = kp.shape[3], table.shape[1]
    written = torch.zeros(kp.shape[:4], dtype=torch.bool)
    for b, n in enumerate(lengths):
        pid = table[b, n // ps] if n // ps < mp else 0
        written[layer, pid, :, n % ps] = True
    assert written[layer, 0].any()  # the boundary row went to page 0
    for got, old in zip(bufs, snap):
        if got is None:
            continue
        assert torch.equal(got[~written], old[~written])
        assert not torch.equal(got[:, 1:][written[:, 1:]], old[:, 1:][written[:, 1:]])


def test_page_allocator_matches_jax():
    ours, theirs = paged.PageAllocator(9), jpaged.PageAllocator(9)
    for op, arg in (("alloc", 3), ("free", [2, 0]), ("alloc", 2), ("free", [5, 1]),
                    ("alloc", 4)):
        assert getattr(ours, op)(arg) == getattr(theirs, op)(arg)
        assert ours.free_pages == theirs.free_pages
    with pytest.raises(MemoryError):
        ours.alloc(ours.free_pages + 1)
    for n in (1, 64, 65, 128, 129):
        assert paged.pages_needed(n, 64) == jpaged.pages_needed(n, 64)


def _cache_pair(dtype, L=2, Hkv=2, Dh=8, ps=4, mp=4, B=3, seed=0):
    """The same random paged cache in both packages, tables distinct per row."""
    rng = np.random.RandomState(seed)
    P = 1 + B * mp
    if dtype == "int8":
        kp, vp, ks, vs = _pools(rng, (L, P, Hkv, ps, Dh), "int8")
    else:
        kp = rng.randn(L, P, Hkv, ps, Dh).astype(np.float32)
        vp = rng.randn(L, P, Hkv, ps, Dh).astype(np.float32)
        ks = vs = None
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    lengths = np.array([3, 6, 9], np.int32)[:B]
    pads = np.array([0, 1, 2], np.int32)[:B]
    fields = (kp, vp, table, lengths, pads, ks, vs)
    jc = jpaged.PagedKVCache(*(None if a is None else jnp.asarray(a) for a in fields))
    tc = paged.PagedKVCache(*(_t(a) for a in fields))
    return jc, tc


def _assert_cache_equal(tc, jc, skip_null_page=False):
    for f in paged.PagedKVCache._fields:
        got, want = getattr(tc, f), getattr(jc, f)
        if want is None:
            assert got is None
            continue
        g, w = _as_f32(tensor_to_numpy(got)), _as_f32(want)
        if skip_null_page and f in ("k_pool", "v_pool", "k_scale", "v_scale"):
            g, w = g[:, 1:], w[:, 1:]
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_write_tokens_matches_jax(dtype):
    """Positions straddle a page boundary (row 0), run mid-page (row 1) and
    off the end of the table (row 2, → null page); one row inactive in the
    second write."""
    jc, tc = _cache_pair(dtype)
    L, B, T, Hkv, Dh = 2, 3, 3, 2, 8
    ps, mp = 4, 4
    rng = np.random.RandomState(1)
    positions = np.array([[3, 4, 5], [6, 7, 8], [mp * ps - 2, mp * ps - 1, mp * ps]], np.int32)
    kn = rng.randn(L, B, T, Hkv, Dh).astype(np.float32)
    vn = rng.randn(L, B, T, Hkv, Dh).astype(np.float32)
    jc = jpaged.write_tokens(jc, jnp.asarray(kn), jnp.asarray(vn), positions=jnp.asarray(positions))
    tc = paged.write_tokens(tc, _t(kn), _t(vn), positions=_t(positions))
    _assert_cache_equal(tc, jc, skip_null_page=True)
    # default positions (lengths + [0..T)) and an inactive row
    active = np.array([True, False, True])
    kn2, vn2 = kn[:, :, :2] * 2, vn[:, :, :2] * 2
    jc = jpaged.write_tokens(jc, jnp.asarray(kn2), jnp.asarray(vn2), active=jnp.asarray(active))
    tc = paged.write_tokens(tc, _t(kn2), _t(vn2), active=_t(active))
    _assert_cache_equal(tc, jc, skip_null_page=True)


@pytest.mark.parametrize("dtype,prequantized", [("int8", False), ("int8", True),
                                                ("float32", False)])
def test_write_prefill_pages_batch_matches_jax(dtype, prequantized):
    jc, tc = _cache_pair(dtype)
    L, Hkv, Dh, ps = 2, 2, 8, 4
    rng = np.random.RandomState(2)
    rows = np.array([2, 0, 3], np.int32)  # row 3 is past the table: dropped
    pages = np.array([[3, 7], [11, 1], [0, 0]], np.int32)
    T = pages.shape[1] * ps
    toks = [rng.randn(L, 3, T, Hkv, Dh).astype(np.float32) for _ in range(2)]
    pads = np.array([1, 3, 0], np.int32)
    kw_j, kw_t = {}, {}
    if prequantized:
        from llm_speech_summarization_tpu.models.llama import _quantize_kv

        q = [_quantize_kv(jnp.asarray(x)) for x in toks]
        toks = [np.asarray(v) for v, _ in q]
        scales = [np.asarray(s) for _, s in q]
        kw_j = dict(k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]))
        kw_t = dict(k_scales=_t(scales[0]), v_scales=_t(scales[1]))
    jc = jpaged.write_prefill_pages_batch(jc, jnp.asarray(rows), jnp.asarray(pages),
                                          jnp.asarray(toks[0]), jnp.asarray(toks[1]),
                                          jnp.asarray(pads), **kw_j)
    tc = paged.write_prefill_pages_batch(tc, rows.tolist(), _t(pages), _t(toks[0]),
                                         _t(toks[1]), _t(pads), **kw_t)
    _assert_cache_equal(tc, jc, skip_null_page=True)


def test_grow_and_free_row_match_jax():
    jc, tc = _cache_pair("float32")
    # row 1's table is sparse: positions [6, 6 + 3) need pages 1 and 2
    table = np.array(jc.page_table)
    table[1, 1:] = 0
    jc = jc._replace(page_table=jnp.asarray(table))
    tc = tc._replace(page_table=_t(table))
    ja, ta = jpaged.PageAllocator(32), paged.PageAllocator(32)
    ja.alloc(13), ta.alloc(13)  # the pages the tables already hold
    jc, jgrew = jpaged.grow_pages(jc, ja, [0, 1, 2], lookahead=3)
    tc, tgrew = paged.grow_pages(tc, ta, [0, 1, 2], lookahead=3)
    assert jgrew and tgrew and ta.free_pages == ja.free_pages
    _assert_cache_equal(tc, jc)
    # nothing to grow: the cache comes back untouched
    same, grew = paged.grow_pages(tc, ta, [0], lookahead=1)
    assert same is tc and not grew
    with pytest.raises(MemoryError):
        small = paged.PageAllocator(2)
        tc2 = tc._replace(page_table=torch.zeros_like(tc.page_table))
        paged.grow_pages(tc2, small, [0, 1, 2], lookahead=1)
    assert small.free_pages == 1  # the partial grow was rolled back
    jc = jpaged.free_row(jc, ja, 1)
    tc = paged.free_row(tc, ta, 1)
    assert ta.free_pages == ja.free_pages
    _assert_cache_equal(tc, jc)


def test_paged_wrappers_refuse_mixed_devices():
    q, kp, vp, table, lengths, pads, kn, vn, ks, vs = _attn_case(0, 1, "int8")
    meta = torch.empty(q.shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="need all cpu or all cuda"):
        paged_decode_attention(meta, *map(_t, (kp, vp, table, lengths, pads, kn, vn)),
                               k_scale=_t(ks), v_scale=_t(vs))
    c = _fused_case(0, "int8")
    with pytest.raises(ValueError, match="need all cpu or all cuda"):
        fused_paged_decode(meta[:, :1], *map(_t, c[1:]), 0)


def test_fused_paged_wrapper_refuses_shared_scale_storage():
    """The CUDA path's checks run before any build: a v_scale that is a view
    of k_scale's storage is refused."""
    from llm_speech_summarization_tpu_torch.kernels import fused_paged as fp

    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = _fused_case(0, "int8")
    ks_t = _t(ks)
    with pytest.raises(ValueError, match="must not share storage"):
        fp._launch(_t(q).bfloat16(), _t(kp), _t(vp), ks_t, ks_t[:], _t(table), _t(lengths),
                   _t(pads), _t(kn).bfloat16(), _t(vn).bfloat16(), 0)


# ---- on the card: each CUDA kernel against its plain version run in float32
# on the same inputs. The kernel computes in float32, so only its bf16 output
# rounding (at most 2^-8 relative) is left; outputs of rows that attend a few
# hundred positions are ~0.03 in size, so the bound scales with each output.
CARD_ATOL, CARD_RTOL = 1e-3, 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 3])
def test_paged_kernel_matches_plain_on_card(card, T):
    case = _attn_case(10 + T, T, "int8")
    to = lambda a: _t(a).to(card)  # noqa: E731
    q, kn, vn = (to(case[i]).bfloat16() for i in (0, 6, 7))
    args = (q, to(case[1]), to(case[2]), to(case[3]), to(case[4]), to(case[5]), kn, vn,
            to(case[8]), to(case[9]))
    got = paged_decode_attention(*args)
    want = paged_reference(q.float(), *args[1:6], kn.float(), vn.float(), *args[8:])
    torch.testing.assert_close(got.float(), want, atol=CARD_ATOL, rtol=CARD_RTOL)


@pytest.mark.cuda
def test_fused_paged_kernel_matches_plain_on_card(card):
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = _fused_case(3, "int8")
    to = lambda a: _t(a).to(card)  # noqa: E731
    bufs_k = [to(a) for a in (kp, vp, ks, vs)]
    bufs_p = [b.clone() for b in bufs_k]
    bufs_e = [b.clone() for b in bufs_k]
    qb, knb, vnb = (to(a).bfloat16() for a in (q, kn, vn))
    rest = (to(table), to(lengths), to(pads), knb, vnb, 1)
    got = fused_paged_decode(qb, *bufs_k, *rest)
    fused_paged_reference(qb, *bufs_p, *rest)
    exact = fused_paged_reference(qb.float(), *bufs_e, *rest[:3], knb.float(), vnb.float(), 1)
    torch.testing.assert_close(got.float(), exact, atol=CARD_ATOL, rtol=CARD_RTOL)
    for g, w in zip(bufs_k, bufs_p):
        assert torch.equal(g[:, 1:], w[:, 1:])


def _card_case(seed, T, pools, ps, L=2, B=6, Hq=24, Hkv=8, Dh=128, span=768):
    """Rows over a table of span / ps pages: a pad inside the first page (so
    chunks start mid-page) and a long window; a pad past the first page;
    nothing cached (length == pad); length at a page boundary; the whole
    table (length == mp * ps: B5 writes page 0); a released row (a zeroed
    table, which B5 writes page 0 from; compared nowhere)."""
    rng = np.random.RandomState([seed, T, ps])
    mp = span // ps
    P = 1 + B * mp
    kp, vp, ks, vs = _pools(rng, (L, P, Hkv, ps, Dh), pools)
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    table[5] = 0
    pads = np.array([3, ps + 2, 4, 0, 1, 2], np.int32)
    lengths = np.array([mp * ps - 37, mp * ps - 5, 4, 2 * ps, mp * ps, 300], np.int32)
    q, kn, vn = (rng.randn(B, T, h, Dh).astype(np.float32) for h in (Hq, Hkv, Hkv))
    return q, kp, vp, ks, vs, table, lengths, pads, kn, vn


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [None, 1, 2, 4])
@pytest.mark.parametrize("ps", [128, 64, 16])
@pytest.mark.parametrize("pools", ["int8", "bf16"])
@pytest.mark.parametrize("kernel,T", [("B4", 1), ("B4", 3), ("B5", 1)])
def test_paged_kernels_layouts_and_splits_on_card(card, monkeypatch, kernel, T, pools, ps,
                                                  nsplit):
    """B4 and B5 over int8 and bf16 pools at page sizes 128, 64 and 16, with
    the split count of the wrapper's rule (8 here) or forced to 1, 2 or 4:
    within 1e-3 + 1e-2 |exact| of the plain version run in float32 on the
    compared rows; B5's page writes bit-exact with the plain version's
    outside page 0, B4 writes nothing; two calls bit-identical."""
    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod

    if nsplit is not None:
        monkeypatch.setattr(fd_mod, "dense_splits", lambda *args: nsplit)
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = _card_case(20, T, pools, ps)
    to = lambda a: None if a is None else _t(a).to(card)  # noqa: E731
    qb, knb, vnb = (to(a).bfloat16() for a in (q, kn, vn))
    meta = (to(table), to(lengths), to(pads))
    snap = [to(a) for a in (kp, vp, ks, vs) if a is not None]
    rows = torch.from_numpy((table != 0).all(axis=1)).to(card)
    layer = 1
    if kernel == "B4":
        sc = (snap[2][layer], snap[3][layer]) if pools == "int8" else (None, None)

        def run(bufs):
            return paged_decode_attention(qb, bufs[0][layer], bufs[1][layer], *meta, knb, vnb,
                                          *sc)

        exact = paged_reference(qb.float(), snap[0][layer], snap[1][layer], *meta, knb.float(),
                                vnb.float(), *sc)
    else:
        def run(bufs):
            scales = bufs[2:] if pools == "int8" else (None, None)
            return fused_paged_decode(qb, bufs[0], bufs[1], *scales, *meta, knb, vnb, layer)

        ebufs = [t.clone() for t in snap] + [None, None] * (pools != "int8")
        exact = fused_paged_reference(qb.float(), *ebufs, *meta, knb.float(), vnb.float(), layer)
    got_bufs = [t.clone() for t in snap]
    got = run(got_bufs)
    torch.cuda.synchronize()
    assert torch.isfinite(got[rows]).all()
    torch.testing.assert_close(got[rows].float(), exact[rows], atol=CARD_ATOL, rtol=CARD_RTOL)
    if kernel == "B4":
        assert all(torch.equal(g, s) for g, s in zip(got_bufs, snap))
    else:
        plain_bufs = [t.clone() for t in snap] + [None, None] * (pools != "int8")
        fused_paged_reference(qb, *plain_bufs, *meta, knb, vnb, layer)
        for g, p in zip(got_bufs, plain_bufs):
            assert torch.equal(g[:, 1:], p[:, 1:])
    again_bufs = [t.clone() for t in snap]
    assert torch.equal(run(again_bufs)[rows], got[rows])
    assert all(torch.equal(a, g) for a, g in zip(again_bufs, got_bufs))
