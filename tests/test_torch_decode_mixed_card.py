"""On the card: the mixed decode instances (B3, B8, B4 and B5 with a bf16
query over a float32 cache or pools, ``csrc/decode_f32.cu``) against their
plain versions on the same inputs, within chip_smoke.py's mixed bound
MIXED_OUT_ATOL + MIXED_OUT_RTOL (|out| + (P.|V|)/l), the cache and page
writes equal to the plain version's. This file imports no JAX: the CPU
tests of the same route against the JAX kernels are in
tests/test_torch_decode_mixed.py.

    python -m pytest -m cuda tests/test_torch_decode_mixed_card.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from llm_speech_summarization_tpu_torch.kernels import decode_attention as da
from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd
from llm_speech_summarization_tpu_torch.kernels import fused_paged as fp
from llm_speech_summarization_tpu_torch.kernels import paged_attention as pa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


def _bf16_query(c):
    for k in ("q", "kn", "vn"):
        c[k] = c[k].bfloat16()
    return c


def _held(what, got, plain, c, kv, rows):
    return chip_smoke._mixed_check(torch, what, got, plain, c, kv, rows)["err_over_bound"]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 3])
def test_dense_mixed_instances_on_card(card, T):
    """B3 (T = 1 and a verification chunk of 3) and B8 over a float32
    cache: within the bound, B3's write equal to the plain version's."""
    rng = np.random.RandomState(92)
    layer = 1
    c = _bf16_query(chip_smoke._f32_dense_case(torch, rng, 4, T, 200, "float32"))
    bufs = [c[k].clone() for k in ("kc", "vc")]
    ref_bufs = [x.clone() for x in bufs]
    before = fd.fused_decode_attention_write_mixed.launches
    got = fd.fused_decode_attention_write(c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"],
                                          layer, max_offset=int(c["offs_np"].max()))
    plain = fd.fused_decode_attention_write_reference(c["q"], *ref_bufs, c["kn"], c["vn"],
                                                      c["pads"], c["offs"], layer)
    assert fd.fused_decode_attention_write_mixed.launches == before + 1
    assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
    rows = torch.ones(4, dtype=torch.bool, device=card)
    kv = chip_smoke._f64_dense(torch, c, layer)
    assert _held("B3", got, plain, c, kv, rows) <= 1
    if T == 1:
        offset = 190
        slot = torch.arange(200, device=card)
        c["valid"] = (slot >= c["pads"][:, None]) & (slot < offset)
        args = (c["q"], c["kc"][layer], c["vc"][layer], c["kn"], c["vn"], c["pads"], offset)
        before = da.decode_attention_mixed.launches
        got = da.decode_attention(*args)
        assert da.decode_attention_mixed.launches == before + 1
        assert _held("B8", got, da.decode_attention_reference(*args), c, kv, rows) <= 1


@pytest.mark.cuda
def test_paged_mixed_instances_on_card(card):
    """B4 (T = 4) and B5 (T = 1, the page write equal to the plain
    version's outside page 0) over float32 pools at the serving shape."""
    rng = np.random.RandomState(93)
    layer = 1
    for T, write in ((4, False), (1, True)):
        c = _bf16_query(chip_smoke._f32_paged_case(torch, rng, T, write, "float32"))
        rows = torch.from_numpy((c["table_np"] != 0).all(axis=1)).to(card)
        kv = chip_smoke._f64_paged(torch, c, layer)  # before the write
        if write:
            bufs = [c[k].clone() for k in ("kp", "vp")]
            ref_bufs = [x.clone() for x in bufs]
            args = (c["table"], c["lens"], c["pads"], c["kn"], c["vn"], layer)
            got = fp.fused_paged_decode(c["q"], *bufs, None, None, *args)
            plain = fp.fused_paged_reference(c["q"], *ref_bufs, None, None, *args)
            assert all(torch.equal(g[:, 1:], p[:, 1:]) for g, p in zip(bufs, ref_bufs))
        else:
            args = (c["q"], c["kp"][layer], c["vp"][layer], c["table"], c["lens"], c["pads"],
                    c["kn"], c["vn"])
            got = pa.paged_decode_attention(*args)
            plain = pa.paged_reference(*args)
        assert got.dtype == torch.bfloat16
        assert _held(f"B{5 if write else 4}", got, plain, c, kv, rows) <= 1


# the float32 body's ring over a float32 cache: stages of 32 slots at each
# Dh (csrc/dense_decode_f32.cuh, Ring<float, DH>::STAGES)
RING_SLOTS = {128: 3 * 32, 64: 6 * 32}


def _edges(Dh, S, T):
    """(pads, offsets): a window of one ring, one from a chunk boundary to a
    slot past the ring, two rings from an odd start, a slot short of two."""
    span = RING_SLOTS[Dh]
    pads = np.array([0, 32, 5, 0], np.int32)
    offs = np.minimum(np.array([span, 32 + span + 1, 5 + 2 * span, 2 * span - 1]), S - T)
    return pads, offs.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("Dh", [64, 128])
def test_mixed_ring_split_and_page_edges_on_card(card, Dh, nsplit, monkeypatch):
    """B3, B8, B4 and B5 mixed with windows ending on a ring stage, a slot
    past the ring, on a chunk and on a split boundary (the split count
    forced), and B4 / B5 over pages of 16 slots (every chunk of 32 crosses
    a page), at Dh 64 and 128: within the mixed bound, the writes equal to
    the plain version's."""
    monkeypatch.setattr(fd, "f32_splits", lambda *args: nsplit)
    rng = np.random.RandomState(96)
    layer, S = 1, 400
    rows = torch.ones(4, dtype=torch.bool, device=card)
    c = _bf16_query(chip_smoke._f32_dense_case(torch, rng, 4, 1, S, "float32", Hq=6, Hkv=2,
                                               Dh=Dh))
    pads, offs = _edges(Dh, S, 1)
    c["pads"], c["offs"] = (torch.from_numpy(a).to(card) for a in (pads, offs))
    slot = torch.arange(S, device=card)
    c["valid"] = (slot >= c["pads"][:, None]) & (slot < c["offs"][:, None])
    kv = chip_smoke._f64_dense(torch, c, layer)
    bufs = [c[k].clone() for k in ("kc", "vc")]
    ref_bufs = [x.clone() for x in bufs]
    got = fd.fused_decode_attention_write(c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"],
                                          layer, max_offset=int(offs.max()))
    plain = fd.fused_decode_attention_write_reference(c["q"], *ref_bufs, c["kn"], c["vn"],
                                                      c["pads"], c["offs"], layer)
    assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
    assert _held("B3", got, plain, c, kv, rows) <= 1
    offset = int(offs[2])
    c["valid"] = (slot >= c["pads"][:, None]) & (slot < offset)
    args = (c["q"], c["kc"][layer], c["vc"][layer], c["kn"], c["vn"], c["pads"], offset)
    assert _held("B8", da.decode_attention(*args), da.decode_attention_reference(*args), c, kv,
                 rows) <= 1

    ps, mp, L, B, Hkv = 16, 30, 2, 4, 2
    P = 1 + B * mp
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)  # noqa: E731
    kp, vp = (f32(rng.randn(L, P, Hkv, ps, Dh)) for _ in range(2))
    table_np = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads, lens = _edges(Dh, mp * ps, 4)
    for T, write in ((4, False), (1, True)):
        q, kn, vn = (f32(rng.randn(B, T, h, Dh)).bfloat16() for h in (6, Hkv, Hkv))
        pt, lt, table = (torch.from_numpy(a).to(card) for a in (pads, lens, table_np))
        pos = torch.arange(mp * ps, device=card)
        cp = dict(q=q, kn=kn, vn=vn, kp=kp, vp=vp, ks=None, vs=None, table=table,
                  valid=(pos >= pt[:, None]) & (pos < lt[:, None]))
        kvp = chip_smoke._f64_paged(torch, cp, layer)  # before the write
        if write:
            bp, rp = [kp.clone(), vp.clone()], [kp.clone(), vp.clone()]
            rest = (table, lt, pt, kn, vn, layer)
            got = fp.fused_paged_decode(q, *bp, None, None, *rest)
            plain = fp.fused_paged_reference(q, *rp, None, None, *rest)
            assert all(torch.equal(g, p) for g, p in zip(bp, rp))
        else:
            pargs = (q, kp[layer], vp[layer], table, lt, pt, kn, vn)
            got, plain = pa.paged_decode_attention(*pargs), pa.paged_reference(*pargs)
        assert _held(f"B{5 if write else 4}", got, plain, cp, kvp, rows) <= 1
