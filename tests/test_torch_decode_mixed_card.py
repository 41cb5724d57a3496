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
