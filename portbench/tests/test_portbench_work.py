"""The yardstick's arithmetic against hand counts."""

import json

import pytest

from portbench import work
from portbench.tests.conftest import REPO

MINICHAT = json.loads((REPO / "portbench" / "configs" / "minichat_hubert.json").read_text())


def test_bound_is_the_longer_of_bytes_and_operations():
    assert work.bound_ms(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert work.bound_ms(0.0, 989e9) == pytest.approx((1.0, "operations"))
    assert work.bound_ms(3.35e9, 2 * 989e9)[1] == "operations"


def test_flash_work_counts_valid_pairs():
    # one head of width 2, causal window [0, 4): 10 pairs; a 3-key window
    # [1, 4) of a second row, not causal: 9 pairs
    c = {"B": 2, "Hq": 1, "Hkv": 1, "Dh": 2, "causal": True, "starts": [0, 1], "ends": [4, 4]}
    n_bytes, flops = work.flash_work(c, 4)
    assert n_bytes == 2 * 2 * 4 * 2 * 4  # q, k, v, out: bf16, B x T x Dh each
    assert flops == 4 * 2 * (10 + 6)
    c["causal"] = False
    assert work.flash_work(c, 4)[1] == 4 * 2 * (16 + 9)


def test_train_attention_work():
    c = {"B": 1, "Hq": 2, "Hkv": 1, "Dh": 2, "causal": True, "starts": [0], "ends": [4]}
    w = work.train_attn_work(c, 4)
    qo, kv, rowf, f = 2 * 4 * 2 * 2, 2 * 4 * 1 * 2, 4 * 2 * 4, 2 * 2 * 2 * 10
    assert w["fwd_lse"] == (2 * qo + 2 * kv + rowf, 2 * f)
    assert w["dq"] == (3 * qo + 2 * kv + 2 * rowf, 3 * f)
    assert w["dkv"] == (2 * qo + 4 * kv + 2 * rowf, 4 * f)


def test_dense_decode_work():
    # B3 over a bf16 cache, 2 rows, 1 fresh token, 2/1 heads of width 4,
    # 10 valid slots in all; B8's float32 instance over an int8 cache
    n_bytes, flops = work.dense_work(10, 2, 1, 2, 1, 4, 2, False, True)
    assert n_bytes == 10 * 1 * 2 * 4 * 2 + 2 * 2 * 1 * (4 + 2) * 4 + 2 * 1 * 1 * 16
    assert flops == 4 * 4 * 2 * 1 * (10 + 2 * 1)
    n_bytes, flops = work.f32_work(10, 2, 1, 2, 1, 4, 1, True, False)
    assert n_bytes == 10 * 1 * 2 * (4 + 2) + 4 * 2 * 1 * (4 + 2) * 4
    assert flops == 4 * 4 * 2 * 1 * (10 + 2 * 1)


def test_b2_bound_at_the_kernel_tables_shape():
    # B2 at int8, B=128, S=384, 24/8 heads, Dh=128: chip_smoke's draw of
    # pads and offsets leaves 26420 valid slots; PERF.md's kernel table
    # gives the call a 0.0171 ms bytes bound
    n_bytes, flops = work.fused_decode_work(26420, 128, 1, 24, 8, 128)
    assert n_bytes == 26420 * 8 * 260 + 2 * 128 * 64 * 128 + 128 * 8 * 260
    ms, by = work.bound_ms(n_bytes, flops)
    assert by == "bytes" and round(ms, 4) == 0.0171
    rec = {"entry": "fused_decode", "B": 128, "T": 1, "Hq": 24, "Hkv": 8, "Dh": 128,
           "starts": [0] * 128, "offsets": [206] * 127 + [258]}
    assert work.call_bound_ms(rec) == pytest.approx(ms)


def test_roofline_share_over_recorded_calls():
    rec = {"entry": "flash_attention_fwd", "B": 1, "T": 4, "Hq": 1, "Hkv": 1, "Dh": 2,
           "causal": True, "elem": 2, "starts": [0], "ends": [4]}
    bound = work.call_bound_ms(rec)
    calls = [dict(rec, device_ms=bound * 4), dict(rec, device_ms=None),
             dict(rec, entry="fused_decode", device_ms=1.0)]
    assert work.roofline_pct(calls, ("flash_attention_fwd",)) == pytest.approx(25.0)
    assert work.roofline_pct(calls[1:2], ("flash_attention_fwd",)) is None


def test_model_flops_of_minichat_and_hubert_large():
    c = MINICHAT["llm"]
    # 24 layers of q, k, v, o (3072 x 3072 each: 24/24 heads of 128) and
    # the gate, up and down products (3072 x 8192)
    assert work.block_params(c) == 24 * (4 * 3072 * 3072 + 3 * 3072 * 8192) == 2717908992
    assert work.llm_forward_flops(c, 2) == 2 * 2717908992 * 2 + 4 * 128 * 24 * 24 * 3
    assert work.llm_forward_flops(c, 1, context=5) == 2 * 2717908992 + 4 * 128 * 24 * 24 * 6
    # one second of audio: 49 HuBERT frames, 11 pooled embeddings
    assert work.embed_count(MINICHAT, 16000) == 11
    conv = 2 * 512 * 10 * 3199 + 2 * 512 * 512 * 3 * (1599 + 799 + 399 + 199) \
        + 2 * 512 * 512 * 2 * (99 + 49)
    rest = 2 * 512 * 1024 * 49 + 2 * 1024 * 64 * 128 * 49
    blocks = 24 * (2 * 49 * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 4 * 1024 * 49 ** 2)
    assert work.encoder_flops(MINICHAT, 16000) == conv + rest + blocks + 2 * 1024 * 3072 * 11


def test_utterance_flops_compose():
    c = MINICHAT["llm"]
    n_p = 26 + 11
    bulk = work.bulk_utterance_flops(MINICHAT, 16000, 3)
    assert bulk == pytest.approx(work.encoder_flops(MINICHAT, 16000)
                                 + work.llm_forward_flops(c, n_p) + work.head_flops(c, 1)
                                 + work.llm_forward_flops(c, 1, n_p) + work.head_flops(c, 1)
                                 + work.llm_forward_flops(c, 1, n_p + 1) + work.head_flops(c, 1))
    n_s, n_t = 26 + 11 + 5, 26 + 4 + 5
    attn = work.llm_forward_flops(c, n_s) - 2 * work.block_params(c) * n_s
    assert work.train_utterance_flops(MINICHAT, 16000, 4, 5) == pytest.approx(
        3 * work.encoder_flops(MINICHAT, 16000) + work.llm_forward_flops(c, n_t)
        + 2 * work.llm_forward_flops(c, n_s) + attn + 3 * work.head_flops(c, 5))
    assert work.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
