"""A bf16 query over a float32 cache (bf16 parameters at ``compute_dtype:
float32``: the prefill fills a float32 cache, the decode steps run in the
norms' bf16) on the CPU, before any card time:

  * each plain version at the mix (what a CPU tensor takes: the port's
    B3, B8, B4 and B5 with a bf16 q and fresh k/v over a float32 cache or
    pools) held to the JAX kernel in Pallas interpret mode on the same
    inputs: bf16 outputs on both sides, compared in float32 within the
    mixed bound MIXED_OUT_ATOL + MIXED_OUT_RTOL (|out| + (P.|V|)/l) of
    chip_smoke.py (the two sides round p over the cache to bf16 at
    different maxima, the plain version also the fresh p, and sum in
    different orders); cache and page writes bit-exact, every other slot
    unchanged;
  * a CPU emulation of the mixed CUDA instances' arithmetic (chunks of 32
    slots, cached values and p over the cache rounded to bf16, the fresh
    block unrounded, the splits merged in order, the output rounded once)
    held to the JAX kernel within the same bound;
  * the wrappers' routing of a bf16 query over a float32 cache or pools to
    the mixed instances on meta tensors, before any build, the other
    routes unchanged;
  * the repair of ``models/llama.py::_mm``: the prefill at float32 embeds
    with bf16 parameters against JAX's ``llama_forward``;
  * the slice: the engine's batch path and the dense and paged slot
    decoders at ``tiny_test.yaml`` with bf16 parameters and a float32
    cache, every decode attention call a bf16 query over a float32 cache
    and held to the JAX kernel on the same inputs; the engine's rows held
    to the same engine with each decode attention replaced by the JAX
    kernel in interpret mode.
The JAX engine itself does not decode at this mix on XLA:CPU (a bf16 x bf16
-> float32 dot it has no thunk for), so the streams are compared with the
port's engine on the JAX kernels, not with the JAX engine. The mixed
instances on the card: tests/test_torch_decode_mixed_card.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_decode_f32 import _score, _State
from torch_streams import assert_streams_agree, recorded_rows

import chip_smoke
from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.kernels.decode_attention import (
    decode_attention as jax_decode_attention,
)
from llm_speech_summarization_tpu.kernels.fused_decode import fused_reference
from llm_speech_summarization_tpu.kernels.fused_decode import (
    fused_decode_attention_write as jax_fused_write,
)
from llm_speech_summarization_tpu.kernels.fused_paged import fused_paged_decode_write
from llm_speech_summarization_tpu.kernels.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
from llm_speech_summarization_tpu_torch.kernels import decode_attention as da
from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd
from llm_speech_summarization_tpu_torch.kernels import fused_paged as fp
from llm_speech_summarization_tpu_torch.kernels import paged_attention as pa
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
LOG2E = 1.4426950408889634
CH = 32  # slots per chunk of the float32 body
LLAMA_ATOL = 1e-4  # tests/test_torch_models.py's Llama tolerance


def _np(t):
    return bridge.tensor_to_numpy(t)


def _jax(a, bf16=False):
    x = jnp.asarray(np.asarray(a, np.float32) if bf16 else np.asarray(a))
    return x.astype(jnp.bfloat16) if bf16 else x


def _mixed_bound(q, k, v, kn, vn, valid):
    """chip_smoke.py's mixed bound (B, T, Hq, Dh) from the float64
    attention of q (B, T, Hq, Dh) over one layer's dense float32 (B, Hkv,
    S, Dh) k / v rounded to bf16, where ``valid`` (B, S), plus the fresh
    block causally."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    kr, vr = chip_smoke._bf16_cache(torch, (t(k).double(), t(v).double()))
    q, kn, vn, valid = t(q), t(kn), t(vn), torch.as_tensor(valid)
    ref = chip_smoke._f64_decode(torch, q, kr, vr, kn, vn, valid)
    pv = chip_smoke._f64_decode(torch, q, kr, vr.abs(), kn, vn.abs(), valid)
    return (chip_smoke.MIXED_OUT_ATOL + chip_smoke.MIXED_OUT_RTOL * (ref.abs() + pv)).numpy()


def _within(got, want, bound, what=""):
    """|got - want| / bound <= 1 in float32 (bf16 on both sides); returns
    the largest ratio."""
    got = np.asarray(_np(got) if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    ratio = float(np.max(np.abs(got - want) / bound))
    assert ratio <= 1, (what, ratio)
    return ratio


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(_np(got), np.float64),
                                  np.asarray(want, np.float64), err_msg=what)


def _valid(pads, ends, S):
    slot = np.arange(S)
    return (slot[None] >= np.asarray(pads)[:, None]) & (slot[None] < np.asarray(ends)[:, None])


# ---- each plain version at the mix against the TPU kernel


def _dense_case(seed, T=1, L=3, B=4, Hq=6, Hkv=2, S=160, Dh=128):
    """bf16 q and fresh k/v over a float32 (L, B, Hkv, S, Dh) cache; pads
    and offsets spread over the window: a chunk edge, past it, the last
    slot(s), nothing cached."""
    rng = np.random.RandomState(seed)
    kc, vc = (rng.randn(L, B, Hkv, S, Dh).astype(np.float32) for _ in range(2))
    q, kn, vn = (rng.randn(B, T, h, Dh).astype(BF16) for h in (Hq, Hkv, Hkv))
    pads = np.array([0, 37, 5, 2], np.int32)[:B]
    offs = np.array([64, 131, S - T, 2], np.int32)[:B]
    return q, kc, vc, kn, vn, pads, offs


def jax_fused_reference(q, kc, vc, kn, vn, pads, offs, layer):
    """The JAX package's T > 1 path (``fused_reference``) one row at a time:
    XLA:CPU runs its bf16 x bf16 -> float32 einsums at the mix only at B =
    1. Returns (out, k_cache, v_cache) as the batched call does."""
    rows = [fused_reference(q[b:b + 1], kc[:, b:b + 1], vc[:, b:b + 1], kn[b:b + 1],
                            vn[b:b + 1], pads[b:b + 1], offs[b:b + 1], layer)
            for b in range(q.shape[0])]
    return (jnp.concatenate([r[0] for r in rows], 0), jnp.concatenate([r[1] for r in rows], 1),
            jnp.concatenate([r[2] for r in rows], 1))


def _tensors(*arrays):
    return [bridge.tensor_from_numpy(a) for a in arrays]


@pytest.mark.parametrize("layer", [0, 2])
def test_b3_mixed_plain_matches_jax_interpret(layer):
    """B3 at T = 1: the plain version's bf16 out within the mixed bound of
    the TPU kernel's; the bf16 fresh values widened into the float32 cache
    at the offsets bit for bit, every other slot unchanged."""
    q, kc, vc, kn, vn, pads, offs = _dense_case(10 + layer)
    want = jax_fused_write(_jax(q, True), _jax(kc), _jax(vc), _jax(kn, True), _jax(vn, True),
                           _jax(pads), _jax(offs), jnp.int32(layer), interpret=True)
    qt, kt, vt, knt, vnt, pt, ot = _tensors(q, kc, vc, kn, vn, pads, offs)
    got = fd.fused_decode_attention_write_mixed(qt, kt, vt, knt, vnt, pt, ot, layer)
    assert got.dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    _within(got, want[0], _mixed_bound(q, kc[layer], vc[layer], kn, vn,
                                       _valid(pads, offs, kc.shape[3])), "B3")
    _same(kt, want[1], "k cache")
    _same(vt, want[2], "v cache")
    for b in range(q.shape[0]):
        np.testing.assert_array_equal(_np(kt)[layer, b, :, offs[b]],
                                      np.asarray(kn[b, 0], np.float32))
    kt[layer, np.arange(4)[:, None], :, offs[:, None]] = torch.from_numpy(kc)[
        layer, np.arange(4)[:, None], :, offs[:, None]]
    _same(kt, kc, "k cache outside the fresh slots")


@pytest.mark.parametrize("layer", [0, 2])
def test_b3_mixed_plain_takes_a_verification_block(layer):
    """B3 at T = 3 (a speculative verification chunk): the plain version
    against the JAX package's T > 1 path (``fused_reference``), the three
    fresh rows written at [offset, offset + 3)."""
    q, kc, vc, kn, vn, pads, offs = _dense_case(20 + layer, T=3)
    want = jax_fused_reference(_jax(q, True), _jax(kc), _jax(vc), _jax(kn, True),
                               _jax(vn, True), _jax(pads), _jax(offs), jnp.int32(layer))
    qt, kt, vt, knt, vnt, pt, ot = _tensors(q, kc, vc, kn, vn, pads, offs)
    got = fd.fused_decode_attention_write_mixed(qt, kt, vt, knt, vnt, pt, ot, layer)
    _within(got, want[0], _mixed_bound(q, kc[layer], vc[layer], kn, vn,
                                       _valid(pads, offs, kc.shape[3])), "B3 T=3")
    _same(kt, want[1], "k cache")
    _same(vt, want[2], "v cache")


@pytest.mark.parametrize("layer", [0, 2])
def test_b8_mixed_plain_matches_jax_interpret(layer):
    """B8 (read only, one scalar offset) over one layer's float32 cache."""
    q, kc, vc, kn, vn, pads, _ = _dense_case(30 + layer)
    offset = 150
    want = jax_decode_attention(_jax(q, True), _jax(kc[layer]), _jax(vc[layer]),
                                _jax(kn, True), _jax(vn, True), _jax(pads), jnp.int32(offset),
                                interpret=True)
    qt, kt, vt, knt, vnt, pt = _tensors(q, kc[layer], vc[layer], kn, vn, pads)
    got = da.decode_attention_mixed(qt, kt, vt, knt, vnt, pt, offset)
    assert got.dtype == torch.bfloat16
    _within(got, want, _mixed_bound(q, kc[layer], vc[layer], kn, vn,
                                    _valid(pads, [offset] * 4, kc.shape[3])), "B8")
    _same(kt, kc[layer], "read only")


def _paged_case(seed, T, L=None, B=5, Hq=6, Hkv=2, Dh=128, ps=64, mp=3):
    """Distinct pages per row (page 0 = null), bf16 q and fresh k/v over
    float32 pools; lengths at a page interior, a page's first slot, only
    the fresh block, the table's last slot(s) and (B5, ``L`` given) the
    boundary length == ps * mp."""
    rng = np.random.RandomState(seed)
    P = 1 + B * mp
    lead = () if L is None else (L,)
    kp, vp = (rng.randn(*lead, P, Hkv, ps, Dh).astype(np.float32) for _ in range(2))
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads = np.array([5, 0, 3, 2, 70], np.int32)[:B]
    lengths = np.array([2 * ps - 9, ps, 3, mp * ps - T, mp * ps if L else ps + 7],
                       np.int32)[:B]
    q, kn, vn = (rng.randn(B, T, h, Dh).astype(BF16) for h in (Hq, Hkv, Hkv))
    return q, kp, vp, table, lengths, pads, kn, vn


def _dense_pages(pool, table):
    """One layer's (P, Hkv, ps, Dh) pool gathered through the table into
    dense (B, Hkv, mp * ps, Dh)."""
    B, mp = table.shape
    _, Hkv, ps, Dh = pool.shape
    return pool[table].transpose(0, 2, 1, 3, 4).reshape(B, Hkv, mp * ps, Dh)


@pytest.mark.parametrize("T", [1, 4])
def test_b4_mixed_plain_matches_jax_interpret(T):
    q, kp, vp, table, lengths, pads, kn, vn = _paged_case(40 + T, T)
    want = jax_paged_decode_attention(_jax(q, True), _jax(kp), _jax(vp), _jax(table),
                                      _jax(lengths), _jax(pads), _jax(kn, True), _jax(vn, True),
                                      interpret=True)
    got = pa.paged_decode_attention_mixed(*_tensors(q, kp, vp, table, lengths, pads, kn, vn))
    assert got.dtype == torch.bfloat16
    S = table.shape[1] * kp.shape[2]
    _within(got, want, _mixed_bound(q, _dense_pages(kp, table), _dense_pages(vp, table), kn, vn,
                                    _valid(pads, np.minimum(lengths, S), S)), f"B4 T={T}")


@pytest.mark.parametrize("ps", [32, 64])
@pytest.mark.parametrize("layer", [0, 1])
def test_b5_mixed_plain_matches_jax_interpret(layer, ps):
    """B5 at T = 1: out within the bound of the TPU kernel's, the pools
    equal to its pools outside the null page 0 (the TPU kernel drops the
    boundary row's token, which the port writes to page 0), the fresh bf16
    values widened into their pages bit for bit."""
    q, kp, vp, table, lengths, pads, kn, vn = _paged_case(50 + layer, 1, L=2, ps=ps,
                                                          mp=192 // ps)
    want = fused_paged_decode_write(_jax(q, True), _jax(kp), _jax(vp), _jax(table),
                                    _jax(lengths), _jax(pads), _jax(kn, True), _jax(vn, True),
                                    jnp.int32(layer), interpret=True)
    qt, kt, vt, tt, lt, pt, knt, vnt = _tensors(q, kp, vp, table, lengths, pads, kn, vn)
    got = fp.fused_paged_decode_mixed(qt, kt, vt, None, None, tt, lt, pt, knt, vnt, layer)
    assert got.dtype == torch.bfloat16
    S = table.shape[1] * ps
    _within(got, want[0], _mixed_bound(q, _dense_pages(kp[layer], table),
                                       _dense_pages(vp[layer], table), kn, vn,
                                       _valid(pads, np.minimum(lengths, S), S)), "B5")
    for got_pool, want_pool, new, pool in ((kt, want[1], kn, kp), (vt, want[2], vn, vp)):
        _same(got_pool[:, 1:], np.asarray(want_pool)[:, 1:], "pools outside page 0")
        g = _np(got_pool)
        for b in range(q.shape[0]):
            t = lengths[b] // ps
            if t < table.shape[1]:
                pid, slot = table[b, t], lengths[b] % ps
                np.testing.assert_array_equal(g[layer, pid, :, slot],
                                              np.asarray(new[b, 0], np.float32))
                g[layer, pid, :, slot] = pool[layer, pid, :, slot]
        _same(torch.from_numpy(g[:, 1:]), pool[:, 1:], "pools outside the written slots")


# ---- the mixed instances' arithmetic, emulated


def emulate_mixed(q, k, v, kn, vn, pads, offs, nsplit):
    """The mixed CUDA instances on one layer's dense window: bf16 q (B, T,
    Hq, Dh) and fresh kn / vn (B, T, Hkv, Dh) widened exactly, the float32
    k / v (B, Hkv, S, Dh) rounded to bf16, chunks of CH slots per split in
    a base-2 online softmax with p over the cache rounded to bf16 for P.V
    (not in the sum), the fresh block unrounded as the last split's last
    step, the splits merged in order, the output rounded to bf16."""
    B, T, Hq, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    R = T * G
    q, kn, vn = (x.float() for x in (q, kn, vn))
    k, v = k.bfloat16().float(), v.bfloat16().float()
    scale2 = np.float32(Dh ** -0.5 * LOG2E)
    out = torch.zeros(B, T, Hq, Dh)
    for b in range(B):
        pad, c_end = max(int(pads[b]), 0), min(int(offs[b]), S)
        per = -(-max(c_end - pad, 0) // nsplit)
        for h in range(Hkv):
            qr = q[b, :, h * G:(h + 1) * G].reshape(R, Dh)
            total = None
            for split in range(nsplit):
                lo = pad + split * per
                hi = min(lo + per, c_end)
                st = _State(R, Dh)
                for c0 in range(lo, hi, CH):
                    sl = slice(c0, min(c0 + CH, hi))
                    s = _score(qr[:, None, :] * k[b, h, sl][None], 2) * scale2
                    n = s.shape[1]
                    st.step(s, torch.ones_like(s, dtype=torch.bool), torch.ones(n), v[b, h, sl],
                            True)
                if split == nsplit - 1:
                    s = _score(qr[:, None, :] * kn[b, :, h][None], 2) * scale2
                    ok = torch.arange(T)[None, :] <= torch.arange(R)[:, None] // G
                    st.step(s, ok, torch.ones(T), vn[b, :, h], False)
                if total is None:
                    total = st
                else:
                    total.merge(st)
            out[b, :, h * G:(h + 1) * G] = (total.acc / total.l[:, None]).reshape(T, G, Dh)
    return out.bfloat16()


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 3])
def test_mixed_body_emulation_within_the_bound(T, nsplit):
    """The emulated mixed instance against the TPU kernel (T = 1, interpret
    mode) and the JAX T > 1 path (T = 3), over 256 slots: within the mixed
    bound; a window of up to 250 slots takes several chunks per split."""
    layer = 1
    q, kc, vc, kn, vn, pads, _ = _dense_case(60 + T, T=T, S=256)
    offs = np.array([250 - T, 0, 180, 97], np.int32)
    args = (_jax(q, True), _jax(kc), _jax(vc), _jax(kn, True), _jax(vn, True), _jax(pads),
            _jax(offs), jnp.int32(layer))
    want = (jax_fused_write(*args, interpret=True) if T == 1 else jax_fused_reference(*args))[0]
    qt, knt, vnt = _tensors(q, kn, vn)
    got = emulate_mixed(qt, torch.from_numpy(kc[layer]), torch.from_numpy(vc[layer]), knt, vnt,
                        pads, offs, nsplit)
    assert torch.isfinite(got.float()).all()
    _within(got, want, _mixed_bound(q, kc[layer], vc[layer], kn, vn,
                                    _valid(pads, offs, kc.shape[3])), "emulation")


# ---- the route on meta tensors (they stand for CUDA ones)


class _Built(Exception):
    """A bf16-body library load: the route reached the bf16 kernels."""


@pytest.fixture
def meta_route(monkeypatch):
    """Every decode wrapper takes meta tensors for CUDA ones; the float32
    library's launch records its call, a bf16 library's load raises
    ``_Built`` with its name."""
    calls = []
    for mod in (fd, da, pa, fp):
        monkeypatch.setattr(mod, "_devices", lambda what, tensors: "cuda")

    def launch(wrapper, q, k_cache, *args, page_table=None, write=False, **kw):
        calls.append((wrapper.__name__, q.dtype, k_cache.dtype, page_table is not None, write))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")

    def load(name, sources):
        raise _Built(name)

    for mod in (fd, da, pa, fp):
        monkeypatch.setattr(mod, "launch_f32", launch)
        monkeypatch.setattr(mod, "load_library", load)
    monkeypatch.setattr(fd, "sm_count", lambda index: 132)
    monkeypatch.setattr(da, "sm_count", lambda index: 132)
    monkeypatch.setattr(fd, "check_separate_storage", lambda what, tensors: None)
    monkeypatch.setattr(pa, "check_separate_storage", lambda what, tensors: None)
    return calls


def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _calls(q_dtype, cache, T=1):
    """One call of each of the four wrappers with a q of ``q_dtype`` over a
    cache / pools of ``cache`` (B3 and B4 at T, B8 and B5 at T = 1; B3 at T
    > 1 over a float cache only); returns the bf16 libraries a call
    loaded, in order."""
    built = []
    i8 = cache == torch.int8
    q, q1 = _meta((4, T, 6, 128), q_dtype), _meta((4, 1, 6, 128), q_dtype)
    kn, kn1 = _meta((4, T, 2, 128), q_dtype), _meta((4, 1, 2, 128), q_dtype)
    kc = _meta((2, 4, 2, 64, 128), cache)
    idx = _meta((4,), torch.int32)
    sc = [_meta((4, 2, 64), torch.bfloat16) for _ in range(2)] if i8 else []
    kp = _meta((2, 9, 2, 64, 128), cache)
    psc = [_meta((2, 9, 2, 64), torch.bfloat16) for _ in range(2)] if i8 else [None, None]
    table = _meta((4, 2), torch.int32)
    for call in (
            lambda: fd.fused_decode_attention_write(q, kc, kc.clone(), kn, kn.clone(), idx, idx,
                                                    1, *sc, max_offset=60),
            lambda: da.decode_attention(q1, kc[1], kc[1].clone(), kn1, kn1.clone(), idx, 60,
                                        *sc),
            lambda: pa.paged_decode_attention(q, kp[1], kp[1].clone(), table, idx, idx, kn,
                                              kn.clone(), *(s[1] for s in psc if s is not None)),
            lambda: fp.fused_paged_decode(q1, kp, kp.clone(), *psc, table, idx, idx, kn1,
                                          kn1.clone(), 1)):
        try:
            call()
        except _Built as e:
            built.append(str(e))
    return built


def test_bf16_queries_over_float32_caches_take_the_mixed_instances(meta_route):
    """A bf16 query over a float32 cache or pools reaches the mixed launch
    of B3, B8, B4 (T = 4) and B5, each with the layout and write it needs;
    a bf16 query over an int8 or bf16 cache still loads the bf16 kernels,
    a float32 query still takes the float32 instances."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    assert _calls(bf16, f32) == []
    assert _calls(bf16, f32, T=4) == []
    assert meta_route == [
        ("fused_decode_attention_write_mixed", bf16, f32, False, True),
        ("decode_attention_mixed", bf16, f32, False, False),
        ("paged_decode_attention_mixed", bf16, f32, True, False),
        ("fused_paged_decode_mixed", bf16, f32, True, True),
        ("fused_decode_attention_write_mixed", bf16, f32, False, True),
        ("decode_attention_mixed", bf16, f32, False, False),
        ("paged_decode_attention_mixed", bf16, f32, True, False),
        ("fused_paged_decode_mixed", bf16, f32, True, True)]
    del meta_route[:]
    for cache in (bf16, i8):
        assert _calls(bf16, cache) == ["fused_decode", "decode_attention", "paged_attention",
                                       "fused_paged"]
    assert meta_route == []
    for cache in (f32, bf16, i8):
        assert _calls(f32, cache) == []
    assert [c[0] for c in meta_route] == [
        "fused_decode_attention_write_f32", "decode_attention_f32",
        "paged_decode_attention_f32", "fused_paged_decode_f32"] * 3


def test_mixed_route_refusals(meta_route):
    """The mixed route takes no scales and a float32 cache only: a bf16
    query over a float32 cache with layer scales is refused by the mixed
    instance's checks, before any launch; a bf16 query with float32 fresh
    values raises as mixed dtypes."""
    f32, bf16 = torch.float32, torch.bfloat16
    q = _meta((4, 1, 6, 128), bf16)
    kn = _meta((4, 1, 2, 128), bf16)
    kc = _meta((2, 4, 2, 64, 128), f32)
    idx = _meta((4,), torch.int32)
    sc = [_meta((4, 2, 64), torch.bfloat16) for _ in range(2)]
    with pytest.raises(ValueError, match="an int8 cache takes its k/v scales, a float cache none"):
        fd.fused_decode_attention_write(q, kc, kc.clone(), kn, kn.clone(), idx, idx, 1, *sc,
                                        max_offset=8)
    with pytest.raises(ValueError, match="mixed dtypes are not ported"):
        da.decode_attention(q, kc[1], kc[1].clone(), kn.float(), kn.float(), idx, 8)
    with pytest.raises(ValueError, match="the mixed kernel takes a float32 cache"):
        fd._launch_dense(fd.fused_decode_attention_write_mixed, q,
                         _meta((2, 4, 2, 64, 128), bf16), _meta((2, 4, 2, 64, 128), bf16), None,
                         None, kn, kn.clone(), idx, idx, 0, 8, per_layer_scales=True,
                         route="mixed")
    assert meta_route == []


# ---- the _mm repair: a float32 prefill over bf16 parameters


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_f32_over_bf16_params_matches_jax(quantized):
    """The port's ``llama_forward`` prefill at float32 embeds with bf16
    parameters (unquantized, and the int8 LLM with bf16 norms) into a
    float32 cache, against JAX's ``llama_forward`` on the same weights:
    float32 logits within LLAMA_ATOL, the cache within the same. The parent
    refused this mix in ``_mm`` with ``RuntimeError: expected m1 and m2 to
    have the same dtype, but got: float != c10::BFloat16`` (``h @ w``
    without JAX's promotion of a float32 h against a bf16 weight)."""
    cfg = jllama.llama_preset("tiny")
    p = jllama.init_llama_params(jax.random.PRNGKey(3), cfg, dtype=jnp.bfloat16)
    if quantized:
        p = jllama.quantize_llama_params(jllama.fuse_llama_params(p))
    tp = bridge.llama_params_from_numpy(jax.tree.map(np.asarray, p))
    assert tp["final_norm"].dtype == torch.bfloat16
    tcfg = tllama.llama_preset("tiny")
    B, L = 3, 12
    rng = np.random.RandomState(4)
    embeds = rng.randn(B, L, cfg.hidden_size).astype(np.float32)
    pads = np.array([3, 0, 1], np.int32)
    mask = np.arange(L)[None, :] >= pads[:, None]
    jout = jllama.llama_forward(p, cfg, inputs_embeds=jnp.asarray(embeds),
                                attn_mask=jnp.asarray(mask),
                                kv_cache=jllama.init_kv_cache(cfg, B, L, dtype=jnp.float32),
                                cache_offset=jnp.int32(0))
    tcache = tllama.init_kv_cache(tcfg, B, L, dtype=torch.float32)
    tout = tllama.llama_forward(tp, tcfg, inputs_embeds=torch.from_numpy(embeds),
                                attn_mask=torch.from_numpy(mask), kv_cache=tcache,
                                cache_offset=0)
    assert tout.logits.dtype == torch.float32 and jout.logits.dtype == jnp.float32
    np.testing.assert_allclose(tout.logits.numpy()[mask], np.asarray(jout.logits)[mask],
                               atol=LLAMA_ATOL, rtol=0)
    for name, a, b in zip(("k", "v"), jout.kv_cache, tcache):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=LLAMA_ATOL, rtol=0, err_msg=name)


# ---- the slice: bf16 parameters at compute_dtype float32, a float32 cache


TINY_YAML = str(YAML_DIR / "tiny_test.yaml")
JAX_TINY_YAML = str(YAML_DIR.parents[2] / "llm_speech_summarization_tpu" / "configs" / "yaml"
                    / "tiny_test.yaml")
DECODE_FNS = ("fused_decode", "fused_decode_attention_write", "decode_attention",
              "paged_decode_attention", "fused_paged_decode")


def _engines():
    """The JAX and the port's engine at ``tiny_test.yaml`` with bf16
    parameters (compute_dtype float32, ``kv_cache_dtype`` null: a float32
    cache), on the JAX engine's weights."""
    cfgs = [jax_load_config(JAX_TINY_YAML), load_config(TINY_YAML)]
    for c in cfgs:
        assert c.model.compute_dtype == "float32"
        c.model.param_dtype = "bfloat16"
        c.model.kv_cache_dtype = None
    je = JaxEngine(cfgs[0])
    te = LLMSpeechTextInference(
        cfgs[1], device="cpu",
        llm_params=bridge.llama_params_from_numpy(jax.tree.map(np.asarray, je.llm_params)),
        audio_encoder_params=bridge.encoder_params_from_numpy(
            jax.tree.map(np.asarray, je.audio_encoder_params)))
    assert te.cache_dtype == torch.float32 and te.llm_params["final_norm"].dtype == torch.bfloat16
    return je, te


def _jax_call(name, args):
    """The JAX kernel (interpret mode; ``jax_fused_reference`` for a dense
    T > 1 chunk) on numpy copies of a port call's ``args``: (out, [the layer's
    written caches or the pools, as numpy]) ."""
    a = [None if x is None else (_jax(_np(x), True) if x.dtype == torch.bfloat16
                                 else _jax(_np(x)))
         for x in args if x is None or isinstance(x, torch.Tensor)]
    if name == "fused_decode_attention_write":
        q, kc, vc, kn, vn, pads, offs = a[:7]
        layer = jnp.int32(args[7])
        fn = jax_fused_reference if q.shape[1] > 1 else (
            lambda *x: jax_fused_write(*x, interpret=True))
        out, kc2, vc2 = fn(q, kc, vc, kn, vn, pads, offs, layer)
        return out, [kc2, vc2]
    if name == "decode_attention":
        q, kc, vc, kn, vn, pads = a[:6]
        return jax_decode_attention(q, kc, vc, kn, vn, pads, jnp.int32(args[6]),
                                    interpret=True), []
    if name == "paged_decode_attention":
        return jax_paged_decode_attention(*a[:8], interpret=True), []
    assert name == "fused_paged_decode"
    q, kp, vp, ks, vs, table, lengths, pads, kn, vn = args[:10]
    assert ks is None and vs is None
    res = fused_paged_decode_write(*a[:3], *a[5:10], jnp.int32(args[10]), interpret=True)
    return res[0], [res[1], res[2]]


def _call_bound(name, args):
    """The mixed bound of one recorded call, from its inputs (before the
    call writes)."""
    if name in ("fused_decode_attention_write", "decode_attention"):
        q, kc, vc, kn, vn, pads = (_np(x) for x in args[:6])
        if name == "decode_attention":
            ends = np.full(q.shape[0], args[6])
        else:
            kc, vc, ends = kc[args[7]], vc[args[7]], _np(args[6])
        return _mixed_bound(q, kc, vc, kn, vn, _valid(pads, ends, kc.shape[2]))
    if name == "paged_decode_attention":
        q, kp, vp, table, lengths, pads, kn, vn = (_np(x) for x in args[:8])
    else:
        q, kp, vp, _, _, table, lengths, pads, kn, vn = (
            None if x is None else _np(x) for x in args[:10])
        kp, vp = kp[args[10]], vp[args[10]]
    S = table.shape[1] * kp.shape[2]
    return _mixed_bound(q, _dense_pages(kp, table), _dense_pages(vp, table), kn, vn,
                        _valid(pads, np.minimum(lengths, S), S))


@contextlib.contextmanager
def checked_decode_calls(monkeypatch):
    """Record (wrapper, q dtype, cache dtype) of every decode attention call
    the port's LLM makes and hold each call's output to the JAX kernel on
    a copy of its inputs within the mixed bound, its cache or page writes
    to the JAX kernel's bit for bit (outside the null page 0)."""
    seen = []
    for name in DECODE_FNS:
        fn = getattr(tllama, name)

        def check(*args, _fn=fn, _name=name, **kw):
            seen.append((_name, args[0].dtype, args[1].dtype))
            before = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
            want, want_bufs = _jax_call(_name, before)
            bound = _call_bound(_name, before)
            got = _fn(*args, **kw)
            _within(got, want, bound, _name)
            for g, w in zip(args[1:3], want_bufs):
                g, w = _np(g), np.asarray(w)
                if _name == "fused_paged_decode":
                    g, w = g[:, 1:], w[:, 1:]
                np.testing.assert_array_equal(g, w, err_msg=_name)
            return got

        monkeypatch.setattr(tllama, name, check)
    yield seen


@contextlib.contextmanager
def jax_decode_attention_calls(monkeypatch):
    """Each decode attention of the port's LLM replaced by the JAX kernel
    in interpret mode on numpy copies of its inputs, its cache writes
    copied back into the port's tensors."""
    with monkeypatch.context() as m:
        for name in DECODE_FNS:
            def call(*args, _name=name, **kw):
                out, bufs = _jax_call(_name, args)
                for dst, src in zip(args[1:3], bufs):
                    dst.copy_(bridge.tensor_from_numpy(np.asarray(src)))
                return bridge.tensor_from_numpy(np.asarray(out, np.float32)).bfloat16()

            m.setattr(tllama, name, call)
        yield


def test_engine_batch_path_mixed(monkeypatch):
    """``generate_audio_response_batch`` with bf16 parameters at
    compute_dtype float32: the float32 prefill fills a float32 cache and
    every decode step is B3 with a bf16 query over it, each held to the
    TPU kernel; the rows equal, under the margin-aware contract, those of
    the same engine with each decode attention on the JAX kernel."""
    je, te = _engines()
    rng = np.random.RandomState(5)
    clips = [(0.1 * rng.randn(n)).astype(np.float32) for n in (8000, 5600, 12345)]
    with checked_decode_calls(monkeypatch) as seen, recorded_rows(ByteTokenizer) as port_rows:
        te.generate_audio_response_batch(clips, max_new_tokens=8)
    assert seen and set(seen) == {("fused_decode_attention_write", torch.bfloat16,
                                   torch.float32)}
    monkeypatch.undo()
    with jax_decode_attention_calls(monkeypatch), recorded_rows(ByteTokenizer) as ref_rows:
        te.generate_audio_response_batch(clips, max_new_tokens=8)
    embeds, mask = je.build_audio_prompt_batch(clips)
    assert_streams_agree(ref_rows, port_rows,
                         lambda i: (je, np.asarray(embeds)[i:i + 1], np.asarray(mask)[i:i + 1]))


@pytest.mark.parametrize("paged", [False, True])
def test_slot_decoders_mixed(paged, monkeypatch):
    """The dense and paged SlotDecoder with bf16 parameters over a float32
    cache, plain and speculative chunks (spec_k = 2): every decode call a
    bf16 query over the float32 cache (dense: B3 at T = 1 and 3; paged: B5
    per step, B4 per verification round), each held to the TPU kernel
    (``fused_reference`` for B3's verification chunks)."""
    _, te = _engines()
    rng = np.random.RandomState(3)
    B, L = 4, 16
    ids = rng.randint(1, te.llm_cfg.vocab_size, (B, L))
    mask = np.arange(L)[None, :] >= np.array([0, 5, 2, 9])[:, None]
    table = _np(te.llm_params["embed_tokens"])
    embeds = torch.from_numpy((table[ids] * mask[..., None]).astype(np.float32))
    dec = SlotDecoder(te.llm_params, te.llm_cfg, cache_dtype=te.cache_dtype, device="cpu",
                      eos_id=te.tokenizer.eos_id, n_slots=4, max_prompt_len=64,
                      max_new_tokens=12, paged=paged, spec_k=2)
    with checked_decode_calls(monkeypatch) as seen:
        dec.admit(embeds, torch.from_numpy(mask), [0, 1, 2, 3], [12, 9, 12, 10])
        for i in range(20):
            dec.decode_chunk(3, spec=i % 2 == 1)
            dec.harvest()
            if dec.live_count() == 0:
                break
    assert dec.live_count() == 0
    names = {n for n, _, _ in seen}
    assert names == ({"fused_paged_decode", "paged_decode_attention"} if paged
                     else {"fused_decode_attention_write"})
    assert {(qd, cd) for _, qd, cd in seen} == {(torch.bfloat16, torch.float32)}
