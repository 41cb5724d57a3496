"""The float32 decode kernels (``csrc/decode_f32.cu`` over
``csrc/dense_decode_f32.cuh``: B2, B3, B4, B5 and B8 at a float32 query) on
the CPU, before any card time:

  * each float32 instance's plain version (what a CPU tensor takes) at a
    float32 query over float32, int8 and bf16 caches or pools, held to the
    JAX kernel in Pallas interpret mode on the same float32 inputs: outputs
    within atol 1e-5 (float32 on both sides, summed in another order),
    cache, scale and page writes bit-exact;
  * a CPU emulation of the float32 body's arithmetic (chunks of 32 slots,
    the fresh block as the last split's last step, a base-2 online softmax,
    scores a lane pair's two halves of Dh, each in four interleaved partial
    sums, P . V summed over a chunk's keys in order, the splits merged in
    order) held to the JAX kernel within half of chip_smoke.py's float32
    bound, and the same emulation with p rounded to bf16 outside it;
  * the float32 body's split rule (``fused_decode.f32_splits``) at the
    shapes chip_smoke.py's split sweep times;
  * the wrappers' refusals of what is not ported (a float32 query with
    bf16 fresh values, float16) and their routing of a float32 query to
    the float32 instance, and of a bf16 query over a float32 cache to the
    mixed instance, on meta tensors, before any build;
  * the engine's batch path and the dense and paged slot decoders at the
    tiny float32 config, with a float32 and an int8 cache, held to the JAX
    package's under the margin-aware contract (``torch_streams.py``), every
    decode attention call taking a float32 query;
  * marked ``cuda``: each float32 instance against its plain version run in
    float64 on the card, within chip_smoke.py's float32 bound, at the serving
    shapes and at the body's edges: windows ending on a ring stage, one slot
    past the ring, on a chunk and on a split boundary, chunks crossing
    pages, at Dh 64 and 128.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_streams import assert_streams_agree, recorded_rows

import chip_smoke
from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.infer.slots import SlotDecoder as JaxSlotDecoder
from llm_speech_summarization_tpu.kernels.decode_attention import (
    decode_attention as jax_decode_attention,
)
from llm_speech_summarization_tpu.kernels.fused_decode import (
    _pad128,
    fused_decode_aliased_scales,
    fused_reference,
)
from llm_speech_summarization_tpu.kernels.fused_decode import (
    fused_decode_attention_write as jax_fused_write,
)
from llm_speech_summarization_tpu.kernels.fused_paged import (
    fused_paged_decode_write,
)
from llm_speech_summarization_tpu.kernels.fused_paged import (
    fused_paged_reference as jax_fused_paged_reference,
)
from llm_speech_summarization_tpu.kernels.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
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

ATOL = 1e-5  # float32 plain version against the float32 TPU kernel
CACHES = ("float32", "int8", "bfloat16")
NEG = -1e30
LOG2E = 1.4426950408889634
CH = 32  # slots per chunk of the float32 body


def _cache(rng, shape, cache):
    """An int8 cache with bf16 per-slot scales that keep |int8 x scale| <=
    ~1.5, or unit-scale float32 / bf16 values (numpy; bf16 as ml_dtypes)."""
    if cache == "int8":
        kc, vc = (rng.randint(-127, 128, size=shape).astype(np.int8) for _ in range(2))
        ks, vs = ((0.002 + 0.01 * rng.rand(*shape[:-1])).astype(ml_dtypes.bfloat16)
                  for _ in range(2))
        return kc, vc, ks, vs
    dt = np.float32 if cache == "float32" else ml_dtypes.bfloat16
    kc, vc = (rng.randn(*shape).astype(dt) for _ in range(2))
    return kc, vc, None, None


def _dense_case(seed, cache, T=1, L=2, B=4, Hq=6, Hkv=2, S=96, Dh=128):
    """Float32 q and fresh k/v over an (L, B, Hkv, S, Dh) cache; offsets at
    a chunk edge, past it, at the last slot(s) and nothing cached."""
    rng = np.random.RandomState(seed)
    kc, vc, ks, vs = _cache(rng, (L, B, Hkv, S, Dh), cache)
    q, kn, vn = (rng.randn(B, T, h, Dh).astype(np.float32) for h in (Hq, Hkv, Hkv))
    pads = np.array([0, 3, 5, 2], np.int32)[:B]
    offs = np.array([64, 70, S - T, 2], np.int32)[:B]
    return q, kc, vc, ks, vs, kn, vn, pads, offs


def _t(a):
    return None if a is None else bridge.tensor_from_numpy(np.ascontiguousarray(a))


def _np(t):
    return bridge.tensor_to_numpy(t)


def _same(got, want, what):
    got = _np(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got).astype(np.float64),
                                  np.asarray(want).astype(np.float64), err_msg=what)


# ---- the plain versions at a float32 query against the TPU kernels


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 3])
def test_b2_f32_plain_matches_jax_interpret(T, Dh):
    """B2 over the int8 cache: out within ATOL, the quantized fresh values
    and their (L, B, Hkv, S) scales written in place bit-exact."""
    layer = 1
    q, kc, vc, ks, vs, kn, vn, pads, offs = _dense_case(20 + T, "int8", T=T, Dh=Dh)
    S = kc.shape[3]
    pad_s = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros(a.shape[:-1] + (_pad128(S) - S,), a.dtype)], -1)
    want = fused_decode_aliased_scales(
        *map(jnp.asarray, (q, kc, vc, kn, vn, pads, offs)), jnp.int32(layer),
        jnp.asarray(pad_s(ks)), jnp.asarray(pad_s(vs)), interpret=True)
    bufs = [_t(a) for a in (kc, vc, ks, vs)]
    got = fd.fused_decode_f32(torch.from_numpy(q), *bufs, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pads),
                              torch.from_numpy(offs), layer)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    for g, w, name in zip(bufs, want[1:], ("k_cache", "v_cache", "k_scale", "v_scale")):
        w = np.asarray(w)
        _same(g, w[..., :S] if name.endswith("scale") else w, name)


@pytest.mark.parametrize("cache", CACHES)
def test_b3_f32_plain_matches_jax_interpret(cache):
    """B3 at T = 1 over a float32, int8 (one layer's scales read, the fresh
    ones returned) and bf16 cache: out within ATOL, the fresh values (a
    float32 cache's bit for bit) and scales bit-exact, nothing else
    written."""
    layer = 0
    q, kc, vc, ks, vs, kn, vn, pads, offs = _dense_case(30, cache)
    sc = {} if ks is None else dict(k_scale_layer=jnp.asarray(ks[layer]),
                                    v_scale_layer=jnp.asarray(vs[layer]))
    want = jax_fused_write(*map(jnp.asarray, (q, kc, vc, kn, vn, pads, offs)), jnp.int32(layer),
                           **sc, interpret=True)
    bufs = [_t(a) for a in (kc, vc)]
    res = fd.fused_decode_attention_write_f32(
        torch.from_numpy(q), *bufs, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(pads), torch.from_numpy(offs), layer,
        *(() if ks is None else (_t(ks[layer]), _t(vs[layer]))))
    out = res[0] if ks is not None else res
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    for g, w, old, name in zip(bufs, want[1:3], (kc, vc), ("k_cache", "v_cache")):
        _same(g, np.asarray(w), name)
        written = np.zeros(kc.shape[:4], bool)
        written[layer, np.arange(4), :, offs] = True
        _same(_np(g)[~written], old[~written], name)
    if cache == "float32":  # the fresh float32 values, bit for bit
        _same(bufs[0][layer, torch.arange(4), :, torch.from_numpy(offs)], kn[:, 0], "k fresh")
    if ks is not None:
        for g, w, name in zip(res[1:], want[3:], ("ks_new", "vs_new")):
            assert g.dtype == torch.bfloat16
            _same(g, np.asarray(w), name)


def test_b3_f32_plain_takes_a_verification_block():
    """T = 3 over a float32 cache (the TPU kernel takes T = 1; the JAX
    oracle takes the block, as a speculative verification forward over a
    float32 cache sends it): out within ATOL, the three fresh slots written
    as the oracle writes them."""
    layer = 1
    q, kc, vc, _, _, kn, vn, pads, offs = _dense_case(31, "float32", T=3)
    want = fused_reference(*map(jnp.asarray, (q, kc, vc, kn, vn, pads, offs)), jnp.int32(layer))
    bufs = [_t(a) for a in (kc, vc)]
    got = fd.fused_decode_attention_write_f32(
        torch.from_numpy(q), *bufs, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(pads), torch.from_numpy(offs), layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=ATOL, rtol=0)
    for g, w in zip(bufs, want[1:]):
        _same(g, np.asarray(w), "cache")


@pytest.mark.parametrize("cache", CACHES)
def test_b8_f32_plain_matches_jax_interpret(cache):
    """B8 reads one layer's view of a float32, int8 or bf16 cache in place;
    the TPU kernel gets that layer's slab."""
    layer, offset = 1, 90
    q, kc, vc, ks, vs, kn, vn, pads, _ = _dense_case(40, cache)
    sc = {} if ks is None else dict(k_scale=ks[layer], v_scale=vs[layer])
    want = jax_decode_attention(*map(jnp.asarray, (q, kc[layer], vc[layer], kn, vn, pads)),
                                jnp.int32(offset), **{k: jnp.asarray(v) for k, v in sc.items()},
                                interpret=True)
    kt, vt = _t(kc), _t(vc)
    got = da.decode_attention_f32(torch.from_numpy(q), kt[layer], vt[layer],
                                  torch.from_numpy(kn), torch.from_numpy(vn),
                                  torch.from_numpy(pads), offset,
                                  **{k: _t(v) for k, v in sc.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    _same(kt, kc, "read only")


def _paged_case(seed, pools, T, L=None, B=5, Hq=6, Hkv=2, Dh=128, ps=64, mp=3):
    """Distinct pages per row (page 0 = null), float32 q and fresh k/v;
    lengths at a page interior, a page's first slot, only the fresh block,
    the table's last slot(s) and (B5, ``L`` given) the boundary length ==
    ps * mp, whose token the oracle routes to page 0."""
    rng = np.random.RandomState(seed)
    P = 1 + B * mp
    lead = () if L is None else (L,)
    kp, vp, ks, vs = _cache(rng, lead + (P, Hkv, ps, Dh), pools)
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads = np.array([5, 0, 3, 2, 1], np.int32)[:B]
    lengths = np.array([2 * ps - 9, ps, 3, mp * ps - T, mp * ps if L else ps + 7],
                       np.int32)[:B]
    q, kn, vn = (rng.randn(B, T, h, Dh).astype(np.float32) for h in (Hq, Hkv, Hkv))
    return q, kp, vp, table, lengths, pads, kn, vn, ks, vs


@pytest.mark.parametrize("pools", CACHES)
@pytest.mark.parametrize("T", [1, 4])
def test_b4_f32_plain_matches_jax_interpret(T, pools):
    case = _paged_case(50 + T, pools, T)
    got = pa.paged_decode_attention_f32(*map(_t, case[:8]), k_scale=_t(case[8]),
                                        v_scale=_t(case[9]))
    args = [None if a is None else jnp.asarray(a) for a in case]
    want = jax_paged_decode_attention(*args[:8], k_scale=args[8], v_scale=args[9],
                                      interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("oracle", ["interpret", "xla"])
@pytest.mark.parametrize("pools", CACHES)
def test_b5_f32_plain_matches_jax(pools, oracle):
    """B5 at T = 1: out within ATOL of the TPU kernel (interpret mode) and
    of the JAX oracle; pools and scales bit-exact after the JAX call's
    fresh scales are scattered as llama_forward does. The oracle routes the
    boundary row's token to page 0, which the port writes too; the TPU
    kernel drops it, so page 0 is compared with the oracle only."""
    layer = 1
    q, kp, vp, table, lengths, pads, kn, vn, ks, vs = _paged_case(60, pools, 1, L=2)
    a = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    kw = dict(k_scale_layer=a(None if ks is None else ks[layer]),
              v_scale_layer=a(None if vs is None else vs[layer]))
    call = (a(q), a(kp), a(vp), a(table), a(lengths), a(pads), a(kn), a(vn), jnp.int32(layer))
    res = (fused_paged_decode_write(*call, interpret=True, **kw) if oracle == "interpret"
           else jax_fused_paged_reference(*call, **kw))
    bufs = [_t(x) for x in (kp, vp, ks, vs)]
    got = fp.fused_paged_decode_f32(torch.from_numpy(q), *bufs, torch.from_numpy(table),
                                    torch.from_numpy(lengths), torch.from_numpy(pads),
                                    torch.from_numpy(kn), torch.from_numpy(vn), layer)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(res[0]), atol=ATOL, rtol=0)
    want = [np.asarray(res[1]), np.asarray(res[2])]
    if ks is not None:
        ps, mp = kp.shape[3], table.shape[1]
        page_idx = lengths // ps
        pid = np.where(page_idx < mp, table[np.arange(5), np.clip(page_idx, 0, mp - 1)], 0)
        scales = [np.array(ks), np.array(vs)]
        for b in range(5):
            if oracle == "interpret" and page_idx[b] >= mp:
                continue  # the TPU kernel drops the boundary token
            for s, new in zip(scales, res[3:5]):
                s[layer, pid[b], :, lengths[b] % ps] = np.asarray(new)[b]
        want += scales
    for g, w in zip(bufs, want):
        g = _np(g)
        if oracle == "interpret":
            g, w = g[:, 1:], w[:, 1:]
        _same(g, w, "pools")


# ---- the float32 body's arithmetic, emulated


class _State:
    """A split's running max, sum and accumulator per row (base 2)."""

    def __init__(self, R, Dh):
        self.m = torch.full((R,), NEG)
        self.l = torch.zeros(R)
        self.acc = torch.zeros(R, Dh)

    def step(self, s, ok, p_weight, v, p_round):
        """Keys with base-2 scores s (R, n), valid where ok, p times
        ``p_weight`` (n,) in P . V, values v (n, Dh)."""
        mx = torch.where(ok, s, torch.tensor(NEG)).amax(-1)
        m_new = torch.maximum(self.m, mx)
        alpha = torch.exp2(self.m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros(()))
        self.l = self.l * alpha + p.sum(-1)
        pw = p * p_weight
        if p_round:
            pw = pw.bfloat16().float()
        self.acc = self.acc * alpha[:, None] + _in_order(pw[:, :, None] * v[None], 1)
        self.m = m_new

    def merge(self, other):
        M = torch.maximum(self.m, other.m)
        w0, w1 = torch.exp2(self.m - M), torch.exp2(other.m - M)
        self.l = self.l * w0 + other.l * w1
        self.acc = self.acc * w0[:, None] + other.acc * w1[:, None]
        self.m = M


def _partials(x, dim):
    """The sum over ``dim`` as the kernel takes it: four interleaved partial
    sums, then (s0 + s1) + (s2 + s3)."""
    n = x.shape[dim]
    parts = [x.narrow(dim, i, n - i).index_select(dim, torch.arange(0, n - i, 4)).sum(dim)
             if n > i else torch.zeros(()) for i in range(4)]
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _score(x, dim):
    """A score's sum over Dh (``dim``) as the kernel takes it: a lane for
    each half of Dh, each in four interleaved partial sums, then the two
    halves added."""
    h = x.shape[dim] // 2
    return _partials(x.narrow(dim, 0, h), dim) + _partials(x.narrow(dim, h, h), dim)


def _in_order(x, dim):
    """The sum over ``dim`` as P . V takes a chunk's keys: one after the
    other."""
    return x.cumsum(dim).select(dim, -1)


def emulate_f32(q, k, v, ks, vs, kn, vn, pads, offs, nsplit, p_round=False):
    """The float32 body on one layer's dense window: q (B, T, Hq, Dh), k / v
    (B, Hkv, S, Dh) float32 values with per-slot scales ks / vs (B, Hkv, S)
    (ones for a float cache), the fresh kn / vn (B, T, Hkv, Dh). Returns out
    (B, T, Hq, Dh) float32."""
    B, T, Hq, Dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    R = T * G
    scale2 = np.float32(Dh ** -0.5 * LOG2E)
    out = torch.zeros(B, T, Hq, Dh)
    for b in range(B):
        pad, c_end = max(int(pads[b]), 0), min(int(offs[b]), S)
        per = -(-max(c_end - pad, 0) // nsplit)
        for h in range(Hkv):
            qr = q[b, :, h * G:(h + 1) * G].reshape(R, Dh)  # rows (t, g)
            total = None
            for split in range(nsplit):
                lo = pad + split * per
                hi = min(lo + per, c_end)
                st = _State(R, Dh)
                for c0 in range(lo, hi, CH):
                    sl = slice(c0, min(c0 + CH, hi))
                    s = _score(qr[:, None, :] * k[b, h, sl][None], 2) * ks[b, h, sl] * scale2
                    st.step(s, torch.ones_like(s, dtype=torch.bool), vs[b, h, sl], v[b, h, sl],
                            p_round)
                if split == nsplit - 1:  # the fresh block, causal, the last step
                    s = _score(qr[:, None, :] * kn[b, :, h][None], 2) * scale2
                    ok = torch.arange(T)[None, :] <= torch.arange(R)[:, None] // G
                    st.step(s, ok, torch.ones(T), vn[b, :, h], p_round)
                if total is None:
                    total = st
                else:
                    total.merge(st)
            o = (total.acc / total.l[:, None]).reshape(T, G, Dh)
            out[b, :, h * G:(h + 1) * G] = o
    return out


def _bound(q, k, v, kn, vn, pads, offs):
    """chip_smoke.py's float32 bound, from the float64 plain version."""
    S = k.shape[2]
    slot = torch.arange(S)
    valid = (slot[None] >= torch.from_numpy(pads)[:, None]) & \
        (slot[None] < torch.from_numpy(offs)[:, None])
    ref = chip_smoke._f64_decode(torch, q, k.double(), v.double(), kn, vn, valid)
    abs_pv = chip_smoke._f64_decode(torch, q, k.double(), v.double().abs(), kn, vn.abs(), valid)
    return chip_smoke.F32_OUT_ATOL + chip_smoke.F32_OUT_RTOL * (ref.abs() + abs_pv)


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 3])
def test_f32_body_emulation_within_half_the_chip_bound(T, nsplit):
    """The emulated body over an int8 cache (the B2 instance) against the
    JAX B2 kernel in interpret mode at float32; with p rounded to bf16 (the
    bf16 body's rounding) it leaves the bound."""
    layer = 1
    q, kc, vc, ks, vs, kn, vn, pads, offs = _dense_case(70 + T, "int8", T=T, S=256)
    offs = np.array([250 - T, 0, 180, 97], np.int32)
    S = kc.shape[3]
    pad_s = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros(a.shape[:-1] + (_pad128(S) - S,), a.dtype)], -1)
    want = torch.from_numpy(np.array(fused_decode_aliased_scales(
        *map(jnp.asarray, (q, kc, vc, kn, vn, pads, offs)), jnp.int32(layer),
        jnp.asarray(pad_s(ks)), jnp.asarray(pad_s(vs)), interpret=True)[0]))
    qt, knt, vnt = (torch.from_numpy(x) for x in (q, kn, vn))
    k = torch.from_numpy(kc[layer].astype(np.float32))
    v = torch.from_numpy(vc[layer].astype(np.float32))
    kst, vst = (torch.from_numpy(x[layer].astype(np.float32)) for x in (ks, vs))
    bound = _bound(qt, k * kst[..., None], v * vst[..., None], knt, vnt, pads, offs)
    got = emulate_f32(qt, k, v, kst, vst, knt, vnt, pads, offs, nsplit)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() / bound).max().item() <= 0.5
    rounded = emulate_f32(qt, k, v, kst, vst, knt, vnt, pads, offs, nsplit, p_round=True)
    assert ((rounded - want).abs() / bound).max().item() > 1


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("pools", ["float32", "int8"])
def test_f32_paged_emulation_within_half_the_chip_bound(pools, nsplit):
    """The paged instance reads each slot through its page: its window,
    gathered, through the emulated body against the JAX B4 kernel (T = 4,
    ps = 64: chunks of 32 cross pages wherever a pad is not a multiple of
    32)."""
    T = 4
    q, kp, vp, table, lengths, pads, kn, vn, ks, vs = _paged_case(80, pools, T)
    args = [None if x is None else jnp.asarray(x)
            for x in (q, kp, vp, table, lengths, pads, kn, vn, ks, vs)]
    want = torch.from_numpy(np.array(jax_paged_decode_attention(
        *args[:8], k_scale=args[8], v_scale=args[9], interpret=True)))
    B, mp, (P, Hkv, ps, Dh) = table.shape[0], table.shape[1], kp.shape
    tt = torch.from_numpy(table).long()

    def dense(pool, sc):
        x = torch.from_numpy(pool.astype(np.float32))[tt].transpose(1, 2).reshape(
            B, Hkv, mp * ps, Dh)
        s = (torch.ones(B, Hkv, mp * ps) if sc is None else torch.from_numpy(
            sc.astype(np.float32))[tt].transpose(1, 2).reshape(B, Hkv, mp * ps))
        return x, s

    (k, kst), (v, vst) = dense(kp, ks), dense(vp, vs)
    qt, knt, vnt = (torch.from_numpy(x) for x in (q, kn, vn))
    bound = _bound(qt, k * kst[..., None], v * vst[..., None], knt, vnt, pads, lengths)
    got = emulate_f32(qt, k, v, kst, vst, knt, vnt, pads, lengths, nsplit)
    assert ((got - want).abs() / bound).max().item() <= 0.5


# ---- the float32 body's split rule at the split sweep's shapes


@pytest.mark.parametrize("B,want", [(1, None), (8, 4), (16, 2), (128, 1)])
def test_f32_splits_keep_one_wave_of_two_blocks_an_sm(B, want):
    """``f32_splits`` at chip_smoke.py's --split-sweep f32 shapes (24/8
    heads, max offsets 255-2047) on an H100's 132 SMs: as many splits as
    keep the grid within two blocks an SM (B=8: 256 blocks, B=16: 256, B=128:
    1024 blocks, one split), at most 16, each split keeping a chunk of 32
    slots (B=1: offset // 32)."""
    for mo in chip_smoke.SWEEP_OFFSETS:
        n = fd.f32_splits(B, 8, mo, 132)
        assert n == (want if want is not None else min(16, mo // 32))
        assert B * 8 * n <= 2 * 132 or n == 1


def test_f32_splits_at_the_serving_shapes():
    """B8 mixed (B=8, offset 368): 4 splits, 256 blocks on 132 SMs; the
    paged serving shape (B=16, the table bound 7 x 128): 2; MiniChat's 24
    kv heads at B=16: 1; windows shorter than two chunks, nothing cached,
    and a smaller card."""
    assert fd.f32_splits(8, 8, 368, 132) == 4
    assert fd.f32_splits(16, 8, 7 * 128, 132) == 2
    assert fd.f32_splits(16, 24, 7 * 128, 132) == 1
    assert fd.f32_splits(8, 8, 63, 132) == 1
    assert fd.f32_splits(8, 8, 64, 132) == 2
    assert fd.f32_splits(2, 2, 0, 132) == 1
    assert fd.f32_splits(1, 8, 2047, 16) == 4
    assert fd.F32_MAX_SPLITS == 16  # the merge kernel's MAX_SPLITS in csrc/dense_decode_f32.cuh


# ---- the CUDA route's checks on meta tensors (they stand for CUDA ones)


@pytest.fixture
def meta_route(monkeypatch):
    """Every decode wrapper takes meta tensors for CUDA ones, and the
    float32 launch records its call instead of building the library."""
    calls = []
    for mod in (fd, da, pa, fp):
        monkeypatch.setattr(mod, "_devices", lambda what, tensors: "cuda")

    def launch(wrapper, q, k_cache, *args, page_table=None, write=False, **kw):
        calls.append(dict(wrapper=wrapper, cache=k_cache.dtype, paged=page_table is not None,
                          write=write))
        return torch.empty(q.shape, dtype=torch.float32, device="meta")

    for mod in (fd, da, pa, fp):
        monkeypatch.setattr(mod, "launch_f32", launch)
    monkeypatch.setattr(fd, "sm_count", lambda index: 132)
    monkeypatch.setattr(da, "sm_count", lambda index: 132)
    # meta tensors have no storage of their own: every one starts at 0
    monkeypatch.setattr(fd, "check_separate_storage", lambda what, tensors: None)
    monkeypatch.setattr(pa, "check_separate_storage", lambda what, tensors: None)
    return calls


def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _meta_dense(q_dtype, cache, fresh=None, T=1):
    q = _meta((4, T, 6, 128), q_dtype)
    kc = _meta((2, 4, 2, 64, 128), cache)
    kn = _meta((4, T, 2, 128), fresh or q_dtype)
    idx = _meta((4,), torch.int32)
    scales = [_meta((2, 4, 2, 64), torch.bfloat16) for _ in range(2)] \
        if cache == torch.int8 else [None, None]
    return q, kc, kc.clone(), scales, kn, kn.clone(), idx


def _meta_paged(q_dtype, pools, fresh=None, T=1, L=None):
    lead = () if L is None else (L,)
    q = _meta((4, T, 6, 128), q_dtype)
    kp = _meta(lead + (9, 2, 64, 128), pools)
    kn = _meta((4, T, 2, 128), fresh or q_dtype)
    scales = [_meta(lead + (9, 2, 64), torch.bfloat16) for _ in range(2)] \
        if pools == torch.int8 else [None, None]
    table = _meta((4, 2), torch.int32)
    idx = _meta((4,), torch.int32)
    return q, kp, kp.clone(), scales, table, idx, kn, kn.clone()


def test_float32_queries_take_the_float32_instances(meta_route):
    """A float32 query goes to each kernel's float32 instance, over int8,
    float32 and bf16 caches and pools, with the layout and write each
    needs; a bf16 one stays on the bf16 kernels (not recorded here)."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    q, kc, vc, (ks, vs), kn, vn, idx = _meta_dense(f32, i8, T=3)
    fd.fused_decode(q, kc, vc, ks, vs, kn, vn, idx, idx, 1, max_offset=60)
    for cache in (f32, bf16, i8):
        T = 1 if cache == i8 else 3
        q, kc, vc, (ks, vs), kn, vn, idx = _meta_dense(f32, cache, T=T)
        sc = () if ks is None else (ks[1], vs[1])
        fd.fused_decode_attention_write(q, kc, vc, kn, vn, idx, idx, 1, *sc, max_offset=60)
        q, kc, vc, (ks, vs), kn, vn, idx = _meta_dense(f32, cache)
        sc = () if ks is None else (ks[1], vs[1])
        da.decode_attention(q, kc[1], vc[1], kn, vn, idx, 60, *sc)
        q, kp, vp, (ks, vs), table, idx, kn, vn = _meta_paged(f32, cache, T=4)
        pa.paged_decode_attention(q, kp, vp, table, idx, idx, kn, vn, ks, vs)
        q, kp, vp, (ks, vs), table, idx, kn, vn = _meta_paged(f32, cache, L=2)
        fp.fused_paged_decode(q, kp, vp, ks, vs, table, idx, idx, kn, vn, 1)
    got = [(c["wrapper"].__name__, c["cache"], c["paged"], c["write"]) for c in meta_route]
    want = [("fused_decode_f32", i8, False, True)]
    for cache in (f32, bf16, i8):
        want += [("fused_decode_attention_write_f32", cache, False, True),
                 ("decode_attention_f32", cache, False, False),
                 ("paged_decode_attention_f32", cache, True, False),
                 ("fused_paged_decode_f32", cache, True, True)]
    assert got == want


def test_wrappers_refuse_what_is_not_ported(meta_route):
    """A float32 query with bf16 fresh values and float16 raise a
    ValueError naming what is not ported, before any build; a bf16 query
    over a float32 cache or pools is ported (the mixed instances) and
    reaches their launches, nothing else; B2 sends a float cache to B3, and
    B3's int8 mode keeps T = 1 at float32 too."""
    f32, bf16, i8, f16 = torch.float32, torch.bfloat16, torch.int8, torch.float16
    mixed = "mixed dtypes are not ported"
    q, kc, vc, (ks, vs), kn, vn, idx = _meta_dense(f32, i8, fresh=bf16)
    with pytest.raises(ValueError, match=mixed):
        fd.fused_decode(q, kc, vc, ks, vs, kn, vn, idx, idx, 1, max_offset=8)
    q, kc, vc, _, kn, vn, idx = _meta_dense(f32, f32, fresh=bf16)
    with pytest.raises(ValueError, match=mixed):
        fd.fused_decode_attention_write(q, kc, vc, kn, vn, idx, idx, 1, max_offset=8)
    with pytest.raises(ValueError, match=mixed):
        da.decode_attention(q, kc[1], vc[1], kn, vn, idx, 8)
    q, kp, vp, _, table, idx, kn, vn = _meta_paged(f32, f32, fresh=bf16)
    with pytest.raises(ValueError, match=mixed):
        pa.paged_decode_attention(q, kp, vp, table, idx, idx, kn, vn)
    q, kp, vp, _, table, idx, kn, vn = _meta_paged(f32, f32, fresh=bf16, L=2)
    with pytest.raises(ValueError, match=mixed):
        fp.fused_paged_decode(q, kp, vp, None, None, table, idx, idx, kn, vn, 1)
    assert meta_route == []  # nothing reached a launch
    # a bf16 query over a float32 cache or pools: the mixed instances
    q, kc, vc, _, kn, vn, idx = _meta_dense(bf16, f32)
    fd.fused_decode_attention_write(q, kc, vc, kn, vn, idx, idx, 1, max_offset=8)
    da.decode_attention(q, kc[1], vc[1], kn, vn, idx, 8)
    q, kp, vp, _, table, idx, kn, vn = _meta_paged(bf16, f32, T=4)
    pa.paged_decode_attention(q, kp, vp, table, idx, idx, kn, vn)
    q, kp, vp, _, table, idx, kn, vn = _meta_paged(bf16, f32, L=2)
    fp.fused_paged_decode(q, kp, vp, None, None, table, idx, idx, kn, vn, 1)
    assert [(c["wrapper"].__name__, c["cache"]) for c in meta_route] == [
        ("fused_decode_attention_write_mixed", f32), ("decode_attention_mixed", f32),
        ("paged_decode_attention_mixed", f32), ("fused_paged_decode_mixed", f32)]
    meta_route.clear()
    q, kc, vc, _, kn, vn, idx = _meta_dense(f16, f16)
    with pytest.raises(ValueError, match="float16 query is not ported"):
        fd.fused_decode_attention_write(q, kc, vc, kn, vn, idx, idx, 1, max_offset=8)
    q, kc, vc, _, kn, vn, idx = _meta_dense(f32, f32)
    with pytest.raises(ValueError, match="goes to fused_decode_attention_write"):
        fd.fused_decode(q, kc, vc, None, None, kn, vn, idx, idx, 1, max_offset=8)
    q, kc, vc, (ks, vs), kn, vn, idx = _meta_dense(f32, i8, T=2)
    with pytest.raises(ValueError, match="takes T = 1"):
        fd.fused_decode_attention_write(q, kc, vc, kn, vn, idx, idx, 1, ks[1], vs[1],
                                        max_offset=8)
    q, kc, vc, _, kn, vn, idx = _meta_dense(f32, f32, T=3)
    with pytest.raises(ValueError, match="exceeds the cache length"):
        fd.fused_decode_attention_write(q, kc, vc, kn, vn, idx, idx, 1, max_offset=62)
    assert meta_route == []  # nothing reached a launch


# ---- the engine and the slot decoders at the tiny float32 config


TINY_YAML = str(YAML_DIR / "tiny_test.yaml")
JAX_TINY_YAML = str(YAML_DIR.parents[2] / "llm_speech_summarization_tpu" / "configs" / "yaml"
                    / "tiny_test.yaml")


def _engines(cache):
    """The JAX and the port's engine at the tiny float32 config (float32
    parameters and compute) with a float32 (``kv_cache_dtype`` null) or
    int8 cache, on the JAX engine's weights."""
    cfgs = [jax_load_config(JAX_TINY_YAML), load_config(TINY_YAML)]
    for c in cfgs:
        assert c.model.compute_dtype == c.model.param_dtype == "float32"
        c.model.kv_cache_dtype = None if cache == "float32" else cache
    je = JaxEngine(cfgs[0])
    te = LLMSpeechTextInference(
        cfgs[1], device="cpu",
        llm_params=bridge.llama_params_from_numpy(jax.tree.map(np.asarray, je.llm_params)),
        audio_encoder_params=bridge.encoder_params_from_numpy(
            jax.tree.map(np.asarray, je.audio_encoder_params)))
    return je, te


@pytest.fixture
def decode_calls(monkeypatch):
    """(wrapper name, q dtype, cache dtype) of every decode attention call
    the port's LLM makes."""
    seen = []
    for name in ("fused_decode", "fused_decode_attention_write", "decode_attention",
                 "paged_decode_attention", "fused_paged_decode"):
        fn = getattr(tllama, name)

        def record(*args, _fn=fn, _name=name, **kw):
            seen.append((_name, args[0].dtype, args[1].dtype))
            return _fn(*args, **kw)

        monkeypatch.setattr(tllama, name, record)
    return seen


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_engine_batch_path_f32_matches_jax(cache, decode_calls):
    """``generate_audio_response_batch`` at compute_dtype float32: the
    port's rows against the JAX engine's under the margin-aware contract;
    every decode step a float32 query over the cache (B2 over int8, B3
    over float32), as the port's float32 instances take them on the card."""
    je, te = _engines(cache)
    assert te.cache_dtype == (torch.float32 if cache == "float32" else torch.int8)
    rng = np.random.RandomState(5)
    clips = [(0.1 * rng.randn(n)).astype(np.float32) for n in (8000, 5600, 12345)]
    with recorded_rows(JaxByteTokenizer) as jax_rows:
        je.generate_audio_response_batch(clips, max_new_tokens=12)
    with recorded_rows(ByteTokenizer) as port_rows:
        te.generate_audio_response_batch(clips, max_new_tokens=12)
    embeds, mask = je.build_audio_prompt_batch(clips)
    assert_streams_agree(jax_rows, port_rows,
                         lambda i: (je, np.asarray(embeds)[i:i + 1], np.asarray(mask)[i:i + 1]))
    dense = "fused_decode" if cache == "int8" else "fused_decode_attention_write"
    assert decode_calls and set(decode_calls) == {(dense, torch.float32, te.cache_dtype)}


@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_slot_decoders_f32_match_jax(paged, cache, decode_calls):
    """The dense and paged SlotDecoder at float32 over a float32 and an int8
    cache, plain and speculative chunks, against the JAX decoder on the
    same prompts: rows under the margin-aware contract, every decode call
    a float32 query over the cache (paged: B5 per step, B4 per
    verification round)."""
    je, te = _engines(cache)
    rng = np.random.RandomState(3)
    B, L = 4, 16
    ids = rng.randint(1, je.llm_cfg.vocab_size, (B, L))
    mask = np.arange(L)[None, :] >= np.array([0, 5, 2, 9])[:, None]
    embeds = (np.asarray(je.llm_params["embed_tokens"], np.float32)[ids]
              * mask[..., None]).astype(np.float32)
    kw = dict(eos_id=te.tokenizer.eos_id, n_slots=4, max_prompt_len=64, max_new_tokens=12,
              paged=paged, spec_k=2)
    jdt = jnp.float32 if cache == "float32" else jnp.int8
    jd = JaxSlotDecoder(je.llm_params, je.llm_cfg, cache_dtype=jdt, **kw)
    td = SlotDecoder(te.llm_params, te.llm_cfg, cache_dtype=te.cache_dtype, device="cpu", **kw)

    def run(dec, to):
        dec.admit(to(embeds), to(mask), [0, 1, 2, 3], [12, 9, 12, 10])
        out = {}
        for i in range(20):
            dec.decode_chunk(3, spec=i % 2 == 0)
            out.update({s: [int(x) for x in t[:n]] for s, t, n in dec.harvest()})
            if dec.live_count() == 0:
                break
        assert dec.live_count() == 0
        return [out[s] for s in range(B)]

    want = run(jd, jnp.asarray)
    got = run(td, torch.from_numpy)
    assert_streams_agree(want, got, lambda i: (je, embeds[i:i + 1], mask[i:i + 1]))
    names = {n for n, _, _ in decode_calls}
    assert names == ({"fused_paged_decode", "paged_decode_attention"} if paged
                     else {"fused_decode" if cache == "int8" else
                           "fused_decode_attention_write"})
    assert {(qd, cd) for _, qd, cd in decode_calls} == {(torch.float32, te.cache_dtype)}


# ---- on the card: each float32 instance against its plain version in float64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


def _within(got, c, kv, rows=None):
    """chip_smoke.py's float32 check (the float64 plain version, the bound
    and its faults) on ``rows`` (all by default)."""
    rows = torch.ones(got.shape[0], dtype=torch.bool, device=got.device) if rows is None \
        else rows
    return chip_smoke._f32_decode_check(torch, "card", got, c, kv, rows)["err_over_bound"]


@pytest.mark.cuda
@pytest.mark.parametrize("cache", CACHES)
def test_dense_f32_instances_on_card(card, cache):
    """B2 (int8 only), B3 and B8 at a float32 query: within the bound, and
    B2's and B3's writes equal to the plain version's."""
    rng = np.random.RandomState(90)
    layer = 1
    for T in (1, 3) if cache != "int8" else (1,):
        c = chip_smoke._f32_dense_case(torch, rng, 4, T, 200, cache)
        mo = int(c["offs_np"].max())
        bufs = [c[k].clone() for k in ("kc", "vc")]
        ref_bufs = [x.clone() for x in bufs]
        sc = (c["ks"][layer], c["vs"][layer]) if cache == "int8" else ()
        got = fd.fused_decode_attention_write(c["q"], *bufs, c["kn"], c["vn"], c["pads"],
                                              c["offs"], layer, *sc, max_offset=mo)
        plain = fd.fused_decode_attention_write_reference(c["q"], *ref_bufs, c["kn"], c["vn"],
                                                          c["pads"], c["offs"], layer, *sc)
        if sc:
            assert all(torch.equal(g, p) for g, p in zip(got[1:], plain[1:]))
            got = got[0]
        assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
        assert _within(got, c, chip_smoke._f64_dense(torch, c, layer)) <= 1
        if cache == "int8":
            bufs = [c[k].clone() for k in ("kc", "vc", "ks", "vs")]
            ref_bufs = [x.clone() for x in bufs]
            got = fd.fused_decode(c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer,
                                  max_offset=mo)
            fd.fused_decode_reference(c["q"], *ref_bufs, c["kn"], c["vn"], c["pads"],
                                      c["offs"], layer)
            assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
            assert _within(got, c, chip_smoke._f64_dense(torch, c, layer)) <= 1
    c = chip_smoke._f32_dense_case(torch, rng, 4, 1, 200, cache)
    offset = 190
    slot = torch.arange(200, device=card)
    c["valid"] = (slot >= c["pads"][:, None]) & (slot < offset)
    c["live"] = offset > c["pads"]
    sc = (c["ks"][layer], c["vs"][layer]) if cache == "int8" else ()
    got = da.decode_attention(c["q"], c["kc"][layer], c["vc"][layer], c["kn"], c["vn"],
                              c["pads"], offset, *sc)
    assert got.dtype == torch.float32
    assert _within(got, c, chip_smoke._f64_dense(torch, c, layer)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("pools", CACHES)
def test_paged_f32_instances_on_card(card, pools):
    """B4 (T = 4) and B5 (T = 1, the page write equal to the plain
    version's outside page 0) at a float32 query over the serving shape's
    pages."""
    rng = np.random.RandomState(91)
    layer = 1
    for T, write in ((4, False), (1, True)):
        c = chip_smoke._f32_paged_case(torch, rng, T, write, pools)
        q8 = pools == "int8"
        rows = torch.from_numpy((c["table_np"] != 0).all(axis=1)).to(card)
        snap = [x.clone() for x in (c["kp"], c["vp"], c["ks"], c["vs"]) if x is not None]
        if write:
            bufs, ref_bufs = [x.clone() for x in snap], [x.clone() for x in snap]
            extra = [] if q8 else [None, None]
            got = fp.fused_paged_decode(c["q"], *bufs, *extra, c["table"], c["lens"],
                                        c["pads"], c["kn"], c["vn"], layer)
            fp.fused_paged_reference(c["q"], *ref_bufs, *extra, c["table"], c["lens"],
                                     c["pads"], c["kn"], c["vn"], layer)
            assert all(torch.equal(g[:, 1:], p[:, 1:]) for g, p in zip(bufs, ref_bufs))
        else:
            got = pa.paged_decode_attention(c["q"], c["kp"][layer], c["vp"][layer], c["table"],
                                            c["lens"], c["pads"], c["kn"], c["vn"],
                                            *((c["ks"][layer], c["vs"][layer]) if q8 else ()))
        assert got.dtype == torch.float32
        kv = chip_smoke._f64_paged(torch, dict(c, kp=snap[0], vp=snap[1],
                                               ks=snap[2] if q8 else None,
                                               vs=snap[3] if q8 else None), layer)
        assert _within(got, c, kv, rows) <= 1


# the float32 body's ring of chunks of 32 slots: its stages at each cache
# type and Dh (csrc/dense_decode_f32.cuh, Ring<CT, DH>::STAGES), so that the
# edge cases below end windows and splits on a stage, a ring and a chunk
RING_STAGES = {("float32", 128): 3, ("float32", 64): 6, ("bfloat16", 128): 6,
               ("bfloat16", 64): 8, ("int8", 128): 8, ("int8", 64): 8}


def _edge_windows(cache, Dh, S, T):
    """(pads, offsets) of four rows: a window of exactly one ring, one
    starting on a chunk boundary and one slot past a ring, one of two rings
    from an odd start, and one a slot short of two rings."""
    span = 32 * RING_STAGES[(cache, Dh)]
    pads = np.array([0, 32, 5, 0], np.int32)
    offs = np.minimum(np.array([span, 32 + span + 1, 5 + 2 * span, 2 * span - 1]), S - T)
    return pads, offs.astype(np.int32)


def _set_windows(c, pads, offs, device):
    S = c["kc"].shape[3]
    c["pads"], c["offs"] = (torch.from_numpy(a).to(device) for a in (pads, offs))
    c["pads_np"], c["offs_np"] = pads, offs
    slot = torch.arange(S, device=device)
    c["valid"] = (slot >= c["pads"][:, None]) & (slot < c["offs"][:, None])
    c["live"] = c["offs"] > c["pads"]
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("cache", CACHES)
def test_dense_f32_ring_and_split_edges_on_card(card, cache, Dh, nsplit, monkeypatch):
    """B3 (T = 1 and 3; over int8, B3 with one layer's scales at T = 1 and
    B2 at T = 1 and 3) and B8 with windows that end on a ring stage, one
    slot past the ring, on a chunk and on a split boundary (the split count
    forced), at Dh 64 and 128: within the float32 bound, the writes equal
    to the plain version's."""
    monkeypatch.setattr(fd, "f32_splits", lambda *args: nsplit)
    rng = np.random.RandomState(94)
    layer, S = 1, 520
    for T in (1, 3):
        c = chip_smoke._f32_dense_case(torch, rng, 4, T, S, cache, Hq=6, Hkv=2, Dh=Dh)
        c = _set_windows(c, *_edge_windows(cache, Dh, S, T), card)
        mo = int(c["offs_np"].max())
        if cache != "int8" or T == 1:
            bufs = [c[k].clone() for k in ("kc", "vc")]
            ref_bufs = [x.clone() for x in bufs]
            sc = (c["ks"][layer], c["vs"][layer]) if cache == "int8" else ()
            got = fd.fused_decode_attention_write(c["q"], *bufs, c["kn"], c["vn"], c["pads"],
                                                  c["offs"], layer, *sc, max_offset=mo)
            plain = fd.fused_decode_attention_write_reference(
                c["q"], *ref_bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer, *sc)
            if sc:
                assert all(torch.equal(g, p) for g, p in zip(got[1:], plain[1:]))
                got = got[0]
            assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
            assert _within(got, c, chip_smoke._f64_dense(torch, c, layer)) <= 1
        if cache == "int8":
            bufs = [c[k].clone() for k in ("kc", "vc", "ks", "vs")]
            ref_bufs = [x.clone() for x in bufs]
            got = fd.fused_decode(c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer,
                                  max_offset=mo)
            fd.fused_decode_reference(c["q"], *ref_bufs, c["kn"], c["vn"], c["pads"],
                                      c["offs"], layer)
            assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
            assert _within(got, c, chip_smoke._f64_dense(torch, c, layer)) <= 1
    c = chip_smoke._f32_dense_case(torch, rng, 4, 1, S, cache, Hq=6, Hkv=2, Dh=Dh)
    pads, offs = _edge_windows(cache, Dh, S, 1)
    offset = int(offs[2])
    c = _set_windows(c, pads, np.full_like(offs, offset), card)
    sc = (c["ks"][layer], c["vs"][layer]) if cache == "int8" else ()
    got = da.decode_attention(c["q"], c["kc"][layer], c["vc"][layer], c["kn"], c["vn"],
                              c["pads"], offset, *sc)
    assert _within(got, c, chip_smoke._f64_dense(torch, c, layer)) <= 1


def _edge_paged_case(rng, pools, Dh, T, write, device, ps=16, mp=40, L=2, Hq=6, Hkv=2):
    """Pools of ``pools`` at page size 16 (every chunk of 32 crosses a page)
    under a shuffled table, with _edge_windows' rows as pads and lengths."""
    B = 4
    P = 1 + B * mp
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    if pools == "int8":
        kp, vp = (torch.from_numpy(rng.randint(-127, 128, size=(L, P, Hkv, ps, Dh))
                                   .astype(np.int8)).to(device) for _ in range(2))
        ks, vs = (f32(0.002 + 0.01 * rng.rand(L, P, Hkv, ps)).bfloat16() for _ in range(2))
    else:
        dt = torch.float32 if pools == "float32" else torch.bfloat16
        kp, vp = (f32(rng.randn(L, P, Hkv, ps, Dh)).to(dt) for _ in range(2))
        ks = vs = None
    table_np = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads_np, lens_np = _edge_windows(pools, Dh, mp * ps, T)
    q, kn, vn = (f32(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    lens, pads, table = (torch.from_numpy(a).to(device) for a in (lens_np, pads_np, table_np))
    pos = torch.arange(mp * ps, device=device)
    return dict(q=q, kn=kn, vn=vn, kp=kp, vp=vp, ks=ks, vs=vs, table=table, lens=lens,
                pads=pads, table_np=table_np, quantized=pools == "int8",
                valid=(pos >= pads[:, None]) & (pos < lens[:, None]), live=lens > pads)


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("pools", CACHES)
def test_paged_f32_ring_and_page_edges_on_card(card, pools, Dh, nsplit, monkeypatch):
    """B4 (T = 4) and B5 (T = 1) over pages of 16 slots, so that every
    chunk of 32 crosses a page, with the ring, chunk and split edges of the
    dense test: within the float32 bound, B5's page write equal to the
    plain version's."""
    monkeypatch.setattr(fd, "f32_splits", lambda *args: nsplit)
    rng = np.random.RandomState(95)
    layer = 1
    for T, write in ((4, False), (1, True)):
        c = _edge_paged_case(rng, pools, Dh, T, write, card)
        q8 = pools == "int8"
        kv = chip_smoke._f64_paged(torch, c, layer)  # before the write
        if write:
            bufs = [x.clone() for x in (c["kp"], c["vp"], c["ks"], c["vs"]) if x is not None]
            ref_bufs = [x.clone() for x in bufs]
            extra = [] if q8 else [None, None]
            args = (c["table"], c["lens"], c["pads"], c["kn"], c["vn"], layer)
            got = fp.fused_paged_decode(c["q"], *bufs, *extra, *args)
            fp.fused_paged_reference(c["q"], *ref_bufs, *extra, *args)
            assert all(torch.equal(g, p) for g, p in zip(bufs, ref_bufs))
        else:
            got = pa.paged_decode_attention(c["q"], c["kp"][layer], c["vp"][layer], c["table"],
                                            c["lens"], c["pads"], c["kn"], c["vn"],
                                            *((c["ks"][layer], c["vs"][layer]) if q8 else ()))
        assert _within(got, c, kv) <= 1
