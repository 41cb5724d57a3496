"""The port's dense-cache decode kernels B3 (``fused_decode_attention_write``)
and B8 (``decode_attention``): plain versions against the JAX kernels run in
Pallas interpret mode, the refusals of the wrappers, and — marked ``cuda`` —
each CUDA kernel against its plain version on the card.

CPU tolerances: float32 queries over a bf16 or int8 cache, the same
algorithm summed in another order (atol 1e-5; 5e-5 for B8, whose TPU kernel
folds the fresh token in unrounded where the plain version rounds p to q's
dtype, a no-op in float32). Cache writes and returned scales are held
bit-exact, and every other cache slot unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.kernels.decode_attention import (
    decode_attention as jax_decode_attention,
)
from llm_speech_summarization_tpu.kernels.fused_decode import (
    fused_decode_attention_write as jax_fused_write,
)
from llm_speech_summarization_tpu.kernels.fused_decode import fused_reference
from llm_speech_summarization_tpu_torch.bridge import tensor_from_numpy, tensor_to_numpy
from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod
from llm_speech_summarization_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
    _quantize_kv,
    fused_decode_attention_write,
    fused_decode_attention_write_reference,
)

torch.set_num_threads(1)


def _case(seed, T=1, L=2, B=4, Hq=6, Hkv=2, S=64, Dh=128, quantized=False):
    """tests/test_fused_decode.py's shapes: offsets spread across 32-slot
    windows, one at the last slot(s); a bf16 cache, or int8 values with
    realistic bf16 scales (|int8 x scale| <= ~1.5)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, Hq, Dh).astype(np.float32)
    kn = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    vn = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    pads = rng.randint(0, 5, size=(B,)).astype(np.int32)
    offs = np.array([31, 32, S - T, 17], np.int32)[:B]
    if quantized:
        kc = rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)
        vc = rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)
        ks = np.asarray(jnp.asarray(0.002 + 0.01 * rng.rand(L, B, Hkv, S), jnp.bfloat16))
        vs = np.asarray(jnp.asarray(0.002 + 0.01 * rng.rand(L, B, Hkv, S), jnp.bfloat16))
    else:
        kc = np.asarray(jnp.asarray(rng.randn(L, B, Hkv, S, Dh), jnp.bfloat16))
        vc = np.asarray(jnp.asarray(rng.randn(L, B, Hkv, S, Dh), jnp.bfloat16))
        ks = vs = None
    return q, kc, vc, ks, vs, kn, vn, pads, offs


def _port_b3(case, layer):
    """The port's B3 on CPU tensors: (out, caches, fresh scales or None)."""
    q, kc, vc, ks, vs, kn, vn, pads, offs = case
    bufs = [tensor_from_numpy(a) for a in (kc, vc)]
    scales = {} if ks is None else dict(k_scale_layer=tensor_from_numpy(ks[layer]),
                                        v_scale_layer=tensor_from_numpy(vs[layer]))
    res = fused_decode_attention_write(torch.from_numpy(q), *bufs, torch.from_numpy(kn),
                                       torch.from_numpy(vn), torch.from_numpy(pads),
                                       torch.from_numpy(offs), layer, **scales)
    out, fresh = (res[0], res[1:]) if ks is not None else (res, None)
    return out, bufs, fresh


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("quantized", [False, True])
def test_b3_plain_matches_jax_interpret(quantized, layer):
    """The TPU kernel (interpret mode) and the plain version on the same
    inputs: outputs within atol 1e-5, both caches and the fresh scales
    bit-exact, every slot but the fresh ones unchanged."""
    case = _case(10 + layer, quantized=quantized)
    q, kc, vc, ks, vs, kn, vn, pads, offs = case
    want = jax_fused_write(
        *map(jnp.asarray, (q, kc, vc, kn, vn, pads, offs)), jnp.int32(layer),
        k_scale_layer=None if ks is None else jnp.asarray(ks[layer]),
        v_scale_layer=None if vs is None else jnp.asarray(vs[layer]), interpret=True)
    out, bufs, fresh = _port_b3(case, layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    written = np.zeros(kc.shape[:4], bool)
    written[layer, np.arange(4), :, offs] = True
    for got, w, old, name in zip(bufs, want[1:3], (kc, vc), ("k_cache", "v_cache")):
        got = tensor_to_numpy(got)
        np.testing.assert_array_equal(got, np.asarray(w).astype(got.dtype), err_msg=name)
        np.testing.assert_array_equal(got[~written], old[~written].astype(got.dtype),
                                      err_msg=name)
        assert not np.array_equal(got[written], old[written].astype(got.dtype)), name
    if quantized:
        for got, w, name in zip(fresh, want[3:], ("ks_new", "vs_new")):
            assert got.shape == (4, 2) and got.dtype == torch.bfloat16
            np.testing.assert_array_equal(tensor_to_numpy(got), np.asarray(w, np.float32),
                                          err_msg=name)
        kq, ksc = _quantize_kv(torch.from_numpy(kn))  # the cache contract
        assert torch.equal(fresh[0], ksc[:, 0])
        assert torch.equal(bufs[0][layer, torch.arange(4), :, torch.from_numpy(offs)],
                           kq[:, 0])


def test_b3_plain_takes_a_verification_block():
    """T = 3 over a bf16 cache (the TPU kernel takes T = 1; the JAX
    package's oracle, ``fused_reference``, takes the block): outputs within
    atol 1e-5, the three fresh slots written as the oracle writes them."""
    layer = 1
    case = _case(12, T=3)
    q, kc, vc, _, _, kn, vn, pads, offs = case
    want = fused_reference(*map(jnp.asarray, (q, kc, vc, kn, vn, pads, offs)), jnp.int32(layer))
    out, bufs, _ = _port_b3(case, layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    for got, w in zip(bufs, want[1:]):
        np.testing.assert_array_equal(tensor_to_numpy(got), np.asarray(w, np.float32))


def _b8_case(seed, quantized, layer=1, L=2, B=2, Hq=4, Hkv=2, S=256, Dh=128):
    """tests/test_kernels.py's decode shapes (pads 0 and 13, offset 100),
    read from layer ``layer`` of an (L, B, Hkv, S, Dh) cache: a bf16 cache,
    or ``_quantize_kv`` of a float one."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, Hq, Dh).astype(np.float32)
    kn = rng.randn(B, 1, Hkv, Dh).astype(np.float32)
    vn = rng.randn(B, 1, Hkv, Dh).astype(np.float32)
    kf, vf = (torch.from_numpy(rng.randn(L, B, Hkv, S, Dh).astype(np.float32)) for _ in range(2))
    if quantized:
        (kc, ks), (vc, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        kc, vc, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
    return q, kc, vc, ks, vs, kn, vn, np.array([0, 13], np.int32), 100


@pytest.mark.parametrize("quantized", [False, True])
def test_b8_plain_matches_jax_interpret(quantized):
    """The port's ``decode_attention`` reads one layer's view of the cache
    in place; the TPU kernel (interpret mode) gets that layer's slab."""
    layer = 1
    q, kc, vc, ks, vs, kn, vn, pads, offset = _b8_case(20, quantized, layer)
    snap = [t.clone() for t in (kc, vc)]
    scales = dict(k_scale=ks[layer], v_scale=vs[layer]) if quantized else {}
    got = decode_attention(torch.from_numpy(q), kc[layer], vc[layer], torch.from_numpy(kn),
                           torch.from_numpy(vn), torch.from_numpy(pads), offset, **scales)
    jnp_of = lambda t: jnp.asarray(tensor_to_numpy(t)).astype(  # noqa: E731
        jnp.int8 if t.dtype == torch.int8 else jnp.bfloat16)
    want = jax_decode_attention(
        *map(jnp.asarray, (q,)), jnp_of(kc[layer]), jnp_of(vc[layer]), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(pads), jnp.int32(offset),
        **{k: jnp_of(v) for k, v in scales.items()}, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip((kc, vc), snap))  # read only


def test_dense_wrappers_refuse_what_the_kernels_do_not_take():
    """B3's int8 mode keeps the TPU signature (T = 1, both layer scales);
    offsets + T past the cache raise; B8 takes one host-side offset within
    the cache; on CUDA tensors, a float32 cache is refused before any build."""
    q, kc, vc, ks, vs, kn, vn, pads, offs = _case(0, T=2, quantized=True)
    t = lambda a: tensor_from_numpy(a)  # noqa: E731
    args = (t(q), t(kc), t(vc), t(kn), t(vn), t(pads), t(offs), 0)
    with pytest.raises(ValueError, match="takes T = 1"):
        fused_decode_attention_write(*args, t(ks[0]), t(vs[0]))
    with pytest.raises(ValueError, match="both layer scales"):
        fused_decode_attention_write(*args, t(ks[0]))
    bf = _case(0, T=2)
    bad = bf[-1].copy()
    bad[0] = kc.shape[3] - 1
    with pytest.raises(ValueError, match="exceeds the cache length"):
        fused_decode_attention_write(*(t(a) for a in (bf[0], bf[1], bf[2], bf[5], bf[6],
                                                      bf[7], bad)), 0)
    q8, kc8, vc8, _, _, kn8, vn8, pads8, offset = _b8_case(1, False)
    b8 = (torch.from_numpy(q8), kc8[0], vc8[0], torch.from_numpy(kn8), torch.from_numpy(vn8),
          torch.from_numpy(pads8))
    for off in (torch.tensor(offset), kc8.shape[3] + 1):
        with pytest.raises(ValueError, match="one host-side integer"):
            decode_attention(*b8, off)
    meta = torch.empty((4, 1, 6, 128), dtype=torch.bfloat16, device="meta")
    f32 = torch.empty((2, 4, 2, 64, 128), dtype=torch.float32, device="meta")
    fresh = torch.empty((4, 1, 2, 128), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="bfloat16 or int8 cache"):
        fd_mod._launch_dense(fused_decode_attention_write, meta, f32, f32, None, None, fresh,
                             fresh, idx, idx, 0, 8, per_layer_scales=True)


# ---- on the card: each CUDA kernel against its plain version run in float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


def _within(got, exact):
    """chip_smoke's B4/B5 bound for a kernel that computes in float32: its
    bf16 output rounding, 1e-3 + 1e-2 |exact|."""
    return bool(((got.float() - exact).abs() <= 1e-3 + 1e-2 * exact.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,quantized", [(1, False), (3, False), (1, True)])
def test_b3_kernel_matches_plain_on_card(card, T, quantized):
    q, kc, vc, ks, vs, kn, vn, pads, offs = _case(30 + T, T=T, quantized=quantized)
    layer = 1
    to = lambda a: tensor_from_numpy(a).to(card)  # noqa: E731
    bufs_k = [to(a) for a in (kc, vc)]
    bufs_p = [b.clone() for b in bufs_k]
    scales = (to(ks[layer]), to(vs[layer])) if quantized else ()
    qb, knb, vnb = (to(a).bfloat16() for a in (q, kn, vn))
    got = fused_decode_attention_write(qb, *bufs_k, knb, vnb, to(pads), to(offs), layer, *scales,
                                       max_offset=int(offs.max()))
    exact = fused_decode_attention_write_reference(qb.float(), *bufs_p, knb.float(),
                                                   vnb.float(), to(pads), to(offs), layer,
                                                   *scales)
    if quantized:
        assert all(torch.equal(g, e) for g, e in zip(got[1:], exact[1:]))
        got, exact = got[0], exact[0]
    assert _within(got, exact)
    assert all(torch.equal(g, p) for g, p in zip(bufs_k, bufs_p))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_b8_kernel_matches_plain_on_card(card, quantized):
    q, kc, vc, ks, vs, kn, vn, pads, offset = _b8_case(40, quantized)
    kc, vc = kc.to(card), vc.to(card)
    scales = (ks[1].to(card), vs[1].to(card)) if quantized else ()
    qb, knb, vnb = (torch.from_numpy(a).to(card, torch.bfloat16) for a in (q, kn, vn))
    pads = torch.from_numpy(pads).to(card)
    got = decode_attention(qb, kc[1], vc[1], knb, vnb, pads, offset, *scales)
    exact = decode_attention_reference(qb.float(), kc[1], vc[1], knb.float(), vnb.float(), pads,
                                       offset, *scales)
    assert _within(got, exact)


# the split-S body's edges: each (sample, kv head) window [pad, offset) cut
# into `splits` even shares over blocks, the fresh block in the last split,
# the splits merged in split order; `splits` is what the wrapper picks on
# an H100 (132 SMs, Hkv = 8), asserted against the card's own count
SPLIT_EDGES = {
    # B=1, the trainers' generations: 8 splits of a long window
    "b1_long_window": dict(B=1, S=2048, T=1, pads=[7], offs=[2040], splits=8),
    # B=1: 8 splits of a 4-slot window behind a large pad, four left empty
    "b1_large_pad_empty_splits": dict(B=1, S=1280, T=1, pads=[1100], offs=[1104], splits=8),
    # 8 splits of a 3-slot window, five empty
    "b1_pad_past_first_splits": dict(B=1, S=512, T=1, pads=[300], offs=[303], splits=8),
    # nothing cached yet: only the fresh block
    "offset_zero": dict(B=2, S=256, T=1, pads=[0, 0], offs=[0, 0], splits=1),
    # the last slots of the cache: max_offset = S - T, at T = 3
    "max_offset_T3": dict(B=2, S=384, T=3, pads=[0, 5], offs=[381, 200], splits=8),
    # 4 splits over windows of 1, 2 and 100 slots and a whole one
    "short_windows": dict(B=4, S=448, T=1, pads=[0, 10, 3, 7], offs=[2, 11, 400, 100],
                          splits=4),
    # 3 splits, a row with nothing cached and one with a single slot
    "three_splits": dict(B=5, S=512, T=1, pads=[0, 0, 30, 449, 2],
                         offs=[500, 0, 37, 450, 129], splits=3),
    # 2 splits at the batch path's B=8 over a long window
    "two_splits_b8": dict(B=8, S=640, T=1, pads=[5, 0, 299, 0, 1, 3, 0, 17],
                          offs=[600, 1, 300, 599, 64, 512, 0, 333], splits=2),
    # a grid of more blocks than SMs: the 8-warp instance (two blocks an SM)
    "grid_past_the_sms": dict(B=20, S=256, T=1, pads=[3] * 20,
                              offs=[252 - 12 * i for i in range(20)], splits=1),
    # R = T * G = 18 query rows: the 32-row instance, two m16 tiles
    "rows_32_T6": dict(B=2, S=384, T=6, pads=[0, 9], offs=[378, 250], splits=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("name", sorted(SPLIT_EDGES))
def test_split_decode_edges_on_card(card, name, quantized):
    """B2 (int8 cache, (L, B, Hkv, S) scales written in place) and B3 (bf16
    cache) at the split body's edges, against their plain versions run in
    float32 within 1e-3 + 1e-2 |exact|; cache and scale writes bit-exact;
    two calls bit-identical."""
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode, fused_decode_reference)

    c = SPLIT_EDGES[name]
    B, S, T, L, Hq, Hkv, Dh, layer = c["B"], c["S"], c["T"], 2, 24, 8, 128, 1
    sms = fd_mod.sm_count(torch.cuda.current_device())
    assert fd_mod.dense_splits(B, Hkv, max(c["offs"]), sms) == c["splits"]
    rng = np.random.RandomState(70)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(card, torch.bfloat16)  # noqa: E731
    q, kn, vn = (bf(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    if quantized:
        kc, vc = (torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh))
                                   .astype(np.int8)).to(card) for _ in range(2))
        ks, vs = (bf(0.002 + 0.01 * rng.rand(L, B, Hkv, S)) for _ in range(2))
        bufs = [kc, vc, ks, vs]
    else:
        bufs = [bf(rng.randn(L, B, Hkv, S, Dh)) for _ in range(2)]
    pads = torch.tensor(c["pads"], dtype=torch.int32, device=card)
    offs = torch.tensor(c["offs"], dtype=torch.int32, device=card)
    snap = [t.clone() for t in bufs]
    got_bufs, ref_bufs = [t.clone() for t in snap], [t.clone() for t in snap]
    mo = max(c["offs"])
    if quantized:
        run = lambda bb: fused_decode(q, *bb, kn, vn, pads, offs, layer, max_offset=mo)  # noqa: E731
        got = run(got_bufs)
        exact = fused_decode_reference(q.float(), *ref_bufs[:2], *ref_bufs[2:], kn.float(),
                                       vn.float(), pads, offs, layer)
    else:
        run = lambda bb: fused_decode_attention_write(  # noqa: E731
            q, *bb, kn, vn, pads, offs, layer, max_offset=mo)
        got = run(got_bufs)
        exact = fused_decode_attention_write_reference(q.float(), *ref_bufs, kn.float(),
                                                       vn.float(), pads, offs, layer)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within(got, exact)
    plain_bufs = [t.clone() for t in snap]
    if quantized:
        fused_decode_reference(q, *plain_bufs, kn, vn, pads, offs, layer)
    else:
        fused_decode_attention_write_reference(q, *plain_bufs, kn, vn, pads, offs, layer)
    for g, p in zip(got_bufs, plain_bufs):
        assert torch.equal(g, p)
    again = [t.clone() for t in snap]
    assert torch.equal(run(again), got)
