"""B7, the flash kernels' offset mode (the ring-attention interior): the
plain forward with its log-sum-exp and the plain backward against the JAX
package's Pallas kernels in interpret mode (``_flash_impl(...,
offsets=...)``, ``_flash_bwd_impl(..., offsets=...)``) and its XLA block
interiors (``_xla_block_attn``, ``_xla_block_attn_bwd``), at the ring's
three block relations (the visiting block from a rank before, equal to and
after the queries' rank), causal and not, Dh 64 and 128, GQA; the launch
counts of the B7 wrappers; and, marked ``cuda``, the kernels against their
plain versions on the card.

Tolerance: 1e-4 in float32 on rows that see a key of the block (the same
algorithm, summed in another order); the lse of a row that sees none is
-1e30 exactly on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.kernels.flash_attention import _flash_bwd_impl, _flash_impl
from llm_speech_summarization_tpu.ops.ring_attention import _xla_block_attn, _xla_block_attn_bwd
from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

TL, N_RING = 32, 2  # a block of 32 positions of a 2-rank ring
# global windows of the ring (T = 64), clipped to each block: a causal
# batch with a row whose pad reaches into the second block, and a
# bidirectional one with right pads inside each block
WINDOWS = {True: ([0, 45], [64, 64]), False: ([0, 0], [64, 13])}
RELATIONS = {"src<rank": (1, 0), "src==rank": (1, 1), "src>rank": (0, 1)}


def _case(causal, Dh, rel, seed=0):
    rng = np.random.RandomState(seed)
    B, Hq, Hkv = 2, 4, 2
    q = rng.randn(B, TL, Hq, Dh).astype(np.float32)
    k = rng.randn(B, TL, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, TL, Hkv, Dh).astype(np.float32)
    g = rng.randn(B, TL, Hq, Dh).astype(np.float32)
    r, src = RELATIONS[rel]
    gs, ge = (np.asarray(w, np.int32) for w in WINDOWS[causal])
    starts = np.clip(gs - src * TL, 0, TL).astype(np.int32)
    ends = np.clip(ge - src * TL, 0, TL).astype(np.int32)
    return q, k, v, g, starts, ends, (r * TL, src * TL)


PARAMS = [(rel, causal, Dh) for rel in RELATIONS for causal in (True, False) for Dh in (64, 128)]


@pytest.mark.parametrize("rel,causal,Dh", PARAMS)
def test_b7_plain_matches_jax(rel, causal, Dh):
    q, k, v, g, starts, ends, offsets = _case(causal, Dh, rel)
    B, T, Hq, _ = q.shape
    t = [torch.from_numpy(a) for a in (q, k, v, g, starts, ends)]
    out, lse = fa.flash_attention_fwd_lse_offset(*t[:3], t[4], t[5], offsets, causal)
    j = [jnp.asarray(a) for a in (q, k, v, g, starts, ends)]
    j_out, j_lse = _flash_impl(*j[:3], j[4], j[5], causal, T, T, True, return_lse=True,
                               offsets=offsets)
    j_lse = np.asarray(j_lse).reshape(B, Hq, T)
    x_out, x_lse = _xla_block_attn(*j[:3], j[4], j[5], offsets[0], offsets[1], causal)
    seen = j_lse > -1e29  # (B, Hq, T): rows that see a key of the block
    rows = seen.transpose(0, 2, 1)  # (B, T, Hq)
    for name, want_out, want_lse in (("interpret", j_out, j_lse), ("xla", x_out, x_lse)):
        want_lse = np.asarray(want_lse)
        np.testing.assert_allclose(lse.numpy()[seen], want_lse[seen], atol=1e-4, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(out.numpy()[rows], np.asarray(want_out)[rows], atol=1e-4,
                                   rtol=0, err_msg=name)
        assert (want_lse[~seen] == np.float32(-1e30)).all(), name
    assert (lse.numpy()[~seen] == np.float32(-1e30)).all()
    assert torch.isfinite(out).all()
    if rel == "src>rank" and causal:  # a block past the causal frontier: nothing seen
        assert not seen.any()

    # the backward from this block's lse, and delta from its output
    delta = (g * np.asarray(j_out)).sum(-1).transpose(0, 2, 1).copy()  # (B, Hq, T)
    t_lse, t_delta = torch.from_numpy(np.array(j_lse)), torch.from_numpy(delta)
    dq = fa.flash_attention_bwd_dq_offset(*t[:4], t_lse, t_delta, t[4], t[5], offsets, causal)
    dk, dv = fa.flash_attention_bwd_dkv_offset(*t[:4], t_lse, t_delta, t[4], t[5], offsets,
                                               causal)
    want_i = _flash_bwd_impl(*j[:3], j_out, jnp.asarray(j_lse.reshape(B * Hq, 1, T)), j[3],
                             j[4], j[5], causal, T, T, True, offsets=offsets)
    want_x = _xla_block_attn_bwd(*j[:4], jnp.asarray(j_lse), jnp.asarray(delta), j[4], j[5],
                                 offsets[0], offsets[1], causal)
    for name, want in (("interpret", want_i), ("xla", want_x)):
        np.testing.assert_allclose(dq.numpy()[rows.any(-1)], np.asarray(want[0])[rows.any(-1)],
                                   atol=1e-4, rtol=0, err_msg=f"{name} dq")
        np.testing.assert_allclose(dk.numpy(), np.asarray(want[1]), atol=1e-4, rtol=0,
                                   err_msg=f"{name} dk")
        np.testing.assert_allclose(dv.numpy(), np.asarray(want[2]), atol=1e-4, rtol=0,
                                   err_msg=f"{name} dv")


def test_b7_counts_apart_and_refuses_bad_offsets():
    """On CPU tensors no wrapper launches; the offset wrappers are the
    plain functions at the offsets; offsets must be two host ints."""
    q, k, v, g, starts, ends, offsets = _case(True, 64, "src<rank")
    t = [torch.from_numpy(a) for a in (q, k, v, g, starts, ends)]
    wrappers = (fa.flash_attention_fwd_lse, fa.flash_attention_fwd_lse_offset,
                fa.flash_attention_bwd_dq_offset, fa.flash_attention_bwd_dkv_offset)
    before = [w.launches for w in wrappers]
    out, lse = fa.flash_attention_fwd_lse_offset(*t[:3], t[4], t[5], offsets, True)
    want = fa.flash_attention_lse_reference(*t[:3], t[4], t[5], True, offsets)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    delta = torch.zeros(lse.shape)
    dq = fa.flash_attention_bwd_dq_offset(*t[:4], lse, delta, t[4], t[5], offsets)
    assert torch.equal(dq, fa.flash_attention_bwd_reference(*t[:4], lse, delta, t[4], t[5],
                                                            True, offsets)[0])
    assert [w.launches for w in wrappers] == before
    assert fa._offsets("w", None) == (0, 0) and fa._offsets("w", (3, 1)) == (3, 1)
    for bad in ((1,), (1.0, 2), (torch.tensor(1), 2)):
        with pytest.raises(ValueError, match="two host ints"):
            fa._offsets("w", bad)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rel,causal,Dh", PARAMS)
def test_b7_kernels_match_plain_on_card(card, rel, causal, Dh):
    """B7 against its plain versions run in float32 on the same bf16 inputs,
    with the bounds of B1 + LSE and B6 (tests/test_torch_kernels.py); the
    B7 launch counts move and B1/B6's do not."""
    arrays = _case(causal, Dh, rel, seed=5)
    q, k, v, g = (torch.from_numpy(a).to(card, torch.bfloat16) for a in arrays[:4])
    st, en = (torch.from_numpy(a).to(card) for a in arrays[4:6])
    offsets = arrays[6]
    plain_counts = [w.launches for w in (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                                         fa.flash_attention_bwd_dkv)]
    b7 = (fa.flash_attention_fwd_lse_offset, fa.flash_attention_bwd_dq_offset,
          fa.flash_attention_bwd_dkv_offset)
    b7_counts = [w.launches for w in b7]
    out, lse = fa.flash_attention_fwd_lse_offset(q, k, v, st, en, offsets, causal)
    ref_out, ref_lse = fa.flash_attention_lse_reference(q.float(), k.float(), v.float(), st, en,
                                                        causal, offsets)
    abs_out = fa.flash_attention_lse_reference(q.float(), k.float(), v.float().abs(), st, en,
                                               causal, offsets)[0]
    seen = ref_lse > -1e29
    rows = seen.any(1)
    assert ((lse - ref_lse).abs() <= 1e-4 + 1e-5 * ref_lse.abs())[seen].all()
    assert (lse[~seen] == -1e30).all() and torch.isfinite(out).all()
    # bf16 p before P.V and a bf16 output, each at most 2^-8 relative
    # (chip_smoke.py's B7_OUT_ATOL, B7_OUT_RTOL)
    out_bound = 1e-5 + 2.0 ** -8 * (ref_out.abs() + abs_out)
    assert ((out.float() - ref_out).abs() <= out_bound)[rows].all()
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, delta, st, en, offsets, causal)
    got = (fa.flash_attention_bwd_dq_offset(*args), *fa.flash_attention_bwd_dkv_offset(*args))
    ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), g.float(), lse, delta,
                                           st, en, causal, offsets)
    # where no row sees a key every reference gradient is 0, and so must the
    # kernel's be (the bound is then 1e-12)
    for name, a, r, sel in zip(("dq", "dk", "dv"), got, ref,
                               (rows if rows.any() else None, None, None)):
        scale = (r[sel] if sel is not None else r).pow(2).mean().sqrt()
        bound = 2e-2 * r.abs() + 5e-2 * r.pow(2).mean(-1, keepdim=True).sqrt() + 1e-3 * scale
        ratio = (a.float() - r).abs() / (bound + 1e-12)
        assert (ratio[sel] if sel is not None else ratio).max().item() <= 1, name
    assert [w.launches - c for w, c in zip(b7, b7_counts)] == [1, 1, 1]
    assert [w.launches for w in (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == plain_counts


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("diag", [37, -37])
def test_b7_frontier_midtile_on_card(card, diag, Dh):
    """B7's forward, dq and dk/dv with the causal frontier q_off - k_off = +-37
    keys, inside the wgmma kernels' 64-row q tiles and 64- or 128-key k
    tiles, at T = 200 (off the tiles), against the plain versions run in
    float32 with the bounds above; rows past the frontier get lse = -1e30."""
    rng = np.random.RandomState(9)
    B, T, Hq, Hkv = 2, 200, 4, 2
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, h, Dh).astype(np.float32)).to(
        card, torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    st = torch.tensor([0, 45], dtype=torch.int32, device=card)
    en = torch.tensor([200, 200], dtype=torch.int32, device=card)
    offsets = (200 + max(diag, 0), 200 + max(-diag, 0))
    out, lse = fa.flash_attention_fwd_lse_offset(q, k, v, st, en, offsets, True)
    f32 = [t.float() for t in (q, k, v, g)]
    ref_out, ref_lse = fa.flash_attention_lse_reference(*f32[:3], st, en, True, offsets)
    abs_out = fa.flash_attention_lse_reference(*f32[:2], f32[2].abs(), st, en, True, offsets)[0]
    seen = ref_lse > -1e29
    assert ((lse - ref_lse).abs() <= 1e-4 + 1e-5 * ref_lse.abs())[seen].all()
    assert (lse[~seen] == -1e30).all() and torch.isfinite(out).all()
    if diag < 0:  # the first 37 queries see no key of the block
        assert not seen[:, :, :37].any() and seen[:, :, 37:].any()
    out_bound = 1e-5 + 2.0 ** -8 * (ref_out.abs() + abs_out)
    assert ((out.float() - ref_out).abs() <= out_bound)[seen.any(1)].all()
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, delta, st, en, offsets, True)
    dq = fa.flash_attention_bwd_dq_offset(*args)
    dk, dv = fa.flash_attention_bwd_dkv_offset(*args)
    ref = fa.flash_attention_bwd_reference(*f32, lse, delta, st, en, True, offsets)
    rows = seen.any(1)
    for name, a, r, sel in (("dq", dq, ref[0], rows), ("dk", dk, ref[1], None),
                            ("dv", dv, ref[2], None)):
        scale = (r[sel] if sel is not None else r).pow(2).mean().sqrt()
        bound = (2e-2 * r.abs() + 5e-2 * r.pow(2).mean(-1, keepdim=True).sqrt()
                 + 1e-3 * scale + 1e-12)
        ratio = (a.float() - r).abs() / bound
        assert (ratio[sel] if sel is not None else ratio).max().item() <= 1, name
    if diag < 0:  # rows past the frontier see no key of the block: zero dq
        assert (dq[:, :37] == 0).all()
    assert torch.equal(fa.flash_attention_bwd_dq_offset(*args), dq)
