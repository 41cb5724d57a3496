"""The float32 training kernels (B1 + LSE, B6 dq and dk/dv, and their offset
mode B7: ``csrc/flash_attention_f32.cu``, ``csrc/flash_attention_bwd_f32.cu``)
on the CPU against the JAX package, and, marked ``cuda``, on the card.

- The float32 plain versions (what CPU tensors take, and the card's
  yardstick in float64) against the JAX Pallas kernels in interpret mode at
  float32 (``_flash_impl(..., return_lse=True)``, ``_flash_bwd_impl``): GQA
  groups of 1 and 3, causal and bidirectional, Dh 64 and 128, rows that
  see no key, T = 80, not a multiple of the kernels' 64-row tiles (the JAX
  kernel at 16-row blocks); and B7's three float32 entry points at the
  ring's three block relations, with offsets.
- The float64 plain backward against autograd through dense attention in
  float64.
- An emulation of the CUDA kernels' arithmetic (the forward's 3xTF32
  tensor-core products, ``torch_f32_emulation.emulate_flash_3xtf32``:
  32-key tiles, Q.K^T and P.V per k step of 8 added in float32; the
  backward's, ``emulate_bwd_3xtf32``: S and dP 3xTF32 chains over Dh; p =
  2^(s Dh^-0.5 log2(e) - lse log2(e)) by selection inside the mask; dQ a
  3xTF32 chain over the keys in order; dK and dV over the group's heads,
  then the rows, in order) within half of chip_smoke.py's float32 bounds
  against the float64 plain version; the same arithmetic with ds rounded
  to bf16 falls outside them. Both emulations are held to the JAX kernels
  in interpret mode within half the bounds (out and lse; dq, dk and dv),
  and single-pass TF32 (hi.hi alone) falls outside them.
- One float32 KD step on ``tiny_test.yaml`` with every flash call routed
  as on the card to the float32 instances, whose launches run the
  emulation here: the losses and grad_norm of the JAX step, and the
  launches counted under the float32 instances alone.
- The card route's refusals and choices on meta tensors (they stand for
  CUDA tensors, so the checks run before any build).

Tolerances: chip_smoke.py's F32_OUT_ATOL + F32_OUT_RTOL bounds (its comment
derives them), half of them here: out against |out| + (P.|V|)/l, lse
against 1 + |lse|, dq, dk, dv against their magnitudes
(``chip_smoke._f64_bwd_magnitudes``); the KD step as
tests/test_torch_train.py holds it (losses rtol 1e-5, grad_norm 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_f32_emulation import emulate_bwd_3xtf32, emulate_flash_3xtf32
from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.data import SyntheticSpeechDataset, collate_batch
from llm_speech_summarization_tpu.kernels.flash_attention import _flash_bwd_impl, _flash_impl
from llm_speech_summarization_tpu.models import audio_encoder as jae
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.utils.prompts import prompt_template_for
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa
from llm_speech_summarization_tpu_torch.models.audio_encoder import (
    audio_embed_buffer_len,
    encoder_setup_from_config,
)
from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step

torch.set_num_threads(2)

LOG2E = np.float32(1.4426950408889634)
NEG = -1e30
ATOL, RTOL = chip_smoke.F32_OUT_ATOL, chip_smoke.F32_OUT_RTOL

# (B, T, Hq, Hkv, Dh, causal, starts, ends): T = 80 is one full 64-row tile
# and a partial one; causal left pads leave rows 0..29 and 0..78 of two
# samples without a key, the bidirectional batch a sample with none
CASES = {
    "g1_causal_dh64": (3, 80, 2, 2, 64, True, [0, 30, 79], [80] * 3),
    "g3_causal_dh128": (3, 80, 6, 2, 128, True, [0, 30, 79], [80] * 3),
    "g1_bidirectional_dh128": (3, 80, 2, 2, 128, False, [0] * 3, [80, 45, 0]),
    "g3_bidirectional_dh64": (3, 80, 6, 2, 64, False, [0] * 3, [80, 45, 0]),
}
TL = 48  # a ring block of 48 positions on 2 ranks (T = 96)
RING = {True: ([0, 70], [96, 96]), False: ([0, 0], [96, 30])}  # global windows
RELATIONS = {"src<rank": (1, 0), "src==rank": (1, 1), "src>rank": (0, 1)}


def _draw(B, T, Hq, Hkv, Dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, h, Dh).astype(np.float32) for h in (Hq, Hkv, Hkv, Hq)]


def _case(name, seed=0):
    B, T, Hq, Hkv, Dh, causal, starts, ends = CASES[name]
    q, k, v, g = _draw(B, T, Hq, Hkv, Dh, seed)
    return q, k, v, g, np.asarray(starts, np.int32), np.asarray(ends, np.int32), causal, None


def _ring_case(rel, causal, Dh, seed=0):
    q, k, v, g = _draw(2, TL, 6, 2, Dh, seed)
    r, src = RELATIONS[rel]
    gs, ge = (np.asarray(w, np.int32) for w in RING[causal])
    starts = np.clip(gs - src * TL, 0, TL).astype(np.int32)
    ends = np.clip(ge - src * TL, 0, TL).astype(np.int32)
    return q, k, v, g, starts, ends, causal, (r * TL, src * TL)


def _jax(q, k, v, g, starts, ends, causal, offsets, block):
    """JAX's forward with lse and backward in interpret mode at float32;
    delta from its own output."""
    B, T, Hq, _ = q.shape
    j = [jnp.asarray(a) for a in (q, k, v, g, starts, ends)]
    out, lse = _flash_impl(*j[:3], j[4], j[5], causal, block, block, True, return_lse=True,
                           offsets=offsets)
    dq, dk, dv = _flash_bwd_impl(*j[:3], out, lse, j[3], j[4], j[5], causal, block, block, True,
                                 offsets=offsets)
    out, lse = np.asarray(out), np.asarray(lse).reshape(B, Hq, T)
    delta = (g * out).sum(-1).transpose(0, 2, 1).copy()
    return out, lse, delta, (np.asarray(dq), np.asarray(dk), np.asarray(dv))


class Bounds:
    """chip_smoke.py's float32 bounds for one case, from the float64 plain
    versions on the same float32 inputs (the backward's on ``lse`` and
    ``delta``)."""

    def __init__(self, q, k, v, g, lse, delta, starts, ends, causal, offsets):
        f64 = [t.double() for t in (q, k, v, g)]
        self.out, self.lse = fa.flash_attention_lse_reference(*f64[:3], starts, ends, causal,
                                                              offsets)
        abs_pv = fa.flash_attention_lse_reference(*f64[:2], f64[2].abs(), starts, ends, causal,
                                                  offsets)[0]
        self.out_bound = ATOL + RTOL * (self.out.abs() + abs_pv)
        self.lse_bound = ATOL + RTOL * (1 + self.lse.abs())
        self.seen = self.lse > -1e29  # (B, Hq, T): rows that see a key
        self.grads = fa.flash_attention_bwd_reference(*f64, lse, delta, starts, ends, causal,
                                                      offsets)
        self.grad_bounds = [ATOL + RTOL * m for m in chip_smoke._f64_bwd_magnitudes(
            torch, q, k, v, g, lse, delta, starts, ends, causal, offsets)]

    def ratios(self, out=None, lse=None, grads=None):
        """Largest |got - float64| / bound of each output given: out and lse
        on the rows that see a key, the gradients everywhere."""
        r = {}
        rows = self.seen.transpose(1, 2)  # (B, T, Hq)
        if out is not None and rows.any():
            r["out"] = ((out.double() - self.out).abs() / self.out_bound).amax(-1)[rows].max()
        if lse is not None and rows.any():
            r["lse"] = ((lse.double() - self.lse).abs() / self.lse_bound)[self.seen].max()
        for name, got, want, bound in zip(("dq", "dk", "dv"), grads or (), self.grads,
                                          self.grad_bounds):
            r[name] = ((got.double() - want).abs() / bound).max()
        return {k: v.item() for k, v in r.items()}


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _held_to_jax(q, k, v, g, starts, ends, causal, offsets, fwd, dq_fn, dkv_fn, block):
    """The float32 entry points (CPU: the plain versions) and JAX's kernels
    in interpret mode, each within half the bound around the float64 plain
    version: so within the bound of each other."""
    out_j, lse_j, delta, grads_j = _jax(q, k, v, g, starts, ends, causal, offsets, block)
    tq, tk, tv, tg, ts, te = _torch(q, k, v, g, starts, ends)
    t_lse, t_delta = _torch(lse_j, delta)
    extra = () if offsets is None else (offsets,)
    out, lse = fwd(tq, tk, tv, ts, te, *extra, causal)
    args = (tq, tk, tv, tg, t_lse, t_delta, ts, te, *extra, causal)
    grads = (dq_fn(*args), *dkv_fn(*args))
    assert {t.dtype for t in (out, lse, *grads)} == {torch.float32}
    bounds = Bounds(tq, tk, tv, tg, t_lse, t_delta, ts, te, causal, offsets)
    for who, o, l_, gr in (("port", out, lse, grads),
                           ("jax", *_torch(out_j, lse_j), _torch(*grads_j))):
        ratios = bounds.ratios(o, l_, gr)
        assert max(ratios.values()) <= 0.5, (who, ratios)
    # a row that sees no key: lse -1e30 on both sides
    unseen = ~bounds.seen.numpy()
    assert (lse.numpy()[unseen] == np.float32(NEG)).all()
    assert (lse_j[unseen] == np.float32(NEG)).all()
    return bounds


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_plain_matches_jax_interpret(name):
    """B1 + LSE, B6 dq and B6 dk/dv at float32 (the float32 entry points;
    CPU tensors take the plain versions) against the JAX kernels at float32
    in interpret mode."""
    q, k, v, g, starts, ends, causal, _ = _case(name)
    bounds = _held_to_jax(q, k, v, g, starts, ends, causal, None, fa.flash_attention_fwd_lse_f32,
                          fa.flash_attention_bwd_dq_f32, fa.flash_attention_bwd_dkv_f32, 16)
    assert not bounds.seen.all()  # the case has rows without a key


@pytest.mark.parametrize("rel", sorted(RELATIONS))
@pytest.mark.parametrize("causal,Dh", [(True, 128), (False, 64)])
def test_b7_f32_plain_matches_jax_interpret(rel, causal, Dh):
    """B7's float32 entry points at the ring's block relations (queries at
    q_off = rank * TL, the visiting block at k_off = src * TL, the global
    windows clipped to the block), GQA 6/2, against the JAX kernels in
    offset mode."""
    q, k, v, g, starts, ends, causal, offsets = _ring_case(rel, causal, Dh)
    bounds = _held_to_jax(q, k, v, g, starts, ends, causal, offsets,
                          fa.flash_attention_fwd_lse_offset_f32,
                          fa.flash_attention_bwd_dq_offset_f32,
                          fa.flash_attention_bwd_dkv_offset_f32, TL)
    if causal and rel == "src>rank":  # past the causal frontier: nothing seen
        assert not bounds.seen.any()


@pytest.mark.parametrize("offsets", [None, (40, 0), (0, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_f64_plain_backward_is_autograd(causal, offsets):
    """The float64 plain backward (chip_smoke's yardstick for the float32
    kernels) equals autograd through dense masked attention in float64, on
    the rows that see a key (the others have lse -1e30 and no gradient)."""
    rng = np.random.RandomState(3)
    B, T, Hq, Hkv, Dh = 2, 40, 6, 2, 16
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv, Hq))
    starts, ends = torch.tensor([0, 7], dtype=torch.int32), torch.tensor([40, 29],
                                                                         dtype=torch.int32)
    out, lse = fa.flash_attention_lse_reference(q, k, v, starts, ends, causal, offsets)
    assert out.dtype == lse.dtype == torch.float64
    g = g * (lse > -1e29).transpose(1, 2)[..., None]  # no gradient into a row without keys
    delta = (g * out).sum(-1).transpose(1, 2)
    got = fa.flash_attention_bwd_reference(q, k, v, g, lse, delta, starts, ends, causal, offsets)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    s, mask = fa._masked_scores(*leaves[:2], starts, ends, causal, offsets)
    p = torch.softmax(torch.where(mask, s, NEG), -1)
    dense = torch.einsum("bhgts,bshd->bthgd", p, leaves[2]).reshape(B, T, Hq, Dh)
    want = torch.autograd.grad(dense, leaves, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


def _float32_bwd_reference(q, k, v, dout, lse, delta, starts, ends, causal, offsets=None):
    """The plain backward as it was before it took float64 inputs (every
    product in float32), kept to hold the float32 and bf16 paths to it bit
    for bit."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, mask = fa._masked_scores(q, k, starts, ends, causal, offsets)
    lse_g = lse.reshape(B, Hkv, G, T, 1)
    p = torch.exp(torch.where(mask, s - lse_g, NEG))
    dog = dout.reshape(B, T, Hkv, G, Dh).float()
    dv = torch.einsum("bhgts,bthgd->bshd", p.to(dout.dtype).float(), dog)
    dp = torch.einsum("bthgd,bshd->bhgts", dog, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, T, 1))
    scale = Dh ** -0.5
    dq = torch.einsum("bhgts,bshd->bthgd", ds.to(k.dtype).float(), k.float()) * scale
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    dk = torch.einsum("bhgts,bthgd->bshd", ds.to(q.dtype).float(), qg) * scale
    return dq.reshape(B, T, Hq, Dh).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_unchanged_below_float64(dtype):
    """float64 inputs run in float64, while float32 and bf16 inputs keep the
    plain backward the bf16 phases hold their kernels to, bit for bit: p and
    ds rounded to the operands' dtype, products in float32."""
    q, k, v, g, starts, ends, causal, offsets = _ring_case("src<rank", True, 64)
    t = [x.to(dtype) for x in _torch(q, k, v, g)] + _torch(starts, ends)
    out, lse = fa.flash_attention_lse_reference(*t[:3], t[4], t[5], causal, offsets)
    delta = (t[3].float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (*t[:4], lse, delta, t[4], t[5], causal, offsets)
    got, want = fa.flash_attention_bwd_reference(*args), _float32_bwd_reference(*args)
    assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(got, want))


# ---- an emulation of the CUDA kernels' arithmetic


def emulate_fwd_lse(q, k, v, starts, ends, causal, offsets=None, passes=3):
    """``flash_attention_f32.cu``: (out, lse) of the 3xTF32 forward
    (``passes=1``: single-pass TF32); a row that saw no key: zeros and
    -1e30."""
    return emulate_flash_3xtf32(q, k, v, starts, ends, causal, offsets, passes=passes)


def emulate_bwd(q, k, v, g, lse, delta, starts, ends, causal, offsets=None, ds_bf16=False,
                passes=3):
    """``flash_attention_bwd_f32.cu``: the 3xTF32 backward
    (``torch_f32_emulation.emulate_bwd_3xtf32``; ``passes=1``: single-pass
    TF32). ``ds_bf16``: ds rounded to bf16 before its products (a fault)."""
    return emulate_bwd_3xtf32(q, k, v, g, lse, delta, starts, ends, causal, offsets,
                              passes=passes, ds_bf16=ds_bf16)


EMULATED = [(name, None) for name in sorted(CASES)] + [
    ("ring", (rel, causal)) for rel in ("src<rank", "src==rank") for causal in (True, False)]


@pytest.mark.parametrize("name,ring", EMULATED)
def test_f32_kernel_emulation_within_half_the_chip_bound(name, ring):
    """The kernels' tiles and sums (the forward's lse and out, then the
    backward from that lse) stay under half of chip_smoke's float32 bounds
    against the float64 plain version; with ds rounded to bf16 the
    gradients leave them: the bounds tell a float32 backward from one that
    rounds ds as the bf16 kernels do."""
    q, k, v, g, starts, ends, causal, offsets = (_ring_case(*ring, 128, seed=2) if ring
                                                 else _case(name, seed=2))
    q, k, v, g, starts, ends = _torch(q, k, v, g, starts, ends)
    out, lse = emulate_fwd_lse(q, k, v, starts, ends, causal, offsets)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    bounds = Bounds(q, k, v, g, lse, delta, starts, ends, causal, offsets)
    grads = emulate_bwd(q, k, v, g, lse, delta, starts, ends, causal, offsets)
    ratios = bounds.ratios(out, lse, grads)
    assert max(ratios.values()) <= 0.5, ratios
    unseen = ~bounds.seen
    assert (lse[unseen] == np.float32(NEG)).all() and (out.transpose(1, 2)[unseen] == 0).all()
    rounded = bounds.ratios(grads=emulate_bwd(q, k, v, g, lse, delta, starts, ends, causal,
                                              offsets, ds_bf16=True))
    assert max(rounded["dq"], rounded["dk"]) > 1, rounded


@pytest.mark.parametrize("name,ring", EMULATED)
def test_3xtf32_forward_emulation_held_to_jax(name, ring):
    """The forward's 3xTF32 arithmetic against JAX's ``_flash_impl`` in
    interpret mode at float32: out and lse within half of chip_smoke's
    float32 bounds (set by the float64 plain version) of the JAX values on
    the rows that see a key; single-pass TF32 (hi.hi alone, what the
    tensor cores give a float32 operand without the split) leaves them."""
    q, k, v, g, starts, ends, causal, offsets = (_ring_case(*ring, 128, seed=3) if ring
                                                 else _case(name, seed=3))
    out_j, lse_j, delta, _ = _jax(q, k, v, g, starts, ends, causal, offsets,
                                  TL if ring else 16)
    tq, tk, tv, tg, ts, te, t_lse, t_delta = _torch(q, k, v, g, starts, ends, lse_j, delta)
    bounds = Bounds(tq, tk, tv, tg, t_lse, t_delta, ts, te, causal, offsets)
    rows = bounds.seen.transpose(1, 2)  # (B, T, Hq)
    want_out, want_lse = _torch(out_j, lse_j)

    def ratios(passes):
        out, lse = emulate_fwd_lse(tq, tk, tv, ts, te, causal, offsets, passes)
        if not rows.any():
            return {"out": 0.0, "lse": 0.0}
        r_out = ((out.double() - want_out.double()).abs() / bounds.out_bound).amax(-1)[rows]
        r_lse = ((lse.double() - want_lse.double()).abs() / bounds.lse_bound)[bounds.seen]
        return {"out": r_out.max().item(), "lse": r_lse.max().item()}

    assert max(ratios(3).values()) <= 0.5
    if rows.any():
        assert max(ratios(1).values()) > 1


@pytest.mark.parametrize("name,ring", EMULATED)
def test_3xtf32_backward_emulation_held_to_jax(name, ring):
    """The backward's 3xTF32 arithmetic against JAX's ``_flash_bwd_impl`` in
    interpret mode at float32, both from JAX's lse and delta: dq, dk and dv
    within half of chip_smoke's float32 bounds (set by the float64 plain
    version) of the JAX values; single-pass TF32 (hi.hi alone) leaves
    them."""
    q, k, v, g, starts, ends, causal, offsets = (_ring_case(*ring, 128, seed=4) if ring
                                                 else _case(name, seed=4))
    _, lse_j, delta, grads_j = _jax(q, k, v, g, starts, ends, causal, offsets,
                                    TL if ring else 16)
    tq, tk, tv, tg, ts, te, t_lse, t_delta = _torch(q, k, v, g, starts, ends, lse_j, delta)
    bounds = Bounds(tq, tk, tv, tg, t_lse, t_delta, ts, te, causal, offsets)
    want = _torch(*grads_j)

    def ratios(passes):
        got = emulate_bwd(tq, tk, tv, tg, t_lse, t_delta, ts, te, causal, offsets,
                          passes=passes)
        return {key: ((a.double() - b.double()).abs() / bound).max().item()
                for key, a, b, bound in zip(("dq", "dk", "dv"), got, want, bounds.grad_bounds)}

    assert max(ratios(3).values()) <= 0.5
    if bounds.seen.any():
        assert max(ratios(1).values()) > 1


# ---- one KD step through the float32 instances


@pytest.fixture
def emulated_card(monkeypatch):
    """Every flash call takes the card's route (meta tensors aside, CPU
    tensors stand for CUDA ones): the float32 instances' launches count
    and run the emulation."""
    monkeypatch.setattr(fa, "_devices", lambda what, tensors: "cuda")

    def launch_fwd(wrapper, q, k, v, starts, ends, causal, with_lse=False, offsets=None):
        assert wrapper in fa._F32_WRAPPERS, wrapper.__name__
        fa.count_launch(wrapper)
        out, lse = emulate_fwd_lse(q, k, v, starts, ends, causal, offsets)
        return out, (lse if with_lse else None)

    def launch_bwd(wrapper, q, k, v, dout, lse, delta, starts, ends, causal, offsets=None):
        assert wrapper in fa._F32_WRAPPERS, wrapper.__name__
        fa.count_launch(wrapper)
        dq, dk, dv = emulate_bwd(q, k, v, dout, lse, delta, starts, ends, causal, offsets)
        return (dk, dv) if wrapper in fa._DKV_WRAPPERS else dq

    monkeypatch.setattr(fa, "_launch_fwd", launch_fwd)
    monkeypatch.setattr(fa, "_launch_bwd", launch_bwd)


JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("remat", [False, True])
def test_f32_kd_step_through_the_kernels_matches_jax(emulated_card, remat):
    """``tiny_test.yaml`` (float32) one KD step from the same weights and
    batch as the JAX step: the student LLM and HuBERT run B1 + LSE and B6
    at float32, the teacher B1 at float32, with remat a second B1 + LSE in
    the backward's recompute; nothing launches the bf16 kernels."""
    # the JAX trainer needs orbax, which the card's machine lacks: imported
    # here, where the card's run of this file (-m cuda) never gets
    from llm_speech_summarization_tpu.train import make_train_state as jax_make_train_state
    from llm_speech_summarization_tpu.train import make_train_step as jax_make_train_step

    jcfg = jax_load_config(JAX_TINY)
    jcfg.train.remat = remat
    tok = ByteTokenizer()
    tpl = prompt_template_for(jcfg.model.llm_type)
    prefix = tok.encode(tpl.prefix, add_bos=True)
    suffix = tok.encode(tpl.suffix, add_bos=False)
    llm_cfg = jllama.llama_preset("tiny")
    llm_params = jllama.init_llama_params(jax.random.PRNGKey(0), llm_cfg, dtype=jnp.float32)
    enc_setup = jae.encoder_setup_from_config(jcfg)
    enc_params = jae.init_audio_encoder(jax.random.PRNGKey(1), enc_setup, dtype=jnp.float32)
    ds = SyntheticSpeechDataset(tok, num_samples=2, max_seconds=2.0)
    batch = collate_batch([ds[0], ds[1]], audio_buckets=jcfg.train.buckets.audio_samples,
                          max_text_tokens=jcfg.train.buckets.max_text_tokens,
                          max_response_tokens=jcfg.train.buckets.max_response_tokens)
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    cfg.train.remat = remat
    setup = encoder_setup_from_config(cfg)
    M = audio_embed_buffer_len(setup, batch.wav.shape[1])
    R, T = jcfg.train.buckets.max_response_tokens, jcfg.train.buckets.max_text_tokens
    total_len = ((len(prefix) + max(M, T) + len(suffix) + R + 63) // 64) * 64

    jstate, tx = jax_make_train_state(jcfg, enc_params, total_opt_steps=100)
    jstep = jax_make_train_step(jcfg, enc_setup, llm_cfg, tx, jnp.asarray(prefix),
                                jnp.asarray(suffix), total_len, donate=False)
    _, want = jstep(jstate, llm_params, batch)

    state, opt = make_train_state(cfg, bridge.params_from_numpy(_np_tree(enc_params)), 100)
    step = make_train_step(cfg, setup, llm_cfg, opt, prefix, suffix, total_len, device="cpu")
    wrappers = chip_smoke._wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    _, got = step(state, bridge.params_from_numpy(_np_tree(llm_params)),
                  bridge.batch_from_numpy(batch))
    for key in ("ntp_loss", "ld_loss", "fd_loss", "total_loss"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    launches = {k: w.launches - before[k] for k, w in wrappers.items()}
    expected = chip_smoke._expected_train_launches(
        setup.encoder_cfg.num_layers, llm_cfg.num_layers, remat, 1, 0, {}, f32=True)
    chip_smoke.check_launches("tiny float32 step", launches, expected)


# ---- the card's route on meta tensors


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


ENTRIES = [
    (fa.flash_attention_fwd_lse, fa.flash_attention_fwd_lse_f32, "flash_attention_f32"),
    (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_f32, "flash_attention_bwd_f32"),
    (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_f32, "flash_attention_bwd_f32"),
    (fa.flash_attention_fwd_lse_offset, fa.flash_attention_fwd_lse_offset_f32,
     "flash_attention_f32"),
    (fa.flash_attention_bwd_dq_offset, fa.flash_attention_bwd_dq_offset_f32,
     "flash_attention_bwd_f32"),
    (fa.flash_attention_bwd_dkv_offset, fa.flash_attention_bwd_dkv_offset_f32,
     "flash_attention_bwd_f32"),
]


class _Built(Exception):
    pass


@pytest.mark.parametrize("entry,f32,library", ENTRIES,
                         ids=[e.__name__ for e, _, _ in ENTRIES])
def test_card_route_takes_the_float32_instance(monkeypatch, entry, f32, library):
    """On the card's route a float32 call of each training entry point goes
    to its float32 instance's library (the build is stopped here, before
    any launch or count), a bf16 call to the bf16 one; float16 and mixed
    dtypes raise naming what is ported; the float32 instance refuses bf16
    operands."""
    monkeypatch.setattr(fa, "_devices", lambda what, tensors: "cuda")
    built = []

    def load_library(name, sources):
        built.append(name)
        raise _Built(name)

    monkeypatch.setattr(fa, "load_library", load_library)
    B, T, Hq, Hkv, Dh = 2, 16, 6, 2, 64
    idx = torch.zeros((B,), dtype=torch.int32, device="meta")
    row = _meta((B, Hq, T), torch.float32)
    offsets = () if "offset" not in entry.__name__ else ((16, 0),)

    def call(fn, dt, dt_kv=None):
        q, g = _meta((B, T, Hq, Dh), dt), _meta((B, T, Hq, Dh), dt)
        k = v = _meta((B, T, Hkv, Dh), dt_kv or dt)
        if "fwd" in fn.__name__:
            return fn(q, k, v, idx, idx, *offsets, True)
        return fn(q, k, v, g, row, row, idx, idx, *offsets, True)

    counts = (entry.launches, f32.launches)
    for dtype, want in ((torch.float32, library),
                        (torch.bfloat16, {"flash_attention_f32": "flash_attention",
                                          "flash_attention_bwd_f32": "flash_attention_dkv"
                                          if "dkv" in entry.__name__ else
                                          "flash_attention_bwd"}[library])):
        with pytest.raises(_Built, match=f"^{want}$"):
            call(entry, dtype)
    assert fa._pick(entry, *(_meta((1, 1, 1, 64), torch.float32),) * 3) is f32
    with pytest.raises(ValueError, match="float16 is not ported; the kernels take bfloat16 "
                                         "or float32"):
        call(entry, torch.float16)
    with pytest.raises(ValueError, match="mixed dtypes"):
        call(entry, torch.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="must be float32"):
        call(f32, torch.bfloat16)
    assert (entry.launches, f32.launches) == counts and len(built) == 2


def test_float32_backward_refuses_what_its_kernels_cannot_take(monkeypatch):
    """The float32 backward checks its operands as the bf16 one does: dout
    rows read as float4 (strides multiples of 4), lse and delta contiguous
    (B, Hq, T) float32, dout shaped as q; nothing is built."""
    monkeypatch.setattr(fa, "_devices", lambda what, tensors: "cuda")
    monkeypatch.setattr(fa, "load_library", lambda name, sources: pytest.fail("built"))
    B, T, Hq, Hkv, Dh = 1, 16, 4, 2, 64
    q = _meta((B, T, Hq, Dh), torch.float32)
    k = _meta((B, T, Hkv, Dh), torch.float32)
    idx = torch.zeros((B,), dtype=torch.int32, device="meta")
    row = _meta((B, Hq, T), torch.float32)
    big = torch.empty(1 << 16, dtype=torch.float32, device="meta")
    odd = big.as_strided((B, T, Hq, Dh), (T * 130, 130, 64, 1))
    with pytest.raises(ValueError, match="positive multiples of 4"):
        fa.flash_attention_bwd_dq(q, k, k, odd, row, row, idx, idx)
    with pytest.raises(ValueError, match="lse must be a contiguous"):
        fa.flash_attention_bwd_dkv(q, k, k, q, row.transpose(1, 2), row, idx, idx)
    with pytest.raises(ValueError, match="delta must be a contiguous"):
        fa.flash_attention_bwd_dq(q, k, k, q, row, row.to(torch.bfloat16), idx, idx)
    with pytest.raises(ValueError, match="does not match q"):
        fa.flash_attention_bwd_dkv(q, k, k, _meta((B, T, Hkv, Dh), torch.float32), row, row,
                                   idx, idx)


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda "
                    "tests/test_torch_flash_f32_train.py)")
    return torch.device("cuda")


# (B, T, Hq, Hkv, Dh, causal, starts, ends): one row and one tile, a tile
# and one row, keyless rows, a window inside one tile, GQA 3 at Dh 128
EDGES = {
    "t1": (2, 1, 2, 2, 64, False, [0, 0], [1, 0]),
    "t65_causal": (2, 65, 6, 2, 128, True, [0, 64], [65, 65]),
    "t130_window": (2, 130, 4, 4, 64, False, [3, 0], [67, 130]),
    "t499_hubert": (2, 499, 16, 16, 64, False, [0, 0], [499, 77]),
    "t200_causal_left_pads": (3, 200, 24, 8, 128, True, [0, 199, 37], [200] * 3),
    # windows on the forward's k tiles (32 keys at Dh = 128, 64 at Dh = 64)
    # and a q tile plus one row or a tile past them
    "t97_k_tiles_dh128": (2, 97, 6, 2, 128, True, [32, 0], [96, 97]),
    "t129_k_tiles_dh64": (2, 129, 4, 4, 64, False, [64, 1], [128, 129]),
    # windows inside the backward's streamed tiles (at Dh = 128 dq's 32 keys
    # and dk/dv's 16 rows, 64 at Dh = 64), T a 16-row tile plus one row
    "t113_bwd_tiles_dh128": (2, 113, 6, 2, 128, True, [16, 0], [48, 113]),
    "t127_bwd_tiles_dh64": (2, 127, 6, 2, 64, True, [1, 64], [127, 65]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [None, "src<rank", "src==rank"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_f32_training_kernels_at_tile_edges_on_card(card, name, offsets):
    """The float32 B1 + LSE, dq and dk/dv (and B7 at two block relations,
    the queries at q_off = T, the keys at 0 or T) at tile edges against the
    float64 plain version within chip_smoke's float32 bounds; rows without
    a key give zeros and lse -1e30; one launch a call, counted under the
    float32 instance alone; repeats bit-identical."""
    B, T, Hq, Hkv, Dh, causal, st, en = EDGES[name]
    q, k, v, g = (torch.from_numpy(a).to(card) for a in _draw(B, T, Hq, Hkv, Dh, 31))
    starts, ends = (torch.tensor(x, dtype=torch.int32, device=card) for x in (st, en))
    offs = None if offsets is None else (T, T * RELATIONS[offsets][1])
    entries = ((fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv) if offs is None else
               (fa.flash_attention_fwd_lse_offset, fa.flash_attention_bwd_dq_offset,
                fa.flash_attention_bwd_dkv_offset))
    watched = [fa._F32_INSTANCES[e] for e in entries] + list(entries)
    before = [w.launches for w in watched]
    extra = () if offs is None else (offs,)
    out, lse = entries[0](q, k, v, starts, ends, *extra, causal)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, delta, starts, ends, *extra, causal)
    grads = (entries[1](*args), *entries[2](*args))
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(watched, before)] == [1, 1, 1, 0, 0, 0]
    bounds = Bounds(q, k, v, g, lse, delta, starts, ends, causal, offs)
    ratios = bounds.ratios(out, lse, grads)
    assert max(ratios.values()) <= 1, ratios
    unseen = ~bounds.seen
    assert (lse[unseen] == np.float32(NEG)).all() and (out.transpose(1, 2)[unseen] == 0).all()
    assert all(torch.isfinite(t).all() for t in (out, lse, *grads))
    again = (*entries[0](q, k, v, starts, ends, *extra, causal), entries[1](*args),
             *entries[2](*args))
    assert all(torch.equal(a, b) for a, b in zip((out, lse, *grads), again))


@pytest.mark.cuda
def test_f32_flash_attention_autograd_on_card(card):
    """``flash_attention`` with a gradient at float32 (the trainer's call):
    B1 + LSE float32 forward and the float32 dq and dk/dv in the backward,
    against autograd through the float64 plain version within the bounds."""
    B, T, Hq, Hkv, Dh, causal, st, en = EDGES["t200_causal_left_pads"]
    q, k, v, g = (torch.from_numpy(a).to(card) for a in _draw(B, T, Hq, Hkv, Dh, 32))
    starts, ends = (torch.tensor(x, dtype=torch.int32, device=card) for x in (st, en))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = [fa._F32_INSTANCES[w].launches for w in (
        fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    out = fa.flash_attention(*leaves, starts, ends, causal)
    grads = torch.autograd.grad(out, leaves, g)
    after = [fa._F32_INSTANCES[w].launches for w in (
        fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    lse = fa.flash_attention_fwd_lse(q, k, v, starts, ends, causal)[1]
    delta = (g * out.detach()).sum(-1).transpose(1, 2).contiguous()
    bounds = Bounds(q, k, v, g, lse, delta, starts, ends, causal, None)
    assert max(bounds.ratios(out.detach(), None, grads).values()) <= 1
