"""B1's float32 instance and the HuBERT-CTC model in float32, on the CPU
against the JAX package.

- A CTC file stored in bf16 (``cli/convert.py ctc``'s default) goes through
  the port's ``load_ctc_fn`` as float32 trees, and its ids and pool ranges
  equal JAX ``make_ctc_fn``'s on the same weights cast to float32 (the JAX
  ``load_ctc_fn`` restores into a float32 template), at 0.3 s, 1 s and
  1.25 s clips.
- The float32 plain version against JAX ``flash_attention(...,
  interpret=True)`` at float32 at the shapes of chip_smoke.py's float32
  phase: the CTC model's 10 s and 20 s clips (B=1, T 499 and 999, 16/16
  heads, Dh=64, bidirectional), a bucket of four clips with windows at its
  edges, and Llama's prefill (B=4, T=320, 24/8, Dh=128, causal, left pads).
  The JAX kernel tiles T only in multiples of 128 (else it falls back to
  XLA), so its inputs are zero-padded to that as the JAX HuBERT pads them.
- An emulation of ``csrc/flash_attention_f32.cu``'s arithmetic
  (``torch_f32_emulation.emulate_flash_3xtf32``: 32-key tiles, Q.K^T and
  P.V as 3xTF32 tensor-core products per k step of 8 added in float32, the
  base-2 online softmax with p in float32, o / max(l, 1e-30) at the end).
  It stays under half of chip_smoke's float32 bound against the JAX
  kernel; the same arithmetic on TF32-rounded operands exceeds the bound.
- The refusals on the card's route (meta tensors stand for CUDA ones, so
  the checks run before any build): float16, mixed dtypes, and float32
  with a log-sum-exp, offsets, a backward or a gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_f32_emulation import emulate_flash_3xtf32
from llm_speech_summarization_tpu.data import preprocess as jpre
from llm_speech_summarization_tpu.kernels.flash_attention import flash_attention as jax_flash
from llm_speech_summarization_tpu.models import hubert as jhub
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.data import preprocess as tpre
from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa
from llm_speech_summarization_tpu_torch.models import hubert as thub
from llm_speech_summarization_tpu_torch.train import checkpoint as tckpt
from llm_speech_summarization_tpu_torch.train.state import tree_leaves, tree_map

torch.set_num_threads(2)


SHAPES = chip_smoke.F32_CASES  # (B, T, Hq, Hkv, Dh, causal, starts, ends)


def _case(name, heads=None, seed=0):
    B, T, Hq, Hkv, Dh, causal, starts, ends = SHAPES[name]
    if heads:  # fewer heads, same group size: the heads are independent
        Hq, Hkv = heads
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, T, h, Dh).astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    return q, k, v, torch.tensor(starts, dtype=torch.int32), torch.tensor(
        ends, dtype=torch.int32), causal


def _jax_f32(q, k, v, starts, ends, causal):
    """JAX's Pallas kernel in interpret mode at float32, T zero-padded to a
    multiple of 128 (the JAX HuBERT's T_pad) where the kernel would not tile
    it; rows past T dropped."""
    T = q.shape[1]
    T_pad = T if T % 16 == 0 and T <= 512 else -(-T // 128) * 128
    pad = lambda x: np.pad(x.numpy(), ((0, 0), (0, T_pad - T), (0, 0), (0, 0)))  # noqa: E731
    out = jax_flash(*(jnp.asarray(pad(x)) for x in (q, k, v)), jnp.asarray(starts.numpy()),
                    jnp.asarray(ends.numpy()), causal, interpret=True)
    return torch.from_numpy(np.array(out)[:, :T])


def _rows(q, starts, ends):
    pos = torch.arange(q.shape[1])[None, :]
    return (pos >= starts[:, None].long()) & (pos < ends[:, None].long())


def _ratio(got, want, abs_pv, rows):
    """Largest |got - want| over chip_smoke's float32 bound, on the valid
    query rows."""
    bound = chip_smoke.F32_OUT_ATOL + chip_smoke.F32_OUT_RTOL * (want.abs() + abs_pv)
    return ((got.double() - want.double()).abs() / bound).amax((2, 3))[rows].max().item()


def emulate_f32(q, k, v, starts, ends, causal, passes=3):
    """The float32 kernel's output (3xTF32 products; ``passes=1``: hi.hi
    alone, single-pass TF32)."""
    return emulate_flash_3xtf32(q, k, v, starts, ends, causal, passes=passes)[0]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_f32_plain_matches_jax_interpret(name):
    """The float32 plain version (the CPU path and the card's yardstick)
    within half of chip_smoke's float32 bound of the JAX kernel at float32:
    the same arithmetic, summed in another order."""
    q, k, v, starts, ends, causal = _case(name)
    got = fa.flash_attention_fwd(q, k, v, starts, ends, causal)  # CPU: the plain version
    assert got.dtype == torch.float32
    want = _jax_f32(q, k, v, starts, ends, causal)
    abs_pv = _jax_f32(q, k, v.abs(), starts, ends, causal)
    assert _ratio(got, want, abs_pv, _rows(q, starts, ends)) <= 0.5


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_f32_kernel_emulation_within_half_the_chip_bound(name):
    """The kernel's tiles and sums stay under half of the bound against the
    JAX kernel (4 of the 16 heads; 6/2 of Llama's 24/8), and the same
    arithmetic on TF32-rounded operands does not: the bound tells a float32
    kernel from a single-pass TF32 one."""
    heads = (6, 2) if name == "llm_prefill" else (4, 4)
    q, k, v, starts, ends, causal = _case(name, heads, seed=1)
    rows = _rows(q, starts, ends)
    want = _jax_f32(q, k, v, starts, ends, causal)
    abs_pv = _jax_f32(q, k, v.abs(), starts, ends, causal)
    assert _ratio(emulate_f32(q, k, v, starts, ends, causal), want, abs_pv, rows) <= 0.5
    # TF32 operands have no lo part: hi.hi alone is all three products
    tf32 = emulate_f32(*(chip_smoke.tf32_round(torch, x) for x in (q, k, v)), starts, ends,
                       causal, passes=1)
    assert _ratio(tf32, want, abs_pv, rows) > 4


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_f32_bound_derivation_covers_the_phase_inputs(name):
    """chip_smoke's F32_OUT_RTOL is 2-3.2x u (sqrt(Dh) S + sqrt(n) + 4) for
    the phase's inputs (its comment): S, the largest Dh^-0.5 sum |q_d k_d|,
    stays within the values the derivation assumes."""
    q, k, v, starts, ends, causal = _case(name)
    B, T, Hq, Dh = q.shape
    G = Hq // k.shape[2]
    S = (q.abs().transpose(1, 2) @ k.abs().repeat_interleave(G, 2).permute(0, 2, 3, 1)).max()
    S = S.item() * Dh ** -0.5
    assert S <= (10.4 if Dh == 64 else 12.5)
    est = 2.0 ** -24 * (Dh ** 0.5 * S + T ** 0.5 + 4)
    assert 2 <= chip_smoke.F32_OUT_RTOL / est <= 3.2


def _ctc_weights():
    """The tiny HuBERT-CTC model of tests/test_torch_preprocess.py (JAX init,
    a head that favours the blank and the delimiter)."""
    import jax

    cfg = jhub.hubert_preset("tiny")
    enc = jhub.init_hubert_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    head = jhub.init_hubert_ctc_head(jax.random.PRNGKey(8), cfg, 32, dtype=jnp.float32)
    head = dict(head, ctc_w=head["ctc_w"] * 40.0)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return cfg, to_np(enc), to_np(head)


def test_bf16_ctc_file_runs_in_float32_as_jax(tmp_path, monkeypatch):
    """A bf16 CTC file: the port's ``load_ctc_fn`` runs it as float32 trees,
    and its ids and pool ranges equal the JAX package's float32 ones on the
    same (bf16-rounded) weights."""
    cfg, enc, head = _ctc_weights()
    bf16 = lambda t: t.bfloat16()  # noqa: E731
    enc_t, head_t = (tree_map(bf16, bridge.params_from_numpy(x)) for x in (enc, head))
    path = tckpt.save_params(str(tmp_path / "ctc.pt"),
                             {"enc_params": enc_t, "head_params": head_t})
    seen = []
    forward = thub.hubert_ctc_logits

    def recorded(params, head_params, cfg_, wav, wav_mask=None):
        seen.append({t.dtype for t in tree_leaves(params) + tree_leaves(head_params)
                     + [wav]})
        return forward(params, head_params, cfg_, wav, wav_mask)

    monkeypatch.setattr(thub, "hubert_ctc_logits", recorded)
    tfn = tpre.load_ctc_fn(path, preset="tiny", vocab_size=32, device="cpu")
    as_f32 = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    jfn = jpre.make_ctc_fn(tree_map(as_f32, enc_t), tree_map(as_f32, head_t), cfg)
    wav = (0.1 * np.random.RandomState(0).randn(4800)).astype(np.float32)
    for n in (4800, 16000, 20000):  # 0.3 s, 1 s and 1.25 s
        clip = np.concatenate([wav, np.zeros(max(n - len(wav), 0), np.float32)])[:n]
        g, w = tfn(clip), jfn(clip)
        assert g[1:] == w[1:] == (0, 4)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(tpre.pool_ranges_for_audio(tfn, clip),
                                      jpre.pool_ranges_for_audio(jfn, clip))
    assert seen and all(s == {torch.float32} for s in seen)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_card_route_refuses_what_is_not_ported(monkeypatch):
    """On the card's route float16 and mixed dtypes raise a ValueError
    naming what is ported; float32 takes each entry point's float32
    instance (B1's alone; with a log-sum-exp, offsets or a backward, the
    training instances), bfloat16 the bf16 kernels."""
    q32, q16, qbf = (_meta((1, 16, 2, 64), dt)
                     for dt in (torch.float32, torch.float16, torch.bfloat16))
    idx = torch.zeros((1,), dtype=torch.int32, device="meta")
    monkeypatch.setattr(fa, "_devices", lambda what, tensors: "cuda")  # meta stands for cuda
    with pytest.raises(ValueError, match="float16 is not ported"):
        fa.flash_attention_fwd(q16, q16, q16, idx, idx)
    with pytest.raises(ValueError, match="mixed dtypes"):
        fa.flash_attention_fwd(qbf, q32, q32, idx, idx)
    for wrapper, f32 in ((fa.flash_attention_fwd, fa.flash_attention_fwd_f32),
                         (fa.flash_attention_fwd_lse, fa.flash_attention_fwd_lse_f32),
                         (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_f32),
                         (fa.flash_attention_bwd_dkv_offset,
                          fa.flash_attention_bwd_dkv_offset_f32)):
        assert fa._pick(wrapper, q32, q32, q32) is f32
        assert fa._pick(wrapper, qbf, qbf, qbf) is wrapper
    assert fa._route("w", q32, q32, q32) == torch.float32
    assert fa._route("w", qbf, qbf, qbf) == torch.bfloat16
    with pytest.raises(ValueError, match="must be float32"):
        fa._launch_fwd(fa.flash_attention_fwd_f32, qbf, qbf, qbf, idx, idx, False)


def test_f32_wrapper_refuses_views_its_row_loads_cannot_take():
    """The float32 kernel reads rows as float4: a (b, t, h) stride that is
    not a positive multiple of 4 elements (16 bytes) is refused before any
    build."""
    big = torch.empty(1 << 20, dtype=torch.float32, device="meta")
    idx = torch.zeros((1,), dtype=torch.int32, device="meta")
    ok = big.as_strided((1, 16, 2, 64), (16 * 132, 132, 64, 1))
    odd_t = big.as_strided((1, 16, 2, 64), (16 * 130, 130, 64, 1))
    for bad in (odd_t, big.as_strided((1, 16, 2, 64), (16 * 64, 64, 0, 1))):
        with pytest.raises(ValueError, match="positive multiples of 4"):
            fa._launch_fwd(fa.flash_attention_fwd_f32, ok, bad, ok, idx, idx, False)
