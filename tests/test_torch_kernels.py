"""The port's kernel modules: plain versions against the JAX kernels (run in
Pallas interpret mode, and against their XLA oracles), the quantizer, the
wrappers' refusals, and — marked ``cuda`` — each CUDA kernel against its
plain version on the card.

CPU tolerances are float32 (atol 1e-5): the same algorithm, summed in
another order. Cache writes are held bit-exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.kernels.flash_attention import (
    _flash_impl,
    _xla_reference,
    flash_attention,
)
from llm_speech_summarization_tpu.kernels.fused_decode import (
    _pad128,
    fused_decode_aliased_scales,
)
from llm_speech_summarization_tpu.models.llama import _quantize_kv as jax_quantize_kv
from llm_speech_summarization_tpu_torch.bridge import tensor_from_numpy, tensor_to_numpy
from llm_speech_summarization_tpu_torch.kernels import build
from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa_mod
from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod
from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_lse,
    flash_attention_reference,
)
from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
    flash_attention as torch_flash_attention,
)
from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
    _quantize_kv,
    fused_decode,
    fused_decode_reference,
)
from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_preset

torch.set_num_threads(1)


def _flash_case(seed, B, T, Hq, Hkv, Dh, starts, ends):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, Hq, Dh).astype(np.float32)
    k = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    return q, k, v, np.asarray(starts, np.int32), np.asarray(ends, np.int32)


FLASH_CASES = {
    # causal GQA, left pads (incl. none and a length-1 row), Dh=128
    "causal_leftpad_dh128": (dict(B=3, T=64, Hq=4, Hkv=2, Dh=128,
                                  starts=[0, 63, 17], ends=[64] * 3), True),
    # bidirectional, right pads [0, n_valid), Dh=64
    "bidir_rightpad_dh64": (dict(B=3, T=48, Hq=4, Hkv=4, Dh=64,
                                 starts=[0] * 3, ends=[48, 30, 1]), False),
}


@pytest.mark.parametrize("oracle", ["interpret", "xla"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(name, oracle):
    spec, causal = FLASH_CASES[name]
    q, k, v, st, en = _flash_case(0, **spec)
    got = flash_attention_fwd(*map(torch.from_numpy, (q, k, v, st, en)), causal=causal)
    args = tuple(map(jnp.asarray, (q, k, v, st, en)))
    if oracle == "interpret":
        want = flash_attention(*args, causal=causal, interpret=True)
    else:
        want = _xla_reference(*args, causal)
    pos = np.arange(q.shape[1])[None, :]
    rows = (pos >= st[:, None]) & (pos < en[:, None])  # valid query rows only
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], atol=1e-5, rtol=0)


# the training shapes at T=128 (tests/test_kernels.py's backward cases):
# causal GQA Dh=128 with left pads (one row fully padded but one key), and
# bidirectional Dh=64 with right pads
FLASH_BWD_CASES = {
    "causal_leftpad_dh128": (dict(B=3, T=128, Hq=4, Hkv=2, Dh=128,
                                  starts=[0, 37, 127], ends=[128] * 3), True),
    "bidir_rightpad_dh64": (dict(B=3, T=128, Hq=4, Hkv=4, Dh=64,
                                 starts=[0] * 3, ends=[128, 77, 1]), False),
}


def _valid_rows(st, en, T):
    pos = np.arange(T)[None, :]
    return (pos >= st[:, None]) & (pos < en[:, None])


@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_lse_plain_matches_jax_interpret(name):
    """Forward + log-sum-exp against the Pallas kernel's return_lse output
    (interpret mode), every row: rows with no valid key are -1e30 in both."""
    spec, causal = FLASH_BWD_CASES[name]
    q, k, v, st, en = _flash_case(3, **spec)
    out, lse = flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v, st, en)), causal=causal)
    T = q.shape[1]
    w_out, w_lse = _flash_impl(*map(jnp.asarray, (q, k, v, st, en)), causal, T, T, True,
                               return_lse=True)
    w_lse = np.asarray(w_lse).reshape(lse.shape)
    np.testing.assert_allclose(lse.numpy(), w_lse, atol=2e-4, rtol=2e-4)
    rows = _valid_rows(st, en, T)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(w_out)[rows], atol=2e-4, rtol=2e-4)
    if causal:  # a left-pad query sees no key: lse = -1e30, as on the TPU
        assert (lse[1, :, :37] == torch.tensor(-1e30)).all()


@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_backward_matches_jax_grad(name):
    """The differentiable ``flash_attention`` on CPU tensors (plain forward
    with lse, plain FA-2 backward) against ``jax.grad`` through the Pallas
    custom VJP in interpret mode; cotangents zero at invalid query rows, as
    tests/test_kernels.py compares them."""
    spec, causal = FLASH_BWD_CASES[name]
    q, k, v, st, en = _flash_case(4, **spec)
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    g *= _valid_rows(st, en, q.shape[1])[:, :, None, None]

    def jax_loss(q, k, v):
        out = flash_attention(q, k, v, jnp.asarray(st), jnp.asarray(en), causal=causal,
                              interpret=True)
        return jnp.vdot(out, jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = torch_flash_attention(qt, kt, vt, torch.from_numpy(st), torch.from_numpy(en), causal)
    (out * torch.from_numpy(g)).sum().backward()
    for name_, got, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name_}")


def test_flash_plain_backward_matches_autograd():
    """The plain backward (the kernels' own formulas from the saved lse)
    equals autograd through the plain forward on the valid rows."""
    spec, causal = FLASH_BWD_CASES["causal_leftpad_dh128"]
    q, k, v, st, en = map(torch.from_numpy, _flash_case(6, **spec))
    g = torch.from_numpy(np.random.RandomState(7).randn(*q.shape).astype(np.float32))
    g = g * torch.from_numpy(_valid_rows(st.numpy(), en.numpy(), q.shape[1]))[:, :, None, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (flash_attention_reference(*leaves, st, en, causal) * g).sum().backward()
    out, lse = flash_attention_fwd_lse(q, k, v, st, en, causal)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    got = flash_attention_bwd_reference(q, k, v, g, lse, delta, st, en, causal)
    assert torch.equal(got[0], flash_attention_bwd_dq(q, k, v, g, lse, delta, st, en, causal))
    for a, b in zip(got[1:], flash_attention_bwd_dkv(q, k, v, g, lse, delta, st, en, causal)):
        assert torch.equal(a, b)
    for a, t in zip(got, leaves):
        torch.testing.assert_close(a, t.grad, atol=2e-5, rtol=2e-5)


def test_flash_without_grad_takes_the_plain_forward():
    """No input needs a gradient (a teacher forward, an eval step): the
    wrapper is the inference forward, which saves nothing."""
    spec, causal = FLASH_BWD_CASES["bidir_rightpad_dh64"]
    q, k, v, st, en = map(torch.from_numpy, _flash_case(8, **spec))
    out = torch_flash_attention(q, k, v, st, en, causal)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention_reference(q, k, v, st, en, causal))
    with torch.no_grad():
        assert torch_flash_attention(q.requires_grad_(), k, v, st, en, causal).grad_fn is None


def test_flash_bwd_wrappers_refuse_bad_operands():
    """The CUDA checks run before any build: mixed devices, a float32 dout
    and an lse of the wrong shape are refused."""
    meta = torch.empty((1, 16, 2, 128), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros((1,), dtype=torch.int32, device="meta")
    lse = torch.zeros((1, 2, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="need all cpu or all cuda"):
        flash_attention_bwd_dq(meta, meta, meta, meta, lse, torch.zeros(lse.shape), idx, idx)
    with pytest.raises(ValueError, match="dout must be bfloat16"):
        fa_mod._launch_bwd(flash_attention_bwd_dq, meta, meta, meta, meta.float(), lse, lse,
                           idx, idx, True)
    with pytest.raises(ValueError, match="lse must be a contiguous"):
        fa_mod._launch_bwd(flash_attention_bwd_dkv, meta, meta, meta, meta, lse[:, :1], lse,
                           idx, idx, True)


def _fused_case(seed, T, L=2, B=4, Hq=6, Hkv=2, S=64, Dh=128):
    """The shapes of tests/test_fused_decode.py; offsets at window edges and
    at the S - T headroom boundary."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, Hq, Dh).astype(np.float32)
    kn = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    vn = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    pads = rng.randint(0, 5, size=(B,)).astype(np.int32)
    offs = np.array([31, 32, S - T, 17], np.int32)[:B]
    kc = rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)
    vc = rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)
    # scales keep |int8 x scale| <= ~1.5, the size of real k/v, so a float32
    # atol of 1e-5 measures the algorithm rather than cancellation
    ks = np.asarray(jnp.asarray(0.002 + 0.01 * rng.rand(L, B, Hkv, S), jnp.bfloat16))
    vs = np.asarray(jnp.asarray(0.002 + 0.01 * rng.rand(L, B, Hkv, S), jnp.bfloat16))
    return q, kc, vc, ks, vs, kn, vn, pads, offs


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("T", [1, 3])
def test_fused_plain_matches_jax_interpret(T, layer):
    q, kc, vc, ks, vs, kn, vn, pads, offs = _fused_case(T, T)
    S = kc.shape[3]
    Spad = _pad128(S)
    pad_s = lambda a: jnp.zeros(a.shape[:-1] + (Spad,), jnp.bfloat16).at[..., :S].set(a)  # noqa: E731
    want = fused_decode_aliased_scales(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pads), jnp.asarray(offs), jnp.int32(layer), pad_s(ks), pad_s(vs),
        interpret=True,
    )
    bufs = [tensor_from_numpy(a) for a in (kc, vc, ks, vs)]
    out = fused_decode(torch.from_numpy(q), *bufs, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pads), torch.from_numpy(offs), layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    for got, w, name in zip(bufs, want[1:], ("k_cache", "v_cache", "k_scale", "v_scale")):
        w = np.asarray(w)[..., :S] if name.endswith("scale") else np.asarray(w)
        np.testing.assert_array_equal(tensor_to_numpy(got), np.asarray(w, np.float32)
                                      if name.endswith("scale") else w, err_msg=name)


def test_fused_plain_writes_only_fresh_slots():
    T, layer = 3, 1
    q, kc, vc, ks, vs, kn, vn, pads, offs = _fused_case(5, T)
    bufs = [tensor_from_numpy(a) for a in (kc, vc, ks, vs)]
    snap = [b.clone() for b in bufs]
    fused_decode(torch.from_numpy(q), *bufs, torch.from_numpy(kn), torch.from_numpy(vn),
                 torch.from_numpy(pads), torch.from_numpy(offs), layer)
    written = torch.zeros(kc.shape[:4], dtype=torch.bool)
    for b, off in enumerate(offs):
        written[layer, b, :, off:off + T] = True
    for got, old in zip(bufs, snap):
        assert torch.equal(got[~written], old[~written])
        assert not torch.equal(got[written], old[written])
    kq, ksc = _quantize_kv(torch.from_numpy(kn))  # (B, T, Hkv, Dh), (B, T, Hkv)
    for b, off in enumerate(offs):
        assert torch.equal(bufs[0][layer, b, :, off:off + T], kq[b].transpose(0, 1))
        assert torch.equal(bufs[2][layer, b, :, off:off + T], ksc[b].transpose(0, 1))


def test_quantize_kv_bit_exact():
    rng = np.random.RandomState(3)
    rows = [rng.randn(16, 128).astype(np.float32) * 3.0]
    # absmax 127 → scale exactly 1.0: exact .5 ties must round half to even
    ties = np.zeros((4, 128), np.float32)
    ties[:, 0] = 127.0
    ties[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    rows += [ties, np.zeros((2, 128), np.float32)]  # all-zero rows: scale floor 1e-8
    x = np.concatenate(rows)
    got_q, got_s = _quantize_kv(torch.from_numpy(x))
    want_q, want_s = jax_quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(tensor_to_numpy(got_s), np.asarray(want_s, np.float32))
    assert got_q[16, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
    assert got_q[-1].abs().max() == 0 and got_s[-1].item() > 0


@pytest.mark.parametrize("T", [1, 3])
def test_fused_offsets_past_cache_raise(T):
    q, kc, vc, ks, vs, kn, vn, pads, offs = _fused_case(0, T)
    offs = offs.copy()
    offs[0] = kc.shape[3] - T + 1
    bufs = [tensor_from_numpy(a) for a in (kc, vc, ks, vs)]
    with pytest.raises(ValueError, match="exceeds the cache length"):
        fused_decode(torch.from_numpy(q), *bufs, torch.from_numpy(kn), torch.from_numpy(vn),
                     torch.from_numpy(pads), torch.from_numpy(offs), 0)


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    """Tensors off the CPU never fall back to the plain version, and a
    kernel that cannot be built raises instead of computing."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    meta = torch.empty((1, 16, 2, 128), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="need all cpu or all cuda"):
        flash_attention_fwd(meta, meta, meta, idx, idx)
    cache = torch.empty((1, 1, 2, 16, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="need all cpu or all cuda"):
        fused_decode(meta, cache, cache, None, None, meta, meta, idx, idx, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("flash_attention_missing_nvcc", ("flash_attention.cu",))


def test_kv_cache_scales_do_not_alias():
    cache = init_kv_cache(llama_preset("tiny"), 2, 8, dtype=torch.int8)
    ptrs = {t.untyped_storage().data_ptr() for t in cache}
    assert len(ptrs) == 4
    cache.k_scale[0, 0, 0, 0] = 3.0
    assert cache.v_scale.abs().max() == 0


def test_fused_wrapper_refuses_shared_scale_storage():
    """The CUDA path's checks run before any build: a v_scale that is a view
    of k_scale's storage is refused."""
    q, kc, vc, ks, vs, kn, vn, pads, offs = _fused_case(0, 1)
    bf = lambda a: tensor_from_numpy(a)  # noqa: E731
    ks_t = bf(ks)
    with pytest.raises(ValueError, match="must not share storage"):
        fd_mod._launch(bf(q).bfloat16(), bf(kc), bf(vc), ks_t, ks_t[:], bf(kn).bfloat16(),
                       bf(vn).bfloat16(), torch.from_numpy(pads), torch.from_numpy(offs), 0,
                       int(offs.max()))


# ---- on the card: each CUDA kernel against its plain version (bf16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_on_card(card, name):
    spec, causal = FLASH_CASES[name]
    arrays = _flash_case(1, **spec)
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16) for a in arrays[:3])
    st, en = (torch.from_numpy(a).to(card) for a in arrays[3:])
    got = flash_attention_fwd(q, k, v, st, en, causal=causal)
    want = flash_attention_reference(q, k, v, st, en, causal=causal)
    pos = torch.arange(q.shape[1], device=card)[None, :]
    rows = (pos >= st[:, None]) & (pos < en[:, None])
    assert torch.isfinite(got).all()
    # bf16 output: ~4 ulps at |out| <= 2
    assert (got.float() - want.float()).abs()[rows].max().item() <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 3])
def test_fused_kernel_matches_plain_on_card(card, T):
    q, kc, vc, ks, vs, kn, vn, pads, offs = _fused_case(2, T)
    to = lambda a: tensor_from_numpy(a).to(card)  # noqa: E731
    bufs_k = [to(a) for a in (kc, vc, ks, vs)]
    bufs_p = [b.clone() for b in bufs_k]
    qb, knb, vnb = (to(a).bfloat16() for a in (q, kn, vn))
    got = fused_decode(qb, *bufs_k, knb, vnb, to(pads), to(offs), 1, max_offset=int(offs.max()))
    want = fused_decode_reference(qb, *bufs_p, knb, vnb, to(pads), to(offs), 1)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    for g, w in zip(bufs_k, bufs_p):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES) + ["ragged_T200_gqa"])
def test_flash_training_kernels_match_plain_on_card(card, name):
    """B1 + LSE and B6 against their plain versions run in float32 on the
    same bf16 inputs (lse within 1e-4 + 1e-5 |lse|; out within B1's 3e-2 on
    valid rows; gradients within
    chip_smoke's bound: 2e-2 |ref| + 5e-2 rms of the row + 1e-3 rms of the
    tensor), and two calls bit-identical."""
    if name == "ragged_T200_gqa":  # T not a multiple of the 64-row tiles
        spec, causal = dict(B=2, T=200, Hq=6, Hkv=2, Dh=128, starts=[0, 71],
                            ends=[200, 200]), True
    else:
        spec, causal = FLASH_BWD_CASES[name]
    arrays = _flash_case(11, **spec)
    q, k, v = (torch.from_numpy(a).to(card, torch.bfloat16) for a in arrays[:3])
    st, en = (torch.from_numpy(a).to(card) for a in arrays[3:])
    rows = torch.from_numpy(_valid_rows(arrays[3], arrays[4], q.shape[1])).to(card)
    g = (torch.randn(q.shape, generator=torch.Generator().manual_seed(12)).to(card)
         * rows[:, :, None, None]).bfloat16()
    out, lse = flash_attention_fwd_lse(q, k, v, st, en, causal)
    ref_out, ref_lse = fa_mod.flash_attention_lse_reference(q.float(), k.float(), v.float(), st,
                                                            en, causal)
    assert ((lse - ref_lse).abs() <= 1e-4 + 1e-5 * ref_lse.abs()).all()
    assert (out.float() - ref_out.float()).abs()[rows].max().item() <= 3e-2  # B1's bound
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, delta, st, en, causal)
    got = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    ref = flash_attention_bwd_reference(q.float(), k.float(), v.float(), g.float(), lse, delta,
                                        st, en, causal)
    for name_, a, r, sel in zip(("dq", "dk", "dv"), got, ref, (rows, None, None)):
        scale = (r[sel] if sel is not None else r).pow(2).mean().sqrt()
        bound = 2e-2 * r.abs() + 5e-2 * r.pow(2).mean(-1, keepdim=True).sqrt() + 1e-3 * scale
        ratio = (a.float() - r).abs() / bound
        assert (ratio[sel] if sel is not None else ratio).max().item() <= 1, name_
    again = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
