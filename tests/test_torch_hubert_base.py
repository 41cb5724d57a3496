"""BASELINE config #1's encoder side in the port against the JAX package:
``ctc_segment_mean``, the hubert-base variant (no conv bias, a group-normed
first conv layer, the encoder LayerNorm before post-LN blocks) and the
``ctc_pool`` / ``stack`` projectors over it, from the same weights (the JAX
init carried by the bridge) and the same numpy inputs.

Tolerances: ``ctc_segment_mean`` float32 atol 1e-6 (float32 products,
summed in another order), bfloat16 bit-exact after the cast (the same
float32 sums rounded once; 1 bf16 ulp allowed where the order decides);
hubert-base frames float32 atol 1e-4 / rtol 1e-3 (as the hubert-large test
in ``test_torch_models.py``), bfloat16 atol 6e-2 / rtol 6e-2 (bf16
activations rounded at other places by the two packages: 8 ulps at |x| ~ 2).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.models import audio_encoder as jae
from llm_speech_summarization_tpu.models import hubert as jhub
from llm_speech_summarization_tpu.ops.pooling import ctc_segment_mean as jax_ctc_segment_mean
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.models import audio_encoder as tae
from llm_speech_summarization_tpu_torch.models import hubert as thub
from llm_speech_summarization_tpu_torch.ops.pooling import ctc_segment_mean

torch.set_num_threads(1)

JAX_YAML_DIR = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                            "configs", "yaml")
BASE_FIELDS = dict(conv_bias=False, feat_extract_norm="group", do_stable_layer_norm=False)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny_base(module):
    """The tiny preset with hubert-base's architecture switches, in either
    package's config class."""
    return dataclasses.replace(module.hubert_preset("tiny"), **BASE_FIELDS)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---- ctc_segment_mean

RANGE_CASES = {
    # [start, end) ranges per row, right-padded with zeros
    "tiling": [[(0, 4), (4, 8), (8, 12), (12, 16)], [(0, 4), (4, 8), (0, 0), (0, 0)]],
    "empty_and_holed": [[(0, 3), (5, 5), (6, 9), (2, 1)], [(0, 0), (3, 7), (0, 0), (7, 20)]],
    "past_the_end": [[(10, 14), (18, 25), (20, 24), (30, 31)], [(0, 20), (19, 20), (20, 20),
                                                                 (25, 26)]],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_ctc_segment_mean_matches_jax(case, dtype):
    """Pooled frames and validity against the JAX op, with empty ranges,
    ranges starting at or past N = 20 frames (invalid) or ending past it
    (clipped), and a valid range after an invalid one (a hole)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 20, 8).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    ranges = np.asarray(RANGE_CASES[case], np.int32)
    want, want_valid = jax_ctc_segment_mean(jnp.asarray(x, dtype), jnp.asarray(ranges))
    got, got_valid = ctc_segment_mean(torch.from_numpy(x).to(getattr(torch, dtype)),
                                      torch.from_numpy(ranges))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 4, 8)
    got, want = bridge.tensor_to_numpy(got), np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    assert (got[~got_valid.numpy()] == 0).all()  # empty / invalid ranges: zeros, not NaN
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:  # one bf16 ulp where the summation order decides the rounding
        np.testing.assert_allclose(got, want, atol=0, rtol=2.0 ** -7)


def test_ctc_segment_mean_explicit_validity():
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 12, 4).astype(np.float32))
    ranges = torch.tensor([[[0, 4], [4, 8], [8, 12]]], dtype=torch.int32)
    pooled, valid = ctc_segment_mean(x, ranges, torch.tensor([[True, False, True]]))
    assert valid.tolist() == [[True, False, True]]
    assert (pooled[0, 1] == 0).all()
    torch.testing.assert_close(pooled[0, 2], x[0, 8:12].mean(0), atol=1e-6, rtol=0)


# ---- hubert-base


def test_hubert_base_preset_matches_jax():
    for name in ("hubert_base", "facebook/hubert-base-ls960", "hubert_large", "tiny"):
        assert dataclasses.asdict(thub.hubert_preset(name)) == \
            dataclasses.asdict(jhub.hubert_preset(name))
    base = thub.hubert_preset("facebook/hubert-base-ls960")
    assert (base.hidden_size, base.num_layers, base.num_heads) == (768, 12, 12)
    assert not base.conv_bias and base.feat_extract_norm == "group"


def test_hubert_base_init_tree_matches_jax():
    """The port's init gives the JAX tree's keys and shapes (gn_* on the
    first conv layer only, no conv bias), and the JAX tree carries across
    the bridge under the same names."""
    jp = np_tree(jhub.init_hubert_params(jax.random.PRNGKey(0), _tiny_base(jhub),
                                         dtype=jnp.float32))
    tp = thub.init_hubert_params(torch.Generator().manual_seed(0), _tiny_base(thub),
                                 dtype=torch.float32)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(jp) == shapes(bridge.params_to_numpy(tp))
    assert sorted(tp["conv_layers"][0]) == ["gn_bias", "gn_scale", "w"]
    assert all(sorted(layer) == ["w"] for layer in tp["conv_layers"][1:])
    carried = bridge.encoder_params_from_numpy(jp)
    assert shapes(bridge.params_to_numpy(carried)) == shapes(jp)


def _wav(seed, B, N=8000):
    rng = np.random.RandomState(seed)
    wav = (0.1 * rng.randn(B, N)).astype(np.float32)
    lens = np.array([N, N - 1700, 3210][:B], np.int32)
    return wav, lens


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_base_forward_matches_jax(dtype, B):
    """Frames of the carried JAX tree through both packages' forwards, with
    right-padded rows: the group norm's moments take every frame of the
    padded buffer, so they see the pads in both."""
    cfg = _tiny_base(jhub)
    jp = jhub.init_hubert_params(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    # non-trivial norm parameters, so a scale or bias in the wrong place shows
    rng = np.random.RandomState(9)
    jp = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                      if a.ndim <= 2 else a, np_tree(jp))
    wav, lens = _wav(0, B)
    if dtype == "bfloat16":
        wav = _bf16(wav)
    mask = np.arange(wav.shape[1])[None, :] < lens[:, None]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jpc = jax.tree.map(lambda a: jnp.asarray(a, jdt), jp)
    want, want_mask = jhub.hubert_forward(jpc, cfg, jnp.asarray(wav, jdt) * mask,
                                          jnp.asarray(mask))
    tp = jax.tree.map(lambda t: t.to(tdt), bridge.encoder_params_from_numpy(jp))
    got, got_mask = thub.hubert_forward(tp, _tiny_base(thub),
                                        torch.from_numpy(wav).to(tdt) * torch.from_numpy(mask),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    valid = np.asarray(want_mask)
    tol = 1e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(bridge.tensor_to_numpy(got)[valid],
                               np.asarray(want.astype(jnp.float32))[valid], atol=tol,
                               rtol=10 * tol if dtype == "float32" else tol)


def test_hubert_base_sequence_parallel_raises():
    """The sequence-parallel forward refuses the group-norm variant (its
    moments span every shard), naming the reason, before any exchange."""
    cfg = _tiny_base(thub)
    p = thub.init_hubert_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="group norm"):
        thub._hubert_forward_sp(p, cfg, torch.zeros((1, 1280)), None, False, None)


# ---- the projector


def _configs(method):
    jcfg = jax_load_config(os.path.join(JAX_YAML_DIR, "tiny_test.yaml"))
    tcfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    for c in (jcfg, tcfg):
        c.model.audio_encoder.downsample_method = method
    jsetup = dataclasses.replace(jae.encoder_setup_from_config(jcfg), encoder_cfg=_tiny_base(jhub))
    tsetup = dataclasses.replace(tae.encoder_setup_from_config(tcfg), encoder_cfg=_tiny_base(thub))
    return jsetup, tsetup


def _ranges(B):
    """4-frame ranges tiling each row's frames, as the synthetic dataset
    draws them, with a hole in row 1 and one past the frames in row 2."""
    rows = [[(4 * i, 4 * i + 4) for i in range(6)], [(0, 4), (4, 4), (8, 12), (0, 0),
                                                      (0, 0), (0, 0)],
            [(0, 2), (2, 9), (30, 34), (0, 0), (0, 0), (0, 0)]]
    return np.asarray(rows[:B], np.int32)


@pytest.mark.parametrize("method", ["ctc_pool", "stack"])
def test_hubert_base_projector_matches_jax(method):
    jsetup, tsetup = _configs(method)
    p = jae.init_audio_encoder(jax.random.PRNGKey(4), jsetup, dtype=jnp.float32)
    wav, lens = _wav(1, 3)
    ranges = _ranges(3) if method == "ctc_pool" else None
    want, want_lens = jae.audio_encoder_forward(
        p, jsetup, jnp.asarray(wav), jnp.asarray(lens),
        ctc_pool_ranges=None if ranges is None else jnp.asarray(ranges))
    got, got_lens = tae.audio_encoder_forward(
        bridge.encoder_params_from_numpy(np_tree(p)), tsetup, torch.from_numpy(wav),
        torch.from_numpy(lens), ctc_pool_ranges=None if ranges is None
        else torch.from_numpy(ranges))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got_lens.dtype == torch.int32
    assert got.shape == tuple(want.shape)
    assert got.shape[1] == tae.audio_embed_buffer_len(
        tsetup, wav.shape[1], None if ranges is None else ranges.shape[1])
    if method == "ctc_pool":  # the splice takes emb_lens from the left, holes too
        assert got_lens.tolist() == [6, 2, 2]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)
    else:
        for b, n in enumerate(np.asarray(want_lens)):
            np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                       atol=1e-4, rtol=1e-3)


def test_ctc_pool_needs_ranges():
    _, tsetup = _configs("ctc_pool")
    p = tae.init_audio_encoder(torch.Generator().manual_seed(0), tsetup, dtype=torch.float32)
    with pytest.raises(ValueError, match="CTC pool ranges"):
        tae.audio_encoder_forward(p, tsetup, torch.zeros((1, 8000)))
    with pytest.raises(ValueError, match="num_ranges"):
        tae.audio_embed_buffer_len(tsetup, 8000)
    assert tae.audio_embed_buffer_len(tsetup, 8000, 17) == 17
