"""The port's models against the JAX package's, from the same weights (the
JAX init, carried over by the bridge) and the same numpy inputs.

Tolerances: encoder outputs atol 1e-4 / rtol 1e-3 (float32 through a conv
stem, two transformer blocks and a projector, summed in another order);
Llama logits atol 1e-4; int8 cache contents bit-exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.models import audio_encoder as jae
from llm_speech_summarization_tpu.models import hubert as jhub
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.models import audio_encoder as tae
from llm_speech_summarization_tpu_torch.models import hubert as thub
from llm_speech_summarization_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_llama(seed=0, fused=False, quantized=False):
    cfg = jllama.llama_preset("tiny")
    p = jllama.init_llama_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    if fused:
        p = jllama.fuse_llama_params(p)
    if quantized:
        p = jllama.quantize_llama_params(p)
    return cfg, p


@pytest.mark.parametrize("fused,quantized", [(False, False), (True, False), (True, True)])
def test_bridge_round_trip_llama(fused, quantized):
    _, p = _jax_llama(fused=fused, quantized=quantized)
    leaves = np_tree(p)
    back = bridge.params_to_numpy(bridge.llama_params_from_numpy(leaves))
    flat_a, tree_a = jax.tree.flatten(leaves)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
                                      else a, b)
    if quantized:
        assert bridge.llama_params_from_numpy(leaves)["layers"]["wqkv"].dtype == torch.int8


def test_port_fuse_quantize_matches_jax():
    """The port's fuse + int8 quantization of the same float weights gives
    the JAX package's int8 values and bf16 scales bit for bit."""
    _, p = _jax_llama(seed=3)
    leaves = np_tree(p)
    ours = tllama.quantize_llama_params(
        tllama.fuse_llama_params(bridge.llama_params_from_numpy(leaves)))
    theirs = np_tree(jllama.quantize_llama_params(jllama.fuse_llama_params(
        jax.tree.map(jnp.asarray, leaves))))
    flat_t, tree_t = jax.tree.flatten(theirs)
    flat_o, tree_o = jax.tree.flatten(bridge.params_to_numpy(ours))
    assert tree_t == tree_o
    for a, b in zip(flat_t, flat_o):
        np.testing.assert_array_equal(np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
                                      else a, b)


def test_bridge_encoder_and_cache():
    setup = jae.encoder_setup_from_config(_tiny_config())
    p = np_tree(jae.init_audio_encoder(jax.random.PRNGKey(1), setup, dtype=jnp.bfloat16))
    t = bridge.encoder_params_from_numpy(p)
    assert t["encoder"]["conv_layers"][0]["w"].dtype == torch.bfloat16
    assert isinstance(t["encoder"]["conv_layers"], list)
    back = bridge.params_to_numpy(t)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    jc = jllama.init_kv_cache(jllama.llama_preset("tiny"), 2, 8, dtype=jnp.int8)
    c = bridge.kv_cache_from_numpy(*np_tree(tuple(jc)))
    assert c.quantized and c.k.dtype == torch.int8 and c.k_scale.dtype == torch.bfloat16
    assert len({x.untyped_storage().data_ptr() for x in c}) == 4


def _tiny_config(port=False, **model):
    """tiny_test.yaml through the JAX package's loader, or through the
    port's loader and its own copy of the file (``port=True``)."""
    if port:
        from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

        path = str(YAML_DIR / "tiny_test.yaml")
    else:
        from llm_speech_summarization_tpu.configs import load_config

        path = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                            "configs", "yaml", "tiny_test.yaml")
    cfg = load_config(path)
    for k, v in model.items():
        setattr(cfg.model.audio_encoder, k, v)
    return cfg


def _wav(seed, B=3, N=8000):
    rng = np.random.RandomState(seed)
    wav = (0.1 * rng.randn(B, N)).astype(np.float32)
    lens = np.array([N, N - 1700, 3210][:B], np.int32)
    return wav, lens


def test_hubert_forward_matches_jax():
    cfg = jhub.hubert_preset("tiny")
    p = jhub.init_hubert_params(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    wav, lens = _wav(0)
    mask = np.arange(wav.shape[1])[None, :] < lens[:, None]
    want, want_mask = jhub.hubert_forward(p, cfg, jnp.asarray(wav), jnp.asarray(mask))
    got, got_mask = thub.hubert_forward(bridge.encoder_params_from_numpy(np_tree(p)),
                                        thub.hubert_preset("tiny"), torch.from_numpy(wav),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    valid = np.asarray(want_mask)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("method", ["pool", "stack"])
def test_audio_encoder_forward_matches_jax(method):
    jsetup = jae.encoder_setup_from_config(_tiny_config(downsample_method=method))
    tsetup = tae.encoder_setup_from_config(_tiny_config(port=True, downsample_method=method))
    p = jae.init_audio_encoder(jax.random.PRNGKey(4), jsetup, dtype=jnp.float32)
    wav, lens = _wav(1)
    want, want_lens = jae.audio_encoder_forward(p, jsetup, jnp.asarray(wav), jnp.asarray(lens))
    got, got_lens = tae.audio_encoder_forward(bridge.encoder_params_from_numpy(np_tree(p)),
                                              tsetup, torch.from_numpy(wav),
                                              torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape[1] == tae.audio_embed_buffer_len(tsetup, wav.shape[1])
    for b, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   atol=1e-4, rtol=1e-3)


def test_audio_embed_lengths_golden():
    with open(os.path.join(GOLDEN_DIR, "audio_embed_lengths.json")) as f:
        g = json.load(f)
    for factor, table in g.items():
        setup = tae.AudioEncoderParams(
            encoder_cfg=thub.hubert_preset("tiny"), downsample_method="pool",
            downsample_factor=int(factor), pool_kernel=8, pool_stride=4,
            llm_embedding_channels=64,
        )
        samples = torch.tensor([int(s) for s in table], dtype=torch.int32)
        assert tae.audio_embed_lengths(setup, samples).tolist() == list(table.values())


@pytest.mark.parametrize("N", [1600, 8000, 160000, 161600])
def test_embed_buffer_len_from_frame_arithmetic(N):
    """M from the frame arithmetic == the JAX encoder's traced output length."""
    setup = jae.encoder_setup_from_config(_tiny_config())
    p = jae.init_audio_encoder(jax.random.PRNGKey(0), setup, dtype=jnp.float32)
    out, _ = jax.eval_shape(lambda w: jae.audio_encoder_forward(p, setup, w),
                            jax.ShapeDtypeStruct((1, N), jnp.float32))
    assert tae.audio_embed_buffer_len(tae.encoder_setup_from_config(_tiny_config(port=True)), N) \
        == out.shape[1]


@pytest.mark.parametrize("cache_dtype", ["int8", "float32"])
@pytest.mark.parametrize("quantized", [False, True])
def test_llama_prefill_and_decode_match_jax(quantized, cache_dtype):
    cfg, p = _jax_llama(seed=1, fused=quantized, quantized=quantized)
    tp = bridge.llama_params_from_numpy(np_tree(p))
    tcfg = tllama.llama_preset("tiny")
    B, L, steps = 3, 12, 3
    S = L + steps
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(B, L)).astype(np.int32)
    pads = np.array([3, 0, 1], np.int32)
    mask = np.arange(L)[None, :] >= pads[:, None]
    jdt = jnp.dtype(cache_dtype)
    tdt = torch.int8 if cache_dtype == "int8" else torch.float32

    jout = jllama.llama_forward(p, cfg, input_ids=jnp.asarray(ids), attn_mask=jnp.asarray(mask),
                                kv_cache=jllama.init_kv_cache(cfg, B, S, dtype=jdt),
                                cache_offset=jnp.int32(0))
    tcache = tllama.init_kv_cache(tcfg, B, S, dtype=tdt)
    tout = tllama.llama_forward(tp, tcfg, input_ids=torch.from_numpy(ids),
                                attn_mask=torch.from_numpy(mask), kv_cache=tcache,
                                cache_offset=0)
    valid = mask  # pad positions hold garbage rows in both packages
    np.testing.assert_allclose(tout.logits.numpy()[valid], np.asarray(jout.logits)[valid],
                               atol=1e-4, rtol=0)
    jcache = jout.kv_cache
    tok = np.asarray(jnp.argmax(jout.logits[:, -1], -1)).astype(np.int32)
    lens = mask.sum(1).astype(np.int32)
    for step in range(steps):
        jo = jllama.llama_forward(p, cfg, input_ids=jnp.asarray(tok[:, None]), attn_mask=None,
                                  positions=jnp.asarray((lens + step)[:, None]),
                                  kv_cache=jcache, cache_offset=L + step,
                                  kv_pad_lens=jnp.asarray(pads))
        to = tllama.llama_forward(tp, tcfg, input_ids=torch.from_numpy(tok[:, None]),
                                  positions=torch.from_numpy((lens + step)[:, None]),
                                  kv_cache=tcache, cache_offset=L + step,
                                  kv_pad_lens=torch.from_numpy(pads))
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=1e-4, rtol=0)
        jcache = jo.kv_cache
        tok = np.asarray(jnp.argmax(jo.logits[:, 0], -1)).astype(np.int32)
    for name, a, b in zip(("k", "v", "k_scale", "v_scale"), jcache, tcache):
        if a is None:
            assert b is None
            continue
        a = np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a)
        b = bridge.tensor_to_numpy(b)
        if cache_dtype == "int8":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:  # float cache: the projections themselves, float32-close
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=name)


def test_decode_rejects_explicit_mask():
    cfg = tllama.llama_preset("tiny")
    tp = bridge.llama_params_from_numpy(np_tree(_jax_llama()[1]))
    cache = tllama.init_kv_cache(cfg, 1, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="attn_mask=None"):
        tllama.llama_forward(tp, cfg, input_ids=torch.zeros((1, 1), dtype=torch.int32),
                             attn_mask=torch.ones((1, 1), dtype=torch.bool), kv_cache=cache,
                             cache_offset=0, kv_pad_lens=torch.zeros((1,), dtype=torch.int32))


def test_per_row_decode_offsets_need_a_host_bound():
    """A per-row offset tensor comes with a host-side bound: the forward
    reads no device value to size the decode kernel's cache window."""
    cfg = tllama.llama_preset("tiny")
    tp = bridge.llama_params_from_numpy(np_tree(_jax_llama()[1]))
    cache = tllama.init_kv_cache(cfg, 2, 8, dtype=torch.int8)
    kw = dict(input_ids=torch.zeros((2, 1), dtype=torch.int32), kv_cache=cache,
              cache_offset=torch.tensor([3, 5], dtype=torch.int32),
              kv_pad_lens=torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="cache_offset_bound"):
        tllama.llama_forward(tp, cfg, **kw)
    out = tllama.llama_forward(tp, cfg, cache_offset_bound=5, **kw)
    assert out.logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(out.logits).all()


@pytest.mark.parametrize("base,method", [("hubert", "ctc_pool")])
def test_unported_encoders_raise(base, method):
    """The ctc_pool projector builds and runs (it raised before it was
    ported); what the port still refuses here is hubert-base under encoder
    sequence parallelism, whose group norm spans every shard, as the JAX
    package refuses it."""
    setup = tae.encoder_setup_from_config(_tiny_config(port=True, base=base,
                                                       downsample_method=method))
    assert setup.downsample_method == method
    p = tae.init_audio_encoder(torch.Generator().manual_seed(0), setup, dtype=torch.float32)
    ranges = torch.tensor([[[0, 4], [4, 8], [8, 8]]], dtype=torch.int32)
    emb, lens = tae.audio_encoder_forward(p, setup, torch.zeros((1, 8000)),
                                          ctc_pool_ranges=ranges)
    assert emb.shape[:2] == (1, 3) and lens.tolist() == [2]
    base_cfg = thub.hubert_preset("facebook/hubert-base-ls960")
    with pytest.raises(ValueError, match="group norm"):
        thub._hubert_forward_sp({}, base_cfg, torch.zeros((1, 3200)), None, False, None)


def test_dequantize_kv_matches_jax():
    rng = np.random.RandomState(5)
    vals = rng.randint(-127, 128, size=(2, 3, 4, 16)).astype(np.int8)
    scale = np.asarray(jnp.asarray(0.01 + rng.rand(2, 3, 4), jnp.bfloat16))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jllama.dequantize_kv(jnp.asarray(vals), jnp.asarray(scale), jdt),
                          np.float32)
        got = tllama.dequantize_kv(torch.from_numpy(vals), bridge.tensor_from_numpy(scale), tdt)
        np.testing.assert_array_equal(bridge.tensor_to_numpy(got), want)
