"""The port's Whisper path and its bf16-cache decoding against the JAX
package, from the same weights (the JAX init, carried over by the bridge)
and the same numpy inputs: the log-mel frontend, the Whisper encoder and
the audio encoder with its 30 s budget and dynamic frames, the engine on a
Whisper config, ``llama_forward`` decode over a bf16 cache,
``greedy_generate(attn_impl="pallas")`` (kernel B8's plain version), a
dense ``SlotDecoder`` on a bf16 cache (kernel B3's), and the refusals.

Tolerances: log-mel atol 5e-5 (an FFT against the JAX package's DFT
matmul, both float32: ~1e-5 seen); encoder outputs atol 1e-4 / rtol 1e-3
(float32 through a conv stem, two blocks and a projector, summed in
another order); logits 1e-4 in float32. Token streams follow the
margin-aware contract: they may part only where the JAX model's top-2
margin is under twice the logit tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.infer.generate import greedy_generate as jax_generate
from llm_speech_summarization_tpu.infer.slots import SlotDecoder as JaxSlotDecoder
from llm_speech_summarization_tpu.models import audio_encoder as jae
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.models import whisper as jw
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.infer.generate import greedy_generate
from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
from llm_speech_summarization_tpu_torch.models import audio_encoder as tae
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.models import whisper as tw

torch.set_num_threads(1)

JAX_TINY_YAML = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                             "configs", "yaml", "tiny_test.yaml")
LOGIT_TOL = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _whisper_config(load, path, dynamic=False, cache=None):
    cfg = load(str(path))
    cfg.model.audio_encoder.base = "whisper"
    cfg.model.audio_encoder.whisper_dynamic_frames = dynamic
    if cache:
        cfg.model.kv_cache_dtype = cache
    return cfg


def _setups(dynamic=False):
    """(JAX setup, port setup) of tiny Whisper + pool."""
    return (jae.encoder_setup_from_config(_whisper_config(jax_load_config, JAX_TINY_YAML,
                                                          dynamic)),
            tae.encoder_setup_from_config(_whisper_config(load_config,
                                                          YAML_DIR / "tiny_test.yaml", dynamic)))


def _wav(seed, B=2, N=32000, lens=(32000, 17000)):
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(B, N)).astype(np.float32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("frames", [3000, 200])  # the fixed 30 s budget, dynamic for 2 s
def test_log_mel_matches_jax(frames):
    wav, _ = _wav(0)
    wav[1, 17000:] = 0.0  # a zero-padded tail, as the encoder masks it
    want = jw.log_mel_spectrogram(jnp.asarray(wav), jw.whisper_preset("tiny"),
                                  pad_to_frames=frames)
    got = tw.log_mel_spectrogram(torch.from_numpy(wav), tw.whisper_preset("tiny"),
                                 pad_to_frames=frames)
    assert got.dtype == torch.float32 and got.shape == (2, 80, frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


def test_whisper_forward_matches_jax():
    """The tiny encoder through the bridge, on the JAX mel, with partial
    mel frame counts: masks equal, valid frames close."""
    cfg = jw.whisper_preset("tiny")
    p = jw.init_whisper_params(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)
    mel = np.array(jw.log_mel_spectrogram(jnp.asarray(_wav(1)[0]), cfg, pad_to_frames=300))
    counts = np.array([300, 171], np.int32)
    want, want_mask = jw.whisper_forward(p, cfg, jnp.asarray(mel), jnp.asarray(counts))
    tp = bridge.encoder_params_from_numpy(np_tree(p))
    assert tp["conv1_w"].shape == (64, 80, 3) and tp["layers"]["wq"].shape == (2, 64, 64)
    got, got_mask = tw.whisper_forward(tp, tw.whisper_preset("tiny"), torch.from_numpy(mel),
                                       torch.from_numpy(counts))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    valid = np.asarray(want_mask)
    assert valid.sum() == 150 + 86
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dynamic", [False, True])
def test_audio_encoder_whisper_matches_jax(dynamic):
    jsetup, tsetup = _setups(dynamic)
    assert tsetup.base == "whisper" and tsetup.whisper_dynamic_frames == dynamic
    p = jae.init_audio_encoder(jax.random.PRNGKey(4), jsetup, dtype=jnp.float32)
    wav, lens = _wav(2)
    want, want_lens = jae.audio_encoder_forward(p, jsetup, jnp.asarray(wav), jnp.asarray(lens))
    got, got_lens = tae.audio_encoder_forward(bridge.encoder_params_from_numpy(np_tree(p)),
                                              tsetup, torch.from_numpy(wav),
                                              torch.from_numpy(lens))
    assert got.shape == want.shape
    assert got.shape[1] == tae.audio_embed_buffer_len(tsetup, wav.shape[1])
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for b, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   atol=1e-4, rtol=1e-3)


def test_whisper_dynamic_frames_match_fixed():
    """tests/test_variants.py::test_whisper_dynamic_frames_matches_fixed in
    the port: the dynamic budget shrinks the buffer, valid embeds stay."""
    _, fixed = _setups(False)
    _, dyn = _setups(True)
    params = tae.init_audio_encoder(torch.Generator().manual_seed(0), fixed, dtype=torch.float32)
    wav, lens = map(torch.from_numpy, _wav(3))
    e_fixed, l_fixed = tae.audio_encoder_forward(params, fixed, wav, lens)
    e_dyn, l_dyn = tae.audio_encoder_forward(params, dyn, wav, lens)
    assert e_dyn.shape[1] < e_fixed.shape[1]
    assert torch.equal(l_fixed, l_dyn)
    for b in range(2):
        n = int(l_fixed[b])
        torch.testing.assert_close(e_dyn[b, :n], e_fixed[b, :n], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("N", [1600, 32000, 160000, 512000])  # 0.1 s .. 32 s
def test_whisper_embed_buffer_len_from_frame_arithmetic(dynamic, N):
    """M from the frame arithmetic == the JAX encoder's traced output
    length, past the 30 s budget too."""
    jsetup, tsetup = _setups(dynamic)
    p = jae.init_audio_encoder(jax.random.PRNGKey(0), jsetup, dtype=jnp.float32)
    out, _ = jax.eval_shape(lambda w: jae.audio_encoder_forward(p, jsetup, w),
                            jax.ShapeDtypeStruct((1, N), jnp.float32))
    assert tae.audio_embed_buffer_len(tsetup, N) == out.shape[1]


def _engines(cache=None):
    """(JAX engine, port engine) on tiny Whisper + pool, same weights."""
    je = JaxEngine(_whisper_config(jax_load_config, JAX_TINY_YAML, cache=cache))
    te = LLMSpeechTextInference(
        _whisper_config(load_config, YAML_DIR / "tiny_test.yaml", cache=cache), device="cpu",
        llm_params=bridge.llama_params_from_numpy(np_tree(je.llm_params)),
        audio_encoder_params=bridge.encoder_params_from_numpy(np_tree(je.audio_encoder_params)),
    )
    return je, te


def _jax_logits(je, embeds, mask, prefix, cache_dtype):
    """JAX logits predicting token len(prefix) of one row, its own earlier
    tokens fed through the cache step by step."""
    cfg, p = je.llm_cfg, je.llm_params
    L = embeds.shape[0]
    cache = jllama.init_kv_cache(cfg, 1, L + len(prefix) + 1, dtype=cache_dtype)
    out = jllama.llama_forward(p, cfg, inputs_embeds=jnp.asarray(embeds[None]),
                               attn_mask=jnp.asarray(mask[None]), kv_cache=cache,
                               cache_offset=jnp.int32(0), last_logit_only=True)
    logits, cache = out.logits[0, -1], out.kv_cache
    n = int(mask.sum())
    for i, tok in enumerate(prefix):
        out = jllama.llama_forward(
            p, cfg, input_ids=jnp.asarray([[tok]], jnp.int32), attn_mask=None,
            positions=jnp.asarray([[n + i]], jnp.int32), kv_cache=cache,
            cache_offset=L + i, kv_pad_lens=jnp.asarray([L - n], jnp.int32))
        logits, cache = out.logits[0, 0], out.kv_cache
    return np.asarray(logits)


def _assert_streams_agree(got, want, je, embeds, mask, cache_dtype):
    """Row r's token lists equal, or parting only at a JAX near-tie."""
    for r, (g, w) in enumerate(zip(got, want)):
        g, w = list(g), list(w)
        if g == w:
            continue
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        assert t < min(len(g), len(w)), f"row {r}: lengths differ on equal tokens"
        top2 = np.sort(_jax_logits(je, embeds[r], mask[r], w[:t], cache_dtype))[-2:]
        assert top2[1] - top2[0] <= 2 * LOGIT_TOL, f"row {r} parts at token {t}, not a near-tie"


def test_whisper_engine_generation_matches_jax():
    """tests/test_variants.py::test_whisper_engine_generation in both
    packages: the spliced prompt, then the generated text."""
    je, te = _engines()
    audio = (0.05 * np.random.RandomState(0).randn(12000)).astype(np.float32)
    je_e, je_m = je.build_audio_prompt_batch([audio])
    te_e, te_m = te.build_audio_prompt_batch([audio])
    np.testing.assert_array_equal(te_m.numpy(), np.asarray(je_m))
    np.testing.assert_allclose(te_e.numpy(), np.asarray(je_e), atol=1e-4, rtol=1e-3)
    assert te.generate_audio_response(audio, max_new_tokens=8) == \
        je.generate_audio_response(audio, max_new_tokens=8)
    assert te.counts["encoder_forwards"] == 2 and te.counts["prefills"] == 1


def test_whisper_engine_cuts_a_32s_clip():
    """A 32 s clip is cut to Whisper's 3000-frame mel budget and its embed
    length clipped to the buffer, as in the JAX engine; a 3 s clip beside
    it keeps its own length; the batch generates."""
    je, te = _engines(cache="bfloat16")
    rng = np.random.RandomState(5)
    clips = [(0.05 * rng.randn(n)).astype(np.float32) for n in (16000 * 32, 48000)]
    je_e, je_m = je.build_audio_prompt_batch(clips)
    te_e, te_m = te.build_audio_prompt_batch(clips)
    np.testing.assert_array_equal(te_m.numpy(), np.asarray(je_m))
    np.testing.assert_allclose(te_e.numpy(), np.asarray(je_e), atol=1e-4, rtol=1e-3)
    M = tae.audio_embed_buffer_len(te.encoder_setup, 16000 * 32)
    assert M == 374  # 1500 encoder frames through pool(8, 4)
    lens = te_m.sum(1)
    assert int(lens[0] - lens[1]) == M - 36  # 3 s: (48000 - 160) // 320 // 4 - 1
    out = te.generate_audio_response_batch(clips, max_new_tokens=4)
    assert len(out) == 2 and te.cache_dtype == torch.bfloat16


@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
def test_llama_decode_over_a_float_cache_matches_jax(cache):
    """Prefill, then decode steps over a bf16 (or float32) cache: the port's
    fused step (kernel B3's plain version) against the JAX decoder, which
    runs ``fused_reference`` there. Logits within 1e-4, caches equal."""
    cfg = jllama.llama_preset("tiny")
    p = jllama.init_llama_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    tp = bridge.llama_params_from_numpy(np_tree(p))
    tcfg = tllama.llama_preset("tiny")
    B, L, steps = 3, 12, 4
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, size=(B, L)).astype(np.int32)
    pads = np.array([3, 0, 1], np.int32)
    mask = np.arange(L)[None, :] >= pads[:, None]
    jc = jllama.init_kv_cache(cfg, B, L + steps, dtype=jnp.dtype(cache))
    tc = tllama.init_kv_cache(tcfg, B, L + steps, dtype=getattr(torch, cache))
    jo = jllama.llama_forward(p, cfg, input_ids=jnp.asarray(ids), attn_mask=jnp.asarray(mask),
                              kv_cache=jc, cache_offset=jnp.int32(0), attn_impl="fused")
    to = tllama.llama_forward(tp, tcfg, input_ids=torch.from_numpy(ids),
                              attn_mask=torch.from_numpy(mask), kv_cache=tc, cache_offset=0)
    jc = jo.kv_cache
    tok = np.asarray(jnp.argmax(jo.logits[:, -1], -1)).astype(np.int32)
    lens = mask.sum(1).astype(np.int32)
    for step in range(steps):
        kw = dict(cache_offset=L + step)
        jo = jllama.llama_forward(p, cfg, input_ids=jnp.asarray(tok[:, None]), attn_mask=None,
                                  positions=jnp.asarray((lens + step)[:, None]), kv_cache=jc,
                                  kv_pad_lens=jnp.asarray(pads), attn_impl="fused", **kw)
        to = tllama.llama_forward(tp, tcfg, input_ids=torch.from_numpy(tok[:, None]),
                                  positions=torch.from_numpy((lens + step)[:, None]),
                                  kv_cache=tc, kv_pad_lens=torch.from_numpy(pads), **kw)
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=LOGIT_TOL,
                                   rtol=0)
        jc = jo.kv_cache
        tok = np.asarray(jnp.argmax(jo.logits[:, 0], -1)).astype(np.int32)
    for a, b in zip(jc[:2], tc[:2]):
        # the same float32 projections rounded once: equal but for an
        # occasional last-bit flip of a bf16 value (2^-8 relative)
        np.testing.assert_allclose(bridge.tensor_to_numpy(b), np.asarray(a, np.float32),
                                   atol=1e-5, rtol=2 ** -8)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_greedy_generate_pallas_matches_jax(cache):
    """``attn_impl="pallas"`` through every decode step: the port reads the
    cache through kernel B8 (its plain version here), the JAX package,
    off the TPU, through ``decode_xla_q``. Same tokens and lengths, or a
    stream that parts at a near-tie."""
    cfg = jllama.llama_preset("tiny")
    p = jllama.init_llama_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, cfg.vocab_size, size=(3, 10)).astype(np.int32)
    mask = np.arange(10)[None, :] >= np.array([[0], [4], [9]])
    embeds = (np.asarray(p["embed_tokens"])[ids] * mask[..., None]).astype(np.float32)
    kw = dict(max_new_tokens=10, eos_id=5, attn_impl="pallas")
    want_t, want_n = jax_generate(p, cfg, jnp.asarray(embeds), jnp.asarray(mask),
                                  cache_dtype=jnp.dtype(cache), **kw)
    tp = bridge.llama_params_from_numpy(np_tree(p))
    got_t, got_n = greedy_generate(tp, tllama.llama_preset("tiny"), torch.from_numpy(embeds),
                                   torch.from_numpy(mask), cache_dtype=getattr(torch, cache),
                                   **kw)
    auto_t, _ = greedy_generate(tp, tllama.llama_preset("tiny"), torch.from_numpy(embeds),
                                torch.from_numpy(mask), cache_dtype=getattr(torch, cache),
                                max_new_tokens=10, eos_id=5)
    want = [row[:n] for row, n in zip(np.asarray(want_t).tolist(), np.asarray(want_n))]
    got = [row[:n] for row, n in zip(got_t.tolist(), got_n.tolist())]

    class _JE:  # what _jax_logits reads
        llm_cfg, llm_params = cfg, p

    _assert_streams_agree(got, want, _JE, embeds, mask, jnp.dtype(cache))
    assert got_t.tolist() == auto_t.tolist()  # B8 + write == the fused step here


def test_pallas_and_xla_refuse_what_they_cannot_run():
    """B8 takes T == 1 at one scalar offset: per-row offsets and a T > 1
    block raise instead of running another path; an unknown name raises."""
    cfg = tllama.llama_preset("tiny")
    tp = bridge.llama_params_from_numpy(np_tree(jllama.init_llama_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32)))
    cache = tllama.init_kv_cache(cfg, 2, 8, dtype=torch.bfloat16)
    pads = torch.zeros((2,), dtype=torch.int32)
    cases = [
        dict(input_ids=torch.zeros((2, 1), dtype=torch.int32), cache_offset_bound=5,
             cache_offset=torch.tensor([3, 5], dtype=torch.int32)),
        dict(input_ids=torch.zeros((2, 3), dtype=torch.int32), cache_offset=2),
    ]
    for kw in cases:
        with pytest.raises(ValueError, match="kernel B8"):
            tllama.llama_forward(tp, cfg, kv_cache=cache, kv_pad_lens=pads, attn_impl="pallas",
                                 **kw)
        tllama.llama_forward(tp, cfg, kv_cache=cache, kv_pad_lens=pads, **kw)  # "auto" runs
    with pytest.raises(ValueError, match="expected 'auto'"):
        tllama.llama_forward(tp, cfg, input_ids=torch.zeros((2, 1), dtype=torch.int32),
                             kv_cache=cache, cache_offset=2, kv_pad_lens=pads, attn_impl="xla_q")
    out = tllama.llama_forward(tp, cfg, input_ids=torch.zeros((2, 1), dtype=torch.int32),
                               kv_cache=cache, cache_offset=2, kv_pad_lens=pads, attn_impl="xla")
    assert torch.isfinite(out.logits).all()  # the plain versions, on CPU tensors


def test_dense_slot_decoder_on_a_bf16_cache_matches_jax():
    """tests/test_torch_serving.py's dense scenario on a bf16 cache: two
    waves (the second mid-flight), a cancel, chunks to the end; the port's
    steps run kernel B3's plain version at per-row offsets, the JAX
    decoder's ``fused_reference``."""
    je, te = _engines(cache="bfloat16")
    rng = np.random.RandomState(3)
    B, L, pads = 4, 16, (0, 5, 2, 9)
    ids = rng.randint(1, je.llm_cfg.vocab_size, (B, L))
    mask = np.arange(L)[None, :] >= np.asarray(pads)[:, None]
    embeds = (np.asarray(je.llm_params["embed_tokens"], np.float32)[ids]
              * mask[..., None]).astype(np.float32)
    kw = dict(eos_id=te.tokenizer.eos_id, n_slots=4, max_prompt_len=64, max_new_tokens=16)
    jd = JaxSlotDecoder(je.llm_params, je.llm_cfg, cache_dtype=jnp.bfloat16, **kw)
    td = SlotDecoder(te.llm_params, te.llm_cfg, cache_dtype=torch.bfloat16, device="cpu", **kw)

    def scenario(dec, to):
        out = {}

        def chunk(k):
            dec.decode_chunk(k)
            out.update({s: list(t[:n]) for s, t, n in dec.harvest()})

        dec.admit(to(embeds[:2]), to(mask[:2]), [0, 1], [16, 10])
        chunk(3)
        dec.admit(to(embeds[2:]), to(mask[2:]), [2, 3], [12, 14])
        chunk(2)
        dec.cancel([1])
        for _ in range(30):
            if dec.live_count() == 0:
                break
            chunk(4)
        assert dec.live_count() == 0
        return out

    want = scenario(jd, jnp.asarray)
    got = scenario(td, torch.from_numpy)
    assert set(got) == set(want) and {0, 2, 3} <= set(got)
    assert td.state.cache.k.dtype == torch.bfloat16 and not td.state.cache.quantized
    assert td.counts["prefills"] == 2 and td.counts["steps"] > 0
    rows = sorted(want)
    _assert_streams_agree([got[s] for s in rows], [want[s] for s in rows], je,
                          embeds[rows], mask[rows], jnp.bfloat16)


def test_whisper_kd_training_is_refused(tmp_path):
    """Whisper KD training is ported: the old refusal is gone and the
    trainer builds a Whisper encoder (its steps and resume:
    tests/test_torch_variants_train.py)."""
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    cfg = _whisper_config(load_config, YAML_DIR / "tiny_test.yaml")
    cfg.log.checkpoint_dir, cfg.log.log_dir = str(tmp_path / "c"), str(tmp_path / "l")
    t = Trainer(cfg, device="cpu")
    assert t.enc_setup.base == "whisper" and "conv1_w" in t.state.enc_params["encoder"]


def test_whisper_server_on_a_dense_bf16_cache(monkeypatch):
    """``cli.serve -c llama3_whisper.yaml --kv_cache_dtype bfloat16`` hands
    the server a Whisper config on a bf16 cache; a tiny Whisper engine on
    that cache (dynamic frames, as the published config) serves audio and
    text over HTTP on 127.0.0.1 through the dense continuous decoder."""
    import json
    import urllib.request

    from llm_speech_summarization_tpu_torch.cli import serve as cli
    from llm_speech_summarization_tpu_torch.serve import server as server_mod

    seen = {}
    monkeypatch.setattr(server_mod, "serve", lambda config, **kw: seen.update(config=config))
    cli.main(["-c", str(YAML_DIR / "llama3_whisper.yaml"), "--kv_cache_dtype", "bfloat16",
              "--device", "cpu"])
    assert seen["config"].model.kv_cache_dtype == "bfloat16"
    assert seen["config"].model.audio_encoder.base == "whisper"

    te = LLMSpeechTextInference(_whisper_config(load_config, YAML_DIR / "tiny_test.yaml",
                                                dynamic=True, cache="bfloat16"), device="cpu")
    srv = server_mod.SummarizationServer(te, host="127.0.0.1", port=0, continuous=True,
                                         paged=False, n_slots=2, max_new_tokens=8,
                                         admit_wait_ms=20, device="cpu")
    srv.start_background()
    try:
        wav = (0.1 * np.random.RandomState(6).randn(48000)).astype(np.float32)
        for path, body in (("/v1/audio_summary", {"audio": wav.tolist(), "max_new_tokens": 6}),
                           ("/v1/text_response", {"text": "summarize", "max_new_tokens": 4})):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                         data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200 and isinstance(json.loads(resp.read())["response"], str)
        dec = srv.batcher.decoder
        assert not dec.paged and dec.state.cache.k.dtype == torch.bfloat16
        assert dec.counts["prefills"] == 2 and dec.counts["steps"] > 0
        assert te.counts["encoder_forwards"] == 1
    finally:
        assert srv.drain(timeout=30)
