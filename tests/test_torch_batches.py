"""The port's engine on BASELINE config #1's paths against the JAX engine,
and its pipelined batch stream against per-batch calls, on the CPU:

  * the ``ctc_pool`` projector over hubert-base given frame ranges: the
    spliced prompts, greedy tokens under the margin-aware contract, and the
    encoder's input bit for bit at padded batches of 4 and 8 (the JAX
    engine rounds a batch of 8 through float16 with ranges too);
  * the MiniChat template end to end on a tiny MHA LLM (24/24 in the
    published model: every head its own KV head);
  * ``iter_audio_response_batches`` / ``generate_audio_response_batches``:
    the token streams of per-batch ``generate_audio_response_batch`` calls,
    with ragged batches, a text prompt, per-batch sampling and ranges, an
    empty stream, misaligned iterators and at most two batches held.

Tolerances: spliced prompts float32 atol 1e-5 (as ``test_torch_generate``);
decode logits within ``LOGIT_DELTA`` = 1e-4, a token differing only where
the JAX top-2 margin is below twice that; encoder inputs and token streams
bit for bit.
"""

import dataclasses
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_generate import LOGIT_DELTA, _margin_checked_stream, np_tree

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.models import audio_encoder as jae
from llm_speech_summarization_tpu.models import hubert as jhub
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.models import hubert as thub
from llm_speech_summarization_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_TINY_YAML = ROOT / "llm_speech_summarization_tpu" / "configs" / "yaml" / "tiny_test.yaml"
TINY_YAML = YAML_DIR / "tiny_test.yaml"
BASE_FIELDS = dict(conv_bias=False, feat_extract_norm="group", do_stable_layer_norm=False)
MINICHAT = "GeneZC/MiniChat-2-3B"
# a tiny MHA LLM with MiniChat's switches: no rope scaling, an untied head
MHA_FIELDS = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=4, head_dim=16, rope_theta=10000.0,
                  rope_scaling=None, tie_embeddings=False, max_position_embeddings=2048)


def _configs(method="pool", llm_type=None, dtype="float32"):
    cfgs = [jax_load_config(str(JAX_TINY_YAML)), load_config(str(TINY_YAML))]
    for c in cfgs:
        c.model.audio_encoder.downsample_method = method
        c.model.compute_dtype = dtype
        if llm_type:
            c.model.llm_type = llm_type
    return cfgs


def _engines(method="ctc_pool", llm_type=None, mha=False, dtype="float32"):
    """The JAX engine on the tiny hubert-base encoder (its setup and params
    replaced before any call) and the port's engine from the same weights."""
    jcfg, tcfg = _configs(method, llm_type, dtype)
    llm_kw = {}
    if mha:
        jcfg_llm = jllama.LlamaConfig(**MHA_FIELDS)
        llm_kw = dict(llm_cfg=jcfg_llm, llm_params=jllama.init_llama_params(
            jax.random.PRNGKey(3), jcfg_llm, dtype=jax.numpy.float32))
    je = JaxEngine(jcfg, **llm_kw)
    jbase = dataclasses.replace(jhub.hubert_preset("tiny"), **BASE_FIELDS)
    je.encoder_setup = dataclasses.replace(je.encoder_setup, encoder_cfg=jbase)
    je.audio_encoder_params = jae.init_audio_encoder(jax.random.PRNGKey(7), je.encoder_setup,
                                                     dtype=jax.numpy.float32)
    te = LLMSpeechTextInference(
        tcfg, device="cpu",
        llm_params=bridge.llama_params_from_numpy(np_tree(je.llm_params)),
        audio_encoder_params=bridge.encoder_params_from_numpy(np_tree(je.audio_encoder_params)),
        llm_cfg=tllama.LlamaConfig(**MHA_FIELDS) if mha else None,
        encoder_cfg=dataclasses.replace(thub.hubert_preset("tiny"), **BASE_FIELDS),
    )
    return je, te


def _clips(seed=3, lengths=(8000, 5600, 12345)):
    rng = np.random.RandomState(seed)
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in lengths]


def _ranges_for(clip, seed=0):
    """4-frame ranges tiling the clip's frames (the synthetic dataset's
    ``pool_ranges_4``), with one empty range dropped in."""
    frames = max((len(clip) - 160) // 320, 8)
    r = [(s, s + 4) for s in range(0, frames - 3, 4)]
    r.insert(1 + seed % 2, (5, 5))
    return np.asarray(r, np.int32)


def test_ctc_pool_engine_matches_jax():
    """hubert-base + ctc_pool: the spliced prompts of three clips (a padded
    batch of 4 whose padded row has no ranges, so no valid embedding) and
    the greedy stream teacher-forced through both LLMs."""
    je, te = _engines("ctc_pool")
    clips = _clips()
    ranges = [_ranges_for(c, i) for i, c in enumerate(clips)]
    je_embeds, je_mask = je.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)
    te_embeds, te_mask = te.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)
    np.testing.assert_array_equal(te_mask.numpy(), np.asarray(je_mask))
    np.testing.assert_allclose(te_embeds.numpy(), np.asarray(je_embeds), atol=1e-5, rtol=0)
    P, S = te.prefix_ids.shape[0], te.suffix_ids.shape[0]
    n_valid = te_mask.sum(1).tolist()
    assert n_valid[:3] == [P + S + int((r[:, 1] > r[:, 0]).sum()) for r in ranges]
    assert n_valid[3] == P + S  # the padded row: prefix and suffix only
    _margin_checked_stream(je, te, np.asarray(je_embeds), np.asarray(je_mask), steps=8)
    out = te.generate_audio_response(clips[0], max_new_tokens=6, ctc_pool_ranges=ranges[0])
    assert isinstance(out, str)
    with pytest.raises(ValueError, match="ctc_pool_ranges"):
        te.build_audio_prompt_batch(clips)


def _encoder_inputs(je, te, clips, ranges, monkeypatch):
    """The waveforms and ranges that reach ``audio_encoder_forward`` in both
    engines (rows sorted by their bytes: the JAX engine may split a batch
    into chunks on worker threads)."""
    import llm_speech_summarization_tpu.infer.engine as jax_engine_mod
    import llm_speech_summarization_tpu_torch.infer.engine as engine_mod

    seen = {"jax": [], "port": []}
    jax_forward, port_forward = jax_engine_mod.audio_encoder_forward, \
        engine_mod.audio_encoder_forward

    def jax_spy(params, setup, wav, lens, **kw):
        jax.debug.callback(lambda w, r: seen["jax"].append(
            (np.asarray(w, np.float32), np.asarray(r))), wav, kw["ctc_pool_ranges"])
        return jax_forward(params, setup, wav, lens, **kw)

    def port_spy(params, setup, wav, lens, **kw):
        seen["port"].append((wav.float().numpy(), kw["ctc_pool_ranges"].numpy()))
        return port_forward(params, setup, wav, lens, **kw)

    monkeypatch.setattr(jax_engine_mod, "audio_encoder_forward", jax_spy)
    monkeypatch.setattr(engine_mod, "audio_encoder_forward", port_spy)
    je.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)
    jax.effects_barrier()
    te.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)

    def rows(calls):
        pairs = [(w, r) for ws, rs in calls for w, r in zip(ws, rs)]
        pairs.sort(key=lambda p: p[0].tobytes() + p[1].tobytes())
        return np.stack([w for w, _ in pairs]), np.stack([r for _, r in pairs])

    return rows(seen["jax"]), rows(seen["port"])


@pytest.mark.parametrize("n_clips", [3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctc_pool_encoder_input_matches_jax_bit_for_bit(dtype, n_clips, monkeypatch):
    """With ranges, the JAX engine uploads a padded batch of 8 through
    float16 and a batch of 4 straight: the port's encoder sees the same
    waveform bits and the same zero-padded ranges."""
    je, te = _engines("ctc_pool", dtype=dtype)
    rng = np.random.RandomState(11)
    clips = [(0.3 * rng.randn(n)).astype(np.float32)
             for n in rng.randint(4000, 12000, size=n_clips)]
    ranges = [_ranges_for(c, i) for i, c in enumerate(clips)]
    (jw, jr), (tw, tr) = _encoder_inputs(je, te, clips, ranges, monkeypatch)
    assert tw.shape[0] == (8 if n_clips == 8 else 4)
    np.testing.assert_array_equal(tw.view(np.uint32), jw.view(np.uint32))
    np.testing.assert_array_equal(tr, jr)
    if n_clips == 8:  # rounded through float16, as the JAX engine uploads it
        assert all(np.array_equal(w, w.astype(np.float16).astype(np.float32)) for w in tw)


def test_minichat_template_end_to_end():
    """BASELINE config #1's prompt surface at tiny scale: MiniChat's chat
    template ([|User|] ... [|Assistant|]) selected by llm_type, over an MHA
    LLM with an untied head, through text and audio prompts; the same
    template ids, prompts and greedy stream as the JAX engine, and the same
    stream twice."""
    je, te = _engines("pool", llm_type=MINICHAT, mha=True)
    assert "[|User|]" in te.template.prefix and "[|Assistant|]" in te.template.suffix
    np.testing.assert_array_equal(te.prefix_ids.numpy(), np.asarray(je.prefix_ids))
    np.testing.assert_array_equal(te.suffix_ids.numpy(), np.asarray(je.suffix_ids))
    assert te.llm_cfg.num_kv_heads == te.llm_cfg.num_heads and not te.llm_cfg.tie_embeddings
    texts = ["summarize this speech"]
    je_e, je_m = je.build_text_prompt_batch(texts)
    te_e, te_m = te.build_text_prompt_batch(texts)
    np.testing.assert_array_equal(te_m.numpy(), np.asarray(je_m))
    np.testing.assert_allclose(te_e.numpy(), np.asarray(je_e), atol=1e-5, rtol=0)
    clips = _clips(lengths=(8000, 6400))
    je_e, je_m = je.build_audio_prompt_batch(clips)
    te_e, te_m = te.build_audio_prompt_batch(clips)
    np.testing.assert_array_equal(te_m.numpy(), np.asarray(je_m))
    np.testing.assert_allclose(te_e.numpy(), np.asarray(je_e), atol=1e-5, rtol=0)
    _margin_checked_stream(je, te, np.asarray(je_e), np.asarray(je_m), steps=8)
    out_t = te.generate_text_response(texts[0], max_new_tokens=8)
    out_a = te.generate_audio_response(clips[0], max_new_tokens=8)
    assert isinstance(out_t, str) and isinstance(out_a, str)
    assert out_a == te.generate_audio_response(clips[0], max_new_tokens=8)


# ---- the pipelined batch stream


class _Recorder:
    """Wraps an engine's tokenizer and keeps every decoded token row, so two
    runs compare by token stream, not by text."""

    def __init__(self, tok):
        self.tok, self.rows = tok, []

    def decode(self, ids, **kw):
        self.rows.append(list(ids))
        return self.tok.decode(ids, **kw)

    def __getattr__(self, name):
        return getattr(self.tok, name)


@pytest.fixture(scope="module")
def port_engine():
    _, tcfg = _configs("pool")
    tcfg.model.kv_cache_dtype = "int8"
    te = LLMSpeechTextInference(tcfg, device="cpu")
    te.tokenizer = _Recorder(te.tokenizer)
    return te


def _batches(seed=21, sizes=(3, 2, 4, 1)):
    rng = np.random.RandomState(seed)
    return [[(0.05 * rng.randn(8000 + 500 * i + 300 * j)).astype(np.float32)
             for j in range(n)] for i, n in enumerate(sizes)]


def _streams(te, fn):
    te.tokenizer.rows = []
    out = fn()
    return out, te.tokenizer.rows


@pytest.mark.parametrize("text", ["", "Summarize: "])
def test_batches_pipeline_matches_per_batch_calls(port_engine, text):
    """Ragged batches (3, 2, 4 and 1 clips) through the pipelined stream,
    with and without a text prompt: the texts and token streams of
    per-batch calls."""
    te = port_engine
    batches = _batches()
    got, got_rows = _streams(te, lambda: te.generate_audio_response_batches(
        batches, additional_text_prompt=text, max_new_tokens=8))
    want, want_rows = _streams(te, lambda: [te.generate_audio_response_batch(
        b, additional_text_prompt=text, max_new_tokens=8) for b in batches])
    assert got == want and got_rows == want_rows
    assert [len(o) for o in got] == [3, 2, 4, 1]
    assert any(r for r in got_rows)


def test_batches_pipeline_per_batch_sampling(port_engine):
    """Per-batch ``sampling`` drawn in step with the batches: each batch's
    seeded requests replay as in its own call."""
    te = port_engine
    batches = _batches(sizes=(2, 3))
    samp = [[(0.8, 0, 1.0, 5), None], [None, (0.7, 4, 0.9, 6), (1.0, 0, 1.0, 7)]]
    got, got_rows = _streams(te, lambda: te.generate_audio_response_batches(
        batches, max_new_tokens=8, sampling=samp))
    want, want_rows = _streams(te, lambda: [te.generate_audio_response_batch(
        b, max_new_tokens=8, sampling=s) for b, s in zip(batches, samp)])
    assert got == want and got_rows == want_rows


def test_batches_pipeline_ctc_pool_ranges():
    """Per-batch ``ctc_pool_ranges`` drawn in step with the batches (a lazy
    generator of each): the streams of per-batch calls with those ranges."""
    _, te = _engines("ctc_pool")
    te.tokenizer = _Recorder(te.tokenizer)
    batches = _batches(sizes=(2, 3))
    ranges = [[_ranges_for(c, i) for i, c in enumerate(b)] for b in batches]
    got, got_rows = _streams(te, lambda: list(te.iter_audio_response_batches(
        iter(batches), max_new_tokens=6, ctc_pool_ranges=iter(ranges))))
    want, want_rows = _streams(te, lambda: [te.generate_audio_response_batch(
        b, max_new_tokens=6, ctc_pool_ranges=r) for b, r in zip(batches, ranges)])
    assert got == want and got_rows == want_rows


def test_batches_pipeline_edges(port_engine):
    """An empty stream gives nothing; sampling or ranges that run short
    raise ValueError naming the alignment; the stream pulls at most one
    batch ahead of the one it yields."""
    te = port_engine
    assert te.generate_audio_response_batches([], max_new_tokens=4) == []
    assert list(te.iter_audio_response_batches(iter([]), max_new_tokens=4)) == []
    batches = _batches(sizes=(1, 1, 1))
    with pytest.raises(ValueError, match="must align per batch"):
        te.generate_audio_response_batches(batches, max_new_tokens=4, sampling=[None])
    with pytest.raises(ValueError, match="must align per batch"):
        te.generate_audio_response_batches(batches, max_new_tokens=4,
                                           ctc_pool_ranges=[None, None])
    pulled = []
    lock = threading.Lock()

    def lazy():
        for i, b in enumerate(batches):
            with lock:
                pulled.append(i)
            yield b

    for i, out in enumerate(te.iter_audio_response_batches(lazy(), max_new_tokens=4)):
        assert len(out) == 1
        with lock:
            assert max(pulled) <= i + 1  # the batch decoding and the one being built
    assert pulled == [0, 1, 2]


def test_pipeline_counts_every_encoder_forward(port_engine):
    te = port_engine
    te.counts.clear()
    te.generate_audio_response_batches(_batches(sizes=(1, 2, 1)), max_new_tokens=4)
    assert te.counts["encoder_forwards"] == 3 and te.counts["prefills"] == 3


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: python -m pytest -m cuda tests/)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pool", "ctc_pool"])
def test_batches_pipeline_matches_serial_on_card(card, method):
    """On the card the stream builds on a side CUDA stream: its token
    streams equal per-batch calls bit for bit (batches of 8 clips, so the
    float16 upload and the pinned copy run), with ranges too."""
    _, tcfg = _configs(method)
    tcfg.model.kv_cache_dtype = "int8"
    tcfg.model.param_dtype = tcfg.model.compute_dtype = "bfloat16"  # the kernels take bf16
    tcfg.model.llm_embedding_channels = 512
    te = LLMSpeechTextInference(
        tcfg, encoder_cfg=dataclasses.replace(thub.hubert_preset("tiny"), **BASE_FIELDS,
                                              hidden_size=128, num_heads=2),
        llm_cfg=tllama.LlamaConfig(**{**MHA_FIELDS, "hidden_size": 512, "num_heads": 4,
                                      "num_kv_heads": 4, "head_dim": 128}))
    te.tokenizer = _Recorder(te.tokenizer)
    batches = _batches(sizes=(8, 5, 8))
    ranges = ([[_ranges_for(c, i) for i, c in enumerate(b)] for b in batches]
              if method == "ctc_pool" else None)
    got, got_rows = _streams(te, lambda: te.generate_audio_response_batches(
        batches, max_new_tokens=16, ctc_pool_ranges=ranges))
    want, want_rows = _streams(te, lambda: [te.generate_audio_response_batch(
        b, max_new_tokens=16, ctc_pool_ranges=None if ranges is None else ranges[i])
        for i, b in enumerate(batches)])
    assert got == want and got_rows == want_rows
    assert te._side_stream is not None
