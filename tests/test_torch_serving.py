"""The port's serving stack on the CPU: its ``SlotDecoder`` against the JAX
package's (dense and paged, plain and speculative chunks, a wave admitted
mid-flight, a cancel), paged against dense, the engine's speculative path
against plain greedy, and the ``SummarizationServer`` over HTTP on
127.0.0.1. The tiny config with an int8 KV cache, the same weights in both
packages (``bridge``).

Free-running streams are held to the margin-aware contract of
``tests/test_fused_decode.py::test_fused_margin_aware_stream``: two
streams may part only at a step where the JAX model's top-2 logit margin is
a near-tie (the two packages sum in different orders).
"""

import base64
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.infer.slots import SlotDecoder as JaxSlotDecoder
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
from llm_speech_summarization_tpu_torch.serve.server import (
    BatchingEngine,
    ContinuousBatchingEngine,
    SummarizationServer,
)

torch.set_num_threads(1)

TINY_YAML = str(YAML_DIR / "tiny_test.yaml")
NEAR_TIE = 2e-4  # top-2 margin under which the packages may pick differently


def _int8(cfg):
    cfg.model.kv_cache_dtype = "int8"
    return cfg


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with the same weights, int8 KV cache."""
    je = JaxEngine(_int8(jax_load_config(TINY_YAML)))
    te = LLMSpeechTextInference(
        _int8(load_config(TINY_YAML)), device="cpu",
        llm_params=bridge.llama_params_from_numpy(jax.tree.map(np.asarray, je.llm_params)),
        audio_encoder_params=bridge.encoder_params_from_numpy(
            jax.tree.map(np.asarray, je.audio_encoder_params)),
    )
    return je, te


def _prompts(je, seed=3, B=4, L=16, pads=(0, 5, 2, 9)):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, je.llm_cfg.vocab_size, (B, L))
    mask = np.arange(L)[None, :] >= np.asarray(pads)[:, None]
    emb = np.asarray(je.llm_params["embed_tokens"], np.float32)[ids] * mask[..., None]
    return emb.astype(np.float32), mask


def _scenario(dec, embeds, mask, spec, to):
    """Admit two rows, decode, admit two more mid-flight, cancel one, drain.
    Returns {slot: tokens} of every harvested row."""
    out = {}

    def chunk(k):
        dec.decode_chunk(k, spec=spec)
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


def _jax_logits(je, embeds, mask, prefix):
    """JAX logits predicting token len(prefix) of one row, its own earlier
    tokens fed through the int8 KV cache step by step."""
    cfg, p = je.llm_cfg, je.llm_params
    L = embeds.shape[0]
    cache = jllama.init_kv_cache(cfg, 1, L + len(prefix) + 1, dtype=jnp.int8)
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


def _assert_streams_agree(got, want, je, embeds, mask, row_of_slot):
    """Equal token lists, or lists that part only at a JAX near-tie."""
    assert set(got) == set(want)
    for s in want:
        g, w = got[s], want[s]
        if g == w:
            continue
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        assert t < min(len(g), len(w)), f"slot {s}: lengths {len(g)} != {len(w)} on equal tokens"
        r = row_of_slot[s]
        logits = _jax_logits(je, embeds[r], mask[r], w[:t] if t else [])
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= NEAR_TIE, f"slot {s} parts at token {t}, not a near-tie"


ROWS = {0: 0, 1: 1, 2: 2, 3: 3}


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("paged", [False, True])
def test_slot_decoder_matches_jax(engines, paged, spec_k):
    je, te = engines
    embeds, mask = _prompts(je)
    kw = dict(eos_id=te.tokenizer.eos_id, n_slots=4, max_prompt_len=64, max_new_tokens=16,
              paged=paged, spec_k=spec_k)
    jd = JaxSlotDecoder(je.llm_params, je.llm_cfg, cache_dtype=jnp.int8, **kw)
    td = SlotDecoder(te.llm_params, te.llm_cfg, cache_dtype=torch.int8, device="cpu", **kw)
    assert (td.page_size, td.max_len) == (jd.page_size, jd.max_len)
    want = _scenario(jd, embeds, mask, spec_k > 0, jnp.asarray)
    got = _scenario(td, embeds, mask, spec_k > 0, torch.from_numpy)
    assert {0, 2, 3} <= set(got)  # slot 1 is cancelled unless it finished first
    _assert_streams_agree(got, want, je, embeds, mask, ROWS)
    assert td.counts["prefills"] == 2
    assert td.counts["spec_rounds" if spec_k else "steps"] > 0
    if paged:
        assert td.allocator.free_pages == td.num_pages - 1  # every page returned


@pytest.mark.parametrize("paged", [False, True])
def test_bridge_carries_jax_slot_state(engines, paged):
    """A JAX decoder's state mid-flight, carried into the port's types: the
    fields arrive equal, a paged cache's lengths and pads are the state's
    offsets and pads, and one decode step from it gives the JAX logits and
    cache writes."""
    from llm_speech_summarization_tpu_torch.infer.slots import SlotState
    from llm_speech_summarization_tpu_torch.models import llama as tllama

    je, te = engines
    embeds, mask = _prompts(je)
    jd = JaxSlotDecoder(je.llm_params, je.llm_cfg, eos_id=te.tokenizer.eos_id, n_slots=4,
                        max_prompt_len=64, max_new_tokens=16, cache_dtype=jnp.int8, paged=paged)
    jd.admit(jnp.asarray(embeds[:2]), jnp.asarray(mask[:2]), [0, 1], [16, 10])
    jd.decode_chunk(3)
    js = jd.state
    st = bridge.slot_state_from_numpy(jax.tree.map(np.asarray, js))
    assert isinstance(st, SlotState) and st.rng.dtype == torch.int64
    for f in SlotState._fields[1:]:  # values compared as float64 (exact for these)
        np.testing.assert_array_equal(bridge.tensor_to_numpy(getattr(st, f)).astype(np.float64),
                                      np.asarray(getattr(js, f)).astype(np.float64), err_msg=f)
    pos = js.offsets - js.pad_lens
    if paged:
        assert st.cache.lengths is st.offsets and st.cache.pad_lens is st.pad_lens
        jo = jllama.llama_forward(je.llm_params, je.llm_cfg, input_ids=js.last_token[:, None],
                                  attn_mask=None, positions=pos[:, None],
                                  kv_cache=js.cache._replace(lengths=js.offsets,
                                                             pad_lens=js.pad_lens))
        to = tllama.llama_forward(te.llm_params, te.llm_cfg, input_ids=st.last_token[:, None],
                                  positions=(st.offsets - st.pad_lens)[:, None], kv_cache=st.cache)
    else:
        jo = jllama.llama_forward(je.llm_params, je.llm_cfg, input_ids=js.last_token[:, None],
                                  attn_mask=None, positions=pos[:, None], kv_cache=js.cache,
                                  cache_offset=js.offsets, kv_pad_lens=js.pad_lens)
        to = tllama.llama_forward(te.llm_params, te.llm_cfg, input_ids=st.last_token[:, None],
                                  positions=(st.offsets - st.pad_lens)[:, None], kv_cache=st.cache,
                                  cache_offset=st.offsets, kv_pad_lens=st.pad_lens,
                                  cache_offset_bound=int(np.asarray(js.offsets).max()))
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=1e-4, rtol=0)
    names = ("k_pool", "v_pool", "k_scale", "v_scale") if paged else ("k", "v", "k_scale",
                                                                          "v_scale")
    for name in names:
        got = bridge.tensor_to_numpy(getattr(to.kv_cache, name))
        want = np.asarray(getattr(jo.kv_cache, name)).astype(got.dtype)
        if paged:
            got, want = got[:, 1:], want[:, 1:]  # the null page takes idle rows' writes
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_paged_and_dense_decoders_agree(engines):
    je, te = engines
    embeds, mask = _prompts(je, seed=8)
    streams = []
    for paged in (False, True):
        td = SlotDecoder(te.llm_params, te.llm_cfg, eos_id=te.tokenizer.eos_id, n_slots=4,
                         max_prompt_len=64, max_new_tokens=16, cache_dtype=torch.int8,
                         paged=paged, device="cpu")
        streams.append(_scenario(td, embeds, mask, False, torch.from_numpy))
    _assert_streams_agree(streams[1], streams[0], je, embeds, mask, ROWS)


def test_engine_speculative_matches_greedy(engines):
    """speculative_k=3 on a float32 cache (where verification is exact)
    emits the plain greedy stream, in fewer forwards."""
    je, te = engines
    cfg = load_config(TINY_YAML)
    kw = dict(device="cpu", llm_params=te.llm_params,
              audio_encoder_params=te.audio_encoder_params)
    plain = LLMSpeechTextInference(cfg, **kw)
    spec = LLMSpeechTextInference(cfg, speculative_k=3, **kw)
    rng = np.random.RandomState(2)
    clips = [(0.1 * rng.randn(n)).astype(np.float32) for n in (8000, 12000, 5000)]
    want = plain.generate_audio_response_batch(clips, max_new_tokens=24)
    got = spec.generate_audio_response_batch(clips, max_new_tokens=24)
    assert got == want
    assert spec.counts["spec_rounds"] > 0 and spec.counts["decode_steps"] == 0
    assert spec.counts["spec_rounds"] < plain.counts["decode_steps"]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_summarization_server_on_cpu(engines):
    _, te = engines
    srv = SummarizationServer(te, host="127.0.0.1", port=0, continuous=True, paged=True,
                              n_slots=4, max_new_tokens=16, admit_wait_ms=20, device="cpu")
    srv.start_background()
    try:
        port = srv.port
        assert _get(port, "/healthz") == (200, {"status": "ok", "batches_run": 0,
                                                "requests_served": 0})
        rng = np.random.RandomState(0)
        wav = (0.1 * rng.randn(8000)).astype(np.float32)
        pcm8k = (np.clip(rng.randn(4000) * 0.1, -1, 1) * 32767).astype(np.int16)
        results = {}
        bodies = {
            "f32": ("/v1/audio_summary", {"audio": wav.tolist(), "max_new_tokens": 6}),
            "b64": ("/v1/audio_summary", {"audio_b64": base64.b64encode(pcm8k.tobytes()).decode(),
                                          "sample_rate": 8000, "max_new_tokens": 5}),
            "text": ("/v1/text_response", {"text": "summarize this", "max_new_tokens": 4}),
        }
        threads = [threading.Thread(target=lambda k=k, v=v: results.__setitem__(k, _post(port, *v)))
                   for k, v in bodies.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for k in bodies:
            assert results[k][0] == 200 and isinstance(results[k][1]["response"], str), k

        # streamed: ndjson deltas, then the final response they add up to
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio_summary",
            data=json.dumps({"audio": wav.tolist(), "max_new_tokens": 12, "stream": True}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            lines = [json.loads(x) for x in resp.read().decode().splitlines() if x.strip()]
        assert lines[-1]["done"] is True
        assert "".join(x.get("delta", "") for x in lines[:-1]) == lines[-1]["response"]

        # a seeded sampled request replays identically
        sampled = {"text": "hello", "max_new_tokens": 8, "temperature": 0.9, "top_k": 20,
                   "seed": 11}
        a, b = _post(port, "/v1/text_response", sampled), _post(port, "/v1/text_response", sampled)
        assert a[0] == 200 and a == b

        status, body = _post(port, "/v1/text_response", {"text": "x", "max_new_tokens": 17})
        assert status == 400 and "max_new_tokens" in body["error"]
        status, m = _get(port, "/metrics")
        assert status == 200 and m["scheduler"] == "ContinuousBatchingEngine" and m["paged"]
        assert m["requests_served"] == 6 and m["free_pages"] == m["num_pages"] - 1
        assert m["decoder_counts"]["prefills"] >= 2
    finally:
        assert srv.drain(timeout=30)


def test_entry_points_need_a_card_or_cpu(engines, monkeypatch):
    """Without a card, device=None raises at every entry point; the CLI
    refuses --tp > 1."""
    from llm_speech_summarization_tpu_torch.cli import serve as cli

    _, te = engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMSpeechTextInference(load_config(TINY_YAML))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotDecoder(te.llm_params, te.llm_cfg, eos_id=0)
    for cls in (BatchingEngine, ContinuousBatchingEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(te)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SummarizationServer(te, port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-c", TINY_YAML, "--no_warmup"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-c", TINY_YAML, "--tp", "2"])


def test_request_level_batcher_on_cpu(engines):
    _, te = engines
    b = BatchingEngine(te, max_batch=4, max_wait_ms=20, device="cpu")
    try:
        from llm_speech_summarization_tpu_torch.serve.server import _Request

        reqs = [_Request("text", t, "", 4) for t in ("one", "two words", "three")]
        outs = {}
        threads = [threading.Thread(target=lambda r=r: outs.__setitem__(r.payload, b.submit(r)))
                   for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert set(outs) == {"one", "two words", "three"}
        deadline = time.monotonic() + 10
        while not b.idle() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b.idle() and b.requests_served == 3
    finally:
        b.shutdown()
