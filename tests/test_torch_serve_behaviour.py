"""Serving behaviours of the port's continuous scheduler and slot decoder on
the CPU, as the JAX package's tests hold its own (tiny config, float32
cache, the port's plain versions):

  * the speculative governor promotes on a stream its drafts predict,
    demotes and re-probes without it, and spec chunks finish such a stream
    in fewer chunks (``tests/test_spec_promote.py``);
  * a sustained mixed load with slot churn answers every request with its
    one-shot text, dense or paged, plain or speculative
    (``tests/test_serve_soak.py``);
  * a submit timeout cancels the request and frees its slot, and the
    scheduler survives a transient decode failure
    (``tests/test_continuous.py``);
  * streamed deltas hold back a split UTF-8 character
    (``tests/test_round3_fixes.py``);
  * an EOS inside a speculative round and an admission in the middle of a
    speculative decode give the plain greedy tokens
    (``tests/test_spec_slots.py``).
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
from llm_speech_summarization_tpu_torch.models.llama import init_llama_params, llama_preset
from llm_speech_summarization_tpu_torch.serve.server import (
    ContinuousBatchingEngine,
    SummarizationServer,
    _Request,
    _SpecGovernor,
)
from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(1)

TINY_YAML = str(YAML_DIR / "tiny_test.yaml")
TINY = llama_preset("tiny")


def _engine():
    return LLMSpeechTextInference(load_config(TINY_YAML), device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _zero_floats(tree):
    if isinstance(tree, dict):
        return {k: _zero_floats(v) for k, v in tree.items()}
    return tree * 0 if tree.is_floating_point() else tree


@pytest.fixture(scope="module")
def repetitive_engine():
    """Zeroed LLM weights make every logit equal, so greedy argmax emits
    token 0 forever (the byte tokenizer's EOS is 257): a stream the n-gram
    drafter predicts perfectly."""
    eng = _engine()
    eng.llm_params = _zero_floats(eng.llm_params)
    return eng


def _continuous(engine, **kw):
    return ContinuousBatchingEngine(engine, max_prompt_len=256, device="cpu", **kw)


# --- the speculative governor -------------------------------------------------


def test_governor_promotes_on_repetitive_stream(repetitive_engine):
    cb = _continuous(repetitive_engine, n_slots=4, chunk_steps=4, max_new_tokens=32, spec_k=4)
    try:
        gov = cb.spec_governor
        assert gov is not None
        assert isinstance(cb.submit(_Request("text", "repeat after me", "", 32), timeout=300),
                          str)
        # every draft accepted: acceptance ~1, far above the demote threshold
        assert gov.acceptance > gov.threshold, gov.acceptance
        assert gov.want_spec()
    finally:
        cb.shutdown()


def test_governor_demotes_then_reprobes_unit():
    gov = _SpecGovernor(spec_k=4, threshold=0.05, probe_every=8)
    for _ in range(10):
        gov.observe(rounds=4, deltas=[4, 4, 4])  # exactly one token a round
    assert gov.acceptance < gov.threshold
    probes = [gov.want_spec() for _ in range(20)]
    assert not probes[0]
    assert any(probes), "the governor keeps probing after a demotion"
    for _ in range(6):
        gov.observe(rounds=4, deltas=[4 + 4 * 4] * 3)  # k drafts accepted every round
    assert gov.acceptance > gov.threshold
    assert gov.want_spec()


def test_spec_run_uses_fewer_chunks_than_plain(repetitive_engine):
    counts = {}
    for spec_k in (0, 4):
        cb = _continuous(repetitive_engine, n_slots=4, chunk_steps=4, max_new_tokens=32,
                         spec_k=spec_k)
        try:
            out = cb.submit(_Request("text", "repeat after me", "", 32), timeout=300)
            assert isinstance(out, str)
            counts[spec_k] = cb.batches_run
        finally:
            cb.shutdown()
    assert counts[4] < counts[0], counts


# --- soak ---------------------------------------------------------------------

N_REQUESTS = 18
BUDGETS = (4, 8, 16)


@pytest.mark.parametrize("paged,spec_k", [(False, 0), (True, 0), (False, 3), (True, 3)],
                         ids=["dense", "paged", "spec", "paged-spec"])
def test_sustained_mixed_load_soak(engine, paged, spec_k):
    """Staggered text requests (a quarter streamed) through three slots and
    two-step chunks: every response equals its one-shot text, and streamed
    deltas add up to it."""
    texts = [f"soak prompt {i} topic {(i * 13) % 7}" for i in range(N_REQUESTS)]
    budgets = [BUDGETS[i % len(BUDGETS)] for i in range(N_REQUESTS)]
    want = [engine.generate_text_response_batch([t], max_new_tokens=b)[0]
            for t, b in zip(texts, budgets)]
    srv = SummarizationServer(engine, host="127.0.0.1", port=0, continuous=True, paged=paged,
                              n_slots=3, chunk_steps=2, max_new_tokens=24, spec_k=spec_k,
                              device="cpu")
    srv.start_background()
    results, errors = {}, []

    def post(i, stream):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
            conn.request("POST", "/v1/text_response",
                         json.dumps({"text": texts[i], "max_new_tokens": budgets[i],
                                     "stream": stream}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            conn.close()
            assert resp.status == 200, raw[:200]
            if stream:
                lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
                assert lines[-1].get("done") is True, lines[-1]
                assert "".join(x.get("delta", "") for x in lines[:-1]) == lines[-1]["response"]
                results[i] = lines[-1]["response"]
            else:
                results[i] = json.loads(raw)["response"]
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append((i, repr(e)))

    try:
        threads = []
        for i in range(N_REQUESTS):
            t = threading.Thread(target=post, args=(i, i % 4 == 1))
            t.start()
            threads.append(t)
            time.sleep(0.02 * (i % 3))  # staggered arrivals
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert [results[i] for i in range(N_REQUESTS)] == want
        m = srv.metrics()
        assert m["requests_served"] == N_REQUESTS and m["scheduler_loop_errors"] == 0
        if paged:
            assert m["free_pages"] == m["num_pages"] - 1  # every page came back
    finally:
        assert srv.drain(timeout=60)


# --- cancellation and a failing chunk -----------------------------------------


def test_submit_timeout_cancels_and_frees_slot(engine):
    cb = _continuous(engine, n_slots=1, chunk_steps=2, max_new_tokens=256, max_admit=1,
                     admit_wait_ms=5.0)
    try:
        long_req = _Request("text", "an epic poem about the sea", "", 256)
        with pytest.raises(TimeoutError):
            cb.submit(long_req, timeout=0.05)
        assert long_req.cancelled.is_set()
        # the one slot comes back for the next request
        want = engine.generate_text_response_batch(["hello there"], max_new_tokens=6)[0]
        assert cb.submit(_Request("text", "hello there", "", 6), timeout=120) == want
        deadline = time.monotonic() + 10
        while cb._by_slot and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not cb._by_slot  # no slot leaked
    finally:
        cb.shutdown()


def test_scheduler_survives_transient_decode_failure(engine):
    cb = _continuous(engine, n_slots=2, max_new_tokens=16, chunk_steps=2)
    try:
        orig = cb.decoder.decode_chunk
        boom = {"n": 0}

        def flaky(*a, **k):
            if boom["n"] == 0:
                boom["n"] += 1
                raise RuntimeError("transient device failure (injected)")
            return orig(*a, **k)

        cb.decoder.decode_chunk = flaky
        with pytest.raises(RuntimeError, match="scheduler error"):
            cb.submit(_Request("text", "will fail", "", 8), timeout=120)
        assert cb._loop_errors == 1
        # the loop lives on: the next request serves normally
        got = cb.submit(_Request("text", "still alive", "", 8), timeout=300)
        assert got == engine.generate_text_response_batch(["still alive"], max_new_tokens=8)[0]
    finally:
        cb.shutdown()


# --- streamed deltas over a split UTF-8 character ------------------------------


def test_emit_partials_holds_back_split_utf8():
    tok = ByteTokenizer()
    text = "naïve café"  # multi-byte characters
    ids = tok.encode(text, add_bos=False)
    tokens = np.asarray([ids + [tok.eos_id] * (16 - len(ids))], np.int32)

    class _Engine:
        tokenizer = tok

    eng = ContinuousBatchingEngine.__new__(ContinuousBatchingEngine)
    eng.engine = _Engine()
    req = _Request(kind="text", payload="", text_prompt="", max_new_tokens=16, stream=True)
    eng._by_slot = {0: req}
    # one id at a time: every prefix that splits a character is held back,
    # and the deltas add up to the text
    for n in range(1, len(ids) + 1):
        eng._emit_partials((np.asarray([False]), np.asarray([16]), np.asarray([n]), tokens))
    got = []
    while not req.partials.empty():
        got.append(req.partials.get())
    assert "".join(got) == text
    assert "�" not in "".join(got)


# --- speculative chunks at the slot decoder -----------------------------------


@pytest.fixture(scope="module")
def params():
    return init_llama_params(torch.Generator().manual_seed(0), TINY, dtype=torch.float32)


def _prompts(params, seed, B=3, L=16, pads=(0, 5, 2)):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(1, TINY.vocab_size, (B, L)))
    mask = torch.from_numpy(np.arange(L)[None, :] >= np.asarray(pads)[:, None])
    return params["embed_tokens"][ids] * mask[..., None], mask


def _decoder(params, eos, spec_k=0):
    return SlotDecoder(params, TINY, eos_id=eos, n_slots=4, max_prompt_len=64,
                       max_new_tokens=24, cache_dtype=torch.float32, spec_k=spec_k,
                       device="cpu")


def _drain(dec, spec, chunk=3, limit=40):
    for _ in range(limit):
        if dec.live_count() == 0:
            break
        dec.decode_chunk(chunk, spec=spec)


def _run(dec, embeds, mask, budgets, spec):
    dec.admit(embeds, mask, list(range(len(budgets))), list(budgets))
    _drain(dec, spec)
    return {s: (t, n) for s, t, n in dec.harvest()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for s, (tw, nw) in want.items():
        tg, ng = got[s]
        assert ng == nw, (s, ng, nw)
        np.testing.assert_array_equal(tg[:ng], tw[:nw], err_msg=f"slot {s}")


def test_spec_eos_mid_round_matches_plain(params):
    """An EOS inside a committed draft window ends the row as stepwise
    greedy does: the EOS id is a token row 0 emits mid-stream."""
    embeds, mask = _prompts(params, seed=11, pads=(0, 0, 0))
    free = _run(_decoder(params, eos=-1), embeds, mask, [24] * 3, False)
    eos = int(free[0][0][7])
    want = _run(_decoder(params, eos=eos), embeds, mask, [24] * 3, False)
    assert min(n for _, n in want.values()) < 24, "the EOS must fire"
    for k in (2, 4):
        _assert_same(_run(_decoder(params, eos=eos, spec_k=k), embeds, mask, [24] * 3, True),
                     want)


def test_spec_mid_decode_admission(params):
    """A row admitted while others are mid-speculation gets the tokens of a
    fresh plain run: each slot's rejected tails stay in its own rows."""
    embeds, mask = _prompts(params, seed=7)
    want = _run(_decoder(params, eos=511), embeds, mask, [20] * 3, False)
    dec = _decoder(params, eos=511, spec_k=3)
    dec.admit(embeds[:2], mask[:2], [0, 1], [20, 20])
    dec.decode_chunk(2, spec=True)  # rows 0 and 1 mid-flight with rejected tails
    dec.admit(embeds[2:3], mask[2:3], [2], [20])
    _drain(dec, spec=True)
    _assert_same({s: (t, n) for s, t, n in dec.harvest()}, want)
