"""The port's evaluation harness against the JAX package's on the CPU: ROUGE
equal (the same pure-Python algorithm), BERTScore within 1e-9 (the same
float64 numpy algorithm over the same embeddings), ``LlamaEmbedder``
within the Llama forward's tolerance (atol 1e-4, rtol 1e-3, as
``test_torch_models.py``) from the same weights, ``evaluate_engine`` with
the JAX harness's keys and ROUGE over equal outputs, and
``cli/evaluate.py --device cpu`` on the tiny config."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.eval import bertscore as jbs
from llm_speech_summarization_tpu.eval import rouge as jrouge
from llm_speech_summarization_tpu.eval.evaluate import evaluate_engine as jax_evaluate
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.eval import bertscore as tbs
from llm_speech_summarization_tpu_torch.eval import rouge as trouge
from llm_speech_summarization_tpu_torch.eval.evaluate import evaluate_engine
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY = str(YAML_DIR / "tiny_test.yaml")
JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")

PAIRS = [("the cat sat", "the cat sat"), ("the cat", "the cat sat"), ("a b c", "a b d"),
         ("a b c d", "a x c y"), ("The CAT, sat!", "the cat sat"), ("", "x"), ("x", ""),
         ("summary: quick brown fox near the river", "summary: a lazy dog near river banks")]


@pytest.mark.parametrize("pred,ref", PAIRS)
def test_rouge_equals_jax(pred, ref):
    for n in (1, 2, 3):
        assert trouge.rouge_n(pred, ref, n) == jrouge.rouge_n(pred, ref, n)
    assert trouge.rouge_l(pred, ref) == jrouge.rouge_l(pred, ref)


def test_rouge_corpus_equals_jax():
    preds, refs = zip(*PAIRS)
    assert trouge.rouge_scores(preds, refs) == jrouge.rouge_scores(preds, refs)
    assert trouge.rouge_scores([], []) == jrouge.rouge_scores([], [])


def _toy_embedder(texts):
    """Deterministic per-word embeddings."""
    out = []
    for t in texts:
        words = t.lower().split()
        embs = [np.random.RandomState(sum(map(ord, w)) * 7919 % (2 ** 31)).randn(16)
                for w in words]
        out.append((np.stack(embs) if embs else np.zeros((0, 16)),
                    [sum(map(ord, w)) for w in words]))
    return out


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_equals_jax(idf):
    cands = ["the cat sat on the mat", "the dog", "quantum flux", "", "sat cat the"]
    refs = ["the cat sat on a mat", "the dog barked", "harmonics", "x", "the cat sat"]
    got = tbs.bert_score(cands, refs, _toy_embedder, idf=idf)
    want = jbs.bert_score(cands, refs, _toy_embedder, idf=idf)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    rng = np.random.RandomState(0)
    c, r, w = rng.randn(5, 8), rng.randn(7, 8), rng.rand(7)
    a, b = tbs.pair_bert_score(c, r, ref_w=w), jbs.pair_bert_score(c, r, ref_w=w)
    assert all(abs(a[k] - b[k]) <= 1e-9 for k in b)
    assert tbs.bert_score(["a b"], ["a b"], _toy_embedder)["f1"] == pytest.approx(1.0, abs=1e-9)


def test_llama_embedder_matches_jax():
    """The same texts through both embedders (left-padded 64-multiple
    buckets, the mid-stack layer by default, batches padded with empty
    rows): equal token ids, embeddings within the forward's tolerance, and
    BERTScore over them within 1e-5."""
    cfg = jllama.llama_preset("tiny")
    params = jllama.init_llama_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    texts = ["hello world", "a", "", "summary: the quick brown fox " * 3]
    for layer in (None, 0, 2):
        je = jbs.LlamaEmbedder(params, cfg, JaxByteTokenizer(), layer=layer, batch_size=2)
        te = tbs.LlamaEmbedder(tparams, tllama.llama_preset("tiny"), ByteTokenizer(),
                               layer=layer, batch_size=2)
        assert te.layer == je.layer
        want, got = je(texts), te(texts)
        assert len(got) == len(want) == 4
        for (ge, gi), (we, wi) in zip(got, want):
            assert gi == wi and ge.shape == we.shape and ge.dtype == np.float32
            np.testing.assert_allclose(ge, we, atol=1e-4, rtol=1e-3)
    s_t = tbs.bert_score(texts[:2], texts[2:], te, idf=True)
    s_j = jbs.bert_score(texts[:2], texts[2:], je, idf=True)
    assert all(abs(s_t[k] - s_j[k]) <= 1e-5 for k in s_j)
    e = te(["hello world", "hello world"])
    assert tbs.pair_bert_score(e[0][0], e[1][0])["f1"] == pytest.approx(1.0, abs=1e-5)


def test_evaluate_engine_keys_and_scores_match_jax():
    """Both harnesses over the same weights and the same synthetic set,
    with BERTScore and latency: the same keys; the ROUGE numbers equal
    where the two engines' outputs are equal (the tiny float32 engines
    agree token for token here)."""
    from llm_speech_summarization_tpu.configs import load_config as jax_load_config
    from llm_speech_summarization_tpu.data.datasets import SyntheticSpeechDataset as JaxDS
    from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine

    je = JaxEngine(jax_load_config(JAX_TINY))
    te = LLMSpeechTextInference(
        load_config(TINY), device="cpu",
        llm_params=bridge.params_from_numpy(jax.tree.map(np.asarray, je.llm_params)),
        audio_encoder_params=bridge.params_from_numpy(
            jax.tree.map(np.asarray, je.audio_encoder_params)))
    ds = JaxDS(JaxByteTokenizer(), num_samples=4, max_seconds=1.5)
    kw = dict(num_samples=3, batch_size=2, max_new_tokens=8, measure_latency=True)
    want = jax_evaluate(je, ds, bertscore_embedder=jbs.LlamaEmbedder(
        je.llm_params, je.llm_cfg, je.tokenizer, batch_size=4), **kw)
    got = evaluate_engine(te, ds, bertscore_embedder=tbs.LlamaEmbedder(
        te.llm_params, te.llm_cfg, te.tokenizer, batch_size=4), **kw)
    assert set(got) == set(want)
    assert got["num_samples"] == want["num_samples"] == 3.0
    for k in ("rouge1", "rouge2", "rougeL", "bertscore_f1"):
        assert 0.0 <= got[k] <= 1.0 + 1e-9
    audio = [ds[i]["audio"] for i in range(3)]
    if te.generate_audio_response_batch(audio[:2], max_new_tokens=8) == \
            je.generate_audio_response_batch(audio[:2], max_new_tokens=8):
        for k in ("rouge1", "rouge2", "rougeL"):
            assert got[k] == want[k], k
    assert all(got[k] >= 0 for k in ("ttft_p50_s", "latency_p50_s", "latency_p90_s"))


def test_evaluate_cli(tmp_path, capsys):
    """``cli/evaluate.py --device cpu --bertscore`` on the tiny config's
    synthetic validation split, with an encoder export through ``-p``."""
    from llm_speech_summarization_tpu_torch.cli import evaluate as cli
    from llm_speech_summarization_tpu_torch.train.checkpoint import export_encoder

    eng = LLMSpeechTextInference(load_config(TINY), device="cpu")
    enc = export_encoder(str(tmp_path / "enc.pt"), eng.audio_encoder_params)
    m = cli.main(["-c", TINY, "-p", enc, "--num_samples", "2", "--batch_size", "2",
                  "--max_new_tokens", "4", "--no_latency", "--bertscore", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == m
    assert {"rouge1", "rouge2", "rougeL", "num_samples", "bertscore_f1"} <= set(m)
    assert m["num_samples"] == 2.0 and all(np.isfinite(v) for v in m.values())
