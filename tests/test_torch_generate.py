"""The port's generation loop and engine against the JAX package and the
committed goldens, plus an import scan that keeps jax out of the port."""

import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.infer.generate import (
    _apply_repetition_penalty,
    greedy_generate,
)
from llm_speech_summarization_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_DIR = ROOT / "tests" / "goldens"
JAX_TINY_YAML = ROOT / "llm_speech_summarization_tpu" / "configs" / "yaml" / "tiny_test.yaml"
TINY_YAML = YAML_DIR / "tiny_test.yaml"  # the port's own copy
# float32 logit delta between the two packages' decode steps (summation
# order only); a token may differ only where the top-2 margin is below twice it
LOGIT_DELTA = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_generate_tokens_golden():
    with open(GOLDEN_DIR / "generate_tokens_tiny.json") as f:
        g = json.load(f)
    cfg = jllama.llama_preset(g["llm_preset"])
    p = jllama.init_llama_params(jax.random.PRNGKey(g["param_seed"]), cfg, dtype=jnp.float32)
    tp = bridge.llama_params_from_numpy(np_tree(p))
    ids = torch.tensor(g["prompt_ids"], dtype=torch.long)
    embeds = tp["embed_tokens"][ids]
    toks, lens = greedy_generate(
        tp, tllama.llama_preset(g["llm_preset"]), embeds, torch.ones(ids.shape, dtype=torch.bool),
        max_new_tokens=g["max_new_tokens"], eos_id=g["eos_id"], cache_dtype=torch.float32,
    )
    assert toks.tolist() == g["tokens"]
    assert lens.tolist() == g["lengths"]


def test_greedy_generate_with_penalty_and_pads_matches_jax():
    """The decode loop with a repetition penalty, left pads and an early
    step cap: the same token stream and lengths as the JAX loop."""
    from llm_speech_summarization_tpu.infer.generate import greedy_generate as jax_generate

    cfg = jllama.llama_preset("tiny")
    p = jllama.init_llama_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, size=(3, 10)).astype(np.int32)
    mask = np.arange(10)[None, :] >= np.array([[0], [4], [9]])
    embeds = np.asarray(p["embed_tokens"])[ids] * mask[..., None]
    kw = dict(max_new_tokens=12, eos_id=5, repetition_penalty=1.3)
    want_t, want_n = jax_generate(p, cfg, jnp.asarray(embeds), jnp.asarray(mask),
                                  cache_dtype=jnp.float32, num_steps=jnp.int32(9), **kw)
    got_t, got_n = greedy_generate(
        bridge.llama_params_from_numpy(np_tree(p)), tllama.llama_preset("tiny"),
        torch.from_numpy(embeds), torch.from_numpy(mask), cache_dtype=torch.float32,
        num_steps=9, **kw)
    assert got_t.tolist() == np.asarray(want_t).tolist()
    assert got_n.tolist() == np.asarray(want_n).tolist()


def test_repetition_penalty_matches_jax():
    from llm_speech_summarization_tpu.infer.generate import (
        _apply_repetition_penalty as jax_penalty,
    )

    rng = np.random.RandomState(0)
    logits = rng.randn(3, 11).astype(np.float32)
    seen = rng.rand(3, 11) > 0.5
    want = jax_penalty(jnp.asarray(logits), jnp.asarray(seen), 1.3)
    got = _apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen), 1.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _configs(load, path):
    base = load(str(path))
    q8 = load(str(path))
    q8.model.kv_cache_dtype = "int8"
    q8.model.llm_weight_dtype = "int8"
    return {"tiny_test": base, "tiny_int8": q8}


def _engines(name):
    """The JAX engine from the JAX package's config, the port's engine from
    the port's copy of the same YAML, with the JAX engine's weights."""
    je = JaxEngine(_configs(jax_load_config, JAX_TINY_YAML)[name])
    te = LLMSpeechTextInference(
        _configs(load_config, TINY_YAML)[name], device="cpu",
        llm_params=bridge.llama_params_from_numpy(np_tree(je.llm_params)),
        audio_encoder_params=bridge.encoder_params_from_numpy(np_tree(je.audio_encoder_params)),
    )
    return je, te


def _clips():
    rng = np.random.RandomState(3)
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in (8000, 5600, 12345)]


def _margin_checked_stream(je, te, embeds, mask, steps):
    """Teacher-force the JAX stream into both packages; the port's argmax
    must equal JAX's wherever JAX's top-2 margin exceeds 2 * LOGIT_DELTA."""
    jp, cfg = je.llm_params, je.llm_cfg
    tp, tcfg = te.llm_params, te.llm_cfg
    B, L, _ = embeds.shape
    S = L + steps
    jc = jllama.init_kv_cache(cfg, B, S, dtype=je.cache_dtype)
    tc = tllama.init_kv_cache(tcfg, B, S, dtype=te.cache_dtype)
    jo = jllama.llama_forward(jp, cfg, inputs_embeds=jnp.asarray(embeds),
                              attn_mask=jnp.asarray(mask), kv_cache=jc,
                              cache_offset=jnp.int32(0), last_logit_only=True)
    to = tllama.llama_forward(tp, tcfg, inputs_embeds=torch.from_numpy(embeds),
                              attn_mask=torch.from_numpy(mask), kv_cache=tc, cache_offset=0,
                              last_logit_only=True)
    lx, lt = np.asarray(jo.logits[:, -1]), to.logits[:, -1].numpy()
    jc = jo.kv_cache
    lens = mask.sum(1).astype(np.int32)
    pads = (L - lens).astype(np.int32)
    checked = 0
    for step in range(steps):
        top2 = np.sort(lx, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_DELTA
        assert (lx.argmax(-1)[decided] == lt.argmax(-1)[decided]).all(), f"step {step}"
        np.testing.assert_allclose(lt, lx, atol=LOGIT_DELTA, rtol=0)
        checked += int(decided.sum())
        tok = lx.argmax(-1).astype(np.int32)
        pos = (lens + step)[:, None]
        jo = jllama.llama_forward(jp, cfg, input_ids=jnp.asarray(tok[:, None]),
                                  attn_mask=None, positions=jnp.asarray(pos), kv_cache=jc,
                                  cache_offset=L + step, kv_pad_lens=jnp.asarray(pads))
        to = tllama.llama_forward(tp, tcfg, input_ids=torch.from_numpy(tok[:, None]),
                                  positions=torch.from_numpy(pos), kv_cache=tc,
                                  cache_offset=L + step, kv_pad_lens=torch.from_numpy(pads))
        lx, lt = np.asarray(jo.logits[:, 0]), to.logits[:, 0].numpy()
        jc = jo.kv_cache
    assert checked >= B * steps // 2


@pytest.mark.parametrize("name", ["tiny_test", "tiny_int8"])
def test_engine_audio_prompt_matches_jax(name):
    je, te = _engines(name)
    clips = _clips()
    je_embeds, je_mask = je.build_audio_prompt_batch(clips)
    te_embeds, te_mask = te.build_audio_prompt_batch(clips)
    np.testing.assert_array_equal(te_mask.numpy(), np.asarray(je_mask))
    np.testing.assert_allclose(te_embeds.numpy(), np.asarray(je_embeds), atol=1e-5, rtol=0)
    assert te_embeds.shape[0] == 4  # three clips → a power-of-two batch
    _margin_checked_stream(je, te, np.asarray(je_embeds), np.asarray(je_mask), steps=8)
    out = te.generate_audio_response_batch(clips, max_new_tokens=6)
    assert len(out) == 3 and all(isinstance(s, str) for s in out)
    assert te.counts["encoder_forwards"] == 2 and te.counts["prefills"] == 1


@pytest.mark.parametrize("name", ["tiny_test", "tiny_int8"])
def test_engine_text_prompt_matches_jax(name):
    je, te = _engines(name)
    texts = ["summarize this", "a much longer request to summarize, with punctuation!"]
    je_embeds, je_mask = je.build_text_prompt_batch(texts)
    te_embeds, te_mask = te.build_text_prompt_batch(texts)
    np.testing.assert_array_equal(te_mask.numpy(), np.asarray(je_mask))
    np.testing.assert_allclose(te_embeds.numpy(), np.asarray(je_embeds), atol=1e-5, rtol=0)
    assert len(te.generate_text_response_batch(texts, max_new_tokens=4)) == 2


def test_engine_interleaved_text_and_audio_matches_jax():
    je, te = _engines("tiny_test")
    clips = _clips()[:2]
    je_embeds, je_mask = je.build_audio_prompt_batch(clips, "transcript first:")
    te_embeds, te_mask = te.build_audio_prompt_batch(clips, "transcript first:")
    np.testing.assert_array_equal(te_mask.numpy(), np.asarray(je_mask))
    np.testing.assert_allclose(te_embeds.numpy(), np.asarray(je_embeds), atol=1e-5, rtol=0)


def test_engine_batches_run_each_batch():
    _, te = _engines("tiny_int8")
    clips = _clips()
    outs = te.generate_audio_response_batches([clips[:2], clips[2:]], max_new_tokens=3)
    assert [len(o) for o in outs] == [2, 1]
    assert te.counts["encoder_forwards"] == 2 and te.counts["prefills"] == 2


def test_engine_prompt_ids_golden():
    with open(GOLDEN_DIR / "prompt_ids_byte_tokenizer.json") as f:
        g = json.load(f)
    te = LLMSpeechTextInference(load_config(str(TINY_YAML)), device="cpu")
    ids = g["prompts"]["meta-llama/Llama-3.2-3B-Instruct"]
    assert te.prefix_ids.tolist() == ids["prefix_ids_with_bos"]
    assert te.suffix_ids.tolist() == ids["suffix_ids"]


@pytest.mark.parametrize("kwargs", [dict(mesh=object()), dict(llm_checkpoint="/ckpt/llm"),
                                    dict(encoder_checkpoint="/ckpt/encoder")])
def test_engine_unported_options_raise(kwargs):
    """Meshes and checkpoints are still refused (sampling and speculative
    decoding are ported)."""
    cfg = load_config(str(TINY_YAML))
    kwargs = dict(kwargs)
    for key in ("llm_checkpoint", "encoder_checkpoint"):
        if key in kwargs:
            setattr(cfg.model, key, kwargs.pop(key))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMSpeechTextInference(cfg, device="cpu", **kwargs)


def test_engine_per_request_sampling_raises():
    """Per-request sampling runs: a seeded request replays, all-greedy
    entries are the greedy path, and a malformed entry raises."""
    te = LLMSpeechTextInference(load_config(str(TINY_YAML)), device="cpu")
    spec = [(0.7, 0, 1.0, 3), None]
    a = te.generate_text_response_batch(["hi", "there"], max_new_tokens=6, sampling=spec)
    b = te.generate_text_response_batch(["hi", "there"], max_new_tokens=6, sampling=spec)
    greedy = te.generate_text_response_batch(["hi", "there"], max_new_tokens=6)
    assert a == b and a[1] == greedy[1]
    assert te.generate_text_response_batch(["hi"], max_new_tokens=6, sampling=[None]) \
        == greedy[:1]
    with pytest.raises(ValueError):
        te.generate_text_response_batch(["hi"], max_new_tokens=2, sampling=[(0.7, 3)])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("target", ["package", "chip_smoke", "profile_script"])
def test_port_imports_no_jax(target):
    """No module of the port, chip_smoke.py or the profile script imports
    jax or any part of the JAX package: the port keeps its own copies."""
    files = {
        "package": sorted((ROOT / "llm_speech_summarization_tpu_torch").rglob("*.py")),
        "chip_smoke": [ROOT / "chip_smoke.py"],
        "profile_script": [ROOT / "scripts" / "torch_profile_main_path.py"],
    }[target]
    assert files
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax"), f"{f}: {mod}"
            assert root != "llm_speech_summarization_tpu", f"{f} imports {mod}"


def test_speculative_helpers_match_jax():
    """The n-gram drafter and the accept/commit core, on random histories
    with repeats, EOS inside the verified window and budget caps."""
    from llm_speech_summarization_tpu.infer.generate import (
        _ngram_propose as jax_propose,
        commit_verified_drafts as jax_commit,
    )
    from llm_speech_summarization_tpu_torch.infer.generate import (
        _ngram_propose,
        commit_verified_drafts,
    )

    rng = np.random.RandomState(5)
    B, S, k, eos = 6, 24, 3, 2
    tokens = rng.randint(0, 5, size=(B, S)).astype(np.int32)  # a small alphabet repeats
    t = np.array([0, 2, 3, 9, 17, 24], np.int32)
    last = tokens[np.arange(B), np.maximum(t - 1, 0)]
    draft = _ngram_propose(torch.from_numpy(tokens), torch.from_numpy(t), torch.from_numpy(last), k)
    want = jax_propose(jnp.asarray(tokens), jnp.asarray(t), jnp.asarray(last), k)
    np.testing.assert_array_equal(draft.numpy(), np.asarray(want))

    preds = rng.randint(0, 5, size=(B, k + 1)).astype(np.int32)
    preds[:, :2] = draft.numpy()[:, :2]  # some agreement to accept
    budgets = np.array([24, 5, 24, 10, 18, 24], np.int32)
    done = np.array([False, False, True, False, False, False])
    got = commit_verified_drafts(torch.from_numpy(preds), draft, torch.from_numpy(tokens.copy()),
                                 torch.from_numpy(t), torch.from_numpy(budgets),
                                 torch.from_numpy(done), torch.from_numpy(last), eos)
    want = jax_commit(jnp.asarray(preds), jnp.asarray(draft.numpy()), jnp.asarray(tokens),
                      jnp.asarray(t), jnp.asarray(budgets), jnp.asarray(done), jnp.asarray(last),
                      eos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
