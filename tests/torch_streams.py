"""Token streams of the JAX package and the port, compared under the
margin-aware contract (ROADMAP §C "Argmax tie flips"): two greedy streams
over the same weights may part only at a step where the JAX model's top-2
logit margin is at most 2 * LOGIT_DELTA; before that step they are equal.

``recorded_rows(cls)`` records every token row a tokenizer class turns
into text; ``assert_streams_agree`` checks the contract, computing the JAX
margin at a parting step by a cache-free forward over the row's prompt
embeds and the JAX stream's prefix."""

import contextlib

import numpy as np

LOGIT_DELTA = 1e-4  # as tests/test_torch_generate.py


@contextlib.contextmanager
def recorded_rows(tokenizer_cls):
    rows = []
    decode = tokenizer_cls.decode

    def record(self, ids, *args, **kw):
        rows.append([int(i) for i in ids])
        return decode(self, ids, *args, **kw)

    tokenizer_cls.decode = record
    try:
        yield rows
    finally:
        tokenizer_cls.decode = decode


def jax_margin(je, embeds, mask, prefix):
    """JAX's top-2 margin of the next token after ``prefix`` for one row:
    ``embeds`` (1, L, D) and ``mask`` (1, L) are its prompt from the JAX
    engine's ``build_*_prompt_batch`` (a float LLM, or int8 weights, whose
    table rows are dequantized as the JAX engine does)."""
    import jax.numpy as jnp

    from llm_speech_summarization_tpu.models import llama as jllama

    table = np.asarray(je.llm_params["embed_tokens"], np.float32)
    if "embed_tokens_scale" in je.llm_params:
        table = table * np.asarray(je.llm_params["embed_tokens_scale"], np.float32)[:, None]
    x = np.concatenate([np.asarray(embeds, np.float32),
                        table[np.asarray(prefix, np.int64)][None]], axis=1)
    m = np.concatenate([np.asarray(mask, bool), np.ones((1, len(prefix)), bool)], axis=1)
    logits = np.asarray(jllama.llama_forward(je.llm_params, je.llm_cfg,
                                             inputs_embeds=jnp.asarray(x),
                                             attn_mask=jnp.asarray(m)).logits[0, -1])
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def assert_streams_agree(jax_rows, port_rows, prompt_of):
    """``prompt_of(i)`` → (the JAX engine, embeds, mask) of row i's prompt
    (``build_*_prompt_batch``); returns the number of rows that parted."""
    assert len(jax_rows) == len(port_rows)
    parted = 0
    for i, (a, b) in enumerate(zip(jax_rows, port_rows)):
        if a == b:
            continue
        step = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        je, embeds, mask = prompt_of(i)
        margin = jax_margin(je, embeds, mask, a[:step])
        assert margin <= 2 * LOGIT_DELTA, (i, step, margin)
        parted += 1
    return parted
