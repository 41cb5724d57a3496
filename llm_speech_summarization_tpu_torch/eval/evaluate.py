"""End-to-end quality and latency evaluation harness (port of
``eval/evaluate.py``, the same signature and keys).

Batched audio-prompt generation over an evaluation set, ROUGE-1/2/L of the
audio-prompted summaries against the text-prompted (teacher) outputs or the
set's own ``llm_response``, optional BERTScore, and p50/p90 latency of
single-utterance requests (host clock; on the card every generate call ends
in a copy of its tokens to the host, so each timed call has finished).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .bertscore import bert_score
from .rouge import rouge_scores


def evaluate_engine(
    engine,
    dataset,
    num_samples: int = 64,
    batch_size: int = 16,
    max_new_tokens: int = 128,
    measure_latency: bool = True,
    bertscore_embedder=None,
) -> Dict[str, float]:
    """Generate audio- and text-prompted responses over `dataset` and score.

    dataset items follow the preprocessed schema: {audio, text,
    llm_response?}. When a reference `llm_response` exists it is the ROUGE
    reference; otherwise the engine's own text-prompted output serves as
    the teacher reference (audio↔text consistency, the quantity KD trains).
    """
    n = min(num_samples, len(dataset))
    examples = [dataset[i] for i in range(n)]

    audio_preds: List[str] = []
    text_refs: List[str] = []
    for i in range(0, n, batch_size):
        chunk = examples[i : i + batch_size]
        audio_preds.extend(
            engine.generate_audio_response_batch(
                [e["audio"] for e in chunk], max_new_tokens=max_new_tokens
            )
        )
        refs = []
        need_teacher = [e for e in chunk if not e.get("llm_response")]
        teacher_out = (
            engine.generate_text_response_batch(
                [e["text"] for e in need_teacher], max_new_tokens=max_new_tokens
            )
            if need_teacher
            else []
        )
        ti = iter(teacher_out)
        for e in chunk:
            refs.append(e.get("llm_response") or next(ti))
        text_refs.extend(refs)

    metrics: Dict[str, float] = dict(rouge_scores(audio_preds, text_refs))
    metrics["num_samples"] = float(n)

    if bertscore_embedder is not None:
        # e.g. eval.LlamaEmbedder(engine.llm_params, engine.llm_cfg, engine.tokenizer)
        bs = bert_score(audio_preds, text_refs, bertscore_embedder, idf=True)
        metrics["bertscore_precision"] = bs["precision"]
        metrics["bertscore_recall"] = bs["recall"]
        metrics["bertscore_f1"] = bs["f1"]

    if measure_latency and n:
        # single-utterance latency distribution (prompt build + prefill +
        # full decode; TTFT ≈ prompt + prefill, measured by a 1-token decode)
        lat_e2e, lat_ttft = [], []
        probe = examples[: min(8, n)]
        # warm every (B=1, audio bucket, budget) shape first: the first call
        # builds the kernels and allocates
        for e in probe:
            engine.generate_audio_response(e["audio"], max_new_tokens=1)
            engine.generate_audio_response(e["audio"], max_new_tokens=max_new_tokens)
        for e in probe:
            t0 = time.perf_counter()
            engine.generate_audio_response(e["audio"], max_new_tokens=1)
            lat_ttft.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            engine.generate_audio_response(e["audio"], max_new_tokens=max_new_tokens)
            lat_e2e.append(time.perf_counter() - t0)
        metrics["ttft_p50_s"] = float(np.percentile(lat_ttft, 50))
        metrics["latency_p50_s"] = float(np.percentile(lat_e2e, 50))
        metrics["latency_p90_s"] = float(np.percentile(lat_e2e, 90))
    return metrics
