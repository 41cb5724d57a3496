"""Offline preprocessing pipeline (port of ``data/preprocess.py``).

One job per dataset split:
  1. generate the LLM's response to each transcript: length-sorted batches
     through the engine's ``generate_text_response_batch``, with a budget
     of ``max_new_factor ×`` the longest prompt of the batch;
  2. tokenize transcript + response → text_input_ids / response_input_ids;
  3. HuBERT-CTC word offsets by greedy argmax decode, with the 20 s clip
     filter;
  4. CTC pool ranges: word spans tiled into width-4 windows, inter-word
     gaps kept as single ranges.

Writes an HF dataset on disk with the reference's column schema (audio,
text, text_input_ids, llm_response, response_input_ids,
hubert_word_offsets, pool_ranges_4) through ``datasets``' ``ArrowWriter``;
``datasets`` is imported only there, and its absence raises ImportError.
The port's ``HFDiskDataset`` reads the split back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.tokenizer import Tokenizer

# ---------------------------------------------------------------------------
# Step 1: batched LLM response generation
# ---------------------------------------------------------------------------


def generate_llm_responses(
    engine,
    transcripts: Sequence[str],
    batch_size: int = 32,
    lowercase: bool = True,
    max_new_factor: int = 2,
) -> List[str]:
    """A response to each transcript from the frozen LLM (``engine`` is an
    ``LLMSpeechTextInference``): templated prompts, batches of
    ``batch_size`` in order of prompt length (a batch's prompts then share
    a bucket and short prompts do not pay the longest one's budget), each
    with ``max_new_factor ×`` its longest prompt as the token budget."""
    texts = [t.lower() if lowercase else t for t in transcripts]
    lens = [len(engine.tokenizer.encode(engine.template.full_text_prompt(t))) for t in texts]
    order = sorted(range(len(texts)), key=lambda i: lens[i])
    out: List[str] = [""] * len(texts)
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        max_prompt = max(lens[j] for j in idx)
        resp = engine.generate_text_response_batch(
            [texts[j] for j in idx], max_new_tokens=max_new_factor * max_prompt)
        for j, r in zip(idx, resp):
            out[j] = r
    return out


# ---------------------------------------------------------------------------
# Step 2: tokenization
# ---------------------------------------------------------------------------


def tokenize_example(text: str, llm_response: str, tokenizer: Tokenizer) -> Dict[str, np.ndarray]:
    """The transcript lowercased; both id rows keep their leading BOS (the
    data loader strips it)."""
    return {
        "text_input_ids": np.asarray(tokenizer.encode(text.lower(), add_bos=True), np.int32),
        "response_input_ids": np.asarray(tokenizer.encode(llm_response, add_bos=True), np.int32),
    }


# ---------------------------------------------------------------------------
# Step 3: CTC word offsets
# ---------------------------------------------------------------------------


def ctc_collapse_with_offsets(pred_ids: np.ndarray, blank_id: int) -> List[Tuple[int, int, int]]:
    """Greedy CTC collapse keeping frame offsets: (T,) framewise argmax ids
    → [(token_id, start, end)], [start, end) the run of frames that produced
    the token (HF's ``output_word_offsets`` semantics, in encoder frames)."""
    out: List[Tuple[int, int, int]] = []
    prev = None
    start = 0
    for t, tok in enumerate(list(pred_ids) + [None]):
        if tok != prev:
            if prev is not None and prev != blank_id:
                out.append((int(prev), start, t))
            start = t
            prev = tok
    return out


def word_offsets_from_ctc(pred_ids: np.ndarray, blank_id: int,
                          word_delim_id: int) -> List[Dict[str, int]]:
    """Collapsed CTC tokens grouped into word {start_offset, end_offset}
    spans, split at the word delimiter (``hubert_word_offsets``)."""
    words: List[Dict[str, int]] = []
    cur_start: Optional[int] = None
    cur_end: Optional[int] = None
    for tok, s, e in ctc_collapse_with_offsets(pred_ids, blank_id):
        if tok == word_delim_id:
            if cur_start is not None:
                words.append({"start_offset": cur_start, "end_offset": cur_end})
                cur_start = None
        else:
            if cur_start is None:
                cur_start = s
            cur_end = e
    if cur_start is not None:
        words.append({"start_offset": cur_start, "end_offset": cur_end})
    return words


# ---------------------------------------------------------------------------
# Step 4: pool ranges
# ---------------------------------------------------------------------------


def get_ctc_pool_ranges(word_offsets: List[Dict[str, int]],
                        pool_range: int = 4) -> List[Tuple[int, int]]:
    """Word spans → width-``pool_range`` windows; gaps → single ranges: a
    leading gap from frame 0, windows tiling each word (the last may
    overrun the word's end), single ranges for the gaps between words, and
    a trailing gap of 2 × ``pool_range`` frames. Empty gaps (adjacent
    words) are dropped: their mean would be NaN."""
    if not word_offsets:
        return []
    spans = [(w["start_offset"], w["end_offset"]) for w in word_offsets]
    segments: List[Tuple[int, int, int]] = [(0, 0, spans[0][0])]
    for i in range(len(spans) - 1):
        segments.append((1, spans[i][0], spans[i][1]))
        segments.append((0, spans[i][1], spans[i + 1][0]))
    segments.append((1, spans[-1][0], spans[-1][1]))
    segments.append((0, spans[-1][1], spans[-1][1] + pool_range * 2))

    ranges: List[Tuple[int, int]] = []
    for is_word, start, end in segments:
        if is_word:
            s = start
            while s < end:
                ranges.append((s, s + pool_range))
                s += pool_range
        elif end > start:
            ranges.append((start, end))
    return ranges


def make_ctc_fn(enc_params, head_params, enc_cfg, blank_id: int = 0, word_delim_id: int = 4):
    """The ``ctc_fn(audio) -> (pred_ids, blank_id, word_delim_id)`` of
    :func:`iter_preprocess_examples` from a HuBERT-CTC tree
    (``models/convert.py::convert_hubert_ctc``), run on the device of its
    parameters and in float32 whatever dtype they come in (the JAX package
    restores the model into a float32 template): on the card through B1's
    float32 instance, without TF32. Each clip is zero-padded to a whole
    number of seconds (at least one, as the JAX package buckets it) with a
    sample mask; the argmax runs over its valid frames. The default ids
    are the wav2vec2/HuBERT CTC vocabulary's: ``<pad>`` = 0 is the blank,
    ``|`` = 4 the word delimiter."""
    from ..models.hubert import hubert_ctc_logits
    from ..train.state import tree_map

    def f32(t):
        return t.float() if t.is_floating_point() else t

    enc_params, head_params = tree_map(f32, enc_params), tree_map(f32, head_params)
    ref = enc_params["fp_w"]
    bucket = 16000  # 1 s at 16 kHz

    def ctc_fn(audio):
        wav = np.asarray(audio, np.float32)
        n = len(wav)
        N = max(bucket, -(-n // bucket) * bucket)
        padded = np.zeros((1, N), np.float32)
        padded[0, :n] = wav
        mask = torch.zeros((1, N), dtype=torch.bool)
        mask[0, :n] = True
        with torch.no_grad():
            logits, frame_mask = hubert_ctc_logits(
                enc_params, head_params, enc_cfg,
                torch.from_numpy(padded).to(ref.device, ref.dtype), mask.to(ref.device))
            n_frames = int(frame_mask[0].sum())
            pred_ids = logits[0, :n_frames].argmax(-1).cpu().numpy()
        return pred_ids, blank_id, word_delim_id

    return ctc_fn


def load_ctc_fn(checkpoint_path: str, preset: str = "hubert_large", vocab_size: int = 32,
                device=None):
    """A ``cli/convert.py ctc`` file → a ready ``ctc_fn`` on ``device``
    (None: the CUDA card, raising without one), in float32 whatever dtype
    the file stores (``cli/convert.py`` writes bf16 by default), as the JAX
    package restores it. The head must have ``vocab_size`` classes."""
    from ..device import resolve_device
    from ..models.hubert import hubert_preset
    from ..train.checkpoint import load_params

    payload = load_params(checkpoint_path, resolve_device(device))
    head = payload["head_params"]
    if tuple(head["ctc_w"].shape) != (hubert_preset(preset).hidden_size, vocab_size):
        raise ValueError(f"{checkpoint_path}: CTC head {tuple(head['ctc_w'].shape)}, want "
                         f"({hubert_preset(preset).hidden_size}, {vocab_size}) for preset "
                         f"{preset!r} and vocab {vocab_size}")
    return make_ctc_fn(payload["enc_params"], head, hubert_preset(preset))


def pool_ranges_for_audio(ctc_fn, audio) -> np.ndarray:
    """audio → (G, 2) int32 pool ranges from its CTC word offsets (steps 3-4
    for one clip, the inference-time path); ``[(0, 1)]`` when the clip has
    no word."""
    pred_ids, blank_id, delim_id = ctc_fn(audio)
    ranges = get_ctc_pool_ranges(word_offsets_from_ctc(pred_ids, blank_id, delim_id), 4)
    return np.asarray(ranges if ranges else [(0, 1)], np.int32)


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def iter_preprocess_examples(
    examples,
    engine,
    tokenizer: Tokenizer,
    ctc_fn=None,
    max_seconds: float = 20.0,
    sampling_rate: int = 16000,
    response_batch_size: int = 32,
):
    """The 4-step pipeline over raw {audio, text} examples, yielding one
    output row at a time. ``ctc_fn`` supplies the CTC framewise predictions
    (None: steps 3-4 emit empty columns, the reference's Llama-3 variant).

    Memory: with a lazy ``examples`` source (``LazyRawView``,
    ``load_librispeech_dir``) at most one decoded waveform is live at a
    time. The first pass filters by index and keeps only the texts, step 1
    batches over texts, and the yield loop fetches each kept example again;
    :func:`save_preprocessed` streams the rows to arrow shards."""
    keep_idx: List[int] = []
    texts: List[str] = []
    for i in range(len(examples)):
        e = examples[i]
        if len(e["audio"]) / sampling_rate <= max_seconds:
            keep_idx.append(i)
            texts.append(e["text"])
    responses = generate_llm_responses(engine, texts, batch_size=response_batch_size)
    for i, resp in zip(keep_idx, responses):
        e = examples[i]
        row = dict(e)
        row["llm_response"] = resp
        row.update(tokenize_example(e["text"], resp, tokenizer))
        if ctc_fn is not None:
            pred_ids, blank_id, delim_id = ctc_fn(e["audio"])
            offsets = word_offsets_from_ctc(pred_ids, blank_id, delim_id)
            row["hubert_word_offsets"] = offsets
            row["pool_ranges_4"] = np.asarray(get_ctc_pool_ranges(offsets, 4),
                                              np.int32).reshape(-1, 2)
        else:
            row["hubert_word_offsets"] = []
            row["pool_ranges_4"] = np.zeros((0, 2), np.int32)
        yield row


def preprocess_examples(
    examples: List[dict],
    engine,
    tokenizer: Tokenizer,
    ctc_fn=None,
    max_seconds: float = 20.0,
    sampling_rate: int = 16000,
    response_batch_size: int = 32,
) -> List[dict]:
    """:func:`iter_preprocess_examples` materialized, for small splits and
    tests."""
    return list(iter_preprocess_examples(
        examples, engine, tokenizer, ctc_fn=ctc_fn, max_seconds=max_seconds,
        sampling_rate=sampling_rate, response_batch_size=response_batch_size))


def _import_datasets():
    try:
        import datasets
    except ImportError as e:
        raise ImportError("save_preprocessed writes an HF dataset and needs the `datasets` "
                          "package, which is not installed") from e
    return datasets


def _output_features(sampling_rate: int):
    """The on-disk schema. ``audio`` is HF's ``Audio`` feature where this
    environment can encode one, else the struct {"array": [float32],
    "sampling_rate": int32}, the decoded view HF's Audio feature hands
    consumers (``HFDiskDataset`` reads either)."""
    hfds = _import_datasets()
    from datasets import Features, Sequence, Value

    try:
        audio_feat = hfds.Audio(sampling_rate=sampling_rate)
        audio_feat.encode_example({"array": np.zeros(4, np.float32),
                                   "sampling_rate": sampling_rate})
    except Exception:  # no audio codec here: the decoded struct
        audio_feat = {"array": Sequence(Value("float32")), "sampling_rate": Value("int32")}
    return Features({
        "audio": audio_feat,
        "text": Value("string"),
        "text_input_ids": Sequence(Value("int32")),
        "llm_response": Value("string"),
        "response_input_ids": Sequence(Value("int32")),
        "hubert_word_offsets": [{"start_offset": Value("int32"), "end_offset": Value("int32")}],
        "pool_ranges_4": Sequence(Sequence(Value("int32"), length=2)),
    })


def save_preprocessed(rows, path: str, sampling_rate: int = 16000,
                      writer_batch_size: int = 100) -> int:
    """Stream rows (a list or a generator) to an HF dataset on disk; returns
    the number of rows written.

    Rows go through an incremental ``ArrowWriter`` in ``writer_batch_size``
    chunks, so host memory holds one chunk of waveforms, never the split.
    The arrow shard is written in place as ``data-00000-of-00001.arrow``
    and the ``save_to_disk`` metadata (state.json, dataset_info.json) is
    written beside it, the layout ``load_from_disk`` reads."""
    import json
    import os

    hfds = _import_datasets()
    from datasets.arrow_writer import ArrowWriter
    from datasets.utils.py_utils import asdict

    feats = _output_features(sampling_rate)
    os.makedirs(path, exist_ok=True)
    shard_name = "data-00000-of-00001.arrow"
    arrow_path = os.path.join(path, shard_name)
    with ArrowWriter(features=feats, path=arrow_path,
                     writer_batch_size=writer_batch_size) as writer:
        for r in rows:
            writer.write({
                "audio": {"array": np.asarray(r["audio"], np.float32),
                          "sampling_rate": sampling_rate},
                "text": r["text"],
                "text_input_ids": np.asarray(r["text_input_ids"], np.int32).tolist(),
                "llm_response": r["llm_response"],
                "response_input_ids": np.asarray(r["response_input_ids"], np.int32).tolist(),
                "hubert_word_offsets": r["hubert_word_offsets"],
                "pool_ranges_4": np.asarray(r["pool_ranges_4"], np.int32).reshape(-1, 2).tolist(),
            })
        n, _ = writer.finalize()

    # a memory-mapped open, for the fingerprint and the schema only
    ds = hfds.Dataset.from_file(arrow_path)
    state = {
        "_fingerprint": ds._fingerprint,
        "_format_columns": None,
        "_format_kwargs": {},
        "_format_type": None,
        "_output_all_columns": False,
        "_split": None,
        "_data_files": [{"filename": shard_name}],
    }
    info = asdict(ds._info)
    del ds
    with open(os.path.join(path, "state.json"), "w", encoding="utf-8") as f:
        json.dump(state, f, indent=2, sort_keys=True)
    with open(os.path.join(path, "dataset_info.json"), "w", encoding="utf-8") as f:
        json.dump({k: info[k] for k in sorted(info)}, f, indent=2)
    return n
