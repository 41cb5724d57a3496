"""Collation into static-shape, bucketed batches (port of
``data/collate.py``, host numpy only).

Every batch is padded to a configured bucket: audio samples to an audio
bucket, token streams to fixed caps, so a run sees a few shapes only (the
JAX package compiles one step per shape; here the shapes bound the memory
and the spliced length).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .batch import Batch


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ value, else the largest bucket (inputs are clipped)."""
    for b in sorted(buckets):
        if value <= b:
            return b
    return max(buckets)


def collate_batch(
    examples: List[dict],
    audio_buckets: Sequence[int],
    max_text_tokens: int,
    max_response_tokens: int,
    fixed_audio_len: Optional[int] = None,
    max_pool_ranges: Optional[int] = None,
) -> Batch:
    """List of example dicts → one static-shape Batch.

    Audio is right-padded to a bucket (reference right-pads to batch max,
    trainer.py:141-148); token ids are right-padded to fixed caps and
    truncated beyond them. ``fixed_audio_len`` pins the audio length (useful
    to force one compilation for the whole run).
    """
    B = len(examples)
    lens = [len(e["audio"]) for e in examples]
    N = fixed_audio_len or pick_bucket(max(lens), audio_buckets)
    wav = np.zeros((B, N), np.float32)
    wav_lens = np.zeros((B,), np.int32)
    for b, e in enumerate(examples):
        a = np.asarray(e["audio"], np.float32)[:N]
        wav[b, : len(a)] = a
        wav_lens[b] = len(a)

    def pad_ids(key: str, cap: int):
        ids = np.zeros((B, cap), np.int32)
        out_lens = np.zeros((B,), np.int32)
        for b, e in enumerate(examples):
            row = np.asarray(e[key], np.int32)[:cap]
            ids[b, : len(row)] = row
            out_lens[b] = len(row)
        return ids, out_lens

    text_ids, text_lens = pad_ids("text_input_ids", max_text_tokens)
    resp_ids, resp_lens = pad_ids("response_input_ids", max_response_tokens)

    ranges = None
    if max_pool_ranges is not None:
        have = ["pool_ranges_4" in e for e in examples]
        if any(have):
            if not all(have):
                # concatenated splits can mix rows preprocessed with and
                # without CTC ranges; failing loudly beats a KeyError
                # mid-epoch (or silently pooling garbage)
                raise ValueError(
                    "mixed batch: some examples carry pool_ranges_4 and "
                    "some do not — a ctc_pool run needs every split "
                    "preprocessed with CTC offsets"
                )
            ranges = np.zeros((B, max_pool_ranges, 2), np.int32)
            for b, e in enumerate(examples):
                r = np.asarray(e["pool_ranges_4"], np.int32).reshape(-1, 2)[:max_pool_ranges]
                ranges[b, : len(r)] = r

    return Batch(
        wav=wav,
        wav_lens=wav_lens,
        text_ids=text_ids,
        text_lens=text_lens,
        response_ids=resp_ids,
        response_lens=resp_lens,
        ctc_pool_ranges=ranges,
    )
