"""Training/validation datasets (port of ``data/datasets.py``).

Two sources:
  * ``hf_disk`` — preprocessed HF datasets saved by the preprocessing jobs
    with the reference's column schema: ``audio, text, text_input_ids,
    llm_response, response_input_ids, hubert_word_offsets, pool_ranges_4``
    (reference: preprocess_data/utils.py:121, preprocess.py:104-140). Like
    the reference, multiple named splits are concatenated
    (reference: trainer.py:201-223).
  * ``synthetic`` — deterministic random fixtures (sine-mixture audio,
    byte-tokenized transcripts/responses) so training, tests, and benches
    run in this no-egress environment. No reference counterpart.

Each example is a plain dict; collation to static-shape arrays happens in
collate.py. The offline preprocessing job reads raw {audio, text} examples
lazily: ``load_librispeech_dir`` (a LibriSpeech tree of FLAC/WAV files and
``*.trans.txt`` transcripts) and ``LazyRawView`` (any indexable source).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from ..configs import Config
from ..utils.tokenizer import Tokenizer

_WORDS = (
    "the quick brown fox jumps over a lazy dog near riverbank while birds "
    "sing morning songs about distant mountains and quiet valleys full of light"
).split()


class SyntheticSpeechDataset:
    """Deterministic synthetic (audio, transcript, response) triples."""

    def __init__(
        self,
        tokenizer: Tokenizer,
        num_samples: int = 512,
        sampling_rate: int = 16000,
        min_seconds: float = 1.0,
        max_seconds: float = 8.0,
        seed: int = 1234,
    ):
        self.tokenizer = tokenizer
        self.num_samples = num_samples
        self.sr = sampling_rate
        self.min_s = min_seconds
        self.max_s = max_seconds
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        dur = rng.uniform(self.min_s, self.max_s)
        n = int(dur * self.sr)
        # sine mixture + noise: stable, bounded, non-degenerate audio
        t = np.arange(n) / self.sr
        freqs = rng.uniform(80, 4000, size=3)
        amps = rng.uniform(0.05, 0.2, size=3)
        wav = sum(a * np.sin(2 * np.pi * f * t) for a, f in zip(amps, freqs))
        wav = (wav + 0.01 * rng.randn(n)).astype(np.float32)

        n_words = rng.randint(4, 14)
        text = " ".join(rng.choice(_WORDS) for _ in range(n_words))
        response = "summary: " + " ".join(rng.choice(_WORDS) for _ in range(rng.randint(3, 8)))

        # BOS-strip convention at the data layer (reference strips in the
        # collator, trainer.py:155-156)
        text_ids = self.tokenizer.encode(text, add_bos=False)
        response_ids = self.tokenizer.encode(response, add_bos=False) + [self.tokenizer.eos_id]

        # synthetic "word offsets" → pool ranges compatible with ctc_pool
        num_frames = max((n - self.sr // 100) // (self.sr // 50), 8)
        pool_ranges = []
        start = 0
        while start + 4 <= num_frames:
            pool_ranges.append((start, start + 4))
            start += 4
        return {
            "audio": wav,
            "text": text,
            "text_input_ids": np.asarray(text_ids, np.int32),
            "llm_response": response,
            "response_input_ids": np.asarray(response_ids, np.int32),
            "pool_ranges_4": np.asarray(pool_ranges, np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        for i in range(self.num_samples):
            yield self[i]


class HFDiskDataset:
    """Concatenated preprocessed HF datasets (reference: trainer.py:201-223).

    Normalizes the reference's quirks at load time:
      * BOS-strip of text/response ids (reference: trainer.py:155-156);
      * the Llama-3 preprocessing's nested ``response_input_ids[0]``
        (reference: preprocess_llama3.py:62-72, trainer.py:156).
    """

    def __init__(self, base_path: str, names: List[str]):
        from datasets import concatenate_datasets, load_from_disk  # heavy

        parts = [load_from_disk(f"{base_path}/{name}") for name in names]
        self.ds = parts[0] if len(parts) == 1 else concatenate_datasets(parts)

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> dict:
        row = self.ds[int(idx)]
        audio = row["audio"]
        wav = np.asarray(
            audio["array"] if isinstance(audio, dict) else audio, np.float32
        )
        resp = row["response_input_ids"]
        if len(resp) > 0 and isinstance(resp[0], (list, np.ndarray)):
            resp = resp[0]  # llama3 nested-list quirk
        text_ids = np.asarray(row["text_input_ids"], np.int32)
        resp_ids = np.asarray(resp, np.int32)
        # BOS strip
        if len(text_ids) > 0:
            text_ids = text_ids[1:]
        if len(resp_ids) > 0:
            resp_ids = resp_ids[1:]
        out = {
            "audio": wav,
            "text": row.get("text", ""),
            "text_input_ids": text_ids,
            "llm_response": row.get("llm_response", ""),
            "response_input_ids": resp_ids,
        }
        if "pool_ranges_4" in row and row["pool_ranges_4"] is not None:
            out["pool_ranges_4"] = np.asarray(row["pool_ranges_4"], np.int32).reshape(-1, 2)
        return out

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def load_training_datasets(cfg: Config, tokenizer: Tokenizer):
    """Returns (train_ds, val_ds) per config.data (reference: trainer.py:201-248)."""
    if cfg.data.source == "synthetic":
        n = cfg.data.synthetic_num_samples
        train = SyntheticSpeechDataset(
            tokenizer, num_samples=n, sampling_rate=cfg.audio.sampling_rate,
            seed=cfg.seed_everything,
        )
        val = SyntheticSpeechDataset(
            tokenizer, num_samples=max(n // 8, 2), sampling_rate=cfg.audio.sampling_rate,
            seed=cfg.seed_everything + 1,
        )
        return train, val
    train = HFDiskDataset(cfg.data.base_path, list(cfg.data.train_set))
    val = HFDiskDataset(cfg.data.base_path, list(cfg.data.val_set))
    return train, val


def load_librispeech_dir(path: str, target_sr: int = 16000, limit=None):
    """A raw LibriSpeech-style tree: ``*.flac`` / ``*.wav`` utterances next
    to ``*.trans.txt`` files whose lines are ``<utt-id> <TRANSCRIPT>``.
    Returns a lazy list of {audio, text} examples in utterance-id order
    (audio without a transcript skipped, at most ``limit``), or None when
    the tree holds no audio file (the caller then reads an HF dataset)."""
    import os

    audio_paths = {}
    transcripts = {}
    for root, _, files in os.walk(path):
        for fname in sorted(files):
            stem, ext = os.path.splitext(fname)
            full = os.path.join(root, fname)
            if ext.lower() in (".flac", ".wav"):
                audio_paths[stem] = full
            elif fname.endswith(".trans.txt"):
                with open(full, encoding="utf-8") as f:
                    for line in f:
                        utt, _, text = line.strip().partition(" ")
                        if utt:
                            transcripts[utt] = text
    if not audio_paths:
        return None

    pairs = []
    for utt in sorted(audio_paths):
        if limit is not None and len(pairs) >= limit:
            break
        text = transcripts.get(utt)
        if text is None:
            continue  # an utterance needs its transcript
        pairs.append((audio_paths[utt], text))
    return _LazyAudioExamples(pairs, target_sr)


class _LazyAudioExamples:
    """List-like {audio, text} view that decodes each clip on access: a
    whole LibriSpeech split is hours of waveform, so nothing is decoded
    ahead of its use."""

    def __init__(self, pairs, target_sr: int):
        self._pairs = pairs
        self._target_sr = target_sr

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, i):
        from .audio_io import load_audio

        path, text = self._pairs[i]
        return {"audio": load_audio(path, self._target_sr), "text": text}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class LazyRawView:
    """List-like {audio, text} adapter over any indexable source, fetched on
    access: ``getter(i)`` returns the i-th {audio: float32 1-D, text: str}
    example. Keeps HF-disk and synthetic inputs of the preprocessing job
    lazy, so it holds one waveform at a time."""

    def __init__(self, n: int, getter):
        self._n = int(n)
        self._getter = getter

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._getter(int(i))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
