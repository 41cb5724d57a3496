"""Metrics/observability writer (port of ``obs/writer.py``; host code).

Scalar/text/audio namespace parity with the reference's TensorBoard writer
(reference: writer.py:4-32):
  train/{ntp,ld,fd}_loss, learning_rate, validation/ntp_loss,
  validation/{audio,text}_perplexity, validation audio clips and
  prompt/response texts.

Additions over the reference: a JSONL metrics stream (greppable,
machine-readable for the bench harness) and per-step timing scalars. The
TensorBoard backend (tensorboardX) is used only if it imports — absent,
JSONL still records everything.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str, jsonl: bool = True, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None
        self._jsonl = None
        if jsonl:
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    # -- scalar plumbing ----------------------------------------------------

    def _scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"t": time.time(), "step": step, tag: float(value)}) + "\n"
            )

    # -- reference API parity (reference: writer.py:10-32) -------------------

    def log_training(self, losses: Dict[str, float], step: int):
        for key, value in losses.items():
            self._scalar(f"train/{key}", float(value), step)

    def log_validation(self, loss: float, step: int):
        self._scalar("validation/ntp_loss", float(loss), step)

    def log_lr(self, lr: float, step: int):
        self._scalar("learning_rate", float(lr), step)

    def log_validation_perplexity(self, audio_ppl: float, text_ppl: float, step: int):
        self._scalar("validation/audio_perplexity", float(audio_ppl), step)
        self._scalar("validation/text_perplexity", float(text_ppl), step)

    def log_audio_text_responses(
        self,
        step: int,
        prompt_audios=None,
        prompt_texts=None,
        audio_responses=None,
        text_responses=None,
        sampling_rate: int = 16000,
    ):
        # prompt_audios participates in the bound: an audio-only call (or
        # more clips than texts) must not silently drop clips
        fields = (prompt_audios, prompt_texts, audio_responses, text_responses)
        n = max((len(x) for x in fields if x), default=0)
        for i in range(n):
            if self._tb is not None:
                if prompt_audios is not None and i < len(prompt_audios):
                    try:
                        self._tb.add_audio(
                            f"validation/audio_{i}",
                            np.asarray(prompt_audios[i], np.float32)[None, :],
                            step,
                            sample_rate=sampling_rate,
                        )
                    except Exception:
                        pass  # tensorboardX audio needs soundfile; optional
                if prompt_texts is not None and i < len(prompt_texts):
                    self._tb.add_text(f"validation/prompt_{i}", prompt_texts[i], step)
                if audio_responses is not None and i < len(audio_responses):
                    self._tb.add_text(f"validation/audio_response_{i}", audio_responses[i], step)
                if text_responses is not None and i < len(text_responses):
                    self._tb.add_text(f"validation/text_response_{i}", text_responses[i], step)
            if self._jsonl is not None:
                rec = {"t": time.time(), "step": step, "sample": i}
                if prompt_texts is not None and i < len(prompt_texts):
                    rec["prompt"] = prompt_texts[i]
                if audio_responses is not None and i < len(audio_responses):
                    rec["audio_response"] = audio_responses[i]
                if text_responses is not None and i < len(text_responses):
                    rec["text_response"] = text_responses[i]
                self._jsonl.write(json.dumps(rec) + "\n")

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
