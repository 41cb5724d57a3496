"""Profiling helpers (port of ``obs/profile.py``).

  * ``trace(logdir)``: a context manager over ``torch.profiler.profile``
    that records host and, where a card is visible, CUDA activity and
    writes a Chrome trace (``*.pt.trace.json``) into ``logdir``, which
    TensorBoard's PyTorch profiler plugin and ``chrome://tracing`` read;
  * ``annotate(name)``: ``torch.profiler.record_function``, so stages
    (encoder / splice / llm / losses) are labeled inside traces;
  * ``StepTimer``: host-side EMA step timer for the JSONL metrics stream.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block into ``logdir``; yields the profiler.
    On the card the block's kernels are waited for before the trace stops,
    so the last ones are in it."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def annotate(name: str):
    """Label a region for profiler traces: ``with annotate("encoder"): ...``"""
    return record_function(name)


class StepTimer:
    """Host-side step timing with exponential smoothing."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        self._last = now
        return self.ema
