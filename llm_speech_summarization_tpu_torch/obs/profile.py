"""Profiling helpers (port of ``obs/profile.py``).

  * ``trace(logdir)``: a context manager over ``torch.profiler.profile``
    that records host and, where a card is visible, CUDA activity and
    writes a Chrome trace (``*.pt.trace.json``) into ``logdir``, which
    TensorBoard's PyTorch profiler plugin and ``chrome://tracing`` read;
  * ``annotate(name)``: the port's span. While a profiler records it is
    ``torch.profiler.record_function``, so the span's start and end are
    profiler events on the clock of the device activities, and an idle gap
    of the card can be put down to the span its host thread was in;
    otherwise it does nothing. Span names start with ``lss.``.

The port's counters are plain host numbers in the ``Counter``s of the
objects that count (``LLMSpeechTextInference.counts``, ``Trainer.counts``),
always on.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

_NO_SPAN = contextlib.nullcontext()  # stateless: shared by every thread and call


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
    """A span of the port: ``with annotate("lss.generate.decode_step"): ...``.
    With no profiler recording it returns one shared no-op context and makes
    no ``record_function`` call (one costs ~13 us on a CPU host, where
    the flag check costs well under one)."""
    if autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN
