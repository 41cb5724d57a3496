"""The static-shape training batch (port of ``data/batch.py``).

The collator fills it with host numpy arrays; ``to_device`` gives the same
batch as tensors on the training device.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class Batch(NamedTuple):
    wav: Any  # (B, N) float32, right-padded
    wav_lens: Any  # (B,) int32
    text_ids: Any  # (B, T) int32 transcript tokens, BOS-stripped, right-padded
    text_lens: Any  # (B,) int32
    response_ids: Any  # (B, R) int32 LLM-response tokens, BOS-stripped
    response_lens: Any  # (B,) int32
    ctc_pool_ranges: Optional[Any] = None  # (B, G, 2) int32 or None

    def to_device(self, device) -> "Batch":
        """Every array as a tensor on ``device`` (None stays None)."""
        return Batch(*(None if a is None else torch.as_tensor(np.asarray(a)).to(device)
                       for a in self))
