"""The one traffic generator: every traffic file under ``traffic/`` is read
here, whatever runner drives it.

Sizes are stratified, not drawn: a batch of n clips over [lo, hi] seconds
holds the clips lo + (hi - lo) (i + 1/2) / n, i < n, and likewise for the
response lengths. Every batch of every seed has the same sizes (so the same
shapes and work), and the seed draws only their order, the waveforms and
the token ids. A batch's draws come from its own stream of the seed, so a
batch is the same whichever thread makes it and whenever.
"""

from __future__ import annotations

from typing import List

import numpy as np

POOL = 16  # noise buffers a run's waveforms are cut from


def stratified(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed), *stream])))


class Stream:
    """The batches of one traffic mix and seed."""

    def __init__(self, traffic: dict, seed: int, sampling_rate: int, vocab_size: int):
        self.t = traffic
        self.seed = int(seed)
        self.sr = sampling_rate
        self.vocab = vocab_size
        self.n = traffic["batch"]
        lo, hi = traffic["clip_seconds"]
        self.samples = np.floor(stratified(lo, hi, self.n) * sampling_rate).astype(np.int64)
        r = rng(seed, 0)
        # the waveforms: windows of a few seeded noise buffers (a clip is a
        # view, so making a batch costs the host next to nothing)
        self.pool = (0.1 * r.standard_normal((POOL, int(self.samples.max())),
                                             dtype=np.float32))

    def clips(self, j: int) -> List[np.ndarray]:
        """Batch j's waveforms, in the seed's order."""
        r = rng(self.seed, 1, j)
        lens = r.permutation(self.samples)
        src = r.integers(0, POOL, size=self.n)
        starts = (r.random(self.n) * (self.pool.shape[1] - lens + 1)).astype(np.int64)
        return [self.pool[s, a:a + n] for s, a, n in zip(src, starts, lens)]

    def examples(self, j: int) -> List[dict]:
        """Batch j as training examples: each clip with its transcript's
        token ids (``text_tokens_per_second`` of audio) and a response of a
        stratified length, ids drawn over the whole vocabulary."""
        clips = self.clips(j)
        r = rng(self.seed, 2, j)
        lo, hi = self.t["response_tokens"]
        resp = r.permutation(np.round(stratified(lo, hi, self.n)).astype(np.int64))
        rate = self.t["text_tokens_per_second"]
        out = []
        for clip, n_resp in zip(clips, resp):
            n_text = int(round(rate * len(clip) / self.sr))
            out.append({
                "audio": clip,
                "text_input_ids": r.integers(0, self.vocab, size=n_text).astype(np.int32),
                "response_input_ids": r.integers(0, self.vocab, size=int(n_resp)).astype(np.int32),
            })
        return out
