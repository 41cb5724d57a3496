"""Per-row token sampling for the continuous-batching decoder (port of
``infer/sampling.py``).

Every decode step advances rows of different requests, each with its own
temperature / top-k / top-p / seed. Rows with temperature <= 0 take an exact
full-vocabulary argmax; sampling rows draw inside the top ``CANDIDATES``
logits with one uniform per row from a counter-based hash of (seed,
position): murmur3 finalizers over the row's 64-bit seed and its unpadded
position, so step t of a request is a function of (seed, t) alone and a
seeded request replays identically in any batch. The uint32 arithmetic
runs in int64 tensors masked to 32 bits, which gives the JAX package's
draws bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
CANDIDATES = 64  # top-k sweep size; per-row top_k/top_p act inside it
_M32 = 0xFFFFFFFF


def key_data_from_seed(seed: int) -> np.ndarray:
    """(2,) uint32 seed words for one request (host-side)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([(s >> 32) & _M32, s & _M32], np.uint32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h, c < 2**32 without int64 overflow: the
    constant is split in 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _uniform_rows(rng: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(N,) float32 uniforms in [0, 1) from (N, 2) seed words (int64 holding
    uint32) and (N,) positions."""
    hi = rng[:, 0].long() & _M32
    lo = rng[:, 1].long() & _M32
    pos = positions.long() & _M32
    h = _fmix32(lo ^ _mul32(pos, 0x9E3779B9))
    h = _fmix32(h ^ _fmix32((hi + 0x165667B1) & _M32))
    # 24 high bits: float32 holds them exactly, all 32 could round to 1.0
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_rows(
    logits: torch.Tensor,  # (N, V)
    rng: torch.Tensor,  # (N, 2) seed words (int64 holding uint32)
    positions: torch.Tensor,  # (N,) the row's unpadded position: the draw counter
    temps: torch.Tensor,  # (N,) float32; <= 0 → greedy
    top_ks: torch.Tensor,  # (N,) int; <= 0 → off
    top_ps: torch.Tensor,  # (N,) float32; >= 1 → off
) -> torch.Tensor:
    """(N,) int32 next-token ids with independent sampling params per row."""
    V = logits.shape[-1]
    C = min(CANDIDATES, V)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = torch.topk(logits, C, dim=-1)  # descending
    scaled = vals.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    pos = torch.arange(C, device=logits.device)[None, :]
    kk = torch.where(top_ks <= 0, torch.full_like(top_ks, C), torch.clamp(top_ks, max=C))
    scaled = torch.where(pos < kk[:, None], scaled, torch.full((), NEG_INF, device=logits.device))
    # nucleus: keep the smallest prefix whose mass reaches top_p (the top
    # candidate always stays)
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < torch.clamp(top_ps.float(), min=1e-6)[:, None]
    kept = torch.where(keep, probs, torch.zeros_like(probs))
    kept_cum = torch.cumsum(kept, dim=-1)
    u = _uniform_rows(rng, positions)[:, None] * kept_cum[:, -1:]
    choice = torch.clamp((kept_cum <= u).to(torch.int64).sum(-1), max=C - 1)
    sampled = idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


def pack_sampling_params(sampling, n: int):
    """A length-n list of ``(temperature, top_k, top_p, seed) | None`` →
    (rngs (n, 2) uint32, temps, top_ks, top_ps) numpy arrays, padded rows
    greedy; None when every entry is None (the greedy path)."""
    if sampling is None or all(s is None for s in sampling):
        return None
    temps = np.zeros((n,), np.float32)
    top_ks = np.zeros((n,), np.int32)
    top_ps = np.ones((n,), np.float32)
    rngs = np.zeros((n, 2), np.uint32)
    for i, sp in enumerate(sampling[:n]):
        if sp is None:
            continue
        temperature, top_k, top_p, seed = sp
        temps[i] = temperature
        top_ks[i] = top_k
        top_ps[i] = top_p
        rngs[i] = key_data_from_seed(seed)
    return rngs, temps, top_ks, top_ps


def sampling_tensors(packed, device):
    """Packed numpy sampling params → (rngs int64, temps, top_ks, top_ps)
    tensors on ``device``."""
    rngs, temps, top_ks, top_ps = packed
    return (torch.from_numpy(rngs.astype(np.int64)).to(device), torch.from_numpy(temps).to(device),
            torch.from_numpy(top_ks).to(device), torch.from_numpy(top_ps).to(device))
