"""Audio-embedding downsampling (port of ``ops/pooling.py``): the
projector's average pool, frame stacking and the mean over CTC word
ranges."""

from __future__ import annotations

import torch


def avg_pool_time(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """Average-pool over time: (B, N, D) → (B, (N-k)//s + 1, D), windows
    always full (torch.nn.AvgPool1d without padding). Prefix-sum form in
    float32, like the JAX version."""
    B, N, D = x.shape
    out_len = (N - kernel_size) // stride + 1
    cs = torch.cumsum(x.float(), dim=1)
    cs = torch.nn.functional.pad(cs, (0, 0, 1, 0))
    starts = torch.arange(out_len, device=x.device) * stride
    summed = cs[:, starts + kernel_size, :] - cs[:, starts, :]
    return (summed / kernel_size).to(x.dtype)


def stack_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Concatenate ``factor`` adjacent frames: (B, N, D) → (B, N//f, f*D),
    cropping the trailing N % f frames."""
    B, N, D = x.shape
    n_keep = (N // factor) * factor
    return x[:, :n_keep, :].reshape(B, N // factor, factor * D)


def ctc_segment_mean(
    x: torch.Tensor, pool_ranges: torch.Tensor, range_valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of the frames over per-sample ``[start, end)`` ranges.

    x: (B, N, D) frames; pool_ranges: (B, G, 2) integer ranges, right-padded;
    range_valid: (B, G) bool, by default ``end > start``. A range is real
    only if it also starts inside the frames (``start < N``): ranges drawn on
    a whole clip may pass the end of a clipped buffer. Returns ``(pooled (B,
    G, D), valid (B, G))``, zeros at invalid and empty ranges. The dense
    (B, G, N) membership weights (1 / count in x's dtype) are contracted
    with the frames in float32, as the JAX package's one einsum does.
    """
    B, N, _ = x.shape
    starts, ends = pool_ranges[..., 0], pool_ranges[..., 1]
    if range_valid is None:
        range_valid = ends > starts
    range_valid = range_valid & (starts < N)
    t = torch.arange(N, device=x.device)
    member = (t >= starts[..., None]) & (t < ends[..., None]) & range_valid[..., None]
    counts = member.sum(dim=-1).clamp(min=1)
    weights = member.to(x.dtype) / counts[..., None].to(x.dtype)
    pooled = torch.matmul(weights.float(), x.float())
    return pooled.to(x.dtype), range_valid
