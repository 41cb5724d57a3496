"""Ring attention: sequence-parallel attention over a process group (port of
``ops/ring_attention.py``).

q, k and v are sharded along time over the ranks of ``group``: rank r holds
global positions [r·Tl, (r+1)·Tl). K/V blocks rotate around the ring (one
``ring_shift`` per step) while each rank folds every visiting block into a
running (output, log-sum-exp) state for its local queries. The interior of
one (local queries, visiting block) pair is the flash kernel in offset mode
(B7: ``flash_attention_fwd_lse_offset`` and its backward) on CUDA
tensors, and its plain version on CPU tensors; the (Tl, Tl) logits of a
block pair never reach device memory on the card.

Forward and backward are explicit ring programs in ``RingAttention``:
  * the forward merges the blocks' normalized partials by log-sum-exp
    weights; a block a row cannot see has lse = -1e30 and weight 0;
  * the backward computes delta = rowsum(dO · O) once from the global
    output, then rotates (k, v, dk, dv) together: each rank adds dq for its
    queries, and the visiting block's dk/dv collect every rank's
    contribution and arrive home after n steps (FlashAttention-2's p =
    exp(s - lse) from the saved global lse).
The forward skips the JAX ring's last rotation, which only brings k and v
home; the backward's last step moves dk and dv alone.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import (
    flash_attention_bwd_dkv_offset,
    flash_attention_bwd_dq_offset,
    flash_attention_fwd_lse_offset,
)
from ..parallel.comm import group_rank, group_size, ring_shift
from .attention import NEG_INF


def _block_windows(starts_g, ends_g, src: int, Tl: int):
    """The global window [starts, ends) clipped to the block of rank
    ``src`` and made local to it."""
    starts = torch.clamp(starts_g - src * Tl, 0, Tl).to(torch.int32).contiguous()
    ends = torch.clamp(ends_g - src * Tl, 0, Tl).to(torch.int32).contiguous()
    return starts, ends


class RingAttention(torch.autograd.Function):
    """out (B, Tl, Hq, Dh) of the local queries over the whole ring."""

    @staticmethod
    def forward(ctx, q, k, v, starts_g, ends_g, group, causal):
        n, r = group_size(group), group_rank(group)
        B, Tl, Hq, Dh = q.shape
        o = torch.zeros((B, Tl, Hq, Dh), dtype=torch.float32, device=q.device)
        lse = torch.full((B, Hq, Tl), NEG_INF, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for s in range(n):
            src = (r - s) % n  # the rank whose block this rank holds now
            starts, ends = _block_windows(starts_g, ends_g, src, Tl)
            o_s, lse_s = flash_attention_fwd_lse_offset(q, kb, vb, starts, ends,
                                                        (r * Tl, src * Tl), causal)
            lse_new = torch.logaddexp(lse, lse_s)
            w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
            w_new = torch.exp(lse_s - lse_new).transpose(1, 2)[..., None]
            o = o * w_old + o_s.float() * w_new
            lse = lse_new
            if s < n - 1:
                kb, vb = ring_shift([kb, vb], group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, starts_g, ends_g)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, starts_g, ends_g = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, r = group_size(group), group_rank(group)
        Tl = q.shape[1]
        g = g.contiguous()
        # delta = rowsum(dO * O) in (B, Hq, Tl), FA-2 eq. 19
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for s in range(n):
            src = (r - s) % n
            starts, ends = _block_windows(starts_g, ends_g, src, Tl)
            args = (q, kb, vb, g, lse, delta, starts, ends, (r * Tl, src * Tl), causal)
            dq += flash_attention_bwd_dq_offset(*args).float()
            dk_c, dv_c = flash_attention_bwd_dkv_offset(*args)
            dk += dk_c.float()
            dv += dv_c.float()
            if s < n - 1:
                kb, vb, dk, dv = ring_shift([kb, vb, dk, dv], group)
            else:  # dk and dv of the block this rank holds go home
                dk, dv = ring_shift([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q, k, v, starts, group, causal: bool = True, ends=None) -> torch.Tensor:
    """Sequence-parallel attention (causal or bidirectional).

    q: (B, Tl, Hq, Dh), k, v: (B, Tl, Hkv, Dh), this rank's shard of T =
    n·Tl positions. The valid-key window per sample is [starts, ends) in
    GLOBAL positions, (B,) int32 on every rank: left-padded LLM batches pass
    (pad_lens, None → T), right-padded encoder batches (0, n_valid).
    Returns (B, Tl, Hq, Dh), this rank's queries. Query rows with no valid
    key are finite garbage, as in the unsharded kernels. ``group`` None runs
    the one-rank ring."""
    T = q.shape[1] * group_size(group)
    if ends is None:
        ends = torch.full((q.shape[0],), T, dtype=torch.int32, device=q.device)
    return RingAttention.apply(q, k, v, starts.to(torch.int32), ends.to(torch.int32), group,
                               causal)
