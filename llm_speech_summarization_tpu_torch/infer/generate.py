"""Generation: prefill on spliced embeddings + KV-cache decode loop (port of
``infer/generate.py``).

``greedy_generate``: the prefill writes the cache and gives the first
token from the last position's logits; each decode step feeds the last
token at cache slot ``L + step - 1`` with HF left-pad positions, valid
cache slots ``[pad_len, offset)``, and stops early once every row has
emitted EOS. Tokens are greedy, sampled at one temperature (``_sample``),
or sampled per row (``sampling``, ``infer/sampling.py``).

``speculative_generate``: greedy decoding by self-speculation. Each round
drafts k tokens from the row's own output (``_ngram_propose``) and verifies
them in one (k+1)-token forward; ``commit_verified_drafts`` keeps the
longest agreeing prefix plus the model's bonus token. Where the JAX
function writes every round at one scalar offset and carries a validity
bitmask, here each row writes its k+1 fresh K/V at its own offset and
advances by what it committed (the slot decoder's scheme), so the
verification forward is the fused decode kernel's per-row window at
T = k + 1.

Both take the model group of a tensor-parallel engine (``tp_group``): every
rank of it makes the same call on the same prompt with its parameter shard,
holds a cache of its KV heads and gets the same full logits, so the same
tokens (``models/llama.py``).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional

import torch

from ..models.llama import LlamaConfig, init_kv_cache, llama_forward
from ..obs.profile import annotate
from ..parallel.comm import group_size
from .sampling import sample_rows


def _apply_repetition_penalty(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """HF-style repetition penalty over already generated tokens: seen
    tokens' logits shrink (divide if positive, multiply if negative)."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _sample(
    logits: torch.Tensor,
    temperature: float,
    generator: Optional[torch.Generator],
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits → (B,) int32 ids: argmax at temperature <= 0, else a
    draw from the temperature / top-k / top-p filtered distribution (the
    JAX ``_sample``; the draw comes from ``generator``, so its bits differ
    from ``jax.random.categorical``'s)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    neg = torch.full((), -1e30, device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(1, cutoff_idx.clamp(max=logits.shape[-1] - 1))
        logits = torch.where(logits < cutoff, neg, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def greedy_generate(
    params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    attn_mask: torch.Tensor,
    *,
    max_new_tokens: int,
    eos_id: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    generator: Optional[torch.Generator] = None,
    cache_dtype=torch.bfloat16,
    num_steps: Optional[int] = None,
    sampling=None,
    counts: Optional[Counter] = None,
    attn_impl: str = "auto",
    tp_group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate up to ``max_new_tokens`` from a left-padded embeds batch;
    ``num_steps`` caps the steps below it (the cache and output stay
    ``max_new_tokens`` long). ``sampling``, when given, is a per-row
    ``(rngs, temps, top_ks, top_ps)`` tuple of tensors (``infer/
    sampling.py``) that overrides the one temperature: draw t of row b keys
    to the row's unpadded position. ``counts``, when given, gains
    "prefills", "decode_steps" and "decode_issue_s": the host seconds from
    the end of each step's device read to the start of the next (the
    step's forward, pick and bookkeeping being issued); and, from the
    decode steps' ``llama_forward`` on the card (without ``tp_group``),
    "decode_graph_steps" (steps replayed as piecewise CUDA graphs) and
    "decode_graph_captures" (piece sets captured, each after an eager
    step). Spans (``annotate``): ``lss.generate.prefill``, one
    ``lss.generate.decode_step`` a step and ``lss.generate.done_read``
    around each read of the rows' EOS flags.
    ``attn_impl`` goes to every decode step
    (``llama_forward``): "pallas" reads the cache through kernel B8.
    ``tp_group``: ``params`` is this rank's shard (see the module docstring).

    Returns (tokens (B, max_new_tokens) int32, EOS-padded; lengths (B,)).
    """
    B, L, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    S = L + max_new_tokens
    step_cap = max_new_tokens if num_steps is None else min(int(num_steps), max_new_tokens)

    if sampling is not None:
        s_rngs, s_temps, s_topks, s_topps = sampling

        def pick(logits, position):
            return sample_rows(logits, s_rngs, position, s_temps, s_topks, s_topps)
    else:
        def pick(logits, position):
            return _sample(logits, temperature, generator, top_k, top_p)

    cache = init_kv_cache(cfg, B, S, dtype=cache_dtype, device=dev, tp=group_size(tp_group))
    with annotate("lss.generate.prefill"):
        out = llama_forward(
            params, cfg, inputs_embeds=inputs_embeds, attn_mask=attn_mask,
            kv_cache=cache, cache_offset=0, last_logit_only=True, tp_group=tp_group,
        )
        lens = attn_mask.to(torch.int32).sum(dim=1)
        first = pick(out.logits[:, -1], lens - 1)
    if counts is not None:
        counts["prefills"] += 1
    pad_lens = (L - lens).to(torch.int32)

    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = first
    use_rep = repetition_penalty != 1.0
    rows = torch.arange(B, device=dev)
    seen = None
    if use_rep:
        seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev)
        seen[rows, first.long()] = True
    last = first
    done = first == eos_id
    step = 1
    while step < step_cap:
        with annotate("lss.generate.done_read"):
            finished = bool(done.all())
        if finished:
            break
        issued = time.perf_counter()
        with annotate("lss.generate.decode_step"):
            out = llama_forward(
                params, cfg, input_ids=last[:, None], attn_mask=None,
                positions=(lens + step - 1)[:, None],
                kv_cache=cache, cache_offset=L + step - 1, kv_pad_lens=pad_lens,
                attn_impl=attn_impl, tp_group=tp_group, counts=counts,
            )
            logits = out.logits[:, 0]
            if use_rep:
                logits = _apply_repetition_penalty(logits, seen, repetition_penalty)
            nxt = pick(logits, lens + step - 1)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            tokens[:, step] = nxt
            if use_rep:
                seen[rows, nxt.long()] = True
            last = nxt
            done = done | (nxt == eos_id)
        step += 1
        if counts is not None:
            counts["decode_steps"] += 1
            counts["decode_issue_s"] += time.perf_counter() - issued

    before_eos = torch.cumsum((tokens == eos_id).to(torch.int32), dim=1) == 0
    num = torch.clamp(before_eos.to(torch.int32).sum(dim=1) + 1, max=step)  # incl. the EOS
    return tokens, num.to(torch.int32)


def _ngram_propose(tokens: torch.Tensor, t: torch.Tensor, last: torch.Tensor, k: int):
    """Self-speculative draft: continue the most recent earlier occurrence
    of the last emitted 2-gram in the row's own output. tokens (B, S)
    emitted so far (EOS-padded); t (B,) emitted counts; last (B,) newest
    token. Rows without a match draft ``last`` repeated."""
    B, S = tokens.shape
    dev = tokens.device
    t = t.long()
    rows = torch.arange(B, device=dev)
    g0 = tokens[rows, torch.clamp(t - 2, min=0)]
    idx = torch.arange(S, device=dev)[None, :]
    m = (
        (tokens == g0[:, None])
        & (torch.roll(tokens, -1, dims=1) == last[:, None])
        & (idx + 1 <= t[:, None] - 2)  # strictly before the trailing 2-gram
        & (t[:, None] >= 3)
    )
    best = torch.where(m, idx, torch.full_like(idx, -1)).amax(dim=1)  # most recent match
    ahead = best[:, None] + 2 + torch.arange(k, device=dev)[None, :]
    cont = tokens.gather(1, ahead.clamp(0, S - 1))
    use = (best >= 0)[:, None] & (ahead < t[:, None])
    return torch.where(use, cont, last[:, None]).to(torch.int32)


def commit_verified_drafts(preds, draft, tokens, n_emitted, budgets, done, last, eos_id: int):
    """Accept/commit core of speculative decoding, shared by
    ``speculative_generate`` and the slot decoder's speculative chunks:
    the longest agreeing draft prefix plus the bonus token commit, the first
    committed EOS truncates, budgets cap. preds/draft (B, k+1)/(B, k) from
    one verification forward; tokens (B, cap) is updated in place.
    Returns (tokens, n_add, last, done, commit)."""
    B, k1 = preds.shape
    dev = preds.device
    agree = torch.cumprod((preds[:, :-1] == draft).to(torch.int32), dim=1)
    a = agree.sum(dim=1)  # accepted draft tokens
    j = torch.arange(k1, device=dev)[None, :]
    commit = j <= a[:, None]
    is_eos = (preds == eos_id).to(torch.int32)
    commit = commit & (torch.cumsum(is_eos, dim=1) - is_eos == 0)
    budgets = torch.broadcast_to(torch.as_tensor(budgets, dtype=torch.int32, device=dev), (B,))
    commit = commit & (~done)[:, None] & ((n_emitted[:, None] + j) < budgets[:, None])
    dest = torch.clamp(n_emitted[:, None].long() + j, 0, tokens.shape[1] - 1)
    for i in range(k1):
        col = dest[:, i:i + 1]
        cur = tokens.gather(1, col)
        tokens.scatter_(1, col, torch.where(commit[:, i:i + 1], preds[:, i:i + 1], cur))
    n_add = commit.to(torch.int32).sum(dim=1)
    last_new = preds.gather(1, torch.clamp(n_add.long() - 1, min=0)[:, None])[:, 0]
    last = torch.where(done | (n_add == 0), last, last_new)
    done = done | ((preds == eos_id) & commit).any(dim=1) | ((n_emitted + n_add) >= budgets)
    return tokens, n_add, last, done, commit


@torch.no_grad()
def speculative_generate(
    params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    attn_mask: torch.Tensor,
    *,
    max_new_tokens: int,
    eos_id: int,
    k: int = 4,
    cache_dtype=torch.bfloat16,
    num_steps: Optional[int] = None,
    counts: Optional[Counter] = None,
    tp_group=None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy generation with self-speculative (n-gram lookahead) decoding.
    ``counts``, when given, gains "prefills" and "spec_rounds";
    ``tp_group`` as in ``greedy_generate``.

    Returns (tokens (B, max_new) int32 EOS-padded, lengths (B,), rounds:
    the verification forwards run)."""
    B, L, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    cap = max_new_tokens if num_steps is None else min(int(num_steps), max_new_tokens)
    # a row's offset is L + emitted - 1 < L + cap, and a round writes k + 1
    S = L + max_new_tokens + k + 1
    cache = init_kv_cache(cfg, B, S, dtype=cache_dtype, device=dev, tp=group_size(tp_group))
    out = llama_forward(params, cfg, inputs_embeds=inputs_embeds, attn_mask=attn_mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True, tp_group=tp_group)
    if counts is not None:
        counts["prefills"] += 1
    first = torch.argmax(out.logits[:, -1], dim=-1).to(torch.int32)
    lens = attn_mask.to(torch.int32).sum(dim=1)
    pad_lens = (L - lens).to(torch.int32)
    tokens = torch.full((B, max_new_tokens), eos_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = first
    n = torch.ones((B,), dtype=torch.int32, device=dev)
    offsets = torch.full((B,), L, dtype=torch.int32, device=dev)
    last = first
    done = (first == eos_id) | (n >= cap)
    ar = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
    rounds = 0
    while rounds < cap - 1 and not bool(done.all()):
        draft = _ngram_propose(tokens, n, last, k)
        seq = torch.cat([last[:, None], draft], dim=1)
        fwd = llama_forward(params, cfg, input_ids=seq, positions=(lens + n - 1)[:, None] + ar,
                            kv_cache=cache, cache_offset=offsets, kv_pad_lens=pad_lens,
                            cache_offset_bound=L + cap - 1, tp_group=tp_group)
        rounds += 1
        if counts is not None:
            counts["spec_rounds"] += 1
        preds = torch.argmax(fwd.logits, dim=-1).to(torch.int32)
        tokens, n_add, last, done, _ = commit_verified_drafts(
            preds, draft, tokens, n, cap, done, last, eos_id)
        n = n + n_add
        offsets = offsets + n_add
    return tokens, torch.clamp(n, max=cap), rounds
