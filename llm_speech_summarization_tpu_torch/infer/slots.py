"""Slot-based continuous batching decoder (port of ``infer/slots.py``).

A persistent KV cache of N slots lives on the device. ``admit`` prefills
new requests as a mini-batch into a temporary dense cache and copies their
K/V into free slots (dense) or into pages reserved for prompt + budget
(paged); ``decode_chunk`` advances every live slot up to k steps with
per-row cache offsets; between chunks the host harvests finished rows (EOS
or budget) and frees their slots, so short requests return without waiting
for long co-batched ones and new requests join mid-decode.

A dense step runs the fused decode kernel (B2) at T = 1, a paged step the
fused paged kernel (B5); a speculative round runs one (spec_k + 1)-token
verification forward, B2 at T = spec_k + 1 (dense) or the paged attention
kernel B4 followed by ``write_tokens`` (paged). Admission prefill runs the
flash-attention kernel (B1).

The state is a ``SlotState`` of device tensors updated in place. The host
keeps what it needs to run a chunk without reading the device: the page
ownership per slot, a bound on every row's cache offset (the dense
kernel's bound check), the live rows' temperatures, and a copy of the
(done, budget, emitted) flags read once at the end of every chunk. A chunk
runs at most as many steps as the longest remaining budget needs; the JAX
chunk's on-device early exit when every row is done would cost a host read
per step here.

Under a tensor-parallel mesh (``mesh.model`` > 1) the decoder runs this
rank's parameter shard in the model group: its cache holds the rank's
Hkv/tp KV heads (dense or paged), every kernel runs on the rank's heads,
and every rank of the group must make the same calls in the same order
(the server's followers mirror rank 0's, ``serve/model_group.py``); the
logits, hence the tokens and every host mirror, are the same on every
rank.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import LlamaConfig, init_kv_cache, llama_forward, shard_config
from .generate import _ngram_propose, commit_verified_drafts
from .paged import PageAllocator, init_paged_cache, pages_needed, write_prefill_pages_batch
from .sampling import pack_sampling_params, sample_rows, sampling_tensors


class SlotState(NamedTuple):
    cache: object  # KVCache (dense) or PagedKVCache
    pad_lens: torch.Tensor  # (N,) int32 row window start in the cache
    offsets: torch.Tensor  # (N,) int32 next cache slot to write (row depth)
    last_token: torch.Tensor  # (N,) int32
    done: torch.Tensor  # (N,) bool
    tokens: torch.Tensor  # (N, max_new) int32 emitted tokens, EOS-padded
    n_emitted: torch.Tensor  # (N,) int32
    budgets: torch.Tensor  # (N,) int32
    seen: torch.Tensor  # (N, V) bool iff repetition penalty on, else (N, 1)
    rng: torch.Tensor  # (N, 2) int64 holding the uint32 seed words
    temps: torch.Tensor  # (N,) float32; <= 0 → greedy
    top_ks: torch.Tensor  # (N,) int32
    top_ps: torch.Tensor  # (N,) float32


class SlotDecoder:
    """Device-resident decode slots over a frozen LLM.

    ``counts`` records what ran: "prefills" (admission forwards), "steps"
    (T = 1 decode steps) and "spec_rounds" (verification forwards).
    ``mesh``: a ``parallel.mesh.Mesh`` whose model group shares the LLM
    (``llm_params`` is then this rank's shard); a model width it does not
    divide raises ValueError."""

    def __init__(
        self,
        llm_params,
        cfg: LlamaConfig,
        eos_id: int,
        n_slots: int = 32,
        max_prompt_len: int = 512,
        max_new_tokens: int = 256,
        cache_dtype=torch.bfloat16,
        paged: bool = False,
        page_size: int = 64,
        num_pages: Optional[int] = None,
        repetition_penalty: float = 1.0,
        mesh=None,
        spec_k: int = 0,
        device=None,
    ):
        self.tp = mesh.model if mesh is not None else 1
        self.tp_group = mesh.model_group if mesh is not None else None
        shard_config(cfg, self.tp)
        if spec_k > 0 and repetition_penalty != 1.0:
            raise ValueError(
                "speculative decode chunks verify exact greedy streams; "
                "repetition_penalty is incompatible")
        self.device = resolve_device(device)
        self.params = llm_params
        self.cfg = cfg
        self.eos_id = eos_id
        self.n_slots = n_slots
        self.repetition_penalty = repetition_penalty
        self.spec_k = spec_k
        self.max_prompt_len = max_prompt_len
        self.max_new = max_new_tokens
        # + spec headroom: a verification round writes spec_k + 1 fresh K/V
        # at the row's offset before knowing how many commit; rounded up to
        # 32 so that the cache geometry matches the JAX decoder's
        self.max_len = max_prompt_len + max_new_tokens + (spec_k + 1 if spec_k else 0)
        self.max_len = (self.max_len + 31) // 32 * 32
        self.paged = paged
        if paged and cache_dtype == torch.int8 and page_size % 128 != 0:
            # the JAX decoder's bump (a TPU lane rule), kept so that both
            # decoders have the same page geometry and token stream
            page_size = 128
        self.page_size = page_size
        if paged:
            worst = n_slots * pages_needed(self.max_len, page_size)
            self.num_pages = num_pages or max(2, n_slots + 1, int(0.6 * worst) + 1)
            self.allocator = PageAllocator(self.num_pages)
            # host mirror of page ownership per slot
            self._host_table = np.zeros((n_slots, pages_needed(self.max_len, page_size)),
                                        np.int32)
        self.cache_dtype = cache_dtype
        self.counts: Counter = Counter()
        self.state = self._init_state()
        N = n_slots
        self._bound = np.ones((N,), np.int64)  # >= every row's offset
        self._temps = np.zeros((N,), np.float32)  # live rows' temperatures
        # (done, budgets, n_emitted) as of the last read, updated by admit
        # and release
        self._mirror = (np.ones((N,), bool), np.zeros((N,), np.int32), np.zeros((N,), np.int32))
        self.last_chunk_steps = 0
        self.last_read_s = 0.0

    def _init_state(self) -> SlotState:
        N, dev = self.n_slots, self.device
        pad_lens = torch.zeros((N,), dtype=torch.int32, device=dev)
        offsets = torch.ones((N,), dtype=torch.int32, device=dev)  # >= 1: idle rows write slot 0..1
        if self.paged:
            cache = init_paged_cache(
                self.cfg.num_layers, shard_config(self.cfg, self.tp).num_kv_heads,
                self.cfg.head_dim,
                num_pages=self.num_pages, page_size=self.page_size, batch=N,
                max_pages_per_seq=pages_needed(self.max_len, self.page_size),
                dtype=self.cache_dtype, device=dev,
            )
            # the pool's per-row lengths and pads ARE the decoder's offsets
            # and pads: one tensor each, updated in place
            cache = cache._replace(lengths=offsets, pad_lens=pad_lens)
        else:
            cache = init_kv_cache(self.cfg, N, self.max_len, dtype=self.cache_dtype, device=dev,
                                  tp=self.tp)
        V = self.cfg.vocab_size if self.repetition_penalty != 1.0 else 1
        return SlotState(
            cache=cache,
            pad_lens=pad_lens,
            offsets=offsets,
            last_token=torch.full((N,), self.eos_id, dtype=torch.int32, device=dev),
            done=torch.ones((N,), dtype=torch.bool, device=dev),
            tokens=torch.full((N, self.max_new), self.eos_id, dtype=torch.int32, device=dev),
            n_emitted=torch.zeros((N,), dtype=torch.int32, device=dev),
            budgets=torch.zeros((N,), dtype=torch.int32, device=dev),
            seen=torch.zeros((N, V), dtype=torch.bool, device=dev),
            rng=torch.zeros((N, 2), dtype=torch.int64, device=dev),
            temps=torch.zeros((N,), dtype=torch.float32, device=dev),
            top_ks=torch.zeros((N,), dtype=torch.int32, device=dev),
            top_ps=torch.ones((N,), dtype=torch.float32, device=dev),
        )

    # ------------------------------------------------------------------

    def sync_flags(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(done, budgets, n_emitted) in one device→host read, writable."""
        s = self.state
        host = torch.stack([s.done.to(torch.int32), s.budgets, s.n_emitted]).cpu().numpy().copy()
        return host[0].astype(bool), host[1], host[2]

    def free_slots(self, done: Optional[np.ndarray] = None) -> List[int]:
        if done is None:
            done = self.state.done.cpu().numpy()
        return [int(i) for i in np.nonzero(done)[0]]

    def live_count(self, done: Optional[np.ndarray] = None) -> int:
        if done is None:
            done = self.state.done.cpu().numpy()
        return int(np.sum(~done))

    def _ids(self, slot_ids) -> torch.Tensor:
        return torch.tensor(list(slot_ids), dtype=torch.long, device=self.device)

    def admit(
        self,
        embeds: torch.Tensor,  # (n, T, D) left-padded prompt embeddings
        mask: torch.Tensor,  # (n, T) bool
        slot_ids: List[int],
        budgets: List[int],
        sampling=None,  # optional per-request [(temperature, top_k, top_p, seed) | None]
    ) -> None:
        """Prefill ``len(slot_ids)`` requests into their slots. ``embeds``
        may carry more rows than ``slot_ids`` (a wave padded to a power of
        two); only the leading real rows are prefilled. Paged: each
        request's pages for prompt + budget (+ speculative headroom) are
        reserved here, so a chunk never allocates; a pool too small raises
        MemoryError with nothing reserved."""
        n, T, _ = embeds.shape
        n_real = len(slot_ids)
        if n_real > n:
            raise ValueError(f"{n_real} slot_ids for {n} embed rows")
        if len(budgets) != n_real:
            raise ValueError("slot_ids and budgets must have equal length")
        if n_real == 0:
            return
        if T > self.max_prompt_len:
            raise ValueError(
                f"prompt bucket {T} exceeds the decoder's max_prompt_len "
                f"{self.max_prompt_len}; raise max_prompt_len when building the server/decoder")
        slot_ids = [int(s) for s in slot_ids]
        budgets = np.minimum(np.asarray(budgets, np.int64), self.max_new)
        dev = self.device
        embeds, mask = embeds[:n_real].to(dev), mask[:n_real].to(dev)
        full_rows = None
        if self.paged:
            ps = self.page_size
            self._free_rows(slot_ids)
            mp = self._host_table.shape[1]
            head = self.spec_k + 1 if self.spec_k else 0
            full_rows = np.zeros((n_real, mp), np.int32)
            try:
                for i, b in enumerate(budgets):
                    need = pages_needed(T + int(b) + head, ps)
                    full_rows[i, :need] = self.allocator.alloc(need)
            except MemoryError:
                self.allocator.free(full_rows[full_rows != 0].tolist())
                raise
            self._host_table[slot_ids] = full_rows

        packed = pack_sampling_params(list(sampling[:n_real]) if sampling is not None else None,
                                      n_real)
        if packed is None:
            packed = (np.zeros((n_real, 2), np.uint32), np.zeros((n_real,), np.float32),
                      np.zeros((n_real,), np.int32), np.ones((n_real,), np.float32))
        rngs, temps, top_ks, top_ps = sampling_tensors(packed, dev)

        tmp = init_kv_cache(self.cfg, n_real, T, dtype=self.cache_dtype, device=dev, tp=self.tp)
        out = llama_forward(self.params, self.cfg, inputs_embeds=embeds, attn_mask=mask,
                            kv_cache=tmp, cache_offset=0, last_logit_only=True,
                            tp_group=self.tp_group)
        self.counts["prefills"] += 1
        lens = mask.to(torch.int32).sum(dim=1)
        pads = (T - lens).to(torch.int32)
        logits = out.logits[:, -1]
        if (packed[1] > 0).any():
            # the first token draws at the row's unpadded position lens - 1
            first = sample_rows(logits, rngs, lens - 1, temps, top_ks, top_ps)
        else:
            first = torch.argmax(logits, dim=-1).to(torch.int32)

        ids = self._ids(slot_ids)
        s = self.state
        if self.paged:
            ps = self.page_size
            tail = (-T) % ps  # prompts pad right up to a page multiple

            def pad_t(x):  # (L, n, Hkv, T, ...) → T padded to a page multiple
                if not tail:
                    return x
                return torch.nn.functional.pad(x, (0, 0, 0, tail) if x.dim() == 5 else (0, tail))

            n_data = (T + tail) // ps
            pages = torch.from_numpy(full_rows[:, :n_data].copy()).to(dev)
            scales = {}
            if tmp.quantized:
                scales = dict(k_scales=pad_t(tmp.k_scale).transpose(2, 3),
                              v_scales=pad_t(tmp.v_scale).transpose(2, 3))
            write_prefill_pages_batch(s.cache, slot_ids, pages, pad_t(tmp.k).transpose(2, 3),
                                      pad_t(tmp.v).transpose(2, 3), pads, **scales)
            # the table row carries the whole reservation (prompt + budget)
            s.cache.page_table[ids] = torch.from_numpy(full_rows).to(dev)
        else:
            cache = s.cache
            cache.k[:, ids, :, :T] = tmp.k
            cache.v[:, ids, :, :T] = tmp.v
            if cache.quantized:
                cache.k_scale[:, ids, :, :T] = tmp.k_scale
                cache.v_scale[:, ids, :, :T] = tmp.v_scale
        budgets_t = torch.from_numpy(budgets.astype(np.int32)).to(dev)
        s.pad_lens[ids] = pads
        s.offsets[ids] = T
        s.last_token[ids] = first
        s.done[ids] = (first == self.eos_id) | (budgets_t <= 1)
        s.tokens[ids] = self.eos_id
        s.tokens[ids, 0] = first
        s.n_emitted[ids] = 1
        s.budgets[ids] = budgets_t
        if s.seen.shape[1] > 1:
            s.seen[ids] = False
            s.seen[ids, first.long()] = True
        s.rng[ids] = rngs
        s.temps[ids] = temps
        s.top_ks[ids] = top_ks
        s.top_ps[ids] = top_ps

        self._bound[slot_ids] = T + budgets - 1
        self._temps[slot_ids] = packed[1]
        done, bud, emitted = self._mirror
        done[slot_ids] = False
        bud[slot_ids] = budgets
        emitted[slot_ids] = 1

    def _free_rows(self, rows) -> None:
        """Return ``rows``' pages to the allocator (host mirror only; the
        device table rows are zeroed by ``_release_rows`` or overwritten by
        the next admission)."""
        for s in rows:
            held = self._host_table[s]
            self.allocator.free(held[held != 0].tolist())
            self._host_table[s] = 0

    def _release_rows(self, slot_ids: List[int], set_done: bool) -> None:
        """budgets → 0 (+ done for a cancel) and, paged, zero the rows'
        device table: done rows keep writing their last K/V every step, and
        a stale table entry would let them corrupt pages re-allocated to
        live requests; zeroed rows write the null page 0."""
        ids = self._ids(slot_ids)
        s = self.state
        s.budgets[ids] = 0
        if set_done:
            s.done[ids] = True
        if self.paged:
            s.cache.page_table[ids] = 0
        self._temps[slot_ids] = 0.0
        done, bud, _ = self._mirror
        bud[slot_ids] = 0
        done[slot_ids] = True

    def harvest(self, flags: Optional[Tuple[np.ndarray, ...]] = None
                ) -> List[Tuple[int, np.ndarray, int]]:
        """(slot, tokens, n) for every finished row with pending output;
        frees their slots. Pass ``flags`` from ``sync_flags()`` or the
        4-tuple ``decode_chunk(return_flags=True)`` returns (whose token
        copy avoids another device read)."""
        if flags is None:
            flags = self.sync_flags()
        done, budgets, counts_all = flags[0], flags[1], flags[2]
        ready = np.nonzero(done & (budgets > 0))[0]
        if ready.size == 0:
            return []
        if len(flags) > 3:
            tokens = flags[3][ready]
        else:
            tokens = self.state.tokens[self._ids(ready.tolist())].cpu().numpy()
        counts = counts_all[ready]
        rows = ready.tolist()
        if self.paged:
            self._free_rows(rows)
        self._release_rows(rows, set_done=False)
        return [(int(s), tokens[i], int(counts[i])) for i, s in enumerate(ready)]

    def cancel(self, slot_ids: List[int]) -> None:
        """Release ``slot_ids`` now (client gone, deadline passed): done
        with no pending output, pages back to the pool."""
        if not slot_ids:
            return
        if self.paged:
            self._free_rows(list(slot_ids))
        self._release_rows(list(slot_ids), set_done=True)

    # ------------------------------------------------------------------

    def decode_chunk(self, k_steps: int = 8, return_flags: bool = False, spec: bool = False):
        """Advance all live slots up to ``k_steps`` steps, or ``k_steps``
        speculative rounds with ``spec=True`` (requires ``spec_k > 0``;
        greedy rows only), never more than the longest remaining budget
        needs. Ends with one device→host read of the flags and tokens;
        ``return_flags=True`` returns them as (done, budgets, n_emitted,
        tokens)."""
        done, budgets, emitted = self._mirror
        live = ~done & (budgets > 0)
        remaining = int((budgets - emitted)[live].max()) if live.any() else 0
        n = max(0, min(int(k_steps), remaining))
        use_spec = spec and self.spec_k > 0
        ran = 0
        while ran < n:
            ran += 1
            if not use_spec:
                self._step()
                continue
            self._spec_round()
            # a round commits up to spec_k + 1 tokens, so the budget bound
            # above overestimates: stop once every row is done (one read
            # per round, against a (spec_k + 1)-token forward)
            if bool(self.state.done.all()):
                break
        self.last_chunk_steps = ran
        s = self.state
        t0 = time.perf_counter()
        fused = torch.cat([s.done.to(torch.int32)[:, None], s.budgets[:, None],
                           s.n_emitted[:, None], s.tokens], dim=1).cpu().numpy().copy()
        self.last_read_s = time.perf_counter() - t0  # the wait for the chunk's device work
        flags = (fused[:, 0].astype(bool), fused[:, 1], fused[:, 2], fused[:, 3:])
        self._mirror = (flags[0].copy(), flags[1].copy(), flags[2].copy())
        return flags if return_flags else None

    def _forward(self, ids: torch.Tensor, positions: torch.Tensor):
        s = self.state
        if self.paged:
            return llama_forward(self.params, self.cfg, input_ids=ids, positions=positions,
                                 kv_cache=s.cache, tp_group=self.tp_group)
        return llama_forward(self.params, self.cfg, input_ids=ids, positions=positions,
                             kv_cache=s.cache, cache_offset=s.offsets, kv_pad_lens=s.pad_lens,
                             cache_offset_bound=int(self._bound.max()), tp_group=self.tp_group)

    def _step(self) -> None:
        s = self.state
        eos = self.eos_id
        out = self._forward(s.last_token[:, None], (s.offsets - s.pad_lens)[:, None])
        self.counts["steps"] += 1
        logits = out.logits[:, 0]
        rep = self.repetition_penalty
        if rep != 1.0:
            pen = torch.where(logits > 0, logits / rep, logits * rep)
            logits = torch.where(s.seen, pen, logits)
        if (self._temps > 0).any():
            nxt = sample_rows(logits, s.rng, s.offsets - s.pad_lens, s.temps, s.top_ks,
                              s.top_ps)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(s.done, torch.full_like(nxt, eos), nxt)
        emit = ~s.done
        col = torch.clamp(s.n_emitted.long(), max=self.max_new - 1)[:, None]
        s.tokens.scatter_(1, col, torch.where(emit[:, None], nxt[:, None], s.tokens.gather(1, col)))
        s.n_emitted.add_(emit.to(torch.int32))
        s.done.copy_(s.done | (nxt == eos) | (s.n_emitted >= s.budgets))
        # done rows stop advancing: their slot is re-written in place,
        # outside every live window
        s.offsets.add_(emit.to(torch.int32))
        if rep != 1.0:
            s.seen[torch.arange(self.n_slots, device=self.device), nxt.long()] = True
        s.last_token.copy_(nxt)

    def _spec_round(self) -> None:
        s = self.state
        K = self.spec_k
        draft = _ngram_propose(s.tokens, s.n_emitted, s.last_token, K)
        seq = torch.cat([s.last_token[:, None], draft], dim=1)
        positions = (s.offsets - s.pad_lens)[:, None] + torch.arange(
            K + 1, dtype=torch.int32, device=self.device)[None, :]
        out = self._forward(seq, positions)
        self.counts["spec_rounds"] += 1
        preds = torch.argmax(out.logits, dim=-1).to(torch.int32)
        _, n_add, last, done, _ = commit_verified_drafts(
            preds, draft, s.tokens, s.n_emitted, s.budgets, s.done, s.last_token, self.eos_id)
        s.n_emitted.add_(n_add)
        # advancing by n_add keeps exactly the consumed fed slots inside the
        # valid window; the rejected tail is overwritten next round
        s.offsets.add_(n_add)
        s.last_token.copy_(last)
        s.done.copy_(done)
