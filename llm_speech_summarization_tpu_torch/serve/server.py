"""Serving stack: batching engines + HTTP server (port of ``serve/server.py``).

  * ``BatchingEngine``: request-level dynamic batching; a scheduler thread
    drains up to ``max_batch`` compatible requests (same kind / text prompt /
    budget bucket) per engine call, the next wave's prompts built on a
    builder thread meanwhile;
  * ``ContinuousBatchingEngine``: decode-step-level continuous batching
    over a ``SlotDecoder`` (``infer/slots.py``), dense or paged, with
    speculative chunks gated by measured draft acceptance;
  * ``SummarizationServer``: a stdlib ThreadingHTTPServer exposing
      POST /v1/audio_summary   {"audio": [f32...] | "audio_b64": <i16 pcm>,
                                "sample_rate": 16000, "text_prompt": "",
                                "max_new_tokens": 128, "stream": false,
                                "temperature": 0, "top_k": 0, "top_p": 1,
                                "seed": null}
      POST /v1/text_response   {"text": "...", "max_new_tokens": 128, ...}
      GET  /healthz, /metrics
    JSON in and out; ``"stream": true`` (continuous scheduler) answers with
    chunked ndjson: {"delta": ...} per decode chunk, then {"done": true,
    "response": ...}.

The builder thread (prompt build: host upload + audio encoder) and the
scheduler thread (admission + decode chunks) launch work on the device's
current stream, which PyTorch shares between threads, so a built wave is
ordered before the admission that reads it. Each worker thread enters
``torch.no_grad`` itself: the grad mode is per thread.

Where the JAX scheduler dispatches chunk i+1 before reading chunk i's flags
(and guards the reads that went stale meanwhile), this one reads each
chunk's flags when the chunk ends: an eager chunk's host dispatch is most
of its time, so there is no device round trip to hide behind it.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import check_engine_device
from ..models.mla_moe import MlaMoeConfig, not_ported


@dataclass
class _Request:
    kind: str  # "audio" | "text"
    payload: Any  # waveform np.ndarray | str
    text_prompt: str
    max_new_tokens: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[str] = None
    error: Optional[str] = None
    # streaming (continuous scheduler only): text deltas arrive on
    # ``partials`` after every decode chunk; None closes the stream
    stream: bool = False
    partials: "queue.Queue" = field(default_factory=queue.Queue)
    _sent: int = 0  # chars already streamed
    # set when the requester gives up (submit timeout, client disconnect):
    # the continuous scheduler releases the slot at the next chunk boundary
    cancelled: threading.Event = field(default_factory=threading.Event)
    # per-request sampling: temperature 0 = greedy; seed makes it replayable
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    # host clock at creation, and when its first tokens reached the host
    # (the end of the first decode chunk it was live in)
    t_submit: float = field(default_factory=time.monotonic)
    t_first_token: Optional[float] = None

    @property
    def sampling_tuple(self):
        if self.temperature <= 0.0:
            return None
        return (self.temperature, self.top_k, self.top_p,
                self.seed if self.seed is not None else 0)

    @property
    def group_key(self):
        # bucket token budgets so requests with similar budgets co-batch
        budget = ((self.max_new_tokens + 63) // 64) * 64
        return (self.kind, self.text_prompt, budget)


def _fail(reqs, message: str) -> None:
    for r in reqs:
        r.error = message
        if r.stream:
            r.partials.put(None)
        r.event.set()


class BatchingEngine:
    """Request-level dynamic batcher over an ``LLMSpeechTextInference``."""

    def __init__(self, engine, max_batch: int = 32, max_wait_ms: float = 20.0, device=None):
        check_engine_device("BatchingEngine", engine.device, device)
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # incompatible requests popped during a drain park here and lead the
        # next wave, so a steady same-group stream cannot starve them
        self._carry: List[_Request] = []
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: _Request, timeout: float = 300.0) -> str:
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._queue.put(req)
            if not req.event.wait(timeout):
                raise TimeoutError("generation timed out")
            if req.error:
                raise RuntimeError(req.error)
            return req.result  # type: ignore[return-value]
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def idle(self) -> bool:
        """True when no request is queued or mid-generate (drain probe)."""
        return self._inflight == 0 and self._queue.empty()

    def warmup(self, audio_seconds=(10.0,)) -> None:
        """Run one wave of each power-of-two batch size up to ``max_batch``
        before serving: the kernels build at their first launch and the
        allocator grows its pools, outside live traffic."""
        from ..infer.engine import DECODE_BUCKET, _pad_batch

        sr = self.engine.config.audio.sampling_rate
        ladder, b = [], 1
        while b <= _pad_batch(self.max_batch):
            ladder.append(b)
            b *= 2
        with torch.no_grad():
            for secs in audio_seconds:
                wav = np.zeros(int(secs * sr), np.float32)
                for B in ladder:
                    embeds, mask = self.engine.build_audio_prompt_batch([wav] * B)
                    self.engine._generate_from_embeds(embeds, mask, DECODE_BUCKET)

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _drain_compatible(self, first: _Request) -> List[_Request]:
        batch = [first]
        still: List[_Request] = []
        for r in self._carry:
            if len(batch) < self.max_batch and r.group_key == first.group_key:
                batch.append(r)
            else:
                still.append(r)
        self._carry = still
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req.group_key == first.group_key:
                batch.append(req)
            else:
                self._carry.append(req)
        return batch

    def _build_wave(self):
        """Drain one compatible wave and build its prompts. Returns None on
        an empty queue, else (batch, embeds, mask, budget, sampling, error);
        a build failure fails only that wave."""
        with torch.no_grad():
            if self._carry:
                first = self._carry.pop(0)
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    return None
            batch = self._drain_compatible(first)
            budget = max(r.max_new_tokens for r in batch)
            sampling = [r.sampling_tuple for r in batch]
            if all(s is None for s in sampling):
                sampling = None
            try:
                if first.kind == "text":
                    embeds, mask = self.engine.build_text_prompt_batch([r.payload for r in batch])
                else:
                    embeds, mask = self.engine.build_audio_prompt_batch(
                        [r.payload for r in batch], additional_text_prompt=first.text_prompt)
            except Exception as e:  # noqa: BLE001 — fail the wave, not the loop
                return batch, None, None, budget, sampling, f"{type(e).__name__}: {e}"
            return batch, embeds, mask, budget, sampling, None

    def _finish(self, wave) -> None:
        batch, embeds, mask, budget, sampling, err = wave
        try:
            if err is None:
                outs = self.engine._generate_from_embeds(embeds, mask, budget,
                                                         sampling=sampling)[: len(batch)]
                for r, out in zip(batch, outs):
                    r.result = out
            else:
                for r in batch:
                    r.error = err
        except Exception as e:  # noqa: BLE001 — surface per request
            traceback.print_exc()
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
        finally:
            self.batches_run += 1
            self.requests_served += len(batch)
            for r in batch:
                r.event.set()

    def _loop(self):
        # wave i+1's prompt build runs on the builder thread while wave i
        # decodes; only when requests are already queued, so that an empty
        # queue keeps the next wave's drain window open
        builder = ThreadPoolExecutor(max_workers=1)
        fut = None
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    wave = fut.result() if fut is not None else self._build_wave()
                    fut = builder.submit(self._build_wave) if not self._queue.empty() else None
                    if wave is not None:
                        self._finish(wave)
                if fut is not None:
                    wave = fut.result()
                    if wave is not None:
                        _fail(wave[0], "server shutting down")
        finally:
            builder.shutdown(wait=False)


class _SpecGovernor:
    """Adaptive speculative-chunk gating, host-side. A round pays only when
    drafts are accepted, and acceptance depends on the weights and the
    traffic, so it is measured live: a spec chunk's per-row emitted-token
    excess over one per round is the accepted-draft bonus. Below
    ``threshold`` the scheduler runs plain chunks and probes with a spec
    chunk every ``probe_every`` chunks."""

    def __init__(self, spec_k: int, threshold: float = 0.05,
                 probe_every: int = 32, ema_decay: float = 0.7):
        self.spec_k = spec_k
        self.threshold = threshold
        self.probe_every = probe_every
        self.ema_decay = ema_decay
        self.acceptance = 3.0 * threshold  # optimistic start: try spec first
        self._chunks_since_probe = 0

    def want_spec(self) -> bool:
        if self.acceptance >= self.threshold:
            return True
        self._chunks_since_probe += 1
        if self._chunks_since_probe >= self.probe_every:
            self._chunks_since_probe = 0
            return True
        return False

    def observe(self, rounds: int, deltas) -> None:
        """``deltas``: emitted-token deltas across one spec chunk of
        ``rounds`` rounds for rows live before it (rows that finished inside
        it count as a lower bound)."""
        if not deltas or rounds <= 0:
            return
        bonus = [max(0.0, d - rounds) / (rounds * self.spec_k) for d in deltas]
        m = sum(bonus) / len(bonus)
        self.acceptance = self.ema_decay * self.acceptance + (1.0 - self.ema_decay) * m


class ContinuousBatchingEngine:
    """Decode-step-level continuous batching: requests are admitted into
    free slots between decode chunks, and rows that hit EOS or their budget
    return at once."""

    def __init__(
        self,
        engine,
        n_slots: int = 32,
        chunk_steps: int = 16,
        max_prompt_len: int = 512,
        max_new_tokens: int = 256,
        max_admit: int = 8,
        admit_wait_ms: float = 100.0,
        paged: bool = False,
        max_chunk_steps: int = 64,
        num_pages: Optional[int] = None,
        spec_k: int = 0,
        device=None,
    ):
        from ..infer.slots import SlotDecoder
        from .model_group import ModelGroupDecoder

        dev = check_engine_device("ContinuousBatchingEngine", engine.device, device)
        if isinstance(engine.llm_cfg, MlaMoeConfig):
            raise not_ported("the continuous-batching (slot and paged) server", engine.llm_cfg)
        self.engine = engine
        rep = getattr(engine, "repetition_penalty", 1.0)
        if spec_k > 0 and rep != 1.0:
            print(f"speculative chunks disabled: incompatible with repetition_penalty={rep}")
            spec_k = 0
        self.chunk_steps = chunk_steps
        # adaptive ceiling (_pick_chunk): chunks grow toward it by powers of
        # two when no stream or admission wants a near boundary
        self.max_chunk_steps = max(max_chunk_steps, chunk_steps)
        self.max_admit = min(max_admit, n_slots)  # a wave must fit the slots
        self.admit_wait_s = admit_wait_ms / 1000.0
        decoder_kwargs = dict(
            eos_id=engine.tokenizer.eos_id, n_slots=n_slots, max_prompt_len=max_prompt_len,
            max_new_tokens=max_new_tokens, cache_dtype=engine.cache_dtype,
            repetition_penalty=rep, paged=paged, num_pages=num_pages, spec_k=spec_k,
        )
        # on a model group (tensor parallelism) rank 0's decoder mirrors its
        # calls on the other ranks, which run serve/model_group.py's follow()
        self._tp = getattr(engine, "tp", 1) > 1
        if self._tp:
            self.decoder = ModelGroupDecoder(engine, **decoder_kwargs)
        else:
            self.decoder = SlotDecoder(engine.llm_params, engine.llm_cfg, device=dev,
                                       **decoder_kwargs)
        self.spec_governor = _SpecGovernor(spec_k) if spec_k > 0 else None
        self._spec_prev: Dict[int, tuple] = {}  # slot → (req, n_emitted)
        # LSS_SCHED_TRACE=1: one stderr line per scheduler iteration that did
        # work, with its phases' host walls (admission, chunk dispatch, the
        # chunk's flag read), and one per builder wave; host clocks only, so
        # the trace adds no device work and no synchronisation
        self._trace = os.environ.get("LSS_SCHED_TRACE") == "1"
        self._iter = 0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._prepared: "queue.Queue" = queue.Queue()
        self._pending_wave = None
        self._building = False  # the builder popped requests it has not staged yet
        self._by_slot: Dict[int, _Request] = {}
        self._stop = threading.Event()
        self.batches_run = 0  # decode chunks run
        self.requests_served = 0
        self._loop_errors = 0
        # host clock over decode chunks (each ends in its flag read) and the
        # steps or rounds they ran: the per-step cost /metrics reports
        self.chunk_seconds = 0.0
        self.chunk_steps_run = 0
        # seconds from a request's creation to its first tokens on the host
        # (the time to first token a streaming client sees, before
        # detokenization), for the latest requests
        self.first_token_s: deque = deque(maxlen=4096)
        self._builder = threading.Thread(target=self._build_loop, daemon=True)
        self._builder.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: _Request, timeout: float = 300.0) -> str:
        self._queue.put(req)
        if not req.event.wait(timeout):
            # nobody will read the result: free the slot at the next chunk
            req.cancelled.set()
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result  # type: ignore[return-value]

    def idle(self) -> bool:
        """True when nothing is queued, mid-build, staged or decoding."""
        return (
            not self._building
            and self._queue.empty()
            and self._prepared.qsize() == 0
            and self._pending_wave is None
            and not self._by_slot
        )

    def warmup(self, audio_seconds=(10.0,), timeout: float = 600.0) -> None:
        """One wave of each power-of-two admission size up to ``max_admit``,
        then one full-budget request on plain chunks, through the real queue:
        every kernel is built and the allocator's pools grown before live
        traffic. The speculative governor is frozen meanwhile (budget-2
        dummy rows would read as acceptance 0)."""
        sr = self.engine.config.audio.sampling_rate
        if isinstance(audio_seconds, (int, float)):
            audio_seconds = (float(audio_seconds),)
        sizes, n = [], 1
        while n <= self.max_admit:
            sizes.append(n)
            n *= 2
        gov = self.spec_governor
        saved = (gov.acceptance, gov.probe_every) if gov is not None else None
        try:
            for sec in audio_seconds:
                wav = np.zeros(int(sec * sr), np.float32)
                for size in sizes:
                    reqs = [_Request(kind="audio", payload=wav, text_prompt="", max_new_tokens=2)
                            for _ in range(size)]
                    threads = [threading.Thread(target=self.submit, args=(r, timeout))
                               for r in reqs]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout)
            if gov is not None:
                gov.acceptance, gov.probe_every = 0.0, 10**9
            wav = np.zeros(int(float(audio_seconds[0]) * sr), np.float32)
            self.submit(_Request(kind="audio", payload=wav, text_prompt="",
                                 max_new_tokens=self.decoder.max_new), timeout=timeout)
        finally:
            if gov is not None:
                gov.acceptance, gov.probe_every = saved
                gov._chunks_since_probe = 0

    def shutdown(self):
        self._stop.set()
        self._builder.join(timeout=5)
        # on a model group the scheduler's last call stops the followers
        self._thread.join(timeout=120 if self._tp else 5)
        if self._tp and self._thread.is_alive():
            raise RuntimeError("the scheduler did not stop; the model group's followers "
                               "were not told to")

    # ------------------------------------------------------------------

    def _build_loop(self):
        """Builder thread: coalesce queued requests into waves (up to
        ``admit_wait_ms``) and build their prompts off the scheduler thread,
        so the next wave's encoder forward overlaps the current chunks."""
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._building = True  # visible to idle(): popped, not yet staged
                try:
                    self._build_pending(first)
                finally:
                    self._building = False

    def _build_pending(self, first: _Request):
        pending = [first]
        deadline = time.monotonic() + self.admit_wait_s
        while len(pending) < self.max_admit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                pending.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        ok = []
        for r in pending:
            if r.cancelled.is_set():
                r.event.set()  # the requester gave up while queued
            elif r.max_new_tokens < 1 or r.max_new_tokens > self.decoder.max_new:
                # < 1 would admit a budget-0 slot that is never harvested;
                # > the budget would silently truncate
                _fail([r], f"max_new_tokens {r.max_new_tokens} outside this server's "
                           f"budget [1, {self.decoder.max_new}]")
            else:
                ok.append(r)
        groups: Dict[Any, List[_Request]] = {}
        for r in ok:
            groups.setdefault((r.kind, r.text_prompt), []).append(r)
        for (kind, text_prompt), reqs in groups.items():
            t0 = time.monotonic()
            try:
                if kind == "text":
                    embeds, mask = self.engine.build_text_prompt_batch([r.payload for r in reqs])
                else:
                    embeds, mask = self.engine.build_audio_prompt_batch(
                        [r.payload for r in reqs], additional_text_prompt=text_prompt)
                # the builders pad B to a power of two; admit() prefills
                # only the leading real rows
                self._prepared.put((embeds, mask, reqs))
                if self._trace:
                    print(f"[build] wave n={len(reqs)} kind={kind} "
                          f"wall={time.monotonic() - t0:.3f}s", file=sys.stderr, flush=True)
            except Exception as e:  # noqa: BLE001 — surface per request
                _fail(reqs, f"{type(e).__name__}: {e}")

    def _admit_wave(self, flags):
        """Admit prepared waves into free slots (prefill only). ``flags`` is
        the host copy of (done, budgets, n_emitted); admission updates it in
        place so that _pick_chunk sees the new rows."""
        done, budgets, counts = flags[0], flags[1], flags[2]
        while True:
            if self._pending_wave is None:
                try:
                    self._pending_wave = self._prepared.get_nowait()
                except queue.Empty:
                    return
            embeds, mask, reqs = self._pending_wave
            if all(r.cancelled.is_set() for r in reqs):
                _fail(reqs, "cancelled")
                self._pending_wave = None
                continue
            free = [s for s in self.decoder.free_slots(done) if s not in self._by_slot]
            if len(free) < len(reqs):
                return  # wait for slots; decode keeps running
            slots = free[: len(reqs)]
            try:
                self.decoder.admit(embeds, mask, slots, [r.max_new_tokens for r in reqs],
                                   sampling=[r.sampling_tuple for r in reqs])
                for s, r in zip(slots, reqs):
                    self._by_slot[s] = r
                    done[s] = False
                    budgets[s] = min(r.max_new_tokens, self.decoder.max_new)
                    counts[s] = 1
                    if self.spec_governor is not None:
                        self._spec_prev[s] = (r, 1)
            except MemoryError as e:
                # paged pool full: defer the wave until harvested rows free
                # pages (next chunk boundary)
                if self._by_slot:
                    return
                if len(reqs) > 1:
                    # an empty pool still overflows on the whole wave: admit
                    # the half that fits now, queue the rest behind it
                    k = len(reqs) // 2
                    self._prepared.put((embeds[k:], mask[k:], reqs[k:]))
                    self._pending_wave = (embeds[:k], mask[:k], reqs[:k])
                    continue
                # one request that cannot fit an empty pool never will
                _fail(reqs, f"MemoryError: {e}")
            except Exception as e:  # noqa: BLE001 — fail the wave, not the loop
                _fail(reqs, f"{type(e).__name__}: {e}")
            self._pending_wave = None

    def _pick_chunk(self, flags) -> int:
        """Base ``chunk_steps`` while streams or admissions want a near
        boundary; otherwise powers of two up to the least remaining budget
        among live rows."""
        done, budgets, counts = flags[0], flags[1], flags[2]
        live = (~done) & (budgets > 0)
        if not live.any():
            return self.chunk_steps
        if any(r.stream for r in self._by_slot.values()):
            return self.chunk_steps
        if self._pending_wave is not None or not self._prepared.empty() or not self._queue.empty():
            return self.chunk_steps
        remaining = int((budgets - counts)[live].min())
        k = self.chunk_steps
        while k * 2 <= remaining and k * 2 <= self.max_chunk_steps:
            k *= 2
        return k

    def _loop(self):
        tok = self.engine.tokenizer
        flags = None
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    flags = self._loop_iteration(tok, flags)
                except Exception as e:  # noqa: BLE001 — keep the scheduler alive
                    # fail every in-flight request loudly, release their
                    # slots, and resume from a fresh read of the flags
                    traceback.print_exc()
                    self._loop_errors += 1
                    live = list(self._by_slot.items())
                    self._by_slot.clear()
                    self._pending_wave = None
                    _fail([r for _, r in live], f"scheduler error: {type(e).__name__}: {e}")
                    try:
                        if live:
                            self.decoder.cancel([s for s, _ in live])
                    except Exception:  # noqa: BLE001 — the device may still be sick
                        traceback.print_exc()
                    flags = None
                    self._spec_prev = {}
                    time.sleep(0.1)
            if self._tp:
                self.decoder.stop()

    def _loop_iteration(self, tok, flags):
        self._iter += 1
        t_iter0 = time.monotonic()
        if flags is None:
            flags = self.decoder.sync_flags()
        # release cancelled requests' slots before admission reuses them
        dead = [s for s, r in self._by_slot.items() if r.cancelled.is_set()]
        if dead:
            self.decoder.cancel(dead)
            for s in dead:
                r = self._by_slot.pop(s)
                flags[0][s] = True
                flags[1][s] = 0
                self._spec_prev.pop(s, None)
                if r.stream:
                    r.partials.put(None)
                r.event.set()
        t_admit0 = time.monotonic()
        self._admit_wave(flags)
        t_admit = time.monotonic() - t_admit0
        if not self._by_slot:
            # idle: the flag copy is exact (harvest and cancel reconciled
            # every slot), so wait for admission work without device reads
            while not self._stop.is_set() and self._prepared.qsize() == 0 \
                    and self._pending_wave is None:
                if self._tp:
                    self.decoder.keepalive()
                time.sleep(0.002)
            if self._trace and t_admit > 1e-3:
                self._trace_line(0, t_admit, 0.0, 0.0, t_iter0)
            return flags
        k = self._pick_chunk(flags)
        # speculative chunks verify greedy streams: only when every live
        # request is greedy and the governor says the rounds pay; one chunk
        # length for them (rounds commit several tokens each)
        spec = (self.decoder.spec_k > 0
                and all(r.sampling_tuple is None for r in self._by_slot.values())
                and self.spec_governor.want_spec())
        if spec:
            k = self.chunk_steps
        t0 = time.perf_counter()
        actual = self.decoder.decode_chunk(k, return_flags=True, spec=spec)
        t_chunk = time.perf_counter() - t0
        self.chunk_seconds += t_chunk
        self.chunk_steps_run += self.decoder.last_chunk_steps
        self.batches_run += 1
        now = time.monotonic()
        for r in self._by_slot.values():
            if r.t_first_token is None:
                r.t_first_token = now
                self.first_token_s.append(now - r.t_submit)
        if self.spec_governor is not None:
            if spec:
                deltas = [int(actual[2][s]) - prev_n
                          for s, (prev_r, prev_n) in self._spec_prev.items()
                          if self._by_slot.get(s) is prev_r]
                self.spec_governor.observe(self.decoder.last_chunk_steps, deltas)
            self._spec_prev = {s: (r, int(actual[2][s])) for s, r in self._by_slot.items()
                               if not actual[0][s]}
        self._emit_partials(actual)
        for slot, tokens, n in self.decoder.harvest(actual):
            req = self._by_slot.pop(slot, None)
            actual[0][slot] = True
            actual[1][slot] = 0
            if req is None:
                continue
            n = min(n, req.max_new_tokens)
            req.result = tok.decode(tokens[:n].tolist(), skip_special_tokens=True)
            if req.stream:
                tail = req.result[req._sent:]
                if tail:
                    req.partials.put(tail)
                req.partials.put(None)  # end of stream
            self.requests_served += 1
            req.event.set()
        if self._trace:
            t_read = self.decoder.last_read_s
            self._trace_line(k, t_admit, t_chunk - t_read, t_read, t_iter0)
        return actual[:3]

    def _trace_line(self, k, t_admit, t_disp, t_read, t_iter0):
        """The LSS_SCHED_TRACE line of one iteration (the JAX scheduler's
        fields; ``read`` is the wait for the chunk's flags, which this
        scheduler reads when the chunk ends)."""
        print(f"[sched] it={self._iter} live={len(self._by_slot)} k={k} "
              f"admit={t_admit:.3f}s dispatch={t_disp:.3f}s read={t_read:.3f}s "
              f"total={time.monotonic() - t_iter0:.3f}s", file=sys.stderr, flush=True)

    def _emit_partials(self, flags):
        """Stream text deltas for live streaming slots after each chunk,
        from the chunk's host copy of the tokens: the full prefix is
        decoded again and the client gets what it has not seen."""
        tok = self.engine.tokenizer
        for s, r in self._by_slot.items():
            if not r.stream or flags[0][s]:
                continue
            n = min(int(flags[2][s]), r.max_new_tokens)
            text = tok.decode(flags[3][s][:n].tolist(), skip_special_tokens=True)
            if text.endswith("�"):
                # a chunk boundary split a multi-byte character: hold the
                # delta until the prefix decodes cleanly
                continue
            if len(text) > r._sent:
                r.partials.put(text[r._sent:])
                r._sent = len(text)


def _decode_audio(body: Dict[str, Any], target_sr: int) -> np.ndarray:
    from ..data import native

    if "audio_b64" in body:
        pcm = np.frombuffer(base64.b64decode(body["audio_b64"]), np.int16)
        wav = native.pcm16_to_f32_mono(pcm)
    elif "audio" in body:
        wav = np.asarray(body["audio"], np.float32)
    else:
        raise ValueError("request needs 'audio' or 'audio_b64'")
    sr = int(body.get("sample_rate", target_sr))
    if sr != target_sr:
        wav = native.resample(wav, sr, target_sr)
    return wav


def _dispatch_latency_ms(device) -> float:
    """Measured round trip of a tiny device op and its host read (ms): the
    continuous scheduler pays about one per chunk boundary."""
    x = torch.zeros((8,), dtype=torch.int32, device=device)
    (x + 1).cpu()  # warm
    t0 = time.monotonic()
    for _ in range(3):
        (x + 1).cpu()
    return (time.monotonic() - t0) / 3 * 1000.0


class SummarizationServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: int = 32, max_wait_ms: float = 20.0,
                 continuous="auto", n_slots: int = 32,
                 chunk_steps: int = 16, max_new_tokens: int = 256,
                 max_prompt_len: int = 512, paged: bool = False,
                 num_pages: Optional[int] = None, spec_k: int = 0,
                 admit_wait_ms: Optional[float] = None,
                 max_body_bytes: int = 64 * 1024 * 1024, device=None):
        """``device=None`` means the CUDA card and raises without one; the
        engine must live on the resolved device. ``continuous="auto"`` picks
        the scheduler by the measured device round trip (continuous under
        100 ms)."""
        dev = check_engine_device("SummarizationServer", engine.device, device)
        self.max_new_cap = max_new_tokens
        self.max_body_bytes = max_body_bytes
        if getattr(engine, "tp", 1) > 1:
            # a model group serves through the continuous scheduler, whose
            # decoder calls its followers mirror
            if continuous is False:
                raise ValueError("a tensor-parallel engine serves through the continuous "
                                 "scheduler; the request-level one is not run on a model group")
            continuous = True
        if continuous == "auto":
            lat = _dispatch_latency_ms(dev)
            continuous = lat < 100.0
            self.scheduler_reason = (
                f"auto: dispatch {lat:.1f} ms → {'continuous' if continuous else 'request-level'}")
        else:
            self.scheduler_reason = f"forced: continuous={bool(continuous)}"
        if continuous:
            extra = {} if admit_wait_ms is None else {"admit_wait_ms": admit_wait_ms}
            self.batcher = ContinuousBatchingEngine(
                engine, n_slots=n_slots, chunk_steps=chunk_steps, max_admit=max_batch,
                max_new_tokens=max_new_tokens, max_prompt_len=max_prompt_len, paged=paged,
                num_pages=num_pages, spec_k=spec_k, device=dev, **extra,
            )
        else:
            self.batcher = BatchingEngine(engine, max_batch, max_wait_ms, device=dev)
        self.target_sr = engine.config.audio.sampling_rate
        self._started = time.monotonic()
        self._draining = False
        self.warmup = self.batcher.warmup
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # chunked streaming responses

            def log_message(self, fmt, *args):  # quiet
                pass

            def _stream(self, req: _Request):
                """Chunked ndjson: {"delta": ...} per decode chunk, then
                {"done": true, "response": ...} (or {"error": ...})."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write(obj):
                    data = json.dumps(obj).encode() + b"\n"
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()

                # the headers are out: no exception may reach do_POST's
                # handler, which would write a second status line
                try:
                    while True:
                        piece = req.partials.get(timeout=600)
                        if piece is None:
                            break
                        write({"delta": piece})
                    req.event.wait(timeout=10)
                    if req.error:
                        write({"error": req.error})
                    else:
                        write({"done": True, "response": req.result})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    req.cancelled.set()  # client gone: free the slot
                except Exception as e:  # noqa: BLE001
                    try:
                        write({"error": f"{type(e).__name__}: {e}"})
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except OSError:
                        pass

            def _respond(self, code: int, obj: Dict[str, Any]):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    # 503 while draining: load balancers deroute the pod
                    self._respond(503 if outer._draining else 200, {
                        "status": "draining" if outer._draining else "ok",
                        "batches_run": outer.batcher.batches_run,
                        "requests_served": outer.batcher.requests_served,
                    })
                elif self.path == "/metrics":
                    self._respond(200, outer.metrics())
                else:
                    self._respond(404, {"error": "not found"})

            def do_POST(self):
                if outer._draining:
                    self._respond(503, {"error": "server draining"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length > outer.max_body_bytes:
                        self._respond(413, {"error": f"body {length} B exceeds the "
                                                     f"{outer.max_body_bytes} B limit"})
                        return
                    body = json.loads(self.rfile.read(length) or b"{}")
                    max_new = int(body.get("max_new_tokens", 128))
                    if not (1 <= max_new <= outer.max_new_cap):
                        self._respond(400, {"error": f"max_new_tokens {max_new} outside this "
                                                     f"server's budget [1, {outer.max_new_cap}]"})
                        return
                    if self.path == "/v1/text_response":
                        req = _Request("text", str(body["text"]), "", max_new)
                    elif self.path == "/v1/audio_summary":
                        wav = _decode_audio(body, outer.target_sr)
                        req = _Request("audio", wav, str(body.get("text_prompt", "")), max_new)
                    else:
                        self._respond(404, {"error": "not found"})
                        return
                    temperature = float(body.get("temperature", 0.0))
                    if temperature > 0.0:
                        top_p = float(body.get("top_p", 1.0))
                        if not (0.0 < top_p <= 1.0):
                            self._respond(400, {"error": f"top_p {top_p} outside (0, 1]"})
                            return
                        req.temperature = temperature
                        req.top_k = max(0, int(body.get("top_k", 0)))
                        req.top_p = top_p
                        # unseeded requests draw an independent seed
                        seed = body.get("seed")
                        req.seed = (int(seed) if seed is not None
                                    else int.from_bytes(os.urandom(4), "little"))
                    # streaming rides the continuous scheduler's per-chunk
                    # partials; the request-level batcher answers once
                    if body.get("stream") and isinstance(outer.batcher, ContinuousBatchingEngine):
                        req.stream = True
                        outer.batcher._queue.put(req)
                        self._stream(req)
                        return
                    result = outer.batcher.submit(req)
                    self._respond(200, {"response": result})
                except TimeoutError as e:
                    self._respond(504, {"error": f"{type(e).__name__}: {e}"})
                except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                    self._respond(400, {"error": f"{type(e).__name__}: {e}"})
                except RuntimeError as e:
                    # scheduler-side errors come back wrapped; those rooted
                    # in the request (a prompt over max_prompt_len, a request
                    # larger than the pool) are the caller's
                    code = 400 if str(e).startswith(("ValueError", "KeyError", "MemoryError")) \
                        else 500
                    self._respond(code, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:  # noqa: BLE001 — server-side fault
                    self._respond(500, {"error": f"{type(e).__name__}: {e}"})

        class _Server(ThreadingHTTPServer):
            request_queue_size = 128  # bursts queue instead of being reset
            daemon_threads = True

        self.httpd = _Server((host, port), Handler)

    def metrics(self) -> Dict[str, Any]:
        """Operational snapshot (GET /metrics), host-side state only."""
        b = self.batcher
        out: Dict[str, Any] = {
            "scheduler": type(b).__name__,
            "scheduler_reason": self.scheduler_reason,
            "requests_served": b.requests_served,
            "batches_run": b.batches_run,
            "queue_depth": b._queue.qsize(),
            "uptime_s": round(time.monotonic() - self._started, 3),
        }
        if isinstance(b, ContinuousBatchingEngine):
            out.update(
                scheduler_loop_errors=b._loop_errors,
                live_slots=len(b._by_slot),
                n_slots=b.decoder.n_slots,
                prepared_waves=b._prepared.qsize(),
                chunk_steps=b.chunk_steps,
                max_chunk_steps=b.max_chunk_steps,
                paged=b.decoder.paged,
                spec_k=b.decoder.spec_k,
                decoder_counts=dict(b.decoder.counts),
                chunk_steps_run=b.chunk_steps_run,
                decode_ms_per_step=(1e3 * b.chunk_seconds / b.chunk_steps_run
                                    if b.chunk_steps_run else None),
            )
            first = list(b.first_token_s)  # one C-level copy: the scheduler appends
            out.update(first_token_s_p50=float(np.median(first)) if first else None,
                       first_token_samples=len(first))
            if b.spec_governor is not None:
                out["spec_acceptance"] = round(b.spec_governor.acceptance, 4)
                out["spec_active"] = b.spec_governor.acceptance >= b.spec_governor.threshold
            if b.decoder.paged:
                out["free_pages"] = b.decoder.allocator.free_pages
                out["num_pages"] = b.decoder.num_pages
        return out

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def drain(self, timeout: float = 30.0, poll_s: float = 0.25) -> bool:
        """Graceful stop: refuse new requests (POSTs and /healthz answer
        503), wait for queued and in-flight work, then shut down. Returns
        True if the scheduler went idle within ``timeout``."""
        self._draining = True
        deadline = time.monotonic() + timeout
        drained = False
        streak = 0
        while time.monotonic() < deadline:
            # two idle reads in a row: one can fall between two stages
            streak = streak + 1 if self.batcher.idle() else 0
            if streak >= 2:
                drained = True
                break
            time.sleep(poll_s)
        self.shutdown()
        return drained

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()


def serve(config, host: str = "0.0.0.0", port: int = 8080, warmup: bool = True,
          server_kwargs=None, drain_timeout: float = 30.0, device=None, **engine_kwargs):
    """Build an engine from ``config`` and serve until SIGTERM/SIGINT, which
    drain gracefully (503 for new requests, in-flight work finishes up to
    ``drain_timeout`` seconds, then exit; a second signal stops at once).
    ``device=None`` means the CUDA card and raises without one. With a
    ``mesh`` in ``engine_kwargs`` whose model group has more than one rank,
    rank 0 of the group serves and the other ranks follow its decoder
    (``serve/model_group.py``) until it drains."""
    import signal

    from ..infer.engine import LLMSpeechTextInference
    from ..parallel.comm import group_rank
    from .model_group import follow

    engine = LLMSpeechTextInference(config, device=device, **engine_kwargs)
    if not engine.builds_prompts:
        print(f"model group rank {group_rank(engine.tp_group)}: following rank 0", flush=True)
        n = follow(engine)
        print(f"rank 0 stopped after {n} commands, exiting", flush=True)
        return
    server = SummarizationServer(engine, host=host, port=port, device=engine.device,
                                 **(server_kwargs or {}))
    print(f"scheduler: {server.scheduler_reason}", flush=True)
    if warmup:
        print("warming up (building kernels, growing pools)...", flush=True)
        server.warmup()

    stoppers = []

    def _on_signal(signum, frame):
        if server._draining:  # second signal: stop now
            threading.Thread(target=server.shutdown, daemon=True).start()
            return
        print(f"signal {signum}: draining (503 for new requests, up to "
              f"{drain_timeout:.0f}s for in-flight work)...", flush=True)
        stoppers.append(threading.Thread(target=server.drain,
                                         kwargs=dict(timeout=drain_timeout), daemon=True))
        stoppers[-1].start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(f"serving on {host}:{server.port}", flush=True)
    server.serve_forever()  # returns when drain/shutdown completes
    for t in stoppers:  # the drain goes on to stop the scheduler (and its followers)
        t.join()
    print("drained, exiting", flush=True)
