"""The continuous scheduler's decoder on a tensor-parallel model group.

Rank 0 of the group serves HTTP and runs the scheduler; every rank holds
a ``SlotDecoder`` over its shard of the LLM, and the sharded forward's
collectives need every rank to make the same decoder calls in the same
order. ``ModelGroupDecoder`` is rank 0's decoder: it broadcasts each call
that changes the decoder's state (the decoder's construction, ``admit``
with its embeddings, mask, budgets and sampling, ``decode_chunk`` plain or
speculative, ``harvest``, ``cancel``) before running it, and the other
ranks apply them in ``follow`` until rank 0 stops. Reads of host state
(``free_slots``, ``live_count``, counts) and of the flags
(``sync_flags``) run on rank 0 alone.

Every command carries its number and a fingerprint of what rank 0's
previous call gave (its flags and tokens, its harvest, or the exception it
raised); a follower whose own differs has fallen out of step and raises.
A failure ends the run: a follower raises (its process exits nonzero), and
rank 0 exits its process when a call fails with anything but a refusal
(``ValueError`` or ``MemoryError`` from ``admit``, which every rank meets
alike before the admission's forward), so that it never serves alone.
"""

from __future__ import annotations

import hashlib
import os
import time
import traceback
from typing import Any, List, Optional

import numpy as np
import torch

from ..infer.slots import SlotDecoder
from ..parallel.comm import broadcast_call

# a command at least this often, so that an idle follower's wait never
# reaches the process group's timeout (30 minutes by default)
KEEPALIVE_S = 60.0
REFUSALS = (ValueError, MemoryError)


def _fingerprint(result: Any) -> str:
    """A short digest of a call's outcome: arrays by their bytes, the rest
    by repr."""
    h = hashlib.sha1()
    items = result if isinstance(result, (tuple, list)) else [result]
    for x in items:
        if isinstance(x, np.ndarray):
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(repr(x).encode())
    return h.hexdigest()[:16]


def _apply(dec: SlotDecoder, name: str, args, tensors, last_flags):
    """Run one command on ``dec``: (what the call returns, the outcome the
    ranks compare, the flags of the last chunk)."""
    if name == "admit":
        slot_ids, budgets, sampling = args
        dec.admit(tensors[0], tensors[1], slot_ids, budgets, sampling=sampling)
        return None, "admitted", last_flags
    if name == "decode_chunk":
        k_steps, spec = args
        flags = dec.decode_chunk(k_steps, return_flags=True, spec=spec)
        return flags, flags, flags
    if name == "harvest":
        rows = dec.harvest(last_flags if args else None)
        return rows, [(s, int(n)) for s, _, n in rows], last_flags
    if name == "cancel":
        dec.cancel(args)
        return None, "cancelled", last_flags
    if name == "keepalive":
        return None, "alive", last_flags
    raise ValueError(f"unknown decoder command {name!r}")


class ModelGroupDecoder:
    """Rank 0's ``SlotDecoder`` over a model group (see the module
    docstring); attributes it does not define are the decoder's."""

    def __init__(self, engine, **decoder_kwargs):
        self._group, self._device = engine.tp_group, engine.device
        self._seq = 0
        self._fp: Optional[str] = None
        self._last_flags = None
        self._sent = time.monotonic()
        self._send("init", decoder_kwargs, [])
        self.decoder = SlotDecoder(engine.llm_params, engine.llm_cfg, mesh=engine.mesh,
                                   device=engine.device, **decoder_kwargs)
        self._fp = _fingerprint("built")

    def __getattr__(self, name):
        if name == "decoder":
            raise AttributeError(name)
        return getattr(self.decoder, name)

    def _send(self, name: str, args, tensors) -> None:
        broadcast_call((self._seq, name, args, self._fp), tensors, self._group,
                       device=self._device)
        self._seq += 1
        self._sent = time.monotonic()

    def _call(self, name: str, args, tensors: List = (), refusals=()):
        """Broadcast one command and run it here; a refusal is re-raised, any
        other failure ends the process (the followers cannot go on)."""
        try:
            self._send(name, args, list(tensors))
            result, outcome, self._last_flags = _apply(self.decoder, name, args, tensors,
                                                       self._last_flags)
        except refusals as e:
            self._fp = _fingerprint(type(e).__name__)
            raise
        except BaseException:
            traceback.print_exc()
            print(f"model group: rank 0's {name} failed; ending the run", flush=True)
            os._exit(1)
        self._fp = _fingerprint(outcome)
        return result

    def admit(self, embeds, mask, slot_ids, budgets, sampling=None) -> None:
        n = len(slot_ids)
        self._call("admit", ([int(s) for s in slot_ids], [int(b) for b in budgets],
                             None if sampling is None else list(sampling)[:n]),
                   [embeds[:n], mask[:n]], refusals=REFUSALS)

    def decode_chunk(self, k_steps: int = 8, return_flags: bool = False, spec: bool = False):
        flags = self._call("decode_chunk", (int(k_steps), bool(spec)))
        return flags if return_flags else None

    def harvest(self, flags=None):
        if flags is not None and flags is not self._last_flags:
            raise ValueError("on a model group, harvest takes the flags of the last "
                             "decode_chunk or none")
        return self._call("harvest", flags is not None)

    def cancel(self, slot_ids) -> None:
        if slot_ids:
            self._call("cancel", [int(s) for s in slot_ids])

    def keepalive(self) -> None:
        """A no-op command when none went out for ``KEEPALIVE_S``."""
        if time.monotonic() - self._sent >= KEEPALIVE_S:
            self._call("keepalive", None)

    def stop(self) -> None:
        """Tell the followers to return (the scheduler's last call)."""
        self._send("stop", None, [])


@torch.no_grad()
def follow(engine) -> int:
    """Rank >= 1 of a serving model group: build the decoder rank 0 builds
    and apply its calls until it stops; returns the number of commands.
    Raises RuntimeError when a call fails here or the ranks fall out of
    step."""
    dec = None
    seq, fp, flags = 0, None, None
    while True:
        (n, name, args, fp0), tensors = broadcast_call(None, None, engine.tp_group,
                                                       device=engine.device)
        if n != seq or fp0 != fp:
            raise RuntimeError(f"model group out of step at command {n} ({name}): rank 0 "
                               f"sent number {n} after outcome {fp0}, this rank expected "
                               f"{seq} after {fp}")
        seq += 1
        if name == "stop":
            return seq
        if name == "init":
            dec = SlotDecoder(engine.llm_params, engine.llm_cfg, mesh=engine.mesh,
                              device=engine.device, **args)
            fp = _fingerprint("built")
            continue
        try:
            _, outcome, flags = _apply(dec, name, args, tensors, flags)
        except REFUSALS as e:
            if name != "admit":
                raise RuntimeError(f"model group: {name} failed on this rank") from e
            outcome = type(e).__name__
        fp = _fingerprint(outcome)
