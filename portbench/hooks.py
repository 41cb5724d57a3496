"""Wrappers the benchmark puts around the program's entry points from
outside (the program is not edited), undone by ``Hooks.remove``.

While ``Hooks.on`` is set (the traced window), every launch of an
attention kernel (the flash forward, with or without its log-sum-exp, the
two backward kernels, and B2, the int8 dense decode) is recorded with its
shapes and its window tensors (read once the window has closed, so no
device value is read inside it) and runs inside a range of its own,
``pb.k<n>``, which gives the call's device time in the trace. Other
wrappers (ranges around a layer's calls, a host clock at a layer's end)
are added with ``wrap``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .trace import Tracer


class Hooks:
    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.on = False
        self.calls: List[dict] = []
        self._undo: List[Callable[[], None]] = []

    def wrap(self, obj, name: str, make: Callable[[Callable], Callable]) -> bool:
        """Replace ``obj.name`` by ``make(original)``; False (and nothing
        done) where ``obj`` has no such attribute, as after a rename."""
        orig = getattr(obj, name, None)
        if orig is None:
            return False
        setattr(obj, name, make(orig))
        self._undo.append(lambda: setattr(obj, name, orig))
        return True

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _record(self, rec: dict, run):
        if not self.on:
            return run()
        rec["range"] = f"pb.k{len(self.calls)}"
        self.calls.append(rec)
        with self.tracer.range(rec["range"]):
            return run()

    def install_kernels(self) -> None:
        from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa
        from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd

        def flash_rec(wrapper, q, k, causal, starts, ends):
            B, T, Hq, Dh = q.shape
            return {"entry": wrapper.__name__, "B": B, "T": T, "Hq": Hq, "Hkv": k.shape[2],
                    "Dh": Dh, "causal": bool(causal), "elem": q.element_size(),
                    "starts": starts, "ends": ends}

        def fwd(orig):
            def launch(wrapper, q, k, v, starts, ends, causal, *a, **kw):
                return self._record(flash_rec(wrapper, q, k, causal, starts, ends),
                                    lambda: orig(wrapper, q, k, v, starts, ends, causal, *a, **kw))
            return launch

        def bwd(orig):
            def launch(wrapper, q, k, v, dout, lse, delta, starts, ends, causal, *a, **kw):
                return self._record(
                    flash_rec(wrapper, q, k, causal, starts, ends),
                    lambda: orig(wrapper, q, k, v, dout, lse, delta, starts, ends, causal, *a, **kw))
            return launch

        def dec(orig):
            def launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, pad_lens, offsets,
                       *a, **kw):
                B, T, Hq, Dh = q.shape
                rec = {"entry": "fused_decode", "B": B, "T": T, "Hq": Hq, "Hkv": k_new.shape[2],
                       "Dh": Dh, "starts": pad_lens, "offsets": offsets}
                return self._record(rec, lambda: orig(q, k_cache, v_cache, k_scale, v_scale,
                                                       k_new, v_new, pad_lens, offsets, *a, **kw))
            return launch

        self.wrap(fa, "_launch_fwd", fwd)
        self.wrap(fa, "_launch_bwd", bwd)
        self.wrap(fd, "_launch", dec)

    def resolve(self, device_ms: Dict[str, List[float]]) -> List[dict]:
        """The recorded calls with their windows read back as lists and
        their device ms from the trace (None where it gave none)."""
        cache: Dict[int, list] = {}

        def host(t):
            if id(t) not in cache:
                cache[id(t)] = [int(x) for x in t.tolist()]
            return cache[id(t)]

        out = []
        for rec in self.calls:
            r = dict(rec)
            for key in ("starts", "ends", "offsets"):
                if key in r:
                    r[key] = host(r[key])
            ms = device_ms.get(r["range"])
            r["device_ms"] = ms[0] if ms else None
            out.append(r)
        return out
