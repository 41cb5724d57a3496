"""The benchmark's own spans and the device trace of a ``--trace 1`` run.

``Tracer`` holds a ``torch.profiler`` session (CPU and CUDA activity) over
the measured window. The benchmark's files open ranges named ``pb.<what>``
around the calls into the program's layers (``Tracer.range``; a no-op
when tracing is off). After the window, ``summarize`` reads the raw events:

  * every device operation (kernel, copy, set) with its interval, and the
    runtime call that launched it (they share a correlation id), hence the
    ``pb`` ranges that were open on the launching thread at that moment
    (a library's own launch inside a range is not linked to the range, so
    the time decides);
  * device ms of each range instance: its operations' durations, nested
    ranges included;
  * busy seconds: the union of device intervals inside ``pb.window``, and
    the window's length;
  * the device operations that took most time, and the longest idle gaps,
    each labelled with the ranges open on any thread at its middle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "pb.window"


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds: Dict[str, float] = {}  # what reading the trace cost
        self.summary: Optional["Summary"] = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    @contextlib.contextmanager
    def session(self, cuda: bool):
        """Profile the block (yields nothing when tracing is off)."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        kw = {}
        try:  # the ranges of threads started before the session (the
            # engine's prompt builder, autograd's) are recorded only so
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        with profile(activities=acts, **kw) as prof:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
        t1 = time.perf_counter()
        events = raw_events(prof)
        self.summary = summarize(events)
        self.seconds = {"profiler_stop": t1 - t0, "read": time.perf_counter() - t1,
                        "events": len(events)}


class Ev:
    """One raw profiler event, in nanoseconds on the profiler's clock.
    ``thread``: the profiler's resource id of the host thread (ops, ranges
    and runtime calls of one thread share it)."""

    __slots__ = ("name", "device", "start", "end", "thread", "corr")

    def __init__(self, name, device, start, end, thread, corr):
        self.name, self.device, self.start, self.end = name, device, start, end
        self.thread, self.corr = thread, corr


def raw_events(prof) -> List[Ev]:
    out = []
    for e in prof.profiler.kineto_results.events():
        device = "cpu" if str(e.device_type()).endswith("CPU") else "device"
        if device == "device" and e.is_user_annotation():
            continue  # the ranges' own device-side spans
        start = int(e.start_ns())
        out.append(Ev(e.name(), device, start, start + int(e.duration_ns()),
                      int(e.device_resource_id()), int(e.correlation_id())))
    return out


def _is_launch(e: Ev) -> bool:
    """A CUDA runtime or driver call on the host (a kernel launch, a copy):
    its correlation id is the device operation's."""
    return e.device == "cpu" and e.name.startswith("cu")


class Summary:
    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.range_ms: Dict[str, List[float]] = defaultdict(list)  # name → device ms per instance
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[Ev], top: int = 10) -> Summary:
    sm = Summary()
    windows = [e for e in events if e.device == "cpu" and e.name == WINDOW]
    if not windows:
        return sm
    ws, we = min(w.start for w in windows), max(w.end for w in windows)
    sm.window_s = (we - ws) / 1e9
    launches = {e.corr: e for e in events if _is_launch(e)}
    ranges = defaultdict(list)  # thread → [(start, end, name)]
    for e in events:
        if e.device == "cpu" and e.name.startswith("pb.") and e.name != WINDOW:
            ranges[e.thread].append((e.start, e.end, e.name))
    points = defaultdict(list)  # thread → [(launch time, device ms)]
    dev = [e for e in events if e.device == "device"]
    by_name = defaultdict(float)
    inside = []
    for e in dev:
        s, en = max(e.start, ws), min(e.end, we)
        if en > s:
            inside.append((s, en))
            by_name[e.name] += (en - s) / 1e9
        launch = launches.get(e.corr)
        if launch is not None:
            points[launch.thread].append((launch.start, (e.end - e.start) / 1e6))
    for thread, rs in ranges.items():
        # one sweep in time: a launch adds its device ms to every range open
        # on its thread (ranges nest, so few are open at once)
        ms = [0.0] * len(rs)
        sweep = [(r[0], 0, i) for i, r in enumerate(rs)] + [(r[1], 2, i) for i, r in enumerate(rs)]
        sweep += [(t, 1, d) for t, d in points.get(thread, [])]
        sweep.sort(key=lambda x: (x[0], x[1]))
        open_ = []
        for _, what, v in sweep:
            if what == 0:
                open_.append(v)
            elif what == 2:
                open_.remove(v)
            else:
                for i in open_:
                    ms[i] += v
        for (_, _, name), m in zip(rs, ms):
            sm.range_ms[name].append(m)
    busy = _merge(inside)
    sm.busy_s = sum(e - s for s, e in busy) / 1e9
    sm.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = [], ws
    for s, e in busy + [[we, we]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    all_ranges = [r for rs in ranges.values() for r in rs]
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        names = sorted({n for a, b, n in all_ranges if a <= mid <= b})
        sm.idle_gaps.append(("+".join(n[3:] for n in names) or "no range", (e - s) / 1e9))
    return sm
