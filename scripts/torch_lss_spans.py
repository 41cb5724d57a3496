#!/usr/bin/env python3
"""A ``--trace 1`` run of one benchmark cell, with the port's own ``lss.``
spans and counters read beside the benchmark's result line (one CUDA card).

    python3 scripts/torch_lss_spans.py --workload minichat_hubert.bulk --seed N \
        [--seconds 51] [--out chiprun_out/lss_spans]

``portbench`` reads only its own ``pb.`` ranges and run records; this script
runs a cell through ``portbench.core.run_cell`` as ``portbench/run.py``
does, and meanwhile keeps

  * the counters' change over the untraced phase of the run (the first call
    of the runner's ``_drive`` or ``_steps``): the engine's ``counts``
    (``prompt_wait_s``, ``pipeline_batches``, ``decode_issue_s``,
    ``decode_steps``, ``decode_graph_steps``) or the trainer's
    (``positions``, ``valid_positions``), and the counters' totals at that
    phase's end (set-up included: ``decode_graph_captures``);
  * the traced window's raw events, summarized a second time by
    ``portbench.trace.summarize`` with the ``lss.`` spans in among the
    ``pb.`` ranges: a span is credited with the device time of what was
    launched on its own thread while it was open (``lss.train.loss_backward``
    is on autograd's thread), and each long idle gap is labelled with every
    range and span open at its middle, its ``pb.`` label first.

It prints one JSON line (and writes it under ``--out``): the result line's
``correct`` and metrics, the readings below, device and host ms per span
instance, and the labelled idle gaps.

  * ``prompt_wait_ms``: 1e3 x prompt_wait_s / pipeline_batches (untraced);
  * ``decode_issue_ms_per_step``: 1e3 x decode_issue_s / decode_steps;
  * ``decode_device_ms_per_step``: mean device ms of ``lss.generate.decode_step``;
  * ``kd_loss_ms``: device ms of ``lss.train.loss`` and
    ``lss.train.loss_backward`` over the ``lss.train.loss`` instances;
  * ``valid_position_share``: 100 x valid_positions / positions (untraced);
  * ``decode_graph_share``: 100 x decode_graph_steps / decode_steps, the
    share of the untraced phase's decode steps replayed as CUDA graphs;
  * ``decode_graph_captures``: piece sets captured from the start of the run
    to the end of the untraced phase.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import trace as pb_trace  # noqa: E402

SPAN = "lss."
SUMMARIZE = pb_trace.summarize  # the benchmark's own, before ``_spy`` wraps it


def span_summary(events, top: int = 12) -> dict:
    """``events``: a traced window's raw events (``portbench.trace.Ev``).
    Device and host ms per ``lss.`` span instance, and the ``top`` longest
    idle gaps as (label, seconds): the ``pb.`` ranges open at the gap's
    middle (``summarize``'s own label), then ``|`` and the ``lss.`` spans
    open there, if any."""
    renamed = [pb_trace.Ev("pb." + e.name if e.name.startswith(SPAN) else e.name, e.device,
                           e.start, e.end, e.thread, e.corr) for e in events]
    sm = SUMMARIZE(renamed, top)
    windows = [e for e in events if e.device == "cpu" and e.name == pb_trace.WINDOW]
    host = {}
    if windows:
        ws, we = min(w.start for w in windows), max(w.end for w in windows)
        for e in events:
            if e.device == "cpu" and e.name.startswith(SPAN) and ws <= e.start <= we:
                host.setdefault(e.name, []).append((e.end - e.start) / 1e6)
    device = {n[3:]: ms for n, ms in sm.range_ms.items() if n.startswith("pb." + SPAN)}
    gaps = []
    for label, s in sm.idle_gaps:
        parts = label.split("+")
        spans = [p for p in parts if p.startswith(SPAN)]
        old = "+".join(p for p in parts if not p.startswith(SPAN)) or "no range"
        gaps.append((old + ("|" + "+".join(spans) if spans else ""), s))
    return {"device_ms": device, "host_ms": host, "gaps": gaps}


def readings(counts: Counter, device_ms: dict, totals: Optional[Counter] = None) -> dict:
    """The quantities above, each left out where its data is missing:
    ``counts`` over the untraced phase, ``totals`` from the run's start."""
    out = {}
    if counts["pipeline_batches"]:
        out["prompt_wait_ms"] = 1e3 * counts["prompt_wait_s"] / counts["pipeline_batches"]
    if counts["decode_steps"] and "decode_issue_s" in counts:
        out["decode_issue_ms_per_step"] = 1e3 * counts["decode_issue_s"] / counts["decode_steps"]
    step = device_ms.get("lss.generate.decode_step")
    if step:
        out["decode_device_ms_per_step"] = sum(step) / len(step)
    loss = device_ms.get("lss.train.loss")
    if loss:
        back = device_ms.get("lss.train.loss_backward", [])
        out["kd_loss_ms"] = (sum(loss) + sum(back)) / len(loss)
    if counts["positions"]:
        out["valid_position_share"] = 100.0 * counts["valid_positions"] / counts["positions"]
    if counts["decode_steps"] and "decode_graph_steps" in counts:
        out["decode_graph_share"] = 100.0 * counts["decode_graph_steps"] / counts["decode_steps"]
    if totals is not None and "decode_graph_captures" in totals:
        out["decode_graph_captures"] = totals["decode_graph_captures"]
    return out


def _spy(core, untraced: list, totals: list, events: list) -> None:
    """Wrap the runners' first phase and ``summarize`` to keep what they
    do not hand back."""
    keep = pb_trace.summarize

    def summarize(evs, top=10):
        events[:] = evs
        return keep(evs, top)

    pb_trace.summarize = summarize
    engines = []
    from llm_speech_summarization_tpu_torch.infer import engine as eng_mod

    init = eng_mod.LLMSpeechTextInference.__init__

    def made(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self)

    eng_mod.LLMSpeechTextInference.__init__ = made
    runner = core.Bench.runner

    def first_phase(fn, counts_of):
        def wrapped(*a):
            before = Counter(counts_of(*a))
            out = fn(*a)
            if not untraced:
                totals.append(Counter(counts_of(*a)))
                ran = Counter(totals[0])
                ran.subtract(before)
                untraced.append(ran)
            return out
        return wrapped

    def wrapped_runner(self, kind):
        mod = runner(self, kind)
        if kind == "bulk" and not hasattr(mod._drive, "__wrapped_lss__"):
            mod._drive = first_phase(mod._drive, lambda *a: engines[-1].counts)
            mod._drive.__wrapped_lss__ = True
        elif kind == "train_kd" and not hasattr(mod._steps, "__wrapped_lss__"):
            mod._steps = first_phase(mod._steps, lambda trainer, *a: trainer.counts)
            mod._steps.__wrapped_lss__ = True
        return mod

    core.Bench.runner = wrapped_runner


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="chiprun_out/lss_spans")
    args = ap.parse_args()
    import portbench.run as pb_run

    pb_run.environment()
    from portbench import core

    untraced, totals, events = [], [], []
    _spy(core, untraced, totals, events)
    line = core.run_cell(core.Bench(ROOT), args.workload, args.seed, args.seconds, True,
                         "cuda", T_START)
    sp = span_summary(events)
    mean = lambda v: [len(v), sum(v) / len(v)]  # noqa: E731
    res = {"workload": args.workload, "seed": args.seed, "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "readings": readings(untraced[0] if untraced else Counter(), sp["device_ms"],
                                totals[0] if totals else Counter()),
           "untraced_counts": dict(untraced[0]) if untraced else {},
           "span_device_ms": {n: mean(v) for n, v in sorted(sp["device_ms"].items())},
           "span_host_ms": {n: mean(v) for n, v in sorted(sp["host_ms"].items())},
           "idle_gaps": sp["gaps"]}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    text = json.dumps(res)
    (out / f"{args.workload}_{args.seed}.json").write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
