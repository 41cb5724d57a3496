"""``scripts/torch_lss_spans.py`` on made-up profiler events and counts:
``lss.`` spans credited with what their own thread launched (one span on a
second, autograd, thread), idle gaps labelled ``pb`` ranges first and
``lss.`` spans after, and the five readings, each left out without its data.
"""

import importlib.util
from collections import Counter
from pathlib import Path

import pytest

PATH = Path(__file__).resolve().parent.parent / "scripts" / "torch_lss_spans.py"
spec = importlib.util.spec_from_file_location("torch_lss_spans", PATH)
lss = importlib.util.module_from_spec(spec)
spec.loader.exec_module(lss)
Ev = lss.pb_trace.Ev
MS = 1_000_000  # ns


def _events():
    main, autograd = 1, 2
    cpu = [("pb.window", 0, 100, main), ("pb.decode_step", 10, 60, main),
           ("lss.generate.decode_step", 12, 40, main),
           ("lss.train.loss_backward", 50, 80, autograd),
           ("cudaLaunchKernel", 15, 16, main), ("cudaLaunchKernel", 30, 31, main),
           ("cudaLaunchKernel", 55, 56, autograd)]
    dev = [("k1", 20, 22), ("k2", 30, 33), ("k3", 70, 74)]
    out = [Ev(n, "cpu", a * MS, b * MS, th, i + 1 if n.startswith("cu") else 0)
           for i, (n, a, b, th) in enumerate(cpu)]
    launches = [e for e in out if e.name.startswith("cu")]
    out += [Ev(n, "device", a * MS, b * MS, 0, launch.corr)
            for (n, a, b), launch in zip(dev, launches)]
    return out


def test_spans_take_their_own_threads_launches_and_label_gaps():
    sp = lss.span_summary(_events(), top=4)
    assert sp["device_ms"] == {"lss.generate.decode_step": [pytest.approx(5.0)],
                               "lss.train.loss_backward": [pytest.approx(4.0)]}
    assert sp["host_ms"] == {"lss.generate.decode_step": [pytest.approx(28.0)],
                             "lss.train.loss_backward": [pytest.approx(30.0)]}
    assert [(label, pytest.approx(s)) for label, s in sp["gaps"]] == [
        ("decode_step|lss.train.loss_backward", 0.037), ("no range", 0.026),
        ("decode_step", 0.020), ("decode_step|lss.generate.decode_step", 0.008)]
    # the benchmark's own summary of the same events keeps only its ranges
    sm = lss.pb_trace.summarize(_events(), 4)
    assert dict(sm.range_ms) == {"pb.decode_step": [pytest.approx(5.0)]}
    assert [label for label, _ in sm.idle_gaps] == ["decode_step", "no range", "decode_step",
                                                     "decode_step"]


def test_readings():
    counts = Counter(prompt_wait_s=0.3, pipeline_batches=3, decode_issue_s=0.5,
                     decode_steps=20, positions=400, valid_positions=100)
    device_ms = {"lss.generate.decode_step": [1.0, 3.0], "lss.train.loss": [10.0, 20.0],
                 "lss.train.loss_backward": [30.0]}
    assert lss.readings(counts, device_ms) == pytest.approx({
        "prompt_wait_ms": 100.0, "decode_issue_ms_per_step": 25.0,
        "decode_device_ms_per_step": 2.0, "kd_loss_ms": 30.0, "valid_position_share": 25.0})
    # a program without the counters and spans (the decode steps alone)
    assert lss.readings(Counter(decode_steps=20), {}) == {}


def test_graph_readings():
    """The share of decode steps replayed as CUDA graphs over the untraced
    phase, and the captures from the run's start; none without the
    counters (a program before them), 0 where no step replayed."""
    ran = Counter(decode_steps=40, decode_graph_steps=30, decode_issue_s=0.2)
    assert lss.readings(ran, {}, Counter(decode_graph_captures=1)) == pytest.approx({
        "decode_issue_ms_per_step": 5.0, "decode_graph_share": 75.0,
        "decode_graph_captures": 1})
    ran = Counter(decode_steps=40, decode_graph_steps=0)
    assert lss.readings(ran, {}, Counter(decode_graph_captures=0)) == {
        "decode_graph_share": 0.0, "decode_graph_captures": 0}
    assert lss.readings(Counter(decode_steps=40), {}, Counter(decode_steps=80)) == {}
