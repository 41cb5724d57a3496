"""The trace reader on made-up events: a device operation's time goes to
every range that was open on its launching thread when it was launched
(found through the runtime call that launched it), busy time is the union of device intervals inside the
window, and gaps are labelled with the ranges open at their middle."""

import pytest

from portbench.trace import Ev, summarize


def cpu(name, start, end, thread=1, corr=0):
    return Ev(name, "cpu", start, end, thread, corr)


def test_device_time_goes_to_the_launching_threads_ranges():
    ms = 1_000_000
    events = [
        cpu("pb.window", 0, 100 * ms, corr=1),
        cpu("pb.decode_step", 10 * ms, 20 * ms, corr=2),
        cpu("pb.k0", 11 * ms, 12 * ms, corr=3),
        cpu("aten::mm", 14 * ms, 15 * ms, corr=4),
        # the builder thread
        cpu("pb.prompt_build", 30 * ms, 60 * ms, thread=2, corr=5),
        cpu("aten::conv1d", 31 * ms, 32 * ms, thread=2, corr=6),
        # runtime calls: one inside an op, one a library's own launch
        # inside pb.k0, two on the builder
        cpu("cudaLaunchKernel", 14 * ms + 10, 14 * ms + 20, corr=100),
        cpu("cuLaunchKernelEx", 11 * ms + 5, 11 * ms + 9, corr=101),
        cpu("cudaLaunchKernel", 31 * ms + 5, 31 * ms + 9, thread=2, corr=102),
        cpu("cudaLaunchKernel", 40 * ms, 40 * ms + 9, thread=2, corr=103),
        Ev("gemm", "device", 15 * ms, 17 * ms, 0, 100),
        Ev("flash_fwd_kernel", "device", 12 * ms, 13 * ms, 0, 101),
        Ev("conv", "device", 33 * ms, 36 * ms, 0, 102),
        Ev("flash_fwd_kernel", "device", 41 * ms, 45 * ms, 0, 103),
    ]
    sm = summarize(events)
    assert sm.window_s == pytest.approx(0.1)
    assert sm.range_ms["pb.k0"] == [pytest.approx(1.0)]
    assert sm.range_ms["pb.decode_step"] == [pytest.approx(3.0)]
    assert sm.range_ms["pb.prompt_build"] == [pytest.approx(7.0)]
    assert sm.busy_s == pytest.approx(0.010)
    assert dict(sm.device_ops)["flash_fwd_kernel"] == pytest.approx(0.005)
    # gaps 0-12, 13-15, 17-33, 36-41 and 45-100 ms, labelled at their middles
    assert sm.idle_gaps[0] == ("no range", pytest.approx(0.055))
    labels = dict((round(s, 3), n) for n, s in sm.idle_gaps)
    assert labels == {0.055: "no range", 0.016: "no range", 0.012: "no range",
                      0.005: "prompt_build", 0.002: "decode_step"}
