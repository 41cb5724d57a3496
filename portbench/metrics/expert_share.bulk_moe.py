"""Share of the traced window's busy device time spent in the routed
experts' kernels (K1: the grouped GEMMs ``moe_gemm``, the combine
``moe_combine`` and a decode step's sort ``moe_align``): their device ms by
name over the union of every device operation's intervals in the window.
None for a run without them."""

LAYER = "model"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "device_trace"
KERNELS = ("moe_gemm", "moe_combine", "moe_align")


def read(run):
    ms, sm = getattr(run, "kernel_ms", None), run.summary
    if not ms or sm is None or sm.busy_s <= 0:
        return None
    k1 = sum(v for k, v in ms.items() if any(n in k for n in KERNELS))
    return 100.0 * k1 / (1e3 * sm.busy_s) if k1 > 0 else None
