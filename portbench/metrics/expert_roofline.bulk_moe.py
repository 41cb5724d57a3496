"""K1's two grouped GEMM launches (``kernels/moe_experts.py``; kernels
named ``moe_gemm``; its combine and sort are not counted) against their
roofline over the traced window: Σ bound ms / Σ device ms. The device ms
are the trace's,
by kernel name (a graph replay makes no per-call range); the bound comes
from the program's work counters over the same phase (token-expert pairs
and expert weight sets read, ``work_moe.expert_work``), per phase: every
decode call lies on the bytes side of the ridge and every prefill call on
the operations side at this cell's sizes (~12 and ~1,800 rows an expert),
so each phase's bound is its sums' max. None for a run without them."""

from portbench import work_moe

LAYER = "kernels"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "device_trace"
KERNEL = "moe_gemm"


def read(run):
    w, ms = getattr(run, "moe_work", None), getattr(run, "kernel_ms", None)
    if not w or not ms:
        return None
    dev = sum(v for k, v in ms.items() if KERNEL in k)
    if dev <= 0:
        return None
    c = run.config
    bound = sum(work_moe.phase_bound_ms(*work_moe.expert_work(p["pairs"], p["expert_sets"], c))
                for p in w.values())
    return 100.0 * bound / dev
