"""The flash forward kernel (B1: the encoder's self-attention and the
prefill) against its roofline: Σ bound ms / Σ device ms over its calls in
the traced window. A call's bound is max(bytes / 3.35 TB/s, FLOPs / 989
TFLOP/s) over its valid (query, key) pairs (``work.call_bound_ms``), its
device ms the kernels launched inside its own range."""

from portbench import work

LAYER = "kernels"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "device_trace"
ENTRIES = ("flash_attention_fwd",)


def read(run):
    return work.roofline_pct(run.calls, ENTRIES)
