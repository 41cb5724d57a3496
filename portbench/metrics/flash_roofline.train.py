"""The flash kernels of a KD step against their roofline: B1 (the
teacher), B1 + LSE (the student's forward and its recomputation), B6 dq
and B6 dk/dv, in the encoder and the decoder; Σ bound ms / Σ device ms
over their calls in the traced window (``work.call_bound_ms``)."""

from portbench import work

LAYER = "kernels"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
ENTRIES = ("flash_attention_fwd", "flash_attention_fwd_lse", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv")


def read(run):
    return work.roofline_pct(run.calls, ENTRIES)
