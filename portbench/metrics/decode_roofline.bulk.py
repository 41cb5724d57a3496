"""B2, the int8 dense decode (``kernels/fused_decode.py`` ``fused_decode``:
the split body and its merge), against its roofline: Σ bound ms / Σ device
ms over its calls in the traced window, the bound of a call being its
bytes (the valid int8 slots with their scales, q, the fresh k/v, the
output and the written slots) over 3.35 TB/s, or its FLOPs over 989
TFLOP/s where that is longer."""

from portbench import work

LAYER = "kernels"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "device_trace"
ENTRIES = ("fused_decode",)


def read(run):
    return work.roofline_pct(run.calls, ENTRIES)
