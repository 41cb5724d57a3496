"""Share of the traced window's wall in which no operation ran on the card
(the union of the intervals of every kernel, copy and set, on all
streams)."""

LAYER = "device"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "device_trace"


def read(run):
    sm = run.summary
    if sm is None or sm.window_s <= 0 or sm.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sm.busy_s / sm.window_s)
