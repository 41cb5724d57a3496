"""Model FLOPs of the utterances answered in the untraced phase of a
``--trace 1`` run over that phase's wall (the profiler would slow the
host) at the card's published bf16 peak (989 TFLOP/s): per utterance the encoder
and projector over its valid frames, the prefill of its prompt (the last
position's logits) and one decode step for each served token after the
first (``work.bulk_utterance_flops``)."""

from portbench import work

LAYER = "model"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.utterances or run.window_s <= 0:
        return None
    flops = sum(work.bulk_utterance_flops(run.config, n, g) for n, g in run.utterances)
    return work.mfu_pct(flops, run.window_s)
