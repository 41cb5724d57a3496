"""Model FLOPs of the KD steps of the untraced phase of a ``--trace 1`` run
over that phase's wall, which ends in a synchronize, at the card's
published bf16 peak (989 TFLOP/s): per utterance the encoder's
forward and backward, the teacher's and the student's forwards, the
student's input-gradient backward through the frozen decoder and the loss
heads, over valid positions and frames; recomputation not counted
(``work.train_utterance_flops``)."""

from portbench import work

LAYER = "train step"
UNIT = "%"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.utterances or run.window_s <= 0:
        return None
    flops = sum(work.train_utterance_flops(run.config, *u) for u in run.utterances)
    return work.mfu_pct(flops, run.window_s)
