"""Model FLOPs of the utterances answered in the untraced phase of a
``--trace 1`` run over that phase's wall, at the card's published bf16 peak
(989 TFLOP/s), for the DeepSeek-V3 decoder: per utterance the encoder and
projector over its valid frames, the prefill of its prompt and one decode
step for each served token after the first, each token 2 x its 2.58 B
active weights plus the expanded attention (``work_moe.bulk_utterance_
flops``). None for another kind's run."""

from portbench import work, work_moe

LAYER = "model"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "host_clock"


def read(run):
    if getattr(run, "kind", None) != "bulk_moe" or not run.utterances or run.window_s <= 0:
        return None
    flops = sum(work_moe.bulk_utterance_flops(run.config, n, g) for n, g in run.utterances)
    return work.mfu_pct(flops, run.window_s)
