"""Host ms per decode step of the generation loop, in the untraced phase of
a ``--trace 1`` run (the profiler would slow the host): the wall from each
prefill's end (its stream synchronized) to ``greedy_generate``'s return
(synchronized), over the decode steps the engine counted meanwhile. The
loop reads a device value every step, so the host paces it."""

LAYER = "generation loop"
UNIT = "ms"
MOVES = "utt_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.decode_steps:
        return None
    return 1e3 * run.decode_wall_s / run.decode_steps
