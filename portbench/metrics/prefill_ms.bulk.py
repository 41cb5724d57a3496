"""Device ms per batch of the kernels launched inside the benchmark's range
around the prefill (the ``inputs_embeds`` call of ``llama_forward`` that
each ``greedy_generate`` makes)."""

LAYER = "model"
UNIT = "ms"
MOVES = "utt_per_s"
SOURCE = "device_trace"


def read(run):
    ms = run.summary.range_ms.get("pb.prefill") if run.summary else None
    if not ms or not any(ms):
        return None
    return sum(ms) / len(ms)
