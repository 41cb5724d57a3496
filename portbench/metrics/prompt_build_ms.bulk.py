"""Device ms per batch of the kernels launched inside the benchmark's range
around ``LLMSpeechTextInference.build_audio_prompt_batch`` (upload,
encoder, projector, splice; on the builder thread's side stream)."""

LAYER = "engine prompt build"
UNIT = "ms"
MOVES = "utt_per_s"
SOURCE = "device_trace"


def read(run):
    ms = run.summary.range_ms.get("pb.prompt_build") if run.summary else None
    if not ms or not any(ms):
        return None
    return sum(ms) / len(ms)
