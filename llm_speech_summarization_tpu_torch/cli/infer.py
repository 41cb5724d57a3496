"""Inference CLI: one clip, or a directory of clips to JSONL, on one CUDA card.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.infer -c <yaml> -a <wav|flac> \
      [--text T] [--max_new_tokens N] [--device cpu]
  python -m llm_speech_summarization_tpu_torch.cli.infer -c <yaml> --audio_dir <dir> \
      [--output out.jsonl] [--batch_size 32] [--device cpu]

Bulk mode runs the pipelined batch stream (``iter_audio_response_batches``):
batch i+1's prompt is built while batch i decodes, and each batch's rows
are written and flushed as the batch completes.

``-p`` loads the audio encoder from a file (``export_encoder`` or
``cli/convert.py encoder``). A ``ctc_pool`` config needs ``--ctc``, a
``cli/convert.py ctc`` file: each clip's pool ranges come from its HuBERT-CTC
word offsets (``data/preprocess.py::pool_ranges_for_audio``), the CTC model
run in float32 as the JAX package runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter


def main(argv=None):
    """Parse ``argv``, run, and return the engine (so a caller in the same
    process can read what it ran)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="yaml file for configuration")
    parser.add_argument("-p", "--audio_encoder_checkpoint", type=str, default=None,
                        help="audio encoder file (train/checkpoint.py export_encoder or "
                        "cli/convert.py encoder)")
    parser.add_argument("-a", "--audio_file", type=str, default=None,
                        help="audio file (WAV or FLAC) holding the speech prompt")
    parser.add_argument("--audio_dir", type=str, default=None,
                        help="bulk mode: every .wav/.flac under this directory, in "
                        "length-sorted batches of --batch_size, through the pipelined "
                        "batch stream")
    parser.add_argument("--output", type=str, default=None,
                        help="bulk mode: write {file, response} JSONL here (default: stdout)")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="bulk mode: utterances per batch")
    parser.add_argument("--text", type=str, default="",
                        help="additional text prompt placed before the audio")
    parser.add_argument("--max_new_tokens", type=int, default=512)
    parser.add_argument("--repetition_penalty", type=float, default=1.0,
                        help="damp repeated tokens (greedy repetition loops are a known "
                        "failure; try 1.2)")
    parser.add_argument("--speculative_k", type=int, default=0,
                        help="self-speculative decoding lookahead for the greedy decode "
                        "(0 = off; the same tokens)")
    parser.add_argument("--ctc", type=str, default=None,
                        help="HuBERT-CTC file (cli/convert.py ctc), required for ctc_pool "
                        "configs: each clip's pool ranges from its CTC word offsets; the model "
                        "runs in float32 whatever dtype the file stores")
    parser.add_argument("--ctc_preset", type=str, default="hubert_large")
    parser.add_argument("--ctc_vocab", type=int, default=32)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)
    if (args.audio_file is None) == (args.audio_dir is None):
        parser.error("exactly one of -a/--audio_file or --audio_dir is required")

    from ..configs import load_config
    from ..data.audio_io import load_audio
    from ..infer.engine import LLMSpeechTextInference

    config = load_config(args.config)
    if config.model.audio_encoder.downsample_method == "ctc_pool" and not args.ctc:
        parser.error("this config uses downsample_method=ctc_pool: pass --ctc <HuBERT-CTC file> "
                     "(cli/convert.py ctc)")
    engine = LLMSpeechTextInference(
        config, audio_encoder_checkpoint=args.audio_encoder_checkpoint, device=args.device,
        repetition_penalty=args.repetition_penalty, speculative_k=args.speculative_k,
    )
    ranges_fn = None
    if config.model.audio_encoder.downsample_method == "ctc_pool":
        from ..data.preprocess import load_ctc_fn, pool_ranges_for_audio

        ctc_fn = load_ctc_fn(args.ctc, args.ctc_preset, args.ctc_vocab, device=engine.device)
        ranges_fn = lambda a: pool_ranges_for_audio(ctc_fn, a)  # noqa: E731
    if args.audio_dir is not None:
        _bulk(engine, config, args, ranges_fn)
        return engine

    audio = load_audio(args.audio_file, target_sr=config.audio.sampling_rate)
    response = engine.generate_audio_response(
        audio, additional_text_prompt=args.text, max_new_tokens=args.max_new_tokens,
        ctc_pool_ranges=ranges_fn(audio) if ranges_fn else None)
    print("LLM Response:\n")
    print(response)
    return engine


def audio_paths(audio_dir: str):
    """The .wav and .flac files under ``audio_dir``, sorted by size (a
    stat-only proxy for length: a batch then shares a prompt bucket)."""
    exts = (".wav", ".flac")
    paths = sorted(os.path.join(r, f) for r, _, files in os.walk(audio_dir)
                   for f in files if f.lower().endswith(exts))
    if not paths:
        raise SystemExit(f"no {'/'.join(exts)} files under {audio_dir}")
    return sorted(paths, key=os.path.getsize)


def _bulk(engine, config, args, ranges_fn=None):
    """Directory → JSONL. Audio loads lazily one batch ahead of the decode
    (host memory holds two batches, not the corpus), and each batch's rows
    reach the sink, flushed, as the batch completes: a crash at batch N
    keeps the first N - 1 batches' output. With ``ranges_fn`` (a
    ``ctc_pool`` config) each batch's pool ranges are computed from the
    audio the batch stream loaded, in the stream's order."""
    from ..data.audio_io import load_audio

    paths = audio_paths(args.audio_dir)
    bs = max(1, args.batch_size)
    groups = [paths[i:i + bs] for i in range(0, len(paths), bs)]
    loaded = {}  # group index → its audio, shared with the ranges stream

    def lazy_batches():
        for gi, g in enumerate(groups):
            loaded[gi] = [load_audio(p, target_sr=config.audio.sampling_rate) for p in g]
            yield loaded[gi]

    def lazy_ranges():
        for gi in range(len(groups)):
            yield [ranges_fn(a) for a in loaded.pop(gi)]

    from ..models.mla_moe import MlaMoeConfig, read_moe_counters

    sink = open(args.output, "w") if args.output else sys.stdout
    written = 0
    before = Counter(engine.counts)
    moe = isinstance(engine.llm_cfg, MlaMoeConfig)
    if moe:
        moe_before = read_moe_counters(engine.device, engine.llm_cfg.n_routed_experts)
    try:
        for g, outs in zip(groups, engine.iter_audio_response_batches(
                lazy_batches(), additional_text_prompt=args.text,
                max_new_tokens=args.max_new_tokens,
                ctc_pool_ranges=lazy_ranges() if ranges_fn else None)):
            for path, out in zip(g, outs):
                sink.write(json.dumps({"file": path, "response": out}) + "\n")
            sink.flush()
            written += len(g)
    finally:
        if args.output:
            sink.close()
    if args.output:
        print(f"wrote {written} responses to {args.output}")
    work = None
    if moe:
        after = read_moe_counters(engine.device, engine.llm_cfg.n_routed_experts)
        work = {ph: {k: v - moe_before[ph][k] if k != "max_load" else v
                     for k, v in after[ph].items()} for ph in after}
    print(pipeline_report(engine.counts, before, work), file=sys.stderr)


def pipeline_report(counts: Counter, before: Counter, moe_work=None) -> str:
    """What the batch stream's counters read between ``before`` and
    ``counts``: how long the decoding thread waited for each batch's
    prompt (the encoder keeping up or not), how long each decode step
    took to issue on the host, and the share of the steps replayed as
    CUDA graphs; with ``moe_work`` (the DeepSeek-V3 decoder's work
    counters over the same batches, ``mla_moe.read_moe_counters``), per
    phase the token-expert pairs, expert weight sets read, the largest load
    of one expert in a call and the latent slots attended."""
    ran = Counter(counts)
    ran.subtract(before)
    batches, steps = ran["pipeline_batches"], ran["decode_steps"]
    report = (f"{batches} batches, {1e3 * ran['prompt_wait_s'] / max(batches, 1):.2f} ms a batch "
              f"waiting for its prompt; {steps} decode steps, "
              f"{1e3 * ran['decode_issue_s'] / max(steps, 1):.3f} ms a step issuing them, "
              f"{100 * ran['decode_graph_steps'] / max(steps, 1):.1f}% replayed as CUDA graphs")
    for phase, w in (moe_work or {}).items():
        report += (f"; {phase}: {w['pairs']} token-expert pairs, {w['expert_sets']} expert "
                   f"weight sets, largest load {w['max_load']}, {w['latent_slots']} latent slots")
    return report


if __name__ == "__main__":
    main()
