"""Preprocessing CLI: the 4-step pipeline (``data/preprocess.py``) over a raw
split, written as an HF dataset on disk.

Raw input: an HF dataset on disk with {audio, text} columns, a raw
LibriSpeech-style tree (``*.flac`` / ``*.wav`` next to ``*.trans.txt``
files), or ``--synthetic N`` for fixtures. Every input is read lazily, so
the rows stream to the arrow shard with one waveform in memory at a time.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.preprocess -c <yaml> \
      --input <hf_dataset_dir | librispeech_dir> --output <out_dir> \
      [--ctc <cli/convert.py ctc file>] [--device cpu]

Writing the split needs the ``datasets`` package.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    """Parse ``argv``, run the job; returns the number of rows written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--input", type=str, default=None,
                        help="HF dataset dir with {audio, text} columns, or a LibriSpeech tree")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic raw examples instead of --input")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=32,
                        help="transcripts per response-generation batch")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--ctc", type=str, default=None,
                        help="HuBERT-CTC file (cli/convert.py ctc) -> word offsets and "
                        "pool_ranges_4 (steps 3-4); the model runs in float32 whatever dtype "
                        "the file stores; without it those columns are empty, the "
                        "reference's Llama-3 variant")
    parser.add_argument("--ctc_preset", type=str, default="hubert_large",
                        help="HuBERT preset of the --ctc checkpoint")
    parser.add_argument("--ctc_vocab", type=int, default=32,
                        help="CTC head vocab of the --ctc checkpoint")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)
    if not args.synthetic and not args.input:
        parser.error("--input or --synthetic required")

    import numpy as np

    from ..configs import load_config
    from ..data.datasets import LazyRawView, SyntheticSpeechDataset, load_librispeech_dir
    from ..data.preprocess import iter_preprocess_examples, load_ctc_fn, save_preprocessed
    from ..infer.engine import LLMSpeechTextInference

    config = load_config(args.config)
    engine = LLMSpeechTextInference(config, device=args.device)

    if args.synthetic:
        ds = SyntheticSpeechDataset(engine.tokenizer, num_samples=args.synthetic)
        examples = LazyRawView(len(ds), lambda i: {"audio": ds[i]["audio"],
                                                   "text": ds[i]["text"]})
    else:
        examples = load_librispeech_dir(args.input, target_sr=config.audio.sampling_rate,
                                        limit=args.limit)
        if examples is None:  # no audio files: an HF dataset on disk
            from datasets import load_from_disk

            raw = load_from_disk(args.input)
            n = len(raw) if args.limit is None else min(args.limit, len(raw))

            def _get(i, raw=raw):
                row = raw[i]
                audio = row["audio"]
                wav = np.asarray(audio["array"] if isinstance(audio, dict) else audio,
                                 np.float32)
                return {"audio": wav, "text": row["text"]}

            examples = LazyRawView(n, _get)

    ctc_fn = (load_ctc_fn(args.ctc, args.ctc_preset, args.ctc_vocab, device=engine.device)
              if args.ctc else None)
    rows = iter_preprocess_examples(
        examples, engine, engine.tokenizer, ctc_fn=ctc_fn,
        max_seconds=config.audio.max_seconds, sampling_rate=config.audio.sampling_rate,
        response_batch_size=args.batch_size,
    )
    n_written = save_preprocessed(rows, args.output, sampling_rate=config.audio.sampling_rate)
    print(f"wrote {n_written} examples to {args.output}")
    return n_written


if __name__ == "__main__":
    main()
