"""Evaluation CLI: ROUGE (+ BERTScore) and latency over the config's
validation split (preprocessed or synthetic), on one CUDA card.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.evaluate -c <yaml> \
      [-p <encoder export>] [--num_samples 64] [--bertscore] [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    """Parse ``argv``, evaluate, print and return the metrics."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--audio_encoder_checkpoint", type=str, default=None,
                        help="encoder file (train/checkpoint.py export_encoder or "
                        "cli/convert.py encoder)")
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--no_latency", action="store_true")
    parser.add_argument("--bertscore", action="store_true",
                        help="also compute BERTScore (embedder: the engine's own LLM, a "
                        "mid-stack layer; meaningful with converted weights)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)

    from ..configs import load_config
    from ..data.datasets import load_training_datasets
    from ..eval.evaluate import evaluate_engine
    from ..infer.engine import LLMSpeechTextInference

    config = load_config(args.config)
    engine = LLMSpeechTextInference(
        config, audio_encoder_checkpoint=args.audio_encoder_checkpoint, device=args.device)
    _, val_ds = load_training_datasets(config, engine.tokenizer)
    embedder = None
    if args.bertscore:
        from ..eval.bertscore import LlamaEmbedder

        embedder = LlamaEmbedder(engine.llm_params, engine.llm_cfg, engine.tokenizer)
    metrics = evaluate_engine(
        engine, val_ds, num_samples=args.num_samples, batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens, measure_latency=not args.no_latency,
        bertscore_embedder=embedder,
    )
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
