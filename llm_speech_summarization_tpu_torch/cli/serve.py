"""Serving CLI: the batched HTTP inference server on one CUDA card.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.serve -c <yaml> \
      [--paged] [--speculative_k K] [--port 8080] [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--audio_encoder_checkpoint", type=str, default=None,
                        help="not ported yet: any value raises")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the warmup waves (the first requests then build the "
                        "kernels)")
    parser.add_argument("--repetition_penalty", type=float, default=1.0)
    parser.add_argument("--scheduler", choices=["auto", "continuous", "request"],
                        default="auto",
                        help="decode-level continuous batching vs request-level "
                        "batching; auto picks by measured dispatch latency")
    parser.add_argument("--paged", action="store_true",
                        help="paged KV cache for the continuous scheduler (with an int8 "
                        "kv_cache_dtype: the paged kernels B4/B5)")
    parser.add_argument("--slots", type=int, default=32,
                        help="continuous scheduler: persistent KV slots")
    parser.add_argument("--max_new_tokens", type=int, default=256,
                        help="continuous scheduler: per-request token budget cap")
    parser.add_argument("--speculative_k", type=int, default=0,
                        help="self-speculative decoding lookahead for greedy requests "
                        "(0 = off): the engine's one-shot path and the continuous "
                        "scheduler's speculative chunks")
    parser.add_argument("--drain_timeout", type=float, default=30.0,
                        help="SIGTERM/SIGINT: seconds to let in-flight requests finish "
                        "(new requests get 503) before exit")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree; only 1 is ported")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            "tensor-parallel serving (--tp > 1) is not ported to PyTorch yet (ROADMAP queue A, "
            "item 11)")
    if args.audio_encoder_checkpoint:
        raise NotImplementedError(
            "checkpoint loading is not ported to PyTorch yet (ROADMAP queue A, item 12)")

    from ..configs import load_config
    from ..serve.server import serve

    continuous = {"auto": "auto", "continuous": True, "request": False}[args.scheduler]
    serve(
        load_config(args.config),
        host=args.host,
        port=args.port,
        warmup=not args.no_warmup,
        server_kwargs=dict(
            continuous=continuous,
            paged=args.paged,
            n_slots=args.slots,
            max_new_tokens=args.max_new_tokens,
            spec_k=args.speculative_k,
        ),
        drain_timeout=args.drain_timeout,
        device=args.device,
        repetition_penalty=args.repetition_penalty,
        speculative_k=args.speculative_k,
    )


if __name__ == "__main__":
    main()
