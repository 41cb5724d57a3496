"""Serving CLI: the batched HTTP inference server on one CUDA card, or on a
tensor-parallel model group of ``--tp`` ranks, one process each.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.serve -c <yaml> \
      [--paged] [--speculative_k K] [--kv_cache_dtype bfloat16] [--port 8080] \
      [--device cpu]
  python -m torch.distributed.run --nproc_per_node 2 \
      -m llm_speech_summarization_tpu_torch.cli.serve -c <yaml> --tp 2 [...]

Under ``--tp`` rank 0 serves HTTP on ``--port``; the other ranks follow
its decoder and exit when it drains. Ranks that share a card run over gloo
(``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--audio_encoder_checkpoint", type=str, default=None,
                        help="audio encoder file (train/checkpoint.py export_encoder or "
                        "cli/convert.py encoder)")
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
    parser.add_argument("--kv_cache_dtype", choices=["int8", "bfloat16"], default=None,
                        help="override model.kv_cache_dtype (a dense int8 cache decodes "
                        "through kernel B2, a bfloat16 one through B3)")
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
                        help="tensor-parallel degree: shard the frozen LLM over a model "
                        "group of this many ranks (launch them with torch.distributed.run)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)

    from ..configs import load_config
    from ..serve.server import serve

    mesh, joined = None, False
    if args.tp > 1:
        from ..parallel.mesh import distributed_init, mesh_from_ranks

        joined = distributed_init(cpu=args.device == "cpu")
        mesh = mesh_from_ranks(data=1, model=args.tp)

    continuous = {"auto": "auto", "continuous": True, "request": False}[args.scheduler]
    config = load_config(args.config)
    if args.kv_cache_dtype is not None:
        config.model.kv_cache_dtype = args.kv_cache_dtype
    try:
        serve(
            config,
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
            audio_encoder_checkpoint=args.audio_encoder_checkpoint,
            repetition_penalty=args.repetition_penalty,
            speculative_k=args.speculative_k,
            mesh=mesh,
        )
    finally:
        # leave the group before exit: a process group left to the
        # interpreter's teardown aborted a follower rank now and then
        # ("terminate called without an active exception", after its last
        # Python frame), as cli/train.py leaves its group
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
