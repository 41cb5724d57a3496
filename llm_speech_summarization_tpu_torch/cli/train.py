"""Training CLI: KD training of the audio encoder, on one CUDA card per
process.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.train -c <yaml> -n <name> \
      [-p <checkpoint dir>] [--steps N] [--data_source synthetic] [--device cpu]
  # one process per rank of a (data, seq, model) mesh: data parallel with
  # ZeRO-1 (2,1,1), the LLM tensor parallel (1,1,2), the long-audio ring
  # (1,N,1 with train.use_ring_attention), or all three (2,2,2)
  python -m torch.distributed.run --nproc_per_node N \
      -m llm_speech_summarization_tpu_torch.cli.train -c <yaml> --mesh D,S,M

Flags follow the JAX package's ``cli/train.py`` (-c, -n, -p, --mesh as
``data,model`` or ``data,seq,model``). The process group comes from
``distributed_init`` (``torch.distributed.run``'s environment, or the JAX
package's ``LSS_COORDINATOR`` set), and its backend from what each rank
sees: nccl with a card for each rank on the host, gloo on the CPU or with
ranks that share a card. ``--dist_backend`` overrides that choice.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="yaml file for configuration")
    parser.add_argument("-n", "--name", type=str, default="run",
                        help="name of the run for logging and saving checkpoints")
    parser.add_argument("-p", "--checkpoint_path", type=str, default=None,
                        help="checkpoint (a step_<n> directory) to resume from")
    parser.add_argument("--mesh", type=str, default=None,
                        help="override mesh as 'data,model' or 'data,seq,model' (e.g. '2,1,1'; "
                        "data -1 takes the ranks left over)")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="override the process-group backend of a multi-process run "
                        "(default: nccl with a card for each rank, else gloo)")
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after this many train steps (overrides train.steps)")
    parser.add_argument("--data_source", choices=["hf_disk", "synthetic"], default=None,
                        help="override data.source (synthetic needs no dataset on disk)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)

    from ..configs import load_config
    from ..parallel.mesh import distributed_init, make_mesh
    from ..train.trainer import Trainer

    config = load_config(args.config)
    if args.mesh:
        try:
            sizes = [int(x) for x in args.mesh.split(",")]
        except ValueError:
            sizes = []
        if len(sizes) not in (2, 3):
            parser.error(f"--mesh must be 'data,model' or 'data,seq,model' ints, got {args.mesh!r}")
        if len(sizes) == 3:
            config.train.mesh.data, config.train.mesh.seq, config.train.mesh.model = sizes
        else:
            config.train.mesh.data, config.train.mesh.model = sizes
    if args.steps is not None:
        config.train.steps = args.steps
    if args.data_source is not None:
        config.data.source = args.data_source
    joined = distributed_init(backend=args.dist_backend, cpu=args.device == "cpu")
    try:
        trainer = Trainer(config, run_name=args.name, checkpoint_path=args.checkpoint_path,
                          device=args.device, mesh=make_mesh(config))
        trainer.train()
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
