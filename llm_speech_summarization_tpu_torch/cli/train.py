"""Training CLI: KD training of the audio encoder on one CUDA card.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.train -c <yaml> -n <name> \
      [-p <checkpoint dir>] [--steps N] [--data_source synthetic] [--device cpu]

Flags follow the JAX package's ``cli/train.py`` (-c, -n, -p); ``--mesh`` is
not ported (one card, ROADMAP queue A item 11).
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
    parser.add_argument("--steps", type=int, default=None,
                        help="stop after this many train steps (overrides train.steps)")
    parser.add_argument("--data_source", choices=["hf_disk", "synthetic"], default=None,
                        help="override data.source (synthetic needs no dataset on disk)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA card (raises without one); 'cpu' runs the "
                        "plain PyTorch path")
    args = parser.parse_args(argv)

    from ..configs import load_config
    from ..train.trainer import Trainer

    config = load_config(args.config)
    if args.steps is not None:
        config.train.steps = args.steps
    if args.data_source is not None:
        config.data.source = args.data_source
    trainer = Trainer(config, run_name=args.name, checkpoint_path=args.checkpoint_path,
                      device=args.device)
    trainer.train()


if __name__ == "__main__":
    main()
