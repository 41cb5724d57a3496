"""Checkpoint conversion CLI: a local HF checkpoint → one file in the port's
format (``train/checkpoint.py``: ``save_params``), which the engine and the
trainer load through ``model.llm_checkpoint`` / ``model.encoder_checkpoint``
and the inference and preprocessing CLIs through ``-p`` and ``--ctc``.

Usage:
  # the frozen LLM (LlamaForCausalLM layout)
  python -m llm_speech_summarization_tpu_torch.cli.convert llm \
      --hf_dir /path/to/Llama-3.2-3B-Instruct --preset llama3_3b --output ckpts/llama3_3b.pt

  # the DeepSeek-V3 layout (Moonlight-16B-A3B: latent attention, experts)
  python -m llm_speech_summarization_tpu_torch.cli.convert llm \
      --hf_dir /path/to/Moonlight-16B-A3B --preset moonlight_16b_a3b --output ckpts/moonlight.pt

  # the audio encoder backbone (HubertModel / Whisper layout) in a full
  # encoder tree, its projector freshly initialized
  python -m llm_speech_summarization_tpu_torch.cli.convert encoder \
      -c <yaml> --hf_dir /path/to/hubert-large-ls960-ft --output ckpts/hubert.pt

  # HuBERT-CTC (HubertForCTC) for the word offsets of --ctc
  python -m llm_speech_summarization_tpu_torch.cli.convert ctc \
      --hf_dir /path/to/hubert-large-ls960-ft --output ckpts/hubert_ctc.pt

Conversion runs on the host (no card needed).
"""

from __future__ import annotations

import argparse

_DTYPES = ("bfloat16", "float16", "float32")


def main(argv=None) -> str:
    """Parse ``argv``, convert, write; returns the output path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["llm", "encoder", "ctc"])
    parser.add_argument("--hf_dir", type=str, required=True,
                        help="local HF checkpoint dir (safetensors or .bin)")
    parser.add_argument("--output", type=str, required=True, help="the file to write")
    parser.add_argument("--preset", type=str, default=None,
                        help="llm preset name (llm kind) or HuBERT preset (ctc kind; default "
                        "hubert_large)")
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="framework yaml (encoder kind)")
    parser.add_argument("--dtype", type=str, default="bfloat16", choices=_DTYPES)
    args = parser.parse_args(argv)

    import torch

    from ..models.convert import (
        convert_hubert,
        convert_hubert_ctc,
        convert_llama,
        convert_mla_moe,
        convert_whisper_encoder,
        load_hf_state_dict,
    )
    from ..train.checkpoint import save_params

    dtype = getattr(torch, args.dtype)
    if args.kind == "llm" and not args.preset:
        parser.error("--preset required for llm conversion")
    if args.kind == "encoder" and not args.config:
        parser.error("--config required for encoder conversion")
    sd = load_hf_state_dict(args.hf_dir)

    if args.kind == "llm":
        from ..models.llama import llama_preset
        from ..models.mla_moe import is_mla_moe, mla_moe_preset

        if is_mla_moe(args.preset):
            llm = convert_mla_moe(sd, mla_moe_preset(args.preset), dtype)
        else:
            llm = convert_llama(sd, llama_preset(args.preset), dtype)
        payload = {"llm_params": llm}
    elif args.kind == "ctc":
        from ..models.hubert import hubert_preset

        enc, head = convert_hubert_ctc(sd, hubert_preset(args.preset or "hubert_large"), dtype)
        payload = {"enc_params": enc, "head_params": head}
    else:
        from ..configs import load_config
        from ..models.audio_encoder import encoder_setup_from_config, init_audio_encoder

        setup = encoder_setup_from_config(load_config(args.config))
        convert = convert_hubert if setup.base == "hubert" else convert_whisper_encoder
        # the projector (the trainable part) starts random from a seeded
        # generator; the converted backbone goes inside the full tree
        full = init_audio_encoder(torch.Generator().manual_seed(0), setup, dtype=dtype)
        full["encoder"] = convert(sd, setup.encoder_cfg, dtype)
        payload = {"enc_params": full}
    del sd
    path = save_params(args.output, payload)
    print(f"wrote {args.kind} checkpoint to {path}")
    return path


if __name__ == "__main__":
    main()
