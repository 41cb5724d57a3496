"""AudioEncoder: speech encoder + downsampling projector into the LLM's
embedding space (port of ``models/audio_encoder.py``).

HuBERT frames are downsampled ("pool": AvgPool1d(8, 4); "stack": concat
``factor`` frames) and projected by one Linear to ``llm_embedding_channels``.
Not ported yet: the Whisper encoder (ROADMAP queue A item 7) and the
``ctc_pool`` projector (item 4's ``ctc_segment_mean``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import Config
from ..ops.pooling import avg_pool_time, stack_downsample
from .hubert import HubertConfig, hubert_forward, hubert_frame_count, hubert_preset, init_hubert_params

Params = Dict[str, Any]


@dataclass(frozen=True)
class AudioEncoderParams:
    """Static (non-learned) setup for the audio encoder (HuBERT, the only
    base ported so far)."""

    encoder_cfg: HubertConfig
    downsample_method: str  # "pool" | "stack"
    downsample_factor: int
    pool_kernel: int
    pool_stride: int
    llm_embedding_channels: int
    sampling_rate: int = 16000


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP queue A, {item})")


def encoder_setup_from_config(cfg: Config) -> AudioEncoderParams:
    ae = cfg.model.audio_encoder
    if ae.base == "whisper":
        raise _not_ported("the Whisper encoder", "item 7")
    if ae.base != "hubert":
        raise ValueError(f"unexpected encoder base '{ae.base}'")
    if ae.downsample_method == "ctc_pool":
        raise _not_ported("the ctc_pool projector", "item 4 (ctc_segment_mean)")
    if ae.downsample_method not in ("pool", "stack"):
        raise ValueError(f"invalid downsampling method '{ae.downsample_method}'")
    return AudioEncoderParams(
        encoder_cfg=hubert_preset(ae.preset or ae.type),
        downsample_method=ae.downsample_method,
        downsample_factor=ae.downsample_factor,
        pool_kernel=ae.pooling.kernel_size,
        pool_stride=ae.pooling.stride,
        llm_embedding_channels=cfg.model.llm_embedding_channels,
        sampling_rate=cfg.audio.sampling_rate,
    )


def init_audio_encoder(
    generator: torch.Generator, setup: AudioEncoderParams, dtype=torch.bfloat16, device=None
) -> Params:
    """Encoder params plus the projector: normal with std in_dim**-0.5,
    zero bias (the JAX package's init)."""
    enc_params = init_hubert_params(generator, setup.encoder_cfg, dtype, device)
    hidden = setup.encoder_cfg.hidden_size
    in_dim = hidden * setup.downsample_factor if setup.downsample_method == "stack" else hidden
    E = setup.llm_embedding_channels
    w = torch.randn((in_dim, E), generator=generator, dtype=torch.float32, device=device)
    return {
        "encoder": enc_params,
        "proj_w": (in_dim ** -0.5 * w).to(dtype),
        "proj_b": torch.zeros((E,), dtype=dtype, device=device),
    }


def audio_embed_lengths(setup: AudioEncoderParams, audio_len_samples: torch.Tensor) -> torch.Tensor:
    """The reference's audio-length calculus (utils.py:13-24), floored at 0."""
    sr = setup.sampling_rate
    num_frames = (audio_len_samples - (sr // 100)) // (sr // 50)
    return torch.clamp(num_frames // setup.downsample_factor - 1, min=0).to(torch.int32)


def audio_embed_buffer_len(setup: AudioEncoderParams, num_samples: int) -> int:
    """Length M of the right-padded embedding buffer for N samples, from
    the frame arithmetic alone (no encoder run)."""
    T = hubert_frame_count(setup.encoder_cfg, num_samples)
    if setup.downsample_method == "pool":
        return (T - setup.pool_kernel) // setup.pool_stride + 1
    return T // setup.downsample_factor


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def audio_encoder_forward(
    params: Params,
    setup: AudioEncoderParams,
    wav: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """waveform (B, N) [+ per-sample lengths] → (embeds (B, M, E),
    emb_lens (B,)), the buffer right-padded. ``remat`` recomputes each
    HuBERT layer in the backward."""
    B, N = wav.shape
    if wav_lens is None:
        wav_lens = torch.full((B,), N, dtype=torch.int32, device=wav.device)
    wav_mask = torch.arange(N, device=wav.device)[None, :] < wav_lens[:, None]
    wav = wav * wav_mask.to(wav.dtype)
    # mixed precision: parameters in the compute dtype (no-op when equal);
    # the cast is part of the graph, so float32 master parameters get their
    # gradients through it
    params = _cast_floats(params, wav.dtype)

    frames, _ = hubert_forward(params["encoder"], setup.encoder_cfg, wav, wav_mask, remat=remat)
    if setup.downsample_method == "pool":
        pooled = avg_pool_time(frames, setup.pool_kernel, setup.pool_stride)
    else:
        pooled = stack_downsample(frames, setup.downsample_factor)
    emb_lens = audio_embed_lengths(setup, wav_lens)
    embeds = pooled @ params["proj_w"] + params["proj_b"]
    return embeds, torch.clamp(emb_lens, 0, embeds.shape[1])
