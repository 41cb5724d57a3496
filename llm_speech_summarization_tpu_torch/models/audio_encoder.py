"""AudioEncoder: speech encoder + downsampling projector into the LLM's
embedding space (port of ``models/audio_encoder.py``).

HuBERT or Whisper-encoder frames are downsampled ("pool": AvgPool1d(8, 4);
"stack": concat ``factor`` frames; "ctc_pool": the mean over given (start,
end) frame ranges from CTC word offsets) and projected by one Linear to
``llm_embedding_channels``. Whisper sees a log-mel spectrogram cut or
padded to its 30 s budget, or with ``whisper_dynamic_frames`` sized to the
(bucketed) input and capped at that budget.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs import Config
from ..device import exact_float32, resolve_device
from ..ops.pooling import avg_pool_time, ctc_segment_mean, stack_downsample
from ..parallel.comm import group_size
from .hubert import HubertConfig, hubert_forward, hubert_frame_count, hubert_preset, init_hubert_params
from .whisper import (
    WhisperConfig,
    init_whisper_params,
    log_mel_spectrogram,
    mel_frame_budget,
    whisper_forward,
    whisper_frame_count,
    whisper_preset,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class AudioEncoderParams:
    """Static (non-learned) setup for the audio encoder; the encoder's
    config type says which base it is."""

    encoder_cfg: Union[HubertConfig, WhisperConfig]
    downsample_method: str  # "pool" | "stack" | "ctc_pool"
    downsample_factor: int
    pool_kernel: int
    pool_stride: int
    llm_embedding_channels: int
    sampling_rate: int = 16000
    whisper_dynamic_frames: bool = False

    @property
    def base(self) -> str:
        return "whisper" if isinstance(self.encoder_cfg, WhisperConfig) else "hubert"


def encoder_setup_from_config(cfg: Config) -> AudioEncoderParams:
    ae = cfg.model.audio_encoder
    preset_name = ae.preset or ae.type
    if ae.base == "hubert":
        enc_cfg: Any = hubert_preset(preset_name)
    elif ae.base == "whisper":
        enc_cfg = whisper_preset(preset_name)
    else:
        raise ValueError(f"unexpected encoder base '{ae.base}'")
    if ae.downsample_method not in ("pool", "stack", "ctc_pool"):
        raise ValueError(f"invalid downsampling method '{ae.downsample_method}'")
    return AudioEncoderParams(
        encoder_cfg=enc_cfg,
        downsample_method=ae.downsample_method,
        downsample_factor=ae.downsample_factor,
        pool_kernel=ae.pooling.kernel_size,
        pool_stride=ae.pooling.stride,
        llm_embedding_channels=cfg.model.llm_embedding_channels,
        sampling_rate=cfg.audio.sampling_rate,
        whisper_dynamic_frames=ae.whisper_dynamic_frames,
    )


def init_audio_encoder(
    generator: torch.Generator, setup: AudioEncoderParams, dtype=torch.bfloat16, device=None
) -> Params:
    """Encoder params plus the projector: normal with std in_dim**-0.5,
    zero bias (the JAX package's init)."""
    if setup.base == "whisper":
        enc_params = init_whisper_params(generator, setup.encoder_cfg, dtype, device)
        hidden = setup.encoder_cfg.d_model
    else:
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


def encoder_frame_count(setup: AudioEncoderParams, num_samples: int) -> int:
    """Frames out of the encoder, before the projector, for N samples."""
    if setup.base == "whisper":
        return whisper_frame_count(mel_frame_budget(setup.encoder_cfg, num_samples,
                                                    setup.whisper_dynamic_frames))
    return hubert_frame_count(setup.encoder_cfg, num_samples)


def audio_embed_buffer_len(setup: AudioEncoderParams, num_samples: int,
                           num_ranges: Optional[int] = None) -> int:
    """Length M of the right-padded embedding buffer for N samples, from
    the frame arithmetic alone (no encoder run); for ``ctc_pool`` the
    number of ranges G a row of ``ctc_pool_ranges`` holds."""
    if setup.downsample_method == "ctc_pool":
        if num_ranges is None:
            raise ValueError("the ctc_pool buffer is as long as the ranges: pass num_ranges")
        return num_ranges
    T = encoder_frame_count(setup, num_samples)
    if setup.downsample_method == "pool":
        return (T - setup.pool_kernel) // setup.pool_stride + 1
    return T // setup.downsample_factor


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _exact_float32(forward):
    """``forward(params, setup, wav, ...)`` inside ``exact_float32(wav)``:
    the HuBERT conv stem, Whisper's convolutions and every product in
    float32 for a float32 waveform on the card."""
    @functools.wraps(forward)
    def wrapped(params, setup, wav, *args, **kw):
        with exact_float32(wav):
            return forward(params, setup, wav, *args, **kw)

    return wrapped


@_exact_float32
def audio_encoder_forward(
    params: Params,
    setup: AudioEncoderParams,
    wav: torch.Tensor,
    wav_lens: Optional[torch.Tensor] = None,
    ctc_pool_ranges: Optional[torch.Tensor] = None,
    remat: bool = False,
    sp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """waveform (B, N) [+ per-sample lengths] → (embeds (B, M, E),
    emb_lens (B,)), the buffer right-padded and ``emb_lens`` clipped to it
    (a clip longer than Whisper's 30 s budget is cut). For ``ctc_pool``,
    ``ctc_pool_ranges`` (B, G, 2) selects the frame ranges: M = G and
    ``emb_lens`` counts the valid ranges (the splice takes that many from
    the left, as the JAX package does). ``remat`` recomputes
    each encoder layer in the backward. ``sp_group``: long-audio sequence
    parallelism, the HuBERT frames sharded over the group's ranks
    (``models/hubert.py``); pooling and the projector run on the gathered
    frames, the same on every rank."""
    B, N = wav.shape
    if setup.downsample_method == "ctc_pool" and ctc_pool_ranges is None:
        raise ValueError("Need to specify CTC pool ranges if using ctc_pool downsample method.")
    if wav_lens is None:
        wav_lens = torch.full((B,), N, dtype=torch.int32, device=wav.device)
    wav_mask = torch.arange(N, device=wav.device)[None, :] < wav_lens[:, None]
    wav = wav * wav_mask.to(wav.dtype)
    # mixed precision: parameters in the compute dtype (no-op when equal);
    # the cast is part of the graph, so float32 master parameters get their
    # gradients through it
    params = _cast_floats(params, wav.dtype)

    if setup.base == "whisper":
        if group_size(sp_group) > 1:
            raise ValueError("encoder sequence parallelism covers the HuBERT path (the Whisper "
                             "encoder is 30 s-bounded by its mel featurization)")
        w_cfg = setup.encoder_cfg
        mel = log_mel_spectrogram(wav, w_cfg, pad_to_frames=mel_frame_budget(
            w_cfg, N, setup.whisper_dynamic_frames))
        frames, _ = whisper_forward(params["encoder"], w_cfg, mel, wav_lens // w_cfg.hop_length,
                                    remat=remat)
    else:
        frames, _ = hubert_forward(params["encoder"], setup.encoder_cfg, wav, wav_mask,
                                   remat=remat, sp_group=sp_group)
    if setup.downsample_method == "pool":
        pooled = avg_pool_time(frames, setup.pool_kernel, setup.pool_stride)
        emb_lens = audio_embed_lengths(setup, wav_lens)
    elif setup.downsample_method == "stack":
        pooled = stack_downsample(frames, setup.downsample_factor)
        emb_lens = audio_embed_lengths(setup, wav_lens)
    else:
        pooled, valid = ctc_segment_mean(frames, ctc_pool_ranges)
        emb_lens = valid.to(torch.int32).sum(dim=1)
    embeds = pooled @ params["proj_w"] + params["proj_b"]
    return embeds, torch.clamp(emb_lens, 0, embeds.shape[1]).to(torch.int32)


class AudioEncoder:
    """Object wrapper bundling the setup with init and apply (the JAX
    package's ``AudioEncoder``). ``device=None`` is the CUDA card and
    raises without one; ``"cpu"`` runs the plain path."""

    def __init__(self, config: Config, dtype=torch.bfloat16, device=None):
        self.setup = encoder_setup_from_config(config)
        self.dtype = dtype
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters on the wrapper's device (``generator`` lives
        there too)."""
        return init_audio_encoder(generator, self.setup, self.dtype, self.device)

    def __call__(self, params, wav, wav_lens=None, ctc_pool_ranges=None, remat=False):
        return audio_encoder_forward(params, self.setup, wav, wav_lens, ctc_pool_ranges,
                                     remat=remat)
