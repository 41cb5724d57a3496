"""Whisper encoder (openai/whisper-medium) + log-mel frontend (port of
``models/whisper.py``).

* ``log_mel_spectrogram``: Whisper's frontend (n_fft 400, hop 160, periodic
  Hann window, 80 Slaney-scale mel bins, log10 with an 8-decade floor under
  the sample's maximum and (x + 4) / 4), in float32. Where the JAX package
  multiplies frames by a DFT basis at ``Precision.HIGHEST``, this takes
  ``torch.stft`` with the same window and framing (reflect padding of
  n_fft // 2, the last frame dropped): an FFT has no TF32 mode, and the mel
  projection runs in float64, so no global TF32 flag reaches the frontend.
* encoder: conv stem (k3 s1 → GELU → k3 s2 → GELU) through
  ``torch.nn.functional.conv1d``, fixed sinusoidal positions, pre-LN
  transformer blocks, a final LayerNorm. Self-attention runs through the
  flash attention (B1 forward, B6 backward) with per-sample windows
  ``[0, n_valid)``, so padded frames are masked and any frame count runs
  without padding. GELU is exact (erf). ``remat`` recomputes each layer in
  the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..ops.norms import layer_norm

Params = Dict[str, Any]


@dataclass(frozen=True)
class WhisperConfig:
    num_mel_bins: int = 80
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_source_positions: int = 1500  # 30 s of 20 ms frames
    layer_norm_eps: float = 1e-5
    # frontend
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160


_PRESETS = {
    "whisper_medium": WhisperConfig(),
    "whisper_base": WhisperConfig(d_model=512, num_layers=6, num_heads=8, ffn_dim=2048),
    "tiny": WhisperConfig(
        num_mel_bins=80, d_model=64, num_layers=2, num_heads=4, ffn_dim=128,
        max_source_positions=1500,
    ),
}


def whisper_preset(name: str) -> WhisperConfig:
    aliases = {
        "openai/whisper-medium": "whisper_medium",
        "openai/whisper-base": "whisper_base",
    }
    key = aliases.get(name, name)
    if key not in _PRESETS:
        raise KeyError(f"unknown whisper preset '{name}' (have {sorted(_PRESETS)})")
    return _PRESETS[key]


def mel_frame_budget(cfg: WhisperConfig, num_samples: int, dynamic: bool) -> int:
    """Mel frames the encoder sees for ``num_samples`` of audio: the fixed
    30 s budget (WhisperFeatureExtractor's pad or cut), or with ``dynamic``
    the input's own frames rounded up to even (the stride-2 conv), capped
    at that budget (the JAX ``audio_encoder_forward``)."""
    budget = 2 * cfg.max_source_positions
    if dynamic:
        need = num_samples // cfg.hop_length
        need = ((need + 1) // 2) * 2
        budget = min(budget, max(need, 2))
    return budget


def whisper_frame_count(mel_frames: int) -> int:
    """Encoder frames out of the conv stem for ``mel_frames`` mel frames:
    k3 s1 p1 keeps the count, k3 s2 p1 halves it rounding up."""
    return (mel_frames - 1) // 2 + 1


# ---------------------------------------------------------------------------
# Log-mel frontend
# ---------------------------------------------------------------------------


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-style mel scale (what HF WhisperFeatureExtractor uses)."""
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=4)
def _mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, (n_fft//2+1, n_mels)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(np.array(0.0)), _hz_to_mel(np.array(sr / 2.0)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]  # (F, n_mels+2)
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    return (fb * enorm[None, :]).astype(np.float32)


def log_mel_spectrogram(
    wav: torch.Tensor, cfg: WhisperConfig, pad_to_frames: int | None = None
) -> torch.Tensor:
    """(B, N) waveform → (B, n_mels, T) Whisper-normalized log-mel, float32.

    ``pad_to_frames`` zero-pads or cuts the raw audio to that many hops
    before the transform, as HF WhisperFeatureExtractor does."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    wav = wav.float()
    if pad_to_frames is not None:
        target = pad_to_frames * hop
        N = wav.shape[1]
        wav = F.pad(wav, (0, target - N)) if target > N else wav[:, :target]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=wav.device)
    spec = torch.stft(wav, n_fft, hop_length=hop, window=window, center=True,
                      pad_mode="reflect", return_complex=True)[..., :-1]  # (B, F, T)
    power = spec.real.square() + spec.imag.square()
    filters = torch.from_numpy(_mel_filters(cfg.sampling_rate, n_fft, cfg.num_mel_bins))
    mel = torch.einsum("bft,fm->bmt", power.double(),
                       filters.to(wav.device, torch.float64)).float()
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions (length, channels)."""
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def init_whisper_params(
    generator: torch.Generator, cfg: WhisperConfig, dtype=torch.bfloat16, device=None
) -> Params:
    """Random init with the JAX package's distributions: normal(0.02)
    weights, ones for norm scales, zeros for biases; conv weights in the
    torch (out, in, k) layout, layers stacked on a leading axis."""
    D, Fi, L = cfg.d_model, cfg.ffn_dim, cfg.num_layers

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (0.02 * w).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv1_w": normal((D, cfg.num_mel_bins, 3)),
        "conv1_b": zeros((D,)),
        "conv2_w": normal((D, D, 3)),
        "conv2_b": zeros((D,)),
        "pos_embed": torch.from_numpy(_sinusoids(cfg.max_source_positions, D)).to(device, dtype),
        "layers": {
            "ln1_scale": ones((L, D)),
            "ln1_bias": zeros((L, D)),
            "wq": normal((L, D, D)),
            "bq": zeros((L, D)),
            "wk": normal((L, D, D)),  # k has no bias in Whisper
            "wv": normal((L, D, D)),
            "bv": zeros((L, D)),
            "wo": normal((L, D, D)),
            "bo": zeros((L, D)),
            "ln2_scale": ones((L, D)),
            "ln2_bias": zeros((L, D)),
            "w1": normal((L, D, Fi)),
            "b1": zeros((L, Fi)),
            "w2": normal((L, Fi, D)),
            "b2": zeros((L, D)),
        },
        "final_ln_scale": ones((D,)),
        "final_ln_bias": zeros((D,)),
    }


def whisper_forward(
    params: Params,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    mel_frame_counts: torch.Tensor | None = None,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """mel (B, n_mels, T_mel) [+ valid mel frames per sample] → (frames
    (B, T, D), frame_mask (B, T)), T = ceil(T_mel / 2). ``remat``: recompute
    each layer in the backward."""
    B = mel.shape[0]
    x = mel.to(params["conv1_w"].dtype)
    x = F.gelu(F.conv1d(x, params["conv1_w"], padding=1) + params["conv1_b"][None, :, None])
    x = F.gelu(F.conv1d(x, params["conv2_w"], stride=2, padding=1)
               + params["conv2_b"][None, :, None])
    h = x.transpose(1, 2)  # (B, T, D)
    T = h.shape[1]
    if T > params["pos_embed"].shape[0]:
        raise ValueError(
            f"mel input yields {T} encoder frames > max_source_positions "
            f"{params['pos_embed'].shape[0]} (the 30 s whisper budget): pad_to_frames / cut "
            "the mel like HF does")
    h = h + params["pos_embed"][None, :T]

    if mel_frame_counts is None:
        n_valid = torch.full((B,), T, dtype=torch.int32, device=mel.device)
    else:
        n_valid = torch.clamp((mel_frame_counts.to(torch.int32) + 1) // 2, 0, T).to(torch.int32)
    frame_mask = torch.arange(T, device=mel.device)[None, :] < n_valid[:, None]

    Hh = cfg.num_heads
    Dh = cfg.d_model // Hh
    starts = torch.zeros((B,), dtype=torch.int32, device=mel.device)

    def attn_ffn(h, lp):
        a_in = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg.layer_norm_eps)
        q = (a_in @ lp["wq"] + lp["bq"]).reshape(B, T, Hh, Dh)
        k = (a_in @ lp["wk"]).reshape(B, T, Hh, Dh)
        v = (a_in @ lp["wv"] + lp["bv"]).reshape(B, T, Hh, Dh)
        a = flash_attention(q, k, v, starts, n_valid, causal=False)
        h = h + (a.reshape(B, T, cfg.d_model) @ lp["wo"] + lp["bo"])
        f_in = layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], cfg.layer_norm_eps)
        f = F.gelu(f_in @ lp["w1"] + lp["b1"])
        return h + (f @ lp["w2"] + lp["b2"])

    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        if remat and torch.is_grad_enabled():
            h = checkpoint(attn_ffn, h, lp, use_reentrant=False)
        else:
            h = attn_ffn(h, lp)
    h = layer_norm(h, params["final_ln_scale"], params["final_ln_bias"], cfg.layer_norm_eps)
    return h, frame_mask
