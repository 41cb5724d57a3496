"""HuBERT speech encoder (port of ``models/hubert.py``, the unsharded path).

waveform (B, N) → conv feature extractor (×320, 20 ms frames) → feature
projection → + grouped positional conv → transformer blocks → (B, T, D).
Convolutions are plain ``torch.nn.functional.conv1d`` (the JAX package
left them to XLA); self-attention runs through the differentiable flash
attention (B1 forward, B6 backward) with per-sample windows ``[0,
n_valid)``, so padded frames are masked and any frame count runs without
padding. GELU is exact (erf). ``remat`` recomputes each transformer layer
in the backward (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``).

Ported: the hubert-large architecture (layer-normed conv stem with bias,
pre-LN "stable" blocks) and a tiny preset of it for tests. Not ported yet:
hubert-base's group-norm stem and post-LN blocks (ROADMAP queue A item 4)
and the sequence-parallel path (halo exchange + ring attention, item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..ops.norms import layer_norm

Params = Dict[str, Any]


@dataclass(frozen=True)
class HubertConfig:
    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16


_PRESETS = {
    "hubert_large": HubertConfig(),
    "tiny": HubertConfig(
        conv_dims=(32, 32, 32, 32),
        conv_kernels=(10, 8, 4, 4),
        conv_strides=(5, 4, 4, 4),  # ×320 total like the real model
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        intermediate_size=128,
        pos_conv_kernel=16,
        pos_conv_groups=4,
    ),
}


def hubert_preset(name: str) -> HubertConfig:
    aliases = {"facebook/hubert-large-ls960-ft": "hubert_large"}
    key = aliases.get(name, name)
    if key not in _PRESETS:
        raise KeyError(f"unknown hubert preset '{name}' (have {sorted(_PRESETS)})")
    return _PRESETS[key]


def hubert_frame_count(cfg: HubertConfig, num_samples):
    """Frames out of the conv feature extractor for given sample counts
    (ints or integer tensors)."""
    n = num_samples
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        n = (n - k) // s + 1
    return n


def init_hubert_params(
    generator: torch.Generator, cfg: HubertConfig, dtype=torch.bfloat16, device=None
) -> Params:
    """Random init with the JAX package's distributions: normal(0.02)
    weights, ones for norm scales, zeros for biases."""
    D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (0.02 * w).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    conv_layers = []
    in_dim = 1
    for dim, k in zip(cfg.conv_dims, cfg.conv_kernels):
        conv_layers.append({
            "w": normal((dim, in_dim, k)),  # torch (out, in, k) layout
            "b": zeros((dim,)),
            "ln_scale": ones((dim,)),
            "ln_bias": zeros((dim,)),
        })
        in_dim = dim

    return {
        "conv_layers": conv_layers,
        "fp_ln_scale": ones((cfg.conv_dims[-1],)),
        "fp_ln_bias": zeros((cfg.conv_dims[-1],)),
        "fp_w": normal((cfg.conv_dims[-1], D)),
        "fp_b": zeros((D,)),
        # combined weight-norm pos-conv weight, (D, D / groups, K)
        "pos_conv_w": normal((D, D // cfg.pos_conv_groups, cfg.pos_conv_kernel)),
        "pos_conv_b": zeros((D,)),
        "layers": {
            "ln1_scale": ones((L, D)),
            "ln1_bias": zeros((L, D)),
            "wq": normal((L, D, D)),
            "bq": zeros((L, D)),
            "wk": normal((L, D, D)),
            "bk": zeros((L, D)),
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
        "encoder_ln_scale": ones((D,)),
        "encoder_ln_bias": zeros((D,)),
    }


def _feature_extractor(params: Params, cfg: HubertConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B, N) waveform → (B, T, C) conv features."""
    x = wav[:, None, :]
    for i, layer in enumerate(params["conv_layers"]):
        x = F.conv1d(x, layer["w"].to(x.dtype), stride=cfg.conv_strides[i])
        x = x + layer["b"][None, :, None]
        # layer norm over channels
        x = layer_norm(x.transpose(1, 2), layer["ln_scale"], layer["ln_bias"],
                       cfg.layer_norm_eps).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _pos_conv(params: Params, cfg: HubertConfig, x: torch.Tensor) -> torch.Tensor:
    """HF HubertPositionalConvEmbedding: grouped conv, pad K/2, crop one
    frame when K is even."""
    h = F.conv1d(
        x.transpose(1, 2),
        params["pos_conv_w"].to(x.dtype),
        padding=cfg.pos_conv_kernel // 2,
        groups=cfg.pos_conv_groups,
    )
    h = h + params["pos_conv_b"][None, :, None]
    if cfg.pos_conv_kernel % 2 == 0:
        h = h[:, :, :-1]
    return F.gelu(h).transpose(1, 2)


def hubert_forward(
    params: Params,
    cfg: HubertConfig,
    wav: torch.Tensor,
    wav_mask: torch.Tensor | None = None,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """waveform (B, N) [+ sample-validity mask] → (frames (B, T, D),
    frame_mask (B, T)). ``remat``: recompute each layer in the backward."""
    B, _ = wav.shape
    feats = _feature_extractor(params, cfg, wav)
    T = feats.shape[1]
    if wav_mask is None:
        n_valid = torch.full((B,), T, dtype=torch.int32, device=wav.device)
    else:
        n_valid = hubert_frame_count(cfg, wav_mask.to(torch.int32).sum(dim=1)).to(torch.int32)
    frame_mask = torch.arange(T, device=wav.device)[None, :] < n_valid[:, None]
    n_valid = frame_mask.to(torch.int32).sum(dim=1).to(torch.int32)  # clipped to [0, T]

    h = layer_norm(feats, params["fp_ln_scale"], params["fp_ln_bias"], cfg.layer_norm_eps)
    h = h @ params["fp_w"].to(h.dtype) + params["fp_b"]
    # zero padded frames so the positional conv sees zeros there
    h = h * frame_mask[..., None].to(h.dtype)
    h = h + _pos_conv(params, cfg, h)

    Hh = cfg.num_heads
    Dh = cfg.hidden_size // Hh
    starts = torch.zeros((B,), dtype=torch.int32, device=wav.device)
    def attn_ffn(h, lp):
        a_in = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg.layer_norm_eps)
        q = (a_in @ lp["wq"] + lp["bq"]).reshape(B, T, Hh, Dh)
        k = (a_in @ lp["wk"] + lp["bk"]).reshape(B, T, Hh, Dh)
        v = (a_in @ lp["wv"] + lp["bv"]).reshape(B, T, Hh, Dh)
        a = flash_attention(q, k, v, starts, n_valid, causal=False)
        h = h + (a.reshape(B, T, cfg.hidden_size) @ lp["wo"] + lp["bo"])
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
    h = layer_norm(h, params["encoder_ln_scale"], params["encoder_ln_bias"], cfg.layer_norm_eps)
    return h, frame_mask
