"""HuBERT speech encoder (port of ``models/hubert.py``).

waveform (B, N) → conv feature extractor (×320, 20 ms frames) → feature
projection → + grouped positional conv → transformer blocks → (B, T, D).
Convolutions are plain ``torch.nn.functional.conv1d`` (the JAX package
left them to XLA); self-attention runs through the differentiable flash
attention (B1 forward, B6 backward) with per-sample windows ``[0,
n_valid)``, so padded frames are masked and any frame count runs without
padding. GELU is exact (erf). ``remat`` recomputes each transformer layer
in the backward (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``).
A float32 forward on the card (the HuBERT-CTC model, ``hubert_ctc_logits``)
runs B1's float32 instance, and its convolutions and products without TF32.

Sequence parallelism (``sp_group``, the long-audio trainer): the waveform
and the frames shard over the group's ranks. The conv stem borrows its
receptive-field halo from the right neighbour and the positional conv K/2
frames from each neighbour (``parallel/comm.halo_shift``; the ranks at the
ends receive zeros, the global zero padding), and self-attention is the
bidirectional ``ring_attention`` (kernel B7 per block on the card). The
frames come back gathered on every rank, equal to the unsharded forward's
on valid frames. It needs the layer-normed stem and pre-LN blocks, which
are per-frame: hubert-base's group norm takes moments over all frames, so
its variant raises there, as in the JAX package.

Both HF variants: hubert-large (layer-normed conv stem with bias, pre-LN
"stable" blocks, the encoder LayerNorm after them) and hubert-base (no conv
bias, a group norm with groups = channels on the first conv layer only,
the encoder LayerNorm before the post-LN blocks), and a tiny preset of
the large one for tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import exact_float32
from ..kernels.flash_attention import flash_attention
from ..ops.norms import layer_norm
from ..ops.ring_attention import ring_attention
from ..parallel.comm import all_gather, group_rank, group_size, halo_shift

Params = Dict[str, Any]


@dataclass(frozen=True)
class HubertConfig:
    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (large) | "group" (base)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = True  # pre-LN (large) | post-LN (base)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16


_PRESETS = {
    "hubert_large": HubertConfig(),
    "hubert_base": HubertConfig(
        conv_bias=False,
        feat_extract_norm="group",
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        do_stable_layer_norm=False,
    ),
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
    aliases = {
        "facebook/hubert-large-ls960-ft": "hubert_large",
        "facebook/hubert-base-ls960": "hubert_base",
    }
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


def conv_receptive_field(cfg: HubertConfig) -> Tuple[int, int]:
    """(receptive field, total stride) of the conv stem, in samples: a
    sequence-parallel shard borrows R - S samples from its right neighbour."""
    R, S = 1, 1
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        R += (k - 1) * S
        S *= s
    return R, S


def init_hubert_params(
    generator: torch.Generator, cfg: HubertConfig, dtype=torch.bfloat16, device=None
) -> Params:
    """Random init with the JAX package's distributions: normal(0.02)
    weights, ones for norm scales, zeros for biases; the conv layers carry
    the JAX tree's keys (``b`` with a conv bias, ``ln_*`` on every layer of
    the layer-normed stem, ``gn_*`` on the first layer of the group-normed
    one)."""
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
    for i, (dim, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        layer = {"w": normal((dim, in_dim, k))}  # torch (out, in, k) layout
        if cfg.conv_bias:
            layer["b"] = zeros((dim,))
        if cfg.feat_extract_norm == "layer":
            layer["ln_scale"] = ones((dim,))
            layer["ln_bias"] = zeros((dim,))
        elif i == 0:
            layer["gn_scale"] = ones((dim,))
            layer["gn_bias"] = zeros((dim,))
        conv_layers.append(layer)
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
        if "b" in layer:
            x = x + layer["b"][None, :, None]
        if "ln_scale" in layer:  # layer norm over channels
            x = layer_norm(x.transpose(1, 2), layer["ln_scale"], layer["ln_bias"],
                           cfg.layer_norm_eps).transpose(1, 2)
        elif "gn_scale" in layer:
            # group norm, groups == channels: each channel over all T frames
            # of the buffer, pad frames included (HF and the JAX package),
            # float32 moments
            xf = x.float()
            var, mean = torch.var_mean(xf, dim=2, keepdim=True, correction=0)
            xf = (xf - mean) * torch.rsqrt(var + cfg.layer_norm_eps)
            x = xf.to(x.dtype) * layer["gn_scale"][None, :, None] + layer["gn_bias"][None, :, None]
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


def _feature_extractor_sp(params, cfg, wav_local, group):
    """The conv stem on this rank's (B, N/n) samples plus the R - S samples
    that start its right neighbour's shard (zeros on the last rank): valid
    convolutions are translation-invariant, so the local frames are the
    global frames whose windows start in the local samples."""
    R, S = conv_receptive_field(cfg)
    halo = R - S
    F_local = wav_local.shape[1] // S
    if hubert_frame_count(cfg, wav_local.shape[1] + halo) < F_local:
        raise ValueError(f"a shard of {wav_local.shape[1]} samples plus the {halo}-sample halo "
                         f"gives fewer than {F_local} frames")
    right = halo_shift(wav_local[:, :halo], -1, group)
    return _feature_extractor(params, cfg, torch.cat([wav_local, right], dim=1))[:, :F_local]


def _pos_conv_sp(params, cfg, h, group):
    """The positional conv on this rank's frames with K/2 halo frames from
    each neighbour (zeros at the ends), a valid conv and the even kernel's
    extra frame cropped: per frame the unsharded ``_pos_conv``."""
    K = cfg.pos_conv_kernel
    if K % 2:
        raise ValueError("the sequence-parallel positional conv assumes an even kernel")
    pad = K // 2
    F_local = h.shape[1]
    if F_local < pad:
        raise ValueError(f"local frames {F_local} < the positional conv's halo {pad}")
    left = halo_shift(h[:, -pad:], 1, group)  # my tail → the right neighbour's left halo
    right = halo_shift(h[:, :pad], -1, group)  # my head → the left neighbour's right halo
    out = F.conv1d(torch.cat([left, h, right], dim=1).transpose(1, 2),
                   params["pos_conv_w"].to(h.dtype), groups=cfg.pos_conv_groups)
    out = out + params["pos_conv_b"][None, :, None]
    return F.gelu(out[:, :, :F_local]).transpose(1, 2)


def _blocks(params, cfg, h, remat, attention):
    """The transformer blocks with ``attention(q, k, v)`` and the encoder
    LayerNorm: pre-LN blocks then the norm (large), or the norm then
    post-LN blocks (base)."""
    B, T, _ = h.shape
    Hh = cfg.num_heads
    Dh = cfg.hidden_size // Hh

    pre_ln = cfg.do_stable_layer_norm
    eps = cfg.layer_norm_eps

    def attn_ffn(h, lp):
        a_in = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], eps) if pre_ln else h
        q = (a_in @ lp["wq"] + lp["bq"]).reshape(B, T, Hh, Dh)
        k = (a_in @ lp["wk"] + lp["bk"]).reshape(B, T, Hh, Dh)
        v = (a_in @ lp["wv"] + lp["bv"]).reshape(B, T, Hh, Dh)
        a = attention(q, k, v)
        h = h + (a.reshape(B, T, cfg.hidden_size) @ lp["wo"] + lp["bo"])
        if pre_ln:
            f_in = layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], eps)
        else:
            h = f_in = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], eps)
        f = F.gelu(f_in @ lp["w1"] + lp["b1"])
        h = h + (f @ lp["w2"] + lp["b2"])
        return h if pre_ln else layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], eps)

    if not pre_ln:
        h = layer_norm(h, params["encoder_ln_scale"], params["encoder_ln_bias"], eps)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        if remat and torch.is_grad_enabled():
            h = checkpoint(attn_ffn, h, lp, use_reentrant=False)
        else:
            h = attn_ffn(h, lp)
    if not pre_ln:
        return h
    return layer_norm(h, params["encoder_ln_scale"], params["encoder_ln_bias"], eps)


def _hubert_forward_sp(params, cfg, wav, wav_mask, remat, group):
    """The sequence-parallel forward: this rank convolves its shard of the
    (B, N) waveform into N / (S·n) frames, the blocks run the bidirectional
    ring over [0, n_valid), and the frames are gathered (the gradient summed
    over the ranks, whose downstreams differ) and cut to the unsharded
    frame count: the last shard's overhang frame only keeps the shards
    equal, and is masked."""
    if cfg.feat_extract_norm != "layer" or not cfg.do_stable_layer_norm:
        raise ValueError("encoder sequence parallelism needs the layer-normed conv stem and "
                         "pre-LN blocks (hubert-large): hubert-base's group norm takes its "
                         "moments over all frames of the buffer, which no shard holds")
    B, N = wav.shape
    n, r = group_size(group), group_rank(group)
    _, S = conv_receptive_field(cfg)
    if N % (S * n):
        raise ValueError(f"encoder sequence parallelism needs audio buckets divisible by "
                         f"stride * seq = {S * n}, got {N}")
    Nl = N // n
    T = (N // (S * n)) * n  # one (masked) frame beyond the unsharded count
    T_real = hubert_frame_count(cfg, N)
    feats = _feature_extractor_sp(params, cfg, wav[:, r * Nl:(r + 1) * Nl], group)
    F_local = feats.shape[1]
    if wav_mask is None:
        n_valid = torch.full((B,), T_real, dtype=torch.int32, device=wav.device)
    else:
        n_valid = hubert_frame_count(cfg, wav_mask.to(torch.int32).sum(dim=1)).to(torch.int32)
    n_valid = torch.clamp(n_valid, 0, T_real).to(torch.int32)
    frame_mask = torch.arange(T, device=wav.device)[None, :] < n_valid[:, None]
    local_mask = frame_mask[:, r * F_local:(r + 1) * F_local]

    h = layer_norm(feats, params["fp_ln_scale"], params["fp_ln_bias"], cfg.layer_norm_eps)
    h = h @ params["fp_w"].to(h.dtype) + params["fp_b"]
    h = h * local_mask[..., None].to(h.dtype)
    h = h + _pos_conv_sp(params, cfg, h, group)
    starts = torch.zeros((B,), dtype=torch.int32, device=wav.device)
    h = _blocks(params, cfg, h, remat,
                lambda q, k, v: ring_attention(q, k, v, starts, group, causal=False, ends=n_valid))
    frames = all_gather(h, group, grad="sum")  # (n, B, F_local, D)
    frames = frames.transpose(0, 1).reshape(B, T, -1)
    return frames[:, :T_real], frame_mask[:, :T_real]


def hubert_forward(
    params: Params,
    cfg: HubertConfig,
    wav: torch.Tensor,
    wav_mask: torch.Tensor | None = None,
    remat: bool = False,
    sp_group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """waveform (B, N) [+ sample-validity mask] → (frames (B, T, D),
    frame_mask (B, T)). ``remat``: recompute each layer in the backward.
    ``sp_group``: shard the frames over the group's ranks (see the module
    docstring); every rank passes the same waveform and gets every frame."""
    if group_size(sp_group) > 1:
        return _hubert_forward_sp(params, cfg, wav, wav_mask, remat, sp_group)
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

    starts = torch.zeros((B,), dtype=torch.int32, device=wav.device)
    h = _blocks(params, cfg, h, remat,
                lambda q, k, v: flash_attention(q, k, v, starts, n_valid, causal=False))
    return h, frame_mask


def init_hubert_ctc_head(generator: torch.Generator, cfg: HubertConfig, vocab_size: int,
                         dtype=torch.bfloat16, device=None) -> Params:
    """CTC head (HF HubertForCTC's ``lm_head``) of the word-offset model the
    preprocessing job runs: normal(0.02) weights (D, V), zero bias."""
    w = torch.randn((cfg.hidden_size, vocab_size), generator=generator, dtype=torch.float32,
                    device=device)
    return {"ctc_w": (0.02 * w).to(dtype),
            "ctc_b": torch.zeros((vocab_size,), dtype=dtype, device=device)}


def hubert_ctc_logits(
    params: Params,
    head: Params,
    cfg: HubertConfig,
    wav: torch.Tensor,
    wav_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """waveform → (framewise CTC logits (B, T, V) float32, frame_mask); the
    HuBERT forward inside runs B1 on the card, in float32 (B1's float32
    instance, no TF32) for a float32 waveform and tree."""
    with exact_float32(wav):
        frames, frame_mask = hubert_forward(params, cfg, wav, wav_mask)
        logits = frames @ head["ctc_w"].to(frames.dtype) + head["ctc_b"]
    return logits.float(), frame_mask
