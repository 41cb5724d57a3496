"""Plain PyTorch reference of the models the benchmark runs: HuBERT-large,
the Whisper-medium encoder with its log-mel front end, the pool projector,
the prompt splice and the MiniChat (Llama-architecture) decoder, with the
int8 KV-cache quantization that the configurations state.

Everything works on one utterance at a time, unpadded, in float32 (TF32
off), so no mask, bucket or kernel of the program is needed. Weights are
the nested dicts of tensors that ``portbench/weights.py`` makes from the
seed (the same trees the program is handed); sizes come from the
configuration file. This file imports nothing of the program.

``Precision`` says how values are rounded: "float32" keeps them; "float8"
(the control that a lower precision must fail) rounds to float8 e4m3, each
with a per-tensor scale, the operands of every product (in the backward
too: the incoming gradient and the saved operands) and the activations
the program holds in its compute dtype (the residual stream, the
encoders' conv outputs, the audio embeddings), the gradient passing
straight through those.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, object]
FP8_MAX = 448.0  # largest float8 e4m3fn value


def exact_float32() -> None:
    """Float32 products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """Rounding of the operands of every product: "float32" keeps them;
    "float8" rounds both operands of each product to float8 e4m3 with a
    per-tensor scale, in the forward and, under autograd, in the backward
    too (the incoming gradient and the saved operands of each product)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision {name!r}: expected 'float32' or 'float8'")
        self.name = name

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as stored in the compute dtype."""
        x = x.float()
        if self.name == "float32":
            return x
        return x + (_fp8(x.detach()) - x).detach()

    def product(self, op, a, b, **kw):
        """``op(a, b, **kw)`` (a matmul, an einsum or a convolution) with
        both operands, and in the backward the incoming gradient, rounded."""
        if self.name == "float32":
            return op(a.float(), b.float(), **kw)
        return _Rounded.apply(op, kw, a.float(), b.float())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.product(torch.matmul, a, b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.product(lambda x, y: torch.einsum(eq, x, y), a, b)

    def conv1d(self, x, w, **kw):
        return self.product(F.conv1d, x, w, **kw)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax() / FP8_MAX, min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Rounded(torch.autograd.Function):
    """A product of float8-rounded operands, summed in float32; its
    backward forms the gradients from the rounded incoming gradient and
    the rounded operands."""

    @staticmethod
    def forward(ctx, op, kw, a, b):
        ra, rb = _fp8(a), _fp8(b)
        ctx.save_for_backward(ra, rb)
        ctx.op, ctx.kw = op, kw
        return op(ra, rb, **kw)

    @staticmethod
    def backward(ctx, dy):
        ra, rb = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = ctx.op(ra, rb, **ctx.kw)
        da, db = torch.autograd.grad(y, (ra, rb), _fp8(dy))
        return None, None, da, db


F32 = Precision("float32")


def layer_norm(x, w, b, eps=1e-5):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w.float() + b.float()


def rms_norm(x, w, eps):
    x = x.float()
    return x / torch.sqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def attention(q, k, v, prec: Precision, causal: bool):
    """q (n, H, Dh), k/v (m, H, Dh) → (n, H, Dh); causal aligns the last
    query with the last key."""
    n, H, Dh = q.shape
    s = prec.einsum("nhd,mhd->hnm", q, k) / math.sqrt(Dh)
    if causal:
        m = k.shape[0]
        keep = torch.ones((n, m), dtype=torch.bool, device=q.device).tril(m - n)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return prec.einsum("hnm,mhd->nhd", p, v)


def _layer(tree, i):
    return {k: w[i] for k, w in tree["layers"].items()}


# ---------------------------------------------------------------- HuBERT


def hubert_frames(p: Tree, cfg: dict, wav: torch.Tensor, prec: Precision = F32):
    """One clip's (N,) waveform → its valid frames (T, D) (HF
    HubertModel, the large "stable layer norm" variant)."""
    x = wav.float()[None, None, :]
    for i, layer in enumerate(p["conv_layers"]):
        x = prec.conv1d(x, layer["w"], stride=cfg["conv_strides"][i]) + layer["b"].float()[None, :, None]
        x = layer_norm(x.transpose(1, 2), layer["ln_scale"], layer["ln_bias"], cfg["eps"]).transpose(1, 2)
        x = prec.act(F.gelu(x))
    h = x[0].transpose(0, 1)  # (T, C)
    h = layer_norm(h, p["fp_ln_scale"], p["fp_ln_bias"], cfg["eps"])
    h = prec.act(prec.mm(h, p["fp_w"]) + p["fp_b"].float())
    K, G = cfg["pos_conv_kernel"], cfg["pos_conv_groups"]
    pc = prec.conv1d(h.t()[None], p["pos_conv_w"], padding=K // 2, groups=G)[0]
    pc = pc + p["pos_conv_b"].float()[:, None]
    if K % 2 == 0:
        pc = pc[:, :-1]
    h = prec.act(h + F.gelu(pc).t())
    H = cfg["num_heads"]
    T, D = h.shape
    for i in range(cfg["num_layers"]):
        lp = _layer(p, i)
        a = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg["eps"])
        q = (prec.mm(a, lp["wq"]) + lp["bq"].float()).reshape(T, H, D // H)
        k = (prec.mm(a, lp["wk"]) + lp["bk"].float()).reshape(T, H, D // H)
        v = (prec.mm(a, lp["wv"]) + lp["bv"].float()).reshape(T, H, D // H)
        h = prec.act(h + prec.mm(attention(q, k, v, prec, causal=False).reshape(T, D), lp["wo"])
                     + lp["bo"].float())
        f = layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], cfg["eps"])
        f = F.gelu(prec.mm(f, lp["w1"]) + lp["b1"].float())
        h = prec.act(h + prec.mm(f, lp["w2"]) + lp["b2"].float())
    return layer_norm(h, p["encoder_ln_scale"], p["encoder_ln_bias"], cfg["eps"])


# ---------------------------------------------------------------- Whisper


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (math.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalized triangular filters (n_fft // 2 + 1, n_mels), as
    librosa and WhisperFeatureExtractor build them."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[None, :] - freqs[:, None]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return fb * (2.0 / (hz[2:] - hz[:-2]))[None, :]


def whisper_mel_frames(cfg: dict, batch_samples: int) -> int:
    """Mel frames of a batch padded to ``batch_samples`` with the dynamic
    budget: its own frames rounded up to even, at most the 30 s window."""
    need = batch_samples // cfg["hop_length"]
    return min(2 * cfg["max_source_positions"], max(((need + 1) // 2) * 2, 2))


def log_mel(cfg: dict, wav: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(N,) waveform zero-padded (or cut) to ``n_frames`` hops → (n_mels,
    n_frames) Whisper-normalized log-mel, float32 (float64 power sums)."""
    hop, n_fft = cfg["hop_length"], cfg["n_fft"]
    x = wav.double()
    target = n_frames * hop
    x = F.pad(x, (0, target - x.shape[0])) if target > x.shape[0] else x[:target]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, n_fft, hop_length=hop, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[:, :-1]
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filters(cfg["sampling_rate"], n_fft, cfg["num_mel_bins"])).to(x.device)
    mel = fb.t() @ power
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).float()


def whisper_frames(p: Tree, cfg: dict, wav: torch.Tensor, batch_samples: int,
                   prec: Precision = F32):
    """One clip of a batch padded to ``batch_samples`` → its valid encoder
    frames (T_valid, D)."""
    n_mel = whisper_mel_frames(cfg, batch_samples)
    mel = log_mel(cfg, wav, n_mel)[None]
    x = prec.act(F.gelu(prec.conv1d(mel, p["conv1_w"], padding=1) + p["conv1_b"].float()[None, :, None]))
    x = prec.act(F.gelu(prec.conv1d(x, p["conv2_w"], stride=2, padding=1)
                        + p["conv2_b"].float()[None, :, None]))
    h = x[0].t()
    n_valid = min((wav.shape[0] // cfg["hop_length"] + 1) // 2, h.shape[0])
    h = (h + p["pos_embed"].float()[: h.shape[0]])[:n_valid]
    T, D = h.shape
    H = cfg["num_heads"]
    for i in range(cfg["num_layers"]):
        lp = _layer(p, i)
        a = layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg["eps"])
        q = (prec.mm(a, lp["wq"]) + lp["bq"].float()).reshape(T, H, D // H)
        k = prec.mm(a, lp["wk"]).reshape(T, H, D // H)
        v = (prec.mm(a, lp["wv"]) + lp["bv"].float()).reshape(T, H, D // H)
        h = prec.act(h + prec.mm(attention(q, k, v, prec, causal=False).reshape(T, D), lp["wo"])
                     + lp["bo"].float())
        f = layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], cfg["eps"])
        h = prec.act(h + prec.mm(F.gelu(prec.mm(f, lp["w1"]) + lp["b1"].float()), lp["w2"])
                     + lp["b2"].float())
    return layer_norm(h, p["final_ln_scale"], p["final_ln_bias"], cfg["eps"])


# ---------------------------------------------------------------- projector


def embed_count(n_samples: int, sr: int, factor: int) -> int:
    """Audio embeddings a clip of ``n_samples`` gives (20 ms frames after a
    10 ms edge, pooled by ``factor``, one dropped)."""
    frames = (n_samples - sr // 100) // (sr // 50)
    return max(frames // factor - 1, 0)


def audio_embeds(enc: Tree, config: dict, wav: torch.Tensor, batch_samples: int,
                 prec: Precision = F32) -> torch.Tensor:
    """Encoder → AvgPool1d(kernel, stride) → Linear: the clip's (e, E)
    prompt embeddings."""
    ec = config["encoder"]
    if ec["type"] == "whisper":
        frames = whisper_frames(enc["encoder"], ec, wav, batch_samples, prec)
    else:
        frames = hubert_frames(enc["encoder"], ec, wav, prec)
    pj = config["projector"]
    k, s = pj["pool_kernel"], pj["pool_stride"]
    e = embed_count(wav.shape[0], ec["sampling_rate"], pj["downsample_factor"])
    idx = torch.arange(e, device=wav.device) * s
    cs = F.pad(torch.cumsum(frames, 0), (0, 0, 1, 0))
    pooled = (cs[idx + k] - cs[idx]) / k
    return prec.act(prec.mm(pooled, enc["proj_w"]) + enc["proj_b"].float())


# ---------------------------------------------------------------- decoder


def byte_ids(text: str, bos: Optional[int] = None) -> List[int]:
    """The offline byte tokenizer: UTF-8 bytes, BOS first when given."""
    ids = list(text.encode("utf-8"))
    return ([bos] if bos is not None else []) + ids


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, H, Dh) at positions 0..n-1, HF rotate-half layout."""
    n, _, Dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float64, device=x.device) / Dh))
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """The int8 cache as stored and read back: per (position, head)
    symmetric absmax, scale max(absmax / 127, 1e-8) in float32, values
    round-half-even to ±127, read with the scale rounded to bfloat16."""
    absmax = x.abs().amax(-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale.to(torch.bfloat16).float()


def _cached_attention(q, k, v, n_prompt, prec: Precision):
    """Causal attention where queries at positions >= ``n_prompt`` (decode
    steps) read every earlier key and value through the int8 cache and
    their own fresh; prompt queries (the prefill) read them exact."""
    n, H, Dh = q.shape
    kq, vq = quantize_int8(k), quantize_int8(v)
    pos = torch.arange(n, device=q.device)
    exact = (pos[:, None] < n_prompt) | (pos[:, None] == pos[None, :])  # (query, key)
    s_e = prec.einsum("nhd,mhd->hnm", q, k)
    s_q = prec.einsum("nhd,mhd->hnm", q, kq)
    s = torch.where(exact[None], s_e, s_q) / math.sqrt(Dh)
    s = s.masked_fill(~(pos[:, None] >= pos[None, :])[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    pe, pq = torch.where(exact[None], p, 0.0), torch.where(exact[None], 0.0, p)
    return prec.einsum("hnm,mhd->nhd", pe, v) + prec.einsum("hnm,mhd->nhd", pq, vq)


def llama(p: Tree, cfg: dict, x: torch.Tensor, prec: Precision = F32, *,
          hidden_at: Optional[List[int]] = None, n_prompt: Optional[int] = None,
          logits_from: int = 0):
    """Decoder over one unpadded sequence of input embeddings x (n, D).

    Returns (logits of positions ``logits_from``.. (n', V), hidden states at
    ``hidden_at``: 0 the embeddings, i the output of block i). With
    ``n_prompt`` the positions from it on are decode steps over the int8
    cache (``_cached_attention``)."""
    n, D = x.shape
    H, Hkv, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = prec.act(x)
    hidden = {0: x} if hidden_at and 0 in hidden_at else {}
    for i in range(cfg["num_hidden_layers"]):
        lp = _layer(p, i)
        h = rms_norm(x, lp["input_norm"], eps)
        q = rope(prec.mm(h, lp["wq"]).reshape(n, H, Dh), theta)
        k = rope(prec.mm(h, lp["wk"]).reshape(n, Hkv, Dh), theta)
        v = prec.mm(h, lp["wv"]).reshape(n, Hkv, Dh)
        if Hkv != H:
            k, v = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
        a = (attention(q, k, v, prec, causal=True) if n_prompt is None
             else _cached_attention(q, k, v, n_prompt, prec))
        x = prec.act(x + prec.mm(a.reshape(n, H * Dh), lp["wo"]))
        h = rms_norm(x, lp["post_attn_norm"], eps)
        x = prec.act(x + prec.mm(F.silu(prec.mm(h, lp["w_gate"])) * prec.mm(h, lp["w_up"]),
                                 lp["w_down"]))
        if hidden_at and i + 1 in hidden_at:
            hidden[i + 1] = x
    x = rms_norm(x[logits_from:], p["final_norm"], eps)
    head = p["embed_tokens"].t() if cfg["tie_word_embeddings"] else p["lm_head"]
    return prec.mm(x, head), hidden


def token_embeds(p: Tree, ids) -> torch.Tensor:
    table = p["embed_tokens"]
    return table[torch.as_tensor(ids, dtype=torch.long, device=table.device)].float()


def prompt(p: Tree, config: dict, audio: torch.Tensor, mid_text_ids=None) -> torch.Tensor:
    """[BOS + prefix | audio embeds (or the transcript's tokens) | suffix]
    input embeddings of the chat template, byte-tokenized."""
    tpl = config["template"]
    pre = token_embeds(p, byte_ids(tpl["prefix"], tpl["bos_id"]))
    suf = token_embeds(p, byte_ids(tpl["suffix"]))
    mid = audio if mid_text_ids is None else token_embeds(p, mid_text_ids)
    return torch.cat([pre, mid.float(), suf])
