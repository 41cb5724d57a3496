"""Llama-family decoder (port of ``models/llama.py``): presets, the int8 KV
cache, int8 weight-only matmuls, and a forward for prefill and decode.

Parameters are a nested dict with the JAX pytree's keys and layouts:
stacked per-layer ``(L, in, out)`` weights, optionally fused (``wqkv``,
``w_gateup``) and int8-quantized with per-out-channel ``*_scale`` leaves.
The forward is a Python loop over layers.

Attention goes through hand-written kernels, and the tensors' device
picks the version: prefill (and the cache-free forward) calls
``flash_attention`` with the left-pad window ``[pad, T)``, which is the
forward kernel B1 without gradients and B1 with its log-sum-exp plus the
backward kernel B6 in training; a decode
step over the dense cache calls ``fused_decode``, which attends the cache
window ``[pad, offset)`` plus the fresh tokens and writes them into the
cache in place. Over the paged cache (``infer/paged.py``), a T == 1 step
calls ``fused_paged_decode`` (attention + in-place page write) and a
T > 1 verification forward calls ``paged_decode_attention``, after which
``write_tokens`` writes the fresh tokens. On CPU the plain versions are the
JAX package's ``"bias"``, ``decode_xla_q`` and ``paged_reference``
formulations.

Training (the cache-free forward of the KD step): ``return_hidden`` /
``hidden_window`` return the hidden-state stack of the last W positions,
``return_final_hidden`` / ``logit_window`` the final hidden states, and
``remat`` recomputes each block in the backward (``torch.utils.checkpoint``,
the JAX "full" policy). The frozen weights take no gradient: autograd
through ``(h @ w.to(h.dtype)) * scale`` gives the activations theirs. Not
ported yet: the ``save_qkv`` remat policy, ring attention, tensor
parallelism (ROADMAP queue A items 10, 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..infer.paged import PagedKVCache, write_tokens
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_decode import _quantize_kv, fused_decode
from ..kernels.fused_paged import fused_paged_decode
from ..kernels.paged_attention import paged_decode_attention
from ..ops.norms import rms_norm
from ..ops.rope import Llama3RopeScaling, apply_rope_cached, rope_cos_sin, rope_inv_freq

Params = Dict[str, Any]

__all__ = [
    "KVCache", "LlamaConfig", "LlamaOutput", "_quantize_kv", "dequantize_kv",
    "fuse_llama_params", "init_kv_cache", "init_llama_params", "llama_forward",
    "llama_preset", "quantize_llama_params",
]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[Llama3RopeScaling] = Llama3RopeScaling()
    tie_embeddings: bool = True
    max_position_embeddings: int = 131072


_PRESETS: Dict[str, LlamaConfig] = {
    # meta-llama/Llama-3.2-3B-Instruct, per the published HF config.json
    "llama3_3b": LlamaConfig(),
    # GeneZC/MiniChat-2-3B: Llama architecture, MHA, no rope scaling
    "minichat_3b": LlamaConfig(
        vocab_size=49216,
        num_layers=24,
        num_kv_heads=24,
        rope_theta=10000.0,
        rope_scaling=None,
        tie_embeddings=False,
        max_position_embeddings=4096,
    ),
    # tiny config for tests
    "tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
        rope_scaling=None,
        tie_embeddings=True,
        max_position_embeddings=2048,
    ),
}


def llama_preset(name: str) -> LlamaConfig:
    """Resolve a preset by short name or reference ``llm_type`` string."""
    aliases = {
        "meta-llama/Llama-3.2-3B-Instruct": "llama3_3b",
        "GeneZC/MiniChat-2-3B": "minichat_3b",
    }
    key = aliases.get(name, name)
    if key not in _PRESETS:
        raise KeyError(f"unknown llama preset '{name}' (have {sorted(_PRESETS)})")
    return _PRESETS[key]


class KVCache(NamedTuple):
    """KV cache laid out (L, B, Hkv, S, Dh), optionally int8 with bf16
    per-(layer, sample, head, slot) scales (L, B, Hkv, S). The tensors are
    updated in place by ``llama_forward``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(
    cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> KVCache:
    """Zero cache. Every field gets its own allocation: the cache is written
    in place, and two fields sharing storage would corrupt each other."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if dtype == torch.int8:
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        )
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def dequantize_kv(values: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (values.float() * scale[..., None].float()).to(dtype)


class LlamaOutput(NamedTuple):
    logits: Optional[torch.Tensor]  # (B, T or W or 1, V) float32
    kv_cache: Optional[KVCache]
    hidden_states: Optional[torch.Tensor] = None  # (L + 1, B, W, D): embeddings, then blocks
    final_hidden: Optional[torch.Tensor] = None  # (B, W, D) after the final norm


def init_llama_params(
    generator: torch.Generator, cfg: LlamaConfig, dtype=torch.bfloat16, device=None
) -> Params:
    """Random init with the JAX package's distributions: normal(0.02)
    weights, ones for norm scales. Weights are (in, out) so the forward is
    ``x @ W``. ``generator`` must live on ``device``."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (0.02 * w).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {
        "embed_tokens": normal((cfg.vocab_size, D)),
        "final_norm": ones((D,)),
        "layers": {
            "input_norm": ones((L, D)),
            "post_attn_norm": ones((L, D)),
            "wq": normal((L, D, Hq * Dh)),
            "wk": normal((L, D, Hkv * Dh)),
            "wv": normal((L, D, Hkv * Dh)),
            "wo": normal((L, Hq * Dh, D)),
            "w_gate": normal((L, D, I)),
            "w_up": normal((L, D, I)),
            "w_down": normal((L, I, D)),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, cfg.vocab_size))
    return params


def _mm(h: torch.Tensor, lp: Params, name: str) -> torch.Tensor:
    """``h @ lp[name]`` with int8 weight-only quantization: the weight is
    converted to h's dtype and the per-out-channel scale multiplies the
    result (the JAX package leaves this product to XLA; here it is a plain
    ``torch.matmul``)."""
    w = lp[name]
    if w.dtype == torch.int8:
        return (h @ w.to(h.dtype)) * lp[name + "_scale"].to(h.dtype)
    return h @ w


def _block(cfg: LlamaConfig, lp: Params, x: torch.Tensor, rope_cos, rope_sin, attend):
    """One pre-norm transformer block; ``attend(q, k, v)`` is the attention
    of the mode at hand. Returns (out, k, v) with post-rope k."""
    B, T, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = rms_norm(x, lp["input_norm"], cfg.rms_eps)
    if "wqkv" in lp:
        qkv = _mm(h, lp, "wqkv")
        q = qkv[..., : Hq * Dh].reshape(B, T, Hq, Dh)
        k = qkv[..., Hq * Dh : (Hq + Hkv) * Dh].reshape(B, T, Hkv, Dh)
        v = qkv[..., (Hq + Hkv) * Dh :].reshape(B, T, Hkv, Dh)
    else:
        q = _mm(h, lp, "wq").reshape(B, T, Hq, Dh)
        k = _mm(h, lp, "wk").reshape(B, T, Hkv, Dh)
        v = _mm(h, lp, "wv").reshape(B, T, Hkv, Dh)
    q = apply_rope_cached(q, rope_cos, rope_sin)
    k = apply_rope_cached(k, rope_cos, rope_sin)

    attn = attend(q, k, v)
    x = x + _mm(attn.reshape(B, T, Hq * Dh), lp, "wo")

    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_eps)
    if "w_gateup" in lp:
        inter = lp["w_down"].shape[-2]
        gu = _mm(h, lp, "w_gateup")
        gate, up = torch.nn.functional.silu(gu[..., :inter]), gu[..., inter:]
    else:
        gate = torch.nn.functional.silu(_mm(h, lp, "w_gate"))
        up = _mm(h, lp, "w_up")
    x = x + _mm(gate * up, lp, "w_down")
    return x, k, v


def _write_cache(cache: KVCache, layer: int, offset: int, k: torch.Tensor, v: torch.Tensor):
    """Write fresh (B, T, Hkv, Dh) k/v at slots [offset, offset + T) of one
    layer, quantized like the JAX prefill write when the cache is int8."""
    T = k.shape[1]
    window = slice(offset, offset + T)
    for new, buf, scales in ((k, cache.k, cache.k_scale), (v, cache.v, cache.v_scale)):
        new = new.transpose(1, 2)  # (B, Hkv, T, Dh)
        if scales is not None:
            vals, sc = _quantize_kv(new)
            buf[layer, :, :, window] = vals
            scales[layer, :, :, window] = sc
        else:
            buf[layer, :, :, window] = new.to(buf.dtype)


def llama_forward(
    params: Params,
    cfg: LlamaConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Union[KVCache, PagedKVCache, None] = None,
    cache_offset: Union[int, torch.Tensor, None] = None,
    kv_pad_lens: Optional[torch.Tensor] = None,
    last_logit_only: bool = False,
    cache_offset_bound: Optional[int] = None,
    return_hidden: bool = False,
    hidden_window: int = 0,
    compute_logits: bool = True,
    logit_window: int = 0,
    return_final_hidden: bool = False,
    remat: bool = False,
    remat_policy: Optional[str] = None,
) -> LlamaOutput:
    """Run the decoder.

    Modes:
      * no cache: causal attention over the left-padded (B, T) batch;
        ``attn_mask`` marks real positions (a left-padded prefix of pads);
      * prefill: ``kv_cache`` + ``cache_offset`` (0) without
        ``kv_pad_lens``; k/v are written to slots [offset, offset + T);
      * decode: ``kv_cache`` + ``cache_offset`` + ``kv_pad_lens``; valid
        cache slots are [pad, offset), the T >= 1 fresh tokens attend
        causally and are written at [offset, offset + T). Fresh tokens are
        real: ``attn_mask`` must be None here. ``cache_offset`` may be a
        per-row (B,) tensor; ``cache_offset_bound``, a host-side upper
        bound of it, must then be given (no device value is read);
      * paged decode: ``kv_cache`` a ``PagedKVCache`` whose ``lengths`` and
        ``pad_lens`` give each row's cached window [pad, length); the T >= 1
        fresh tokens attend it plus themselves causally and are written at
        [length, length + T) of the row's pages. ``attn_mask`` must be None.

    Training outputs (cache-free forward only), with the JAX semantics:
    ``return_hidden`` stacks the embeddings and every block's output, each
    cut to the last ``hidden_window`` positions when it is > 0 (the HF
    ``output_hidden_states`` layout); ``return_final_hidden`` gives the
    normed final hidden states of the last ``logit_window`` positions, and
    logits cover those positions only when ``logit_window`` > 0;
    ``compute_logits=False`` skips the head. ``remat`` with ``remat_policy``
    None or "full" recomputes each block in the backward.

    The cache is updated in place and also returned. Logits are float32:
    the final hidden state and the head are upcast to float32 before the
    product, which is the JAX ``preferred_element_type=f32`` product of
    bf16 operands (exact products, float32 sums), then the int8 head's
    per-vocab scale multiplies them.
    """
    if inputs_embeds is None:
        if input_ids is None:
            raise ValueError("llama_forward needs input_ids or inputs_embeds")
        table = params["embed_tokens"]
        ids = input_ids.long()
        if table.dtype == torch.int8:
            # dequantize to the activation dtype (the norm weights keep it)
            act = params["final_norm"].dtype
            inputs_embeds = table[ids].to(act) * params["embed_tokens_scale"][ids][..., None].to(act)
        else:
            inputs_embeds = table[ids]
    x = inputs_embeds
    B, T, _ = x.shape
    dev = x.device

    is_paged = isinstance(kv_cache, PagedKVCache)
    is_decode = is_paged or (kv_cache is not None and kv_pad_lens is not None)
    if is_decode and attn_mask is not None:
        raise ValueError("a decode step treats its fresh tokens as real: pass attn_mask=None")
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if positions is None:
        # HF-style left-pad positions: the first real token gets position 0
        positions = torch.clamp(torch.cumsum(attn_mask.to(torch.int32), dim=1) - 1, min=0)
    if positions.dim() == 1:
        positions = positions[None, :]
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=dev)
    rope_cos, rope_sin = rope_cos_sin(positions, inv_freq)

    if kv_cache is not None and not is_paged and cache_offset is None:
        raise ValueError("a forward with a kv_cache needs cache_offset")
    if kv_cache is not None and (return_hidden or remat):
        raise ValueError("return_hidden and remat belong to the cache-free (training) forward")
    if remat and remat_policy not in (None, "full"):
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} is not ported to PyTorch yet (ROADMAP queue A, "
            f"item 10: the save_qkv policy); use 'full'")
    remat = remat and torch.is_grad_enabled()

    def window(t, w):
        return t[:, -w:] if w > 0 else t

    hidden = [window(x, hidden_window)] if return_hidden else None
    if is_paged:
        lengths = kv_cache.lengths.to(device=dev, dtype=torch.int32).contiguous()
        pad_lens = kv_cache.pad_lens.to(device=dev, dtype=torch.int32).contiguous()
        fresh_k, fresh_v = [], []
    elif is_decode:
        if isinstance(cache_offset, torch.Tensor):
            if cache_offset_bound is None:
                raise ValueError("a per-row cache_offset needs its host-side cache_offset_bound")
            offsets = torch.broadcast_to(cache_offset.to(device=dev, dtype=torch.int32), (B,))
            max_offset = int(cache_offset_bound)
        else:
            max_offset = int(cache_offset)
            offsets = torch.full((B,), max_offset, dtype=torch.int32, device=dev)
        offsets = offsets.contiguous()
        pad_lens = kv_pad_lens.to(device=dev, dtype=torch.int32).contiguous()
    else:
        pad_lens = (T - attn_mask.to(torch.int32).sum(dim=1)).to(torch.int32)
        ends = torch.full((B,), T, dtype=torch.int32, device=dev)

    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        if is_paged and T == 1:
            def attend(q, k, v, i=i):
                return fused_paged_decode(
                    q, kv_cache.k_pool, kv_cache.v_pool, kv_cache.k_scale, kv_cache.v_scale,
                    kv_cache.page_table, lengths, pad_lens, k, v, i,
                )
        elif is_paged:
            def attend(q, k, v, i=i):
                quant = kv_cache.quantized
                fresh_k.append(k)
                fresh_v.append(v)
                return paged_decode_attention(
                    q, kv_cache.k_pool[i], kv_cache.v_pool[i], kv_cache.page_table, lengths,
                    pad_lens, k, v, kv_cache.k_scale[i] if quant else None,
                    kv_cache.v_scale[i] if quant else None,
                )
        elif is_decode:
            def attend(q, k, v, i=i):
                return fused_decode(
                    q, kv_cache.k, kv_cache.v, kv_cache.k_scale, kv_cache.v_scale, k, v,
                    pad_lens, offsets, i, max_offset=max_offset,
                )
        else:
            def attend(q, k, v):
                return flash_attention(q, k, v, pad_lens, ends, causal=True)
        if remat:
            def block(x, lp=lp, attend=attend):
                return _block(cfg, lp, x, rope_cos, rope_sin, attend)[0]

            x = checkpoint(block, x, use_reentrant=False)
        else:
            x, k, v = _block(cfg, lp, x, rope_cos, rope_sin, attend)
        if return_hidden:
            hidden.append(window(x, hidden_window))
        if kv_cache is not None and not is_decode:
            _write_cache(kv_cache, i, int(cache_offset), k, v)
    if is_paged and T > 1:
        # the verification tokens go into the pages after the layer loop,
        # as in the JAX package (lengths are not advanced)
        write_tokens(kv_cache._replace(lengths=lengths), torch.stack(fresh_k),
                     torch.stack(fresh_v))

    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    out = LlamaOutput(
        logits=None, kv_cache=kv_cache,
        hidden_states=torch.stack(hidden) if return_hidden else None,
        final_hidden=window(x, logit_window) if return_final_hidden else None,
    )
    if not compute_logits:
        return out
    x = x[:, -1:, :] if last_logit_only else window(x, logit_window)
    if cfg.tie_embeddings:
        head, head_scale = params["embed_tokens"], params.get("embed_tokens_scale")
        w_vd = head  # (V, D)
    else:
        head, head_scale = params["lm_head"], params.get("lm_head_scale")
        w_vd = head.t()
    # int8 → float32 is exact; a float head is first rounded to the
    # activation dtype, as the JAX package casts it
    w_vd = w_vd if w_vd.dtype == torch.int8 else w_vd.to(x.dtype)
    logits = x.float() @ w_vd.float().t()
    if head.dtype == torch.int8:
        logits = logits * head_scale.float()
    return out._replace(logits=logits)


def fuse_llama_params(params: Params) -> Params:
    """Decode layout: wq/wk/wv concatenated into ``wqkv`` and w_gate/w_up
    into ``w_gateup``. Returns a new tree; the caller drops the old one."""
    layers = dict(params["layers"])
    layers["wqkv"] = torch.cat([layers.pop("wq"), layers.pop("wk"), layers.pop("wv")], dim=-1)
    layers["w_gateup"] = torch.cat([layers.pop("w_gate"), layers.pop("w_up")], dim=-1)
    out = dict(params)
    out["layers"] = layers
    return out


def _quantize_weight(w: torch.Tensor, axis: int):
    """Per-channel symmetric absmax int8 over ``axis`` (the JAX package's
    ``quantize_llama_params.q``): scale floor 1e-12, round half to even."""
    wf = w.float()
    absmax = torch.amax(torch.abs(wf), dim=axis, keepdim=True)
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-12)  # IEEE quotient
    qw = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return qw, scale.squeeze(axis).to(torch.bfloat16)


def quantize_llama_params(params: Params) -> Params:
    """Weight-only int8 for serving: per-out-channel for the (L, in, out)
    layer weights, per-vocab-row for the embedding table. Layers are
    quantized one at a time to bound the float32 temporaries."""
    layers = dict(params["layers"])
    for name in ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate", "w_up", "w_down"):
        if name in layers:
            w = layers[name]
            parts = [_quantize_weight(w[i], axis=0) for i in range(w.shape[0])]
            layers[name] = torch.stack([p[0] for p in parts])
            layers[name + "_scale"] = torch.stack([p[1] for p in parts])
    out = dict(params)
    out["layers"] = layers
    out["embed_tokens"], out["embed_tokens_scale"] = _quantize_weight(params["embed_tokens"], axis=1)
    if "lm_head" in params:
        out["lm_head"], out["lm_head_scale"] = _quantize_weight(params["lm_head"], axis=0)
    return out
