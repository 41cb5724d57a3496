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
backward kernel B6 in training. A decode step over the dense cache attends
the cache window ``[pad, offset)`` plus the fresh tokens and writes them
into the cache in place: ``fused_decode`` (B2) over an int8 cache,
``fused_decode_attention_write`` (B3) over a bfloat16 one. With
``attn_impl="pallas"`` a T == 1 step with one scalar offset instead reads
each layer through ``decode_attention`` (B8) and writes the fresh k/v
after it. Over the paged cache (``infer/paged.py``), a T == 1 step calls
``fused_paged_decode`` (attention + in-place page write) and a T > 1
verification forward calls ``paged_decode_attention``, after which
``write_tokens`` writes the fresh tokens. On CPU the plain versions are the
JAX package's ``"bias"``, ``decode_xla_q`` and ``paged_reference``
formulations. Every decode kernel takes a float32 query too (a model whose
activations are float32: its norm weights, or float32 prompt embeddings),
through its float32 instance, over an int8, float32 or bfloat16 cache; the
forward of float32 activations on the card runs its products in float32,
not TF32 (``device.exact_float32``), as the JAX package asks for
``Precision.HIGHEST`` at float32. A dense T == 1 step of the batch loop on
the card replays CUDA graphs of the chains between its attentions, which
are launched as above (``graphs_engage``, ``_graphed_step``).

Training (the cache-free forward of the KD step): ``return_hidden`` /
``hidden_window`` return the hidden-state stack of the last W positions,
``return_final_hidden`` / ``logit_window`` the final hidden states, and
``remat`` recomputes each block in the backward (``torch.utils.checkpoint``:
the JAX "full" policy, or "save_qkv", which keeps q, k, v and the attention
output). The frozen weights take no gradient: autograd
through ``(h @ w.to(h.dtype)) * scale`` gives the activations theirs.

Sequence parallelism (``ring_group``, the long-audio trainer): every rank
of the group passes the same global (B, T) inputs; positions and left pads
come from the global mask, each rank keeps its shard [r·Tl, (r+1)·Tl) of
the sequence, and attention is ``ring_attention`` (kernel B7 per block on
the card). The hidden-state stack and the final hidden states keep their
global meaning (the last W positions of the whole sequence) and come back
on every rank.

Tensor parallelism (``tp_group``, the model group of the serving engine
and of the trainer): each rank holds its shard of the parameters
(``parallel/sharding.py``: Megatron-style, Hq/tp query heads, Hkv/tp KV
heads, I/tp MLP columns, V/tp vocab rows) and a KV cache of its Hkv/tp
heads, and every rank passes the same inputs. The block runs at the shard's
widths (``shard_config``); the partial products of ``wo`` and ``w_down``
are summed over the group (``tp_all_reduce``, one each), the embedding
lookup gives zero rows for ids outside the rank's vocab rows and is summed
likewise, and the head's float32 logits of the rank's vocab slice are
gathered, so that every rank holds the same full logits. Every attention
kernel runs on the rank's heads. In training, each normed input enters
the column-parallel products through ``tp_copy``, whose backward sums the
ranks' partial gradients, so the residual stream and its gradient are the
same on every rank; remat recomputes a block's all-reduces in the
backward, every rank in the same (reverse layer) order. With a
``ring_group`` too, each rank rings its own heads over its seq group.
"""

from __future__ import annotations

import functools
import threading
import weakref
from collections import Counter, OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Dict, NamedTuple, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..device import exact_float32
from ..infer.paged import PagedKVCache, write_tokens
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_decode import _quantize_kv, fused_decode, fused_decode_attention_write
from ..kernels.fused_paged import fused_paged_decode
from ..kernels.paged_attention import paged_decode_attention
from ..obs.profile import annotate
from ..ops.norms import rms_norm
from ..ops.ring_attention import ring_attention
from ..parallel.comm import (
    gather_tail,
    group_rank,
    group_size,
    tp_all_gather,
    tp_all_reduce,
    tp_copy,
)
from ..ops.rope import Llama3RopeScaling, apply_rope_cached, rope_cos_sin, rope_inv_freq

Params = Dict[str, Any]

__all__ = [
    "KVCache", "LlamaConfig", "LlamaOutput", "_quantize_kv", "dequantize_kv",
    "fuse_llama_params", "init_kv_cache", "init_llama_params", "llama_forward",
    "llama_preset", "quantize_llama_params", "shard_config",
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


def shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The widths one rank of a ``tp``-rank model group holds: Hq/tp query
    heads, Hkv/tp KV heads and I/tp MLP columns (the vocab stays whole: the
    logits are gathered). Raises ValueError naming every width that ``tp``
    does not divide, the vocab's among them."""
    if tp == 1:
        return cfg
    widths = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
              "intermediate_size": cfg.intermediate_size, "vocab_size": cfg.vocab_size}
    bad = [f"{k}={v}" for k, v in widths.items() if v % tp]
    if bad:
        raise ValueError(f"tensor parallelism over {tp} ranks needs the model's widths to "
                         f"divide by {tp}; these do not: {', '.join(bad)}")
    return replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp)


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
    cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None, tp: int = 1
) -> KVCache:
    """Zero cache of one rank of a ``tp``-rank model group (Hkv/tp heads).
    Every field gets its own allocation: the cache is written in place, and
    two fields sharing storage would corrupt each other."""
    cfg = shard_config(cfg, tp)
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
    ``torch.matmul``). A float weight meets h in their promoted type, as
    JAX's ``h @ w`` does: a float32 h (a float32 prefill) against bf16
    weights is a float32 product."""
    w = lp[name]
    if w.dtype == torch.int8:
        return (h @ w.to(h.dtype)) * lp[name + "_scale"].to(h.dtype)
    dt = torch.result_type(h, w)
    return h.to(dt) @ w.to(dt)


def _block(cfg: LlamaConfig, lp: Params, x: torch.Tensor, rope_cos, rope_sin, attend,
           tp_group=None):
    """One pre-norm transformer block; ``attend(q, k, v)`` is the attention
    of the mode at hand. Returns (out, k, v) with post-rope k. Under a
    ``tp_group``, ``cfg`` holds the shard's widths."""
    h = tp_copy(rms_norm(x, lp["input_norm"], cfg.rms_eps), tp_group)
    q, k, v = _qkv(cfg, lp, h, rope_cos, rope_sin)
    return _block_out(cfg, lp, x, attend(q, k, v), tp_group), k, v


def _block_save_qkv(cfg: LlamaConfig, lp: Params, x: torch.Tensor, rope_cos, rope_sin, attend,
                    tp_group=None):
    """``_block`` under the save_qkv remat policy: the backward keeps the
    post-rope q, k, v and the attention output (which the attention's
    autograd Function saves with its log-sum-exp) and recomputes only the
    norms, the o-projection and the MLP half, never the attention. The same
    operations in the same order as ``_block``, so the values and gradients
    are the other policies' bit for bit."""
    h = checkpoint(rms_norm, x, lp["input_norm"], cfg.rms_eps, use_reentrant=False)
    q, k, v = _qkv(cfg, lp, tp_copy(h, tp_group), rope_cos, rope_sin)
    attn = attend(q, k, v)
    return checkpoint(_block_out, cfg, lp, x, attn, tp_group, use_reentrant=False), k, v


def _qkv(cfg: LlamaConfig, lp: Params, h: torch.Tensor, rope_cos, rope_sin):
    """The normed input's q, k, v (B, T, heads, Dh), q and k after rope."""
    B, T, _ = h.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
    return q, k, v


def _block_out(cfg: LlamaConfig, lp: Params, x: torch.Tensor, attn: torch.Tensor,
               tp_group=None):
    """The block's output from its input and the attention (B, T, Hq, Dh):
    the o-projection's residual, then the MLP half; under a ``tp_group``
    each row-parallel product is summed over the group."""
    B, T, _ = x.shape
    x = x + tp_all_reduce(_mm(attn.reshape(B, T, cfg.num_heads * cfg.head_dim), lp, "wo"),
                          tp_group)
    h = tp_copy(rms_norm(x, lp["post_attn_norm"], cfg.rms_eps), tp_group)
    if "w_gateup" in lp:
        inter = lp["w_down"].shape[-2]
        gu = _mm(h, lp, "w_gateup")
        gate, up = torch.nn.functional.silu(gu[..., :inter]), gu[..., inter:]
    else:
        gate = torch.nn.functional.silu(_mm(h, lp, "w_gate"))
        up = _mm(h, lp, "w_up")
    return x + tp_all_reduce(_mm(gate * up, lp, "w_down"), tp_group)


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


def _dense_windows(cache_offset, cache_offset_bound, kv_pad_lens, B: int, dev):
    """A dense decode step's (offsets, pad_lens) as contiguous (B,) int32
    tensors and the host-side bound of the offsets."""
    if isinstance(cache_offset, torch.Tensor):
        if cache_offset_bound is None:
            raise ValueError("a per-row cache_offset needs its host-side cache_offset_bound")
        offsets = torch.broadcast_to(cache_offset.to(device=dev, dtype=torch.int32), (B,))
        max_offset = int(cache_offset_bound)
    else:
        max_offset = int(cache_offset)
        offsets = torch.full((B,), max_offset, dtype=torch.int32, device=dev)
    pad_lens = kv_pad_lens.to(device=dev, dtype=torch.int32).contiguous()
    return offsets.contiguous(), pad_lens, max_offset


def _dense_attend(cache: KVCache, pad_lens, offsets, max_offset: int, pallas: bool, i: int,
                  q, k, v):
    """Layer ``i``'s attention in a decode step over the dense cache, the
    fresh k/v written in place: B8 and then the write under ``pallas``, else
    B2 over an int8 cache and B3 over a float one."""
    if pallas:
        quant = cache.quantized
        out = decode_attention(q, cache.k[i], cache.v[i], k, v, pad_lens, max_offset,
                               cache.k_scale[i] if quant else None,
                               cache.v_scale[i] if quant else None)
        _write_cache(cache, i, max_offset, k, v)
        return out
    if cache.quantized:
        return fused_decode(q, cache.k, cache.v, cache.k_scale, cache.v_scale, k, v, pad_lens,
                            offsets, i, max_offset=max_offset)
    return fused_decode_attention_write(q, cache.k, cache.v, k, v, pad_lens, offsets, i,
                                        max_offset=max_offset)


def _exact_float32(forward):
    """``forward(params, cfg, **kw)`` inside ``exact_float32`` of its
    activations: the given embeddings, else the norm weights (the
    embedding lookup's dtype)."""
    @functools.wraps(forward)
    def wrapped(params, cfg, **kw):
        x = kw.get("inputs_embeds")
        with exact_float32(x if x is not None else params["final_norm"]):
            return forward(params, cfg, **kw)

    return wrapped


@_exact_float32
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
    attn_impl: str = "auto",
    ring_group=None,
    tp_group=None,
    counts: Optional[Counter] = None,
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
    None or "full" recomputes each block in the backward, attention
    included; "save_qkv" keeps each block's post-rope q, k, v and attention
    output and recomputes the rest (``_block_save_qkv``), on the ring too.

    ``ring_group``: the cache-free forward sharded over the process group's
    ranks (see the module docstring); T must divide by their number. Every
    output covers the global positions, on every rank.

    ``attn_impl`` names the decode attention, as in the JAX package:
    "auto" and "fused" take the kernels above; "pallas" takes B8 for a
    dense T == 1 step at one scalar ``cache_offset`` (per-row offsets and
    T > 1, where the JAX package quietly runs XLA, raise); "xla" names the
    XLA formulations, which are the plain versions: CPU tensors only.
    Prefill, the cache-free forward and paged steps take the same kernels
    under every name.

    A decode step on the card at T == 1 over the dense cache, at one scalar
    ``cache_offset``, from ``input_ids``, without ``tp_group`` or a
    gradient (``graphs_engage``), replays CUDA graphs of its dense chains
    between eager launches of its attention (``_graphed_step``): the same
    kernels in the same order, captured once per batch size, activation
    dtype, widths and parameter tree after one eager step. Its logits are
    then a static buffer, overwritten by the next such step; ``counts``,
    when given, gains "decode_graph_steps" and "decode_graph_captures".

    The cache is updated in place and also returned. Logits are float32:
    the final hidden state and the head are upcast to float32 before the
    product, which is the JAX ``preferred_element_type=f32`` product of
    bf16 operands (exact products, float32 sums), then the int8 head's
    per-vocab scale multiplies them.
    """
    tp = group_size(tp_group)
    if inputs_embeds is None and input_ids is None:
        raise ValueError("llama_forward needs input_ids or inputs_embeds")
    src = input_ids if inputs_embeds is None else inputs_embeds
    B, T, dev = src.shape[0], src.shape[1], src.device

    is_paged = isinstance(kv_cache, PagedKVCache)
    is_decode = is_paged or (kv_cache is not None and kv_pad_lens is not None)
    if is_decode and attn_mask is not None:
        raise ValueError("a decode step treats its fresh tokens as real: pass attn_mask=None")
    if kv_cache is not None and not is_paged and cache_offset is None:
        raise ValueError("a forward with a kv_cache needs cache_offset")
    if kv_cache is not None and (return_hidden or remat):
        raise ValueError("return_hidden and remat belong to the cache-free (training) forward")
    if remat and remat_policy not in (None, "full", "save_qkv"):
        raise ValueError(f"remat_policy={remat_policy!r}: expected 'full' or 'save_qkv'")
    remat = remat and torch.is_grad_enabled()
    if attn_impl not in ("auto", "fused", "pallas", "xla"):
        raise ValueError(f"attn_impl={attn_impl!r}: expected 'auto', 'fused', 'pallas' or 'xla'")
    if attn_impl == "xla" and dev.type != "cpu":
        raise ValueError("attn_impl='xla' names the plain versions, which run on CPU tensors "
                         "only; on the card every attention is a kernel ('auto')")
    pallas_dense = attn_impl == "pallas" and is_decode and not is_paged
    if pallas_dense and (isinstance(cache_offset, torch.Tensor) or T != 1):
        kind = "a per-row tensor" if isinstance(cache_offset, torch.Tensor) else "a scalar"
        raise ValueError(
            f"attn_impl='pallas' runs kernel B8, which takes T == 1 and one scalar "
            f"cache_offset; got T={T} and {kind} offset (use 'auto' for the fused kernels)")

    if is_decode and not is_paged:
        offsets, pad_lens, max_offset = _dense_windows(cache_offset, cache_offset_bound,
                                                       kv_pad_lens, B, dev)
        attend_layer = functools.partial(_dense_attend, kv_cache, pad_lens, offsets, max_offset,
                                         pallas_dense)
        if (inputs_embeds is None and ring_group is None and compute_logits
                and not return_final_hidden and not torch.is_grad_enabled()
                and graphs_engage(dev, kv_cache, kv_pad_lens, cache_offset, T, tp_group)):
            logits = _graphed_step(params, cfg, input_ids, positions, attend_layer, counts)
            return LlamaOutput(logits=logits, kv_cache=kv_cache)

    if inputs_embeds is None:
        inputs_embeds = _embed_lookup(params, input_ids.long(), tp_group)
    x = inputs_embeds
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if positions is None:
        # HF-style left-pad positions: the first real token gets position 0
        positions = torch.clamp(torch.cumsum(attn_mask.to(torch.int32), dim=1) - 1, min=0)
    if positions.dim() == 1:
        positions = positions[None, :]
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=dev)
    rope_cos, rope_sin = rope_cos_sin(positions, inv_freq)

    def window(t, w):
        return t[:, -w:] if w > 0 else t

    if ring_group is not None:
        if kv_cache is not None:
            raise ValueError("ring attention covers the cache-free forward; a forward with a "
                             "kv_cache cannot take ring_group")
        n_ring = group_size(ring_group)
        if T % n_ring:
            raise ValueError(f"T={T} is not divisible by the ring's {n_ring} ranks")
        # the global pads and positions were taken above; keep this rank's shard
        shard = slice(group_rank(ring_group) * (T // n_ring),
                      (group_rank(ring_group) + 1) * (T // n_ring))
        x, rope_cos, rope_sin = x[:, shard], rope_cos[:, shard], rope_sin[:, shard]

    def keep(t):  # a ring shard is cut to the global window after the loop
        return t if ring_group is not None else window(t, hidden_window)

    hidden = [keep(x)] if return_hidden else None
    if is_paged:
        lengths = kv_cache.lengths.to(device=dev, dtype=torch.int32).contiguous()
        pad_lens = kv_cache.pad_lens.to(device=dev, dtype=torch.int32).contiguous()
        fresh_k, fresh_v = [], []
    elif not is_decode:
        pad_lens = (T - attn_mask.to(torch.int32).sum(dim=1)).to(torch.int32)
        ends = torch.full((B,), T, dtype=torch.int32, device=dev)

    lcfg = shard_config(cfg, tp)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
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
            attend = functools.partial(attend_layer, i)
        elif ring_group is not None:
            def attend(q, k, v):
                return ring_attention(q, k, v, pad_lens, ring_group, causal=True)
        else:
            def attend(q, k, v):
                return flash_attention(q, k, v, pad_lens, ends, causal=True)
        if remat and remat_policy == "save_qkv":
            x = _block_save_qkv(lcfg, lp, x, rope_cos, rope_sin, attend, tp_group)[0]
        elif remat:
            def block(x, lp=lp, attend=attend):
                return _block(lcfg, lp, x, rope_cos, rope_sin, attend, tp_group)[0]

            x = checkpoint(block, x, use_reentrant=False)
        else:
            x, k, v = _block(lcfg, lp, x, rope_cos, rope_sin, attend, tp_group)
        if return_hidden:
            hidden.append(keep(x))
        if kv_cache is not None and not is_decode:
            _write_cache(kv_cache, i, int(cache_offset), k, v)
    if is_paged and T > 1:
        # the verification tokens go into the pages after the layer loop,
        # as in the JAX package (lengths are not advanced)
        write_tokens(kv_cache._replace(lengths=lengths), torch.stack(fresh_k),
                     torch.stack(fresh_v))

    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    hidden_states = torch.stack(hidden) if return_hidden else None
    if ring_group is not None:  # the global windows, on every rank
        x = gather_tail(x, logit_window, 1, ring_group)
        if return_hidden:
            hidden_states = gather_tail(hidden_states, hidden_window, 2, ring_group)
    out = LlamaOutput(
        logits=None, kv_cache=kv_cache,
        hidden_states=hidden_states,
        final_hidden=window(x, logit_window) if return_final_hidden else None,
    )
    if not compute_logits:
        return out
    x = x[:, -1:, :] if last_logit_only else window(x, logit_window)
    return out._replace(logits=_head(params, cfg, x, tp_group))


def _head(params: Params, cfg: LlamaConfig, x: torch.Tensor, tp_group=None) -> torch.Tensor:
    """float32 logits of the normed final hidden states ``x``: both upcast
    to float32 before the product; under a ``tp_group`` the ranks' vocab
    slices gathered."""
    if cfg.tie_embeddings:
        head, head_scale = params["embed_tokens"], params.get("embed_tokens_scale")
        w_vd = head  # (V, D)
    else:
        head, head_scale = params["lm_head"], params.get("lm_head_scale")
        w_vd = head.t()
    # int8 → float32 is exact; a float head is first rounded to the
    # activation dtype, as the JAX package casts it
    w_vd = w_vd if w_vd.dtype == torch.int8 else w_vd.to(x.dtype)
    logits = tp_copy(x, tp_group).float() @ w_vd.float().t()
    if head.dtype == torch.int8:
        logits = logits * head_scale.float()
    return tp_all_gather(logits, -1, tp_group)


def _embed_lookup(params: Params, ids: torch.Tensor, tp_group=None) -> torch.Tensor:
    """Token embeddings; an int8 table is gathered at int8 width and
    dequantized per row to the activation dtype (the norm weights'). Under a
    ``tp_group`` the table holds the rank's contiguous vocab rows: ids
    outside them give zero rows, and the rows are summed over the group."""
    table, scale = params["embed_tokens"], params.get("embed_tokens_scale")
    act = params["final_norm"].dtype
    tp = group_size(tp_group)
    if tp > 1:
        lo = group_rank(tp_group) * table.shape[0]
        local = ids - lo
        inside = (local >= 0) & (local < table.shape[0])
        ids = torch.where(inside, local, torch.zeros_like(local))
    rows = table[ids]
    if table.dtype == torch.int8:
        rows = rows.to(act) * scale[ids][..., None].to(act)
    if tp > 1:
        rows = tp_all_reduce(rows * inside[..., None].to(rows.dtype), tp_group)
    return rows


# --- the piecewise CUDA graphs of a decode step ---------------------------
#
# A T = 1 decode step at B = 128 issues ~40 small ops a layer; on the card the
# host took longer to issue them than the card to run them. Here the step is
# cut at its attentions into num_layers + 1 pieces, each captured once as a
# CUDA graph over static buffers and replayed; the attention between them
# (B2, B3 or B8, which read and write the cache and whose split follows the
# step's offset) is launched as it is in the eager step. A device's sets share
# one memory pool, so their intermediates alias: one thread at a time decodes
# through them on a device (the batch loop; the server's one batching thread).

# captured piece sets kept, the least recently used dropped: the server's
# warm-up ladder of power-of-two batches holds up to 8 sizes (1 to 128)
GRAPH_SETS_MAX = 8
_graph_sets: "OrderedDict[tuple, _DecodeGraphs]" = OrderedDict()
_graph_lock = threading.Lock()
_capture_state: Dict[int, tuple] = {}  # device index -> (capture stream, shared pool)


def graphs_engage(device: torch.device, kv_cache, kv_pad_lens, cache_offset, T: int,
                  tp_group) -> bool:
    """Whether a decode forward replays the piecewise graphs: on the card,
    a T == 1 step (``kv_pad_lens`` given) over the dense ``KVCache`` at one
    scalar offset for every row (the batch loop's step; the slot decoders'
    per-row offsets and the paged cache stay eager), on one rank."""
    return (device.type == "cuda" and isinstance(kv_cache, KVCache) and kv_pad_lens is not None
            and T == 1 and not isinstance(cache_offset, torch.Tensor) and tp_group is None)


def _layer(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


def _piece_qkv(cfg: LlamaConfig, params: Params, i: int, x, rope_cos, rope_sin):
    lp = _layer(params, i)
    return _qkv(cfg, lp, rms_norm(x, lp["input_norm"], cfg.rms_eps), rope_cos, rope_sin)


def _first_piece(params: Params, cfg: LlamaConfig, ids, positions):
    """Piece 0: the embeddings of ``ids`` (B, 1), the rope tables at
    ``positions`` (B, 1) and layer 0's q, k, v. Returns (x, q, k, v, cos,
    sin)."""
    x = _embed_lookup(params, ids)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=ids.device)
    rope = rope_cos_sin(positions, inv_freq)
    return (x,) + _piece_qkv(cfg, params, 0, x, *rope) + rope


def _piece(params: Params, cfg: LlamaConfig, i: int, x, attn, rope):
    """Piece i (1 <= i <= num_layers): layer i - 1's block output from its
    input ``x`` and attention ``attn``, then layer i's (x, q, k, v), or,
    after the last layer, the final norm and the float32 logits (B, 1, V)."""
    x = _block_out(cfg, _layer(params, i - 1), x, attn)
    if i == cfg.num_layers:
        return _head(params, cfg, rms_norm(x, params["final_norm"], cfg.rms_eps))
    return (x,) + _piece_qkv(cfg, params, i, x, *rope)


class GraphPieces(NamedTuple):
    """A decoder's T = 1 step cut at its attentions: ``first(params, cfg,
    ids, positions)`` gives (x, *args, *rope), the ``n_args`` args going to
    ``attend(0, *args)``; ``piece(params, cfg, i, x, attn, rope)`` for 1 <= i
    <= num_layers gives layer i - 1's output and layer i's (x, *args), or,
    at i == num_layers, the float32 logits (B, 1, V); ``attn_shape(cfg, B)``
    is the shape of an attention's output."""

    first: Any
    piece: Any
    n_args: int
    attn_shape: Any


PIECES = GraphPieces(_first_piece, _piece, 3,
                     lambda cfg, B: (B, 1, cfg.num_heads, cfg.head_dim))


def piecewise_decode(params: Params, cfg, ids, positions, attend, pieces: GraphPieces = PIECES):
    """A T = 1 decode step run eagerly piece by piece: ``attend(i, *args)``
    is layer i's attention (which writes the cache). The same operations in
    the same order as the forward's step, so the same logits bit for bit;
    the graphs' warm-up step."""
    n = pieces.n_args
    out = pieces.first(params, cfg, ids, positions)
    x, args, rope = out[0], out[1:1 + n], out[1 + n:]
    for i in range(1, cfg.num_layers + 1):
        out = pieces.piece(params, cfg, i, x, attend(i - 1, *args), rope)
        if i < cfg.num_layers:
            x, args = out[0], out[1:]
    return out


def _tree_leaves(tree) -> list:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for _, sub in sorted(tree.items()) for t in _tree_leaves(sub)]


class _DecodeGraphs:
    """One key's captured pieces: the static inputs (ids, positions, and
    the attention output each piece after the first reads), and each
    piece's graph and static outputs. Holds no parameter: ``refs`` are weak
    references to the tree's leaves, and the set is dropped once one dies."""

    def __init__(self, params: Params, cfg, B: int, leaves, pieces: GraphPieces):
        dev = params["final_norm"].device
        dtype = params["final_norm"].dtype
        self.pieces = pieces
        self.refs = [weakref.ref(t) for t in leaves]
        self.ids = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.positions = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.attn = torch.zeros(pieces.attn_shape(cfg, B), dtype=dtype, device=dev)
        self.graphs, self.outs = [], []

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def capture(self, params: Params, cfg, stream, pool) -> None:
        def one(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                # thread_local: another thread (the prompt builder) may run
                # its own stream's work while this one captures
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    g.capture_end()
            self.graphs.append(g)
            self.outs.append(out)

        p = self.pieces
        one(lambda: p.first(params, cfg, self.ids, self.positions))
        rope = self.outs[0][1 + p.n_args:]
        for i in range(1, cfg.num_layers + 1):
            one(lambda: p.piece(params, cfg, i, self.outs[-1][0], self.attn, rope))

    def replay(self, ids, positions, attend) -> torch.Tensor:
        """One step: the logits (B, 1, V) in the last piece's static buffer,
        which the next replay overwrites."""
        n = self.pieces.n_args
        self.ids.copy_(ids)
        self.positions.copy_(positions)
        self.graphs[0].replay()
        for i in range(1, len(self.graphs)):
            self.attn.copy_(attend(i - 1, *self.outs[i - 1][1:1 + n]))
            self.graphs[i].replay()
        return self.outs[-1]


def _graphed_step(params: Params, cfg, ids, positions, attend, counts: Optional[Counter],
                  pieces: GraphPieces = PIECES) -> torch.Tensor:
    """The step through its key's captured pieces (``counts``:
    "decode_graph_steps"), or, for a new key, an eager warm-up step on the
    capture stream and then the capture (``counts``: "decode_graph_captures";
    span ``lss.generate.graph_capture``). A set is keyed by B, the
    activation dtype, the config (its widths and kind) and the identity of
    the tree's leaves, not by the cache: each call allocates its own, and
    the attention is not captured. Returns the step's float32 logits (B, 1,
    V)."""
    B, dev = ids.shape[0], ids.device
    if positions is None:
        positions = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    leaves = _tree_leaves(params)
    key = (B, params["final_norm"].dtype, cfg, dev, tuple(id(t) for t in leaves))
    with _graph_lock:
        graphs = _graph_sets.get(key)
        if graphs is not None and graphs.alive():
            _graph_sets.move_to_end(key)
        else:
            graphs = None
    if graphs is not None:
        logits = graphs.replay(ids, positions, attend)
        if counts is not None:
            counts["decode_graph_steps"] += 1
        return logits

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _graph_lock:
        if index not in _capture_state:
            _capture_state[index] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        stream, pool = _capture_state[index]
    main = torch.cuda.current_stream(dev)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):  # warm-up: lazy set-up happens outside the capture
        logits = piecewise_decode(params, cfg, ids.long(), positions, attend, pieces)
    main.wait_stream(stream)
    logits.record_stream(main)
    graphs = _DecodeGraphs(params, cfg, B, leaves, pieces)
    with annotate("lss.generate.graph_capture"):
        graphs.capture(params, cfg, stream, pool)
    with _graph_lock:
        for k in [k for k, g in _graph_sets.items() if not g.alive()]:
            del _graph_sets[k]
        _graph_sets[key] = graphs
        while len(_graph_sets) > GRAPH_SETS_MAX:
            _graph_sets.popitem(last=False)
    if counts is not None:
        counts["decode_graph_captures"] += 1
    return logits


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
