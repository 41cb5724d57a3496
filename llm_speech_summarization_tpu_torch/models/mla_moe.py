"""DeepSeek-V3 decoder (``model_type`` deepseek_v3): multi-head latent
attention (MLA) and DeepSeekMoE with shared experts, as Moonlight-16B-A3B
publishes it (https://huggingface.co/moonshotai/Moonlight-16B-A3B); the
equations of DeepSeek-V2 (arXiv:2405.04434) and DeepSeek-V3
(arXiv:2412.19437). The JAX package has no such decoder: this module and
its two kernels (``kernels/moe_experts.py`` K1, ``kernels/latent_decode.py``
K2) are the port's own.

A layer, with x the residual stream (no q LoRA, as Moonlight has none):

* attention on h = RMSNorm(x): q = h W_q (H heads of nope 128 | rope 64);
  [c | k_pe] = h W_kva, c = RMSNorm_kv(c) (the latent, 512); rope on q_pe
  and on k_pe, which every head shares; expanded, k = [c W_uk | k_pe] and
  v = c W_uv per head, causal at scale (nope + rope)^-1/2; then W_o;
* the FFN on h2 = RMSNorm(x + attn): the first ``first_k_dense`` layers a
  SwiGLU; the others MoE: float32 logits h2 W_g^T, s = sigmoid, the top k of
  s + b (the correction bias) chosen, weights s of the chosen normalised
  (sum + 1e-20) and scaled by ``routed_scaling_factor``; y = sum_k w_k
  E_k(h2) + S(h2), each expert a SwiGLU, S the shared experts as one SwiGLU
  of n_shared times the expert width.

Then the final RMSNorm and the untied head, float32 logits (``_head``).

**Rope.** DeepSeek-V3 rotates interleaved pairs: its ``apply_rotary_pos_
emb`` regroups the 64 rope dimensions from (32, 2) to (2, 32) before the
half rotation. Here W_q's and W_kva's rope columns are stored already
regrouped (``convert.py`` permutes them, ``rope_permutation``), so the port's
half-split rope (``ops/rope.py``) applies; q_pe . k_pe is unchanged, and the
cache holds k_pe in that order.

**Forward modes** (``mla_moe_forward``): the cache-free forward; the
prefill, which runs the expanded heads through ``scaled_dot_product_
attention`` under the left-pad causal mask (a library call: ~2% of a
batch's FLOPs at 192 / 128 wide heads) and writes the prompt's latents,
int8, into the ``LatentCache``; a decode step, absorbed: q_c = q_nope W_uk
(512 a head), K2 attends the cached latents plus the fresh ones and writes
them, the latent output goes through W_uv. On the card a T = 1 step at one
scalar offset from ``input_ids`` replays CUDA graphs of the chains between
its K2 launches (``llama._graphed_step`` with this module's pieces): the
routing, the pairs' sort and K1 read no device value on the host, at fixed
shapes.

Parameters (bf16 as served; widths (in, out) except the routed experts'):
``embed_tokens`` (V, D), ``final_norm``, ``lm_head`` (D, V); ``layers``
stacked over all L: ``input_norm``, ``post_attn_norm``, ``wq`` (D, H(n +
r)), ``wkv_a`` (D, R + r), ``kv_norm`` (R,), ``wkv_b`` (R, H(n + v)), per
head [W_uk | W_uv] columns, ``wo`` (H v, D); ``dense`` stacked over the
dense layers: ``w_gate``, ``w_up`` (D, I), ``w_down`` (I, D); ``moe``
stacked over the MoE layers: ``router`` (E, D), ``router_bias`` (E,),
``w_gateup`` (E, 2Ie, D) and ``w_down`` (E, D, Ie) (K1's (out, in) rows),
``shared_gate``, ``shared_up`` (D, Is), ``shared_down`` (Is, D).

Work counters (``moe_counters``): device-side int64 sums, per phase
(prefill, decode), of the token-expert pairs computed, the expert weight
sets read (an expert with one row or more, per layer call), each expert's
largest load in a call, and the latent slots attended. Updated on the
device (inside the graphs too); read them outside a timed window.

Not ported for this decoder (each raises naming it): training, tensor or
sequence parallelism, the paged cache, speculative decoding, float32
activations on the card, int8 weights.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.fused_decode import _quantize_kv
from ..kernels.latent_decode import latent_decode
from ..kernels.moe_experts import moe_experts, sort_by_expert
from ..obs.profile import annotate
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_cached, rope_cos_sin, rope_inv_freq
from . import llama

Params = Dict


@dataclass(frozen=True)
class MlaMoeConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264  # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense: int = 1
    routed_scaling_factor: float = 2.446
    rms_eps: float = 1e-5
    # DeepSeek-V3's kv_a_layernorm is built without the config's eps, at
    # its class default (DeepseekV3RMSNorm(kv_lora_rank), eps 1e-6)
    kv_norm_eps: float = 1e-6
    rope_theta: float = 50000.0
    tie_embeddings: bool = False
    max_position_embeddings: int = 8192

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense

    @property
    def shared_intermediate_size(self) -> int:
        return self.moe_intermediate_size * self.n_shared_experts

    @property
    def softmax_scale(self) -> float:
        return self.q_head_dim ** -0.5


_PRESETS = {
    # moonshotai/Moonlight-16B-A3B, per its config.json
    "moonlight_16b_a3b": MlaMoeConfig(),
    # tiny config for tests: 1 dense and 2 MoE layers, 8 experts top-2
    "tiny_mla_moe": MlaMoeConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_layers=3, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
        max_position_embeddings=2048),
}
_ALIASES = {"moonshotai/Moonlight-16B-A3B": "moonlight_16b_a3b",
            "moonshotai/Moonlight-16B-A3B-Instruct": "moonlight_16b_a3b"}


def is_mla_moe(name: Optional[str]) -> bool:
    """Whether a preset name or ``llm_type`` names this decoder."""
    return name is not None and _ALIASES.get(name, name) in _PRESETS


def mla_moe_preset(name: str) -> MlaMoeConfig:
    key = _ALIASES.get(name, name)
    if key not in _PRESETS:
        raise KeyError(f"unknown MLA/MoE preset '{name}' (have {sorted(_PRESETS)})")
    return _PRESETS[key]


def not_ported(what: str, cfg) -> NotImplementedError:
    """The refusal of a path this decoder does not take."""
    return NotImplementedError(
        f"{what} is not ported for the DeepSeek-V3 (MLA + MoE) decoder {cfg}; it runs the "
        "single-card bulk path (greedy_generate, iter_audio_response_batches) in bfloat16 "
        "with an int8 latent cache")


# ----------------------------------------------------------------- parameters


def param_shapes(cfg: MlaMoeConfig) -> Dict[str, tuple]:
    """{path: shape} of the tree, paths 'group/leaf'."""
    D, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    R, r, n, v = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    Ld, Lm, E = cfg.first_k_dense, cfg.num_moe_layers, cfg.n_routed_experts
    I, Ie, Is = cfg.intermediate_size, cfg.moe_intermediate_size, cfg.shared_intermediate_size
    return {
        "embed_tokens": (cfg.vocab_size, D), "final_norm": (D,), "lm_head": (D, cfg.vocab_size),
        "layers/input_norm": (L, D), "layers/post_attn_norm": (L, D),
        "layers/wq": (L, D, H * (n + r)), "layers/wkv_a": (L, D, R + r),
        "layers/kv_norm": (L, R), "layers/wkv_b": (L, R, H * (n + v)), "layers/wo": (L, H * v, D),
        "dense/w_gate": (Ld, D, I), "dense/w_up": (Ld, D, I), "dense/w_down": (Ld, I, D),
        "moe/router": (Lm, E, D), "moe/router_bias": (Lm, E),
        "moe/w_gateup": (Lm, E, 2 * Ie, D), "moe/w_down": (Lm, E, D, Ie),
        "moe/shared_gate": (Lm, D, Is), "moe/shared_up": (Lm, D, Is),
        "moe/shared_down": (Lm, Is, D),
    }


NORMS = ("final_norm", "layers/input_norm", "layers/post_attn_norm", "layers/kv_norm")


def nest(flat: Dict[str, torch.Tensor]) -> Params:
    tree: Params = {}
    for path, t in flat.items():
        node, parts = tree, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def init_mla_moe_params(generator: torch.Generator, cfg: MlaMoeConfig, dtype=torch.bfloat16,
                        device=None) -> Params:
    """Random init: normal(0.02) weights (the router bias too), drawn in
    ``dtype`` in place (the routed experts alone are 29 GB in bf16), ones
    for norm scales. ``generator`` must live on ``device``."""
    flat = {}
    for path, shape in param_shapes(cfg).items():
        if path in NORMS:
            flat[path] = torch.ones(shape, dtype=dtype, device=device)
        else:
            flat[path] = torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, 0.02, generator=generator)
    return nest(flat)


def rope_permutation(r: int) -> torch.Tensor:
    """The stored order of the r rope dimensions: the published interleaved
    pairs (2i, 2i + 1) regrouped as evens then odds, which DeepSeek-V3's
    rope does before its half rotation."""
    return torch.cat([torch.arange(0, r, 2), torch.arange(1, r, 2)])


# ----------------------------------------------------------------- the cache


class LatentCache(NamedTuple):
    """The int8 latent cache: c (L, B, 1, S, R) and k_pe (L, B, 1, S, r),
    each row with its bf16 scale (L, B, 1, S); written in place."""

    c: torch.Tensor
    c_scale: torch.Tensor
    pe: torch.Tensor
    pe_scale: torch.Tensor


def init_latent_cache(cfg: MlaMoeConfig, batch: int, max_len: int, dtype=torch.int8,
                      device=None, tp: int = 1) -> LatentCache:
    if tp != 1:
        raise not_ported("tensor parallelism", cfg)
    if dtype != torch.int8:
        raise ValueError(f"the latent cache is int8 (kv_cache_dtype: int8), got {dtype}")
    L = cfg.num_layers
    return LatentCache(
        torch.zeros((L, batch, 1, max_len, cfg.kv_lora_rank), dtype=torch.int8, device=device),
        torch.zeros((L, batch, 1, max_len), dtype=torch.bfloat16, device=device),
        torch.zeros((L, batch, 1, max_len, cfg.qk_rope_head_dim), dtype=torch.int8,
                    device=device),
        torch.zeros((L, batch, 1, max_len), dtype=torch.bfloat16, device=device))


def _write_latents(cache: LatentCache, layer: int, offset: int, c, kpe) -> None:
    """Fresh (B, T, R) and (B, T, r) latents at slots [offset, offset + T)."""
    window = slice(offset, offset + c.shape[1])
    for new, buf, scales in ((c, cache.c, cache.c_scale), (kpe, cache.pe, cache.pe_scale)):
        vals, sc = _quantize_kv(new)
        buf[layer, :, 0, window] = vals
        scales[layer, :, 0, window] = sc


# ----------------------------------------------------------------- counters

PHASES = ("prefill", "decode")
_counters: Dict[tuple, Dict[str, torch.Tensor]] = {}
_counters_lock = threading.Lock()


def moe_counters(device, n_experts: int) -> Dict[str, torch.Tensor]:
    """The device's work counters (see the module docstring): "experts"
    (2, 3, E) int64 (per phase: rows, calls with rows, largest rows in a
    call) and "slots" (2,) int64."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.type, device.index, n_experts)
    with _counters_lock:
        if key not in _counters:
            _counters[key] = {
                "experts": torch.zeros((2, 3, n_experts), dtype=torch.int64, device=device),
                "slots": torch.zeros((2,), dtype=torch.int64, device=device)}
        return _counters[key]


def read_moe_counters(device, n_experts: int) -> Dict[str, Dict[str, int]]:
    """The counters on the host (this reads the device): per phase, the
    token-expert pairs, expert weight sets read, the largest load of one
    expert in a call, and the latent slots attended."""
    c = moe_counters(device, n_experts)
    ex, slots = c["experts"].cpu(), c["slots"].cpu()
    return {ph: {"pairs": int(ex[i, 0].sum()), "expert_sets": int(ex[i, 1].sum()),
                 "max_load": int(ex[i, 2].max()), "latent_slots": int(slots[i])}
            for i, ph in enumerate(PHASES)}


def _count_experts(cfg: MlaMoeConfig, counts: torch.Tensor, phase: int) -> None:
    ex = moe_counters(counts.device, cfg.n_routed_experts)["experts"][phase]
    ex[0] += counts
    ex[1] += counts > 0
    torch.maximum(ex[2], counts.long(), out=ex[2])


# ----------------------------------------------------------------- the block


_layer = llama._layer


def _project(cfg: MlaMoeConfig, lp: Params, h, cos, sin):
    """The normed input's q (B, T, H, n + r) with rope on its last r, the
    normed latent c (B, T, R) and k_pe (B, T, r) after rope."""
    B, T, _ = h.shape
    H, R = cfg.num_heads, cfg.kv_lora_rank
    n = cfg.qk_nope_head_dim
    q = (h @ lp["wq"]).reshape(B, T, H, cfg.q_head_dim)
    q = torch.cat([q[..., :n], apply_rope_cached(q[..., n:], cos, sin)], dim=-1)
    kv = h @ lp["wkv_a"]
    c = rms_norm(kv[..., :R], lp["kv_norm"], cfg.kv_norm_eps)
    kpe = apply_rope_cached(kv[..., R:][:, :, None, :], cos, sin)[:, :, 0]
    return q, c, kpe


def _wkv_b(cfg: MlaMoeConfig, lp: Params):
    """(W_uk, W_uv) as (R, H, n) and (R, H, v) views of ``wkv_b``."""
    w = lp["wkv_b"].reshape(cfg.kv_lora_rank, cfg.num_heads,
                            cfg.qk_nope_head_dim + cfg.v_head_dim)
    return w[..., :cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def _expanded_attention(cfg: MlaMoeConfig, lp: Params, q, c, kpe, pad_lens):
    """The cache-free (prefill) attention, expanded per head: (B, T, H v).
    Left pads attend only themselves, which keeps their rows finite."""
    B, T, H, _ = q.shape
    w_uk, w_uv = _wkv_b(cfg, lp)
    k = torch.cat([torch.einsum("btr,rhd->bthd", c, w_uk),
                   kpe[:, :, None, :].expand(B, T, H, cfg.qk_rope_head_dim)], dim=-1)
    v = torch.einsum("btr,rhd->bthd", c, w_uv)
    pos = torch.arange(T, device=q.device)
    key, query = pos[None, None, :], pos[None, :, None]
    keep = ((key >= pad_lens[:, None, None]) & (key <= query)) | (key == query)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       attn_mask=keep[:, None], scale=cfg.softmax_scale)
    return o.transpose(1, 2).reshape(B, T, H * cfg.v_head_dim)


def _absorb(cfg: MlaMoeConfig, lp: Params, q):
    """The decode query [q_nope W_uk (R) | q_pe (r)] (B, T, H, R + r)."""
    w_uk, _ = _wkv_b(cfg, lp)
    q_c = torch.einsum("bthd,rhd->bthr", q[..., :cfg.qk_nope_head_dim], w_uk)
    return torch.cat([q_c, q[..., cfg.qk_nope_head_dim:]], dim=-1)


def _latent_out(cfg: MlaMoeConfig, lp: Params, o_lat):
    """The latent attention output (B, T, H, R) through W_uv: (B, T, H v)."""
    B, T = o_lat.shape[:2]
    _, w_uv = _wkv_b(cfg, lp)
    return torch.einsum("bthr,rhd->bthd", o_lat, w_uv).reshape(B, T, -1)


def _swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def _mm_f32(a, b):
    """a @ b in float32, the products of a's and b's values exact (bf16
    products fit float32) and summed in float32: on the card a bf16
    tensor-core product with a float32 output, else in float32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def route(cfg: MlaMoeConfig, mp: Params, h):
    """h (N, D) → (chosen experts (N, k), their weights (N, k) float32):
    float32 logits, sigmoid scores, the top k of score + bias, the chosen
    scores normalised and scaled."""
    s = torch.sigmoid(_mm_f32(h, mp["router"].t()))
    sel = torch.topk(s + mp["router_bias"].float(), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, sel)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return sel, w


def _moe(cfg: MlaMoeConfig, mp: Params, h, valid, phase: int):
    """The MoE FFN of (B, T, D) normed inputs; ``valid`` (B * T,) marks the
    tokens routed (the prefill's left pads are not: their routed part is
    zero)."""
    B, T, D = h.shape
    x = h.reshape(B * T, D)
    with annotate("lss.moe.route"):
        sel, w = route(cfg, mp, x)
        routing = sort_by_expert(sel, cfg.n_routed_experts, valid)
        _count_experts(cfg, routing.counts, phase)
    with annotate("lss.moe.experts"):
        routed = moe_experts(x, routing, w, mp["w_gateup"], mp["w_down"])
    with annotate("lss.moe.shared"):
        shared = _swiglu(x, mp["shared_gate"], mp["shared_up"], mp["shared_down"])
    return (routed + shared).reshape(B, T, D)


def _ffn(cfg: MlaMoeConfig, params: Params, i: int, x, valid, phase: int):
    """Layer i's FFN half, residual included."""
    h = rms_norm(x, params["layers"]["post_attn_norm"][i], cfg.rms_eps)
    if i < cfg.first_k_dense:
        dp = {k: w[i] for k, w in params["dense"].items()}
        return x + _swiglu(h, dp["w_gate"], dp["w_up"], dp["w_down"])
    mp = {k: w[i - cfg.first_k_dense] for k, w in params["moe"].items()}
    return x + _moe(cfg, mp, h, valid, phase)


def _rope_tables(cfg: MlaMoeConfig, positions):
    return rope_cos_sin(positions, rope_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta,
                                                 device=positions.device))


# ----------------------------------------------------------------- forward


def mla_moe_forward(
    params: Params,
    cfg: MlaMoeConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[LatentCache] = None,
    cache_offset=None,
    kv_pad_lens: Optional[torch.Tensor] = None,
    last_logit_only: bool = False,
    cache_offset_bound: Optional[int] = None,
    attn_impl: str = "auto",
    tp_group=None,
    ring_group=None,
    counts=None,
) -> llama.LlamaOutput:
    """Run the decoder; the modes, arguments and outputs of
    ``llama_forward`` that this decoder takes (no training outputs):

      * no cache: causal attention over the left-padded (B, T) batch,
        ``attn_mask`` marking real positions;
      * prefill: ``kv_cache`` + ``cache_offset`` without ``kv_pad_lens``:
        the latents written, int8, at [offset, offset + T);
      * decode: ``kv_cache`` + ``cache_offset`` + ``kv_pad_lens``: valid
        slots [pad, offset), the T >= 1 fresh tokens attend causally (K2)
        and are written at [offset, offset + T); a per-row ``cache_offset``
        needs its host bound ``cache_offset_bound``.

    A T = 1 decode step on the card from ``input_ids`` at one scalar offset
    replays the piecewise graphs (``graphs_engage``); ``counts`` gains
    "decode_graph_steps" and "decode_graph_captures" as in
    ``llama_forward``. Spans (eager): ``lss.mla.attend``, ``lss.moe.route``,
    ``lss.moe.experts``, ``lss.moe.shared``."""
    if tp_group is not None or ring_group is not None:
        raise not_ported("tensor or sequence parallelism", cfg)
    if attn_impl not in ("auto", "fused"):
        raise not_ported(f"attn_impl={attn_impl!r}", cfg)
    if inputs_embeds is None and input_ids is None:
        raise ValueError("mla_moe_forward needs input_ids or inputs_embeds")
    src = input_ids if inputs_embeds is None else inputs_embeds
    B, T, dev = src.shape[0], src.shape[1], src.device
    act = params["final_norm"].dtype if inputs_embeds is None else inputs_embeds.dtype
    if dev.type == "cuda" and act != torch.bfloat16:
        raise not_ported(f"{act} activations on the card", cfg)
    is_decode = kv_cache is not None and kv_pad_lens is not None
    if is_decode and attn_mask is not None:
        raise ValueError("a decode step treats its fresh tokens as real: pass attn_mask=None")
    if kv_cache is not None and cache_offset is None:
        raise ValueError("a forward with a kv_cache needs cache_offset")

    if is_decode:
        offsets, pad_lens, max_offset = llama._dense_windows(cache_offset, cache_offset_bound,
                                                             kv_pad_lens, B, dev)
        slots = moe_counters(dev, cfg.n_routed_experts)["slots"]
        slots[1] += cfg.num_layers * ((offsets - pad_lens).sum() + B * T * (T + 1) // 2)

        def attend(i, q, c, kpe):
            with annotate("lss.mla.attend"):
                return latent_decode(q, *kv_cache, c, kpe, pad_lens, offsets, i,
                                     max_offset=max_offset, scale=cfg.softmax_scale)

        if (inputs_embeds is None and not torch.is_grad_enabled()
                and graphs_engage(dev, kv_cache, kv_pad_lens, cache_offset, T)):
            logits = llama._graphed_step(params, cfg, input_ids, positions, attend, counts,
                                         PIECES)
            return llama.LlamaOutput(logits=logits, kv_cache=kv_cache)

    x = llama._embed_lookup(params, input_ids.long()) if inputs_embeds is None else inputs_embeds
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if positions is None:
        positions = torch.clamp(torch.cumsum(attn_mask.to(torch.int32), dim=1) - 1, min=0)
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _rope_tables(cfg, positions)
    phase = 1 if is_decode else 0
    valid = None
    if not is_decode:
        pad_lens = (T - attn_mask.to(torch.int32).sum(dim=1)).to(torch.int32)
        valid = attn_mask.reshape(-1)
        lens = T - pad_lens.long()
        moe_counters(dev, cfg.n_routed_experts)["slots"][0] += \
            cfg.num_layers * (lens * (lens + 1) // 2).sum()

    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["input_norm"], cfg.rms_eps)
        q, c, kpe = _project(cfg, lp, h, cos, sin)
        if is_decode:
            attn = _latent_out(cfg, lp, attend(i, _absorb(cfg, lp, q), c, kpe))
        else:
            if kv_cache is not None:
                _write_latents(kv_cache, i, int(cache_offset), c, kpe)
            with annotate("lss.mla.attend"):
                attn = _expanded_attention(cfg, lp, q, c, kpe, pad_lens)
        x = x + attn @ lp["wo"]
        x = _ffn(cfg, params, i, x, valid, phase)

    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if last_logit_only:
        x = x[:, -1:, :]
    return llama.LlamaOutput(logits=_head(params, x), kv_cache=kv_cache)


def _head(params: Params, x):
    """float32 logits (B, T, V) of the normed final hidden states: the
    untied head's bf16 values against x's, exact products, float32 sums
    (``llama._head``'s arithmetic, on the tensor cores on the card)."""
    B, T, D = x.shape
    return _mm_f32(x.reshape(B * T, D), params["lm_head"].to(x.dtype)).reshape(B, T, -1)


# ----------------------------------------------------------------- decode graphs
#
# The step cut at its K2 launches, as ``llama`` cuts a Llama step at B2's:
# piece 0 the embedding, the rope tables and layer 0's absorbed query and
# fresh latents; piece i the rest of layer i - 1 (W_uv, W_o, its FFN: the
# routing, the sort and K1) and layer i's query and latents, or the head.


def graphs_engage(device: torch.device, kv_cache, kv_pad_lens, cache_offset, T: int) -> bool:
    """Whether a decode forward replays the piecewise graphs: on the card,
    a T == 1 step over the ``LatentCache`` at one scalar offset."""
    return (device.type == "cuda" and isinstance(kv_cache, LatentCache)
            and kv_pad_lens is not None and T == 1 and not isinstance(cache_offset, torch.Tensor))


def _piece_project(cfg, params, i, x, cos, sin):
    lp = _layer(params, i)
    q, c, kpe = _project(cfg, lp, rms_norm(x, lp["input_norm"], cfg.rms_eps), cos, sin)
    return _absorb(cfg, lp, q), c, kpe


def _first_piece(params: Params, cfg: MlaMoeConfig, ids, positions):
    x = llama._embed_lookup(params, ids)
    rope = _rope_tables(cfg, positions)
    return (x,) + _piece_project(cfg, params, 0, x, *rope) + rope


def _piece(params: Params, cfg: MlaMoeConfig, i: int, x, o_lat, rope):
    lp = _layer(params, i - 1)
    x = x + _latent_out(cfg, lp, o_lat) @ lp["wo"]
    x = _ffn(cfg, params, i - 1, x, None, 1)
    if i == cfg.num_layers:
        return _head(params, rms_norm(x, params["final_norm"], cfg.rms_eps))
    return (x,) + _piece_project(cfg, params, i, x, *rope)


PIECES = llama.GraphPieces(
    _first_piece, _piece, 3,
    lambda cfg, B: (B, 1, cfg.num_heads, cfg.kv_lora_rank))
