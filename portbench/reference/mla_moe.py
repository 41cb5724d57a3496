"""Plain PyTorch reference of the DeepSeek-V3 decoder (Moonlight-16B-A3B:
multi-head latent attention and sparse experts with shared experts), with
the int8 latent cache the configuration states.

Equations as DeepSeek-V2 (arXiv:2405.04434) and DeepSeek-V3
(arXiv:2412.19437) publish them and as their ``modeling_deepseek.py``
computes them, expanded (no absorption): per head k = [c W_uk | k_pe] and
v = c W_uv, c the RMS-normed latent (eps 1e-6, the norm's own default),
rope on interleaved pairs of q_pe and k_pe (the published regrouping from
(r/2, 2) to (2, r/2) before the half rotation), scale (nope + rope)^-1/2;
the MoE FFN with float32 sigmoid scores, top-k of score + correction bias,
weights the chosen scores normalised (+ 1e-20) and scaled; each expert and
the shared experts a SwiGLU.

One unpadded sequence at a time in float32 (TF32 off), each weight cast to
float32 a layer or an expert at a time, so the 16B model fits beside
nothing else. Weights are the nested trees ``portbench/weights_moe.py``
makes (the program's tree): their rope columns of W_q and W_kva are stored
regrouped (evens, then odds), as the program's converter stores them;
``published_rope`` puts them back before the published rotation, unless
the tree is already in the published order. Sizes come from the HF
config keys, which the configuration file holds at its top level. This
file imports nothing of the program.

With ``n_prompt``, positions from it on are decode steps: each reads every
earlier latent (c and k_pe) rounded through the int8 cache and its own
exact, as ``model._cached_attention`` does for the dense cache; the prompt
reads its own exact. ``Precision`` rounds the operands of every product,
the router's included, and the residual stream.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.model import F32, Precision, quantize_int8, rms_norm

KV_NORM_EPS = 1e-6  # DeepseekV3RMSNorm(kv_lora_rank): the class default, not the config's eps
NEAR_TIE = 1e-3  # a selection margin below this counts as a near-tie


def _layer(tree, i):
    return {k: w[i] for k, w in tree.items()}


def published_rope(w: torch.Tensor, r: int, heads: int) -> torch.Tensor:
    """(D, heads * (n + r)) columns with each head's last r regrouped
    (evens, then odds) → the published interleaved order, float32."""
    D, cols = w.shape
    w = w.float().reshape(D, heads, cols // heads)
    n = w.shape[-1] - r
    stored = torch.cat([torch.arange(0, r, 2), torch.arange(1, r, 2)]).to(w.device)
    inverse = torch.argsort(stored)
    return torch.cat([w[..., :n], w[..., n:][..., inverse]], dim=-1).reshape(D, cols)


def rope_interleaved(x: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's ``apply_rotary_pos_emb`` on x (n, H, r) at positions
    0..n-1: pairs regrouped (r/2, 2) → (2, r/2), then the half rotation."""
    n, H, r = x.shape
    x = x.reshape(n, H, r // 2, 2).transpose(-1, -2).reshape(n, H, r)
    inv = 1.0 / (theta ** (torch.arange(0, r, 2, dtype=torch.float64, device=x.device) / r))
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : r // 2], x[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, n_prompt, scale, exact_k=None, exact_v=None):
    """Causal attention (queries and keys at 0..n-1); with ``n_prompt``,
    queries from it on read earlier keys and values from (k, v), the
    cache's rounding, and their own from (exact_k, exact_v); the prompt
    reads (exact_k, exact_v)."""
    n = q.shape[0]
    pos = torch.arange(n, device=q.device)
    s = torch.einsum("nhd,mhd->hnm", q, k)
    if n_prompt is not None:
        exact = (pos[:, None] < n_prompt) | (pos[:, None] == pos[None, :])
        s = torch.where(exact[None], torch.einsum("nhd,mhd->hnm", q, exact_k), s)
    s = (s * scale).masked_fill(~(pos[:, None] >= pos[None, :])[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if n_prompt is None:
        return torch.einsum("hnm,mhd->nhd", p, v)
    pe, pq = torch.where(exact[None], p, 0.0), torch.where(exact[None], 0.0, p)
    return torch.einsum("hnm,mhd->nhd", pe, exact_v) + torch.einsum("hnm,mhd->nhd", pq, v)


def _swiglu(h, w_gate, w_up, w_down, prec: Precision):
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_up), w_down)


def _moe(h, mp, cfg: dict, prec: Precision, info: dict):
    """The MoE FFN of h (n, D): routed experts (each expert's weights cast
    one at a time) plus the shared experts."""
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    s = torch.sigmoid(prec.mm(h, mp["router"].float().t()))
    choice = s + mp["router_bias"].float()
    top = torch.topk(choice, k + 1, dim=-1)
    sel = top.indices[:, :k]
    margin = top.values[:, k - 1] - top.values[:, k]
    info["min_margin"] = min(info.get("min_margin", math.inf), float(margin.min()))
    info["near_ties"] = info.get("near_ties", 0) + int((margin < NEAR_TIE).sum())
    w = s.gather(1, sel)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    Ie = cfg["moe_intermediate_size"]
    out = torch.zeros_like(h)
    for e in range(E):
        hit = sel == e  # (n, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gu = mp["w_gateup"][e].float()
        y = _swiglu(h[rows], gu[:Ie].t(), gu[Ie:].t(), mp["w_down"][e].float().t(), prec)
        out[rows] += (w * hit)[rows].sum(-1, keepdim=True) * y
    shared = _swiglu(h, mp["shared_gate"].float(), mp["shared_up"].float(),
                     mp["shared_down"].float(), prec)
    return out + shared


def mla_moe(p, cfg: dict, x: torch.Tensor, prec: Precision = F32, *,
            n_prompt: Optional[int] = None, logits_from: int = 0, rope_stored: bool = True):
    """Decoder over one unpadded sequence of input embeddings x (n, D).

    Returns (logits of positions ``logits_from``.. (n', V) float32, info:
    the smallest selection margin of the routed layers, over every token,
    and the count of near-ties). ``rope_stored``: the tree's rope columns
    are regrouped as the program stores them (else published)."""
    n, D = x.shape
    H, R = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, r, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    scale = (dn + r) ** -0.5
    k_dense = cfg["first_k_dense_replace"]
    info: dict = {}
    x = prec.act(x)
    for i in range(cfg["num_hidden_layers"]):
        lp = _layer(p["layers"], i)
        wq, wkv_a = lp["wq"].float(), lp["wkv_a"].float()
        if rope_stored:
            wq = published_rope(wq, r, H)
            wkv_a = published_rope(wkv_a, r, 1)
        h = rms_norm(x, lp["input_norm"], eps)
        q = prec.mm(h, wq).reshape(n, H, dn + r)
        kv = prec.mm(h, wkv_a)
        c = rms_norm(kv[:, :R], lp["kv_norm"], KV_NORM_EPS)
        q = torch.cat([q[..., :dn], rope_interleaved(q[..., dn:], theta)], dim=-1)
        kpe = rope_interleaved(kv[:, None, R:], theta)  # (n, 1, r)
        wkv_b = lp["wkv_b"].float().reshape(R, H, dn + dv)

        def heads(c, kpe):
            kn = prec.einsum("nr,rhd->nhd", c, wkv_b[..., :dn])
            return (torch.cat([kn, kpe.expand(n, H, r)], dim=-1),
                    prec.einsum("nr,rhd->nhd", c, wkv_b[..., dn:]))

        k, v = heads(c, kpe)
        if n_prompt is None:
            a = _attention(q, k, v, None, scale)
        else:
            kq, vq = heads(quantize_int8(c), quantize_int8(kpe))
            a = _attention(q, kq, vq, n_prompt, scale, k, v)
        x = prec.act(x + prec.mm(a.reshape(n, H * dv), lp["wo"].float()))
        h = rms_norm(x, lp["post_attn_norm"], eps)
        if i < k_dense:
            dp = _layer(p["dense"], i)
            f = _swiglu(h, dp["w_gate"].float(), dp["w_up"].float(), dp["w_down"].float(), prec)
        else:
            f = _moe(h, _layer(p["moe"], i - k_dense), cfg, prec, info)
        x = prec.act(x + f)
    x = rms_norm(x[logits_from:], p["final_norm"], eps)
    return prec.mm(x, p["lm_head"].float()), info
