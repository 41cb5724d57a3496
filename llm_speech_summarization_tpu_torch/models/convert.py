"""HF checkpoint → the port's parameter trees (port of ``models/convert.py``).

Conversion is an explicit offline step: a host-side transform from an HF
state dict (tensors keyed by HF parameter names) into the port's trees,
which keep the JAX package's layout and key names (``bridge.py``): torch
Linear weights (out, in) are transposed to (in, out) so forwards are plain
``x @ W``, and per-layer tensors are stacked on a leading layer axis.

``load_hf_state_dict(dir)`` reads a local checkpoint: every
``*.safetensors`` shard in sorted order through the port's own reader (a
memory map; bf16 arrives as ``torch.bfloat16`` without a float32 round
trip), or else every ``*.bin`` shard through ``torch.load(weights_only=
True)``. Floating tensors keep their stored dtype until ``_cast``; integer
and bool buffers pass through unchanged. Stacks are filled one layer at a
time into one preallocated tensor, so the host holds about one copy of the
weights beside the mapped file.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from .hubert import HubertConfig
from .llama import LlamaConfig
from .whisper import WhisperConfig

StateDict = Dict[str, torch.Tensor]

# safetensors dtype names → torch dtypes
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header (``__metadata__`` skipped) of {name: {dtype, shape,
    data_offsets}}, then the raw data, offsets relative to the header's end.
    The tensors are views of a copy-on-write memory map of the file; an
    unknown dtype raises ValueError."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    mm = np.memmap(path, dtype=np.uint8, mode="c") if os.path.getsize(path) > 8 + n else None
    out: StateDict = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, which the "
                             f"reader does not map (have {sorted(SAFETENSORS_DTYPES)})")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = int(np.prod(shape, dtype=np.int64))
        if numel * dtype.itemsize != end - begin:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, its shape "
                             f"{shape} and dtype {info['dtype']} need {numel * dtype.itemsize}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=numel,
                                         offset=8 + n + begin).reshape(shape)
    return out


def load_hf_state_dict(model_dir: str) -> StateDict:
    """Every tensor of a local HF checkpoint directory (see the module
    docstring); FileNotFoundError when it holds neither format."""
    names = sorted(os.listdir(model_dir))
    safes = [f for f in names if f.endswith(".safetensors")]
    bins = [f for f in names if f.endswith(".bin")]
    out: StateDict = {}
    if safes:
        for f in safes:
            out.update(read_safetensors(os.path.join(model_dir, f)))
        return out
    if bins:
        for f in bins:
            out.update(torch.load(os.path.join(model_dir, f), map_location="cpu",
                                  weights_only=True, mmap=True))
        return out
    raise FileNotFoundError(f"no .safetensors or .bin files in {model_dir}")


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor with its own storage (never a view of the map)."""
    return torch.empty(t.shape, dtype=t.dtype).copy_(t)


def _stack(sd: StateDict, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
    """The ``n`` layers' tensors stacked on a new leading axis, filled one
    layer at a time (transposed to (in, out) with ``transpose``)."""
    first = sd[fmt.format(i=0)]
    shape = tuple(reversed(first.shape)) if transpose else tuple(first.shape)
    out = torch.empty((n, *shape), dtype=first.dtype)
    for i in range(n):
        m = sd[fmt.format(i=i)]
        out[i].copy_(m.t() if transpose else m)
    return out


def convert_llama(sd: StateDict, cfg: LlamaConfig, dtype=torch.float32) -> dict:
    """HF LlamaForCausalLM state dict → ``init_llama_params`` layout. A tied
    config (Llama-3.2-3B) takes no ``lm_head.weight``; an untied one
    (MiniChat-3B) needs it."""
    L = cfg.num_layers
    p = "model.layers.{i}."
    params = {
        "embed_tokens": _own(sd["model.embed_tokens.weight"]),
        "final_norm": _own(sd["model.norm.weight"]),
        "layers": {
            "input_norm": _stack(sd, p + "input_layernorm.weight", L),
            "post_attn_norm": _stack(sd, p + "post_attention_layernorm.weight", L),
            "wq": _stack(sd, p + "self_attn.q_proj.weight", L, transpose=True),
            "wk": _stack(sd, p + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, p + "self_attn.v_proj.weight", L, transpose=True),
            "wo": _stack(sd, p + "self_attn.o_proj.weight", L, transpose=True),
            "w_gate": _stack(sd, p + "mlp.gate_proj.weight", L, transpose=True),
            "w_up": _stack(sd, p + "mlp.up_proj.weight", L, transpose=True),
            "w_down": _stack(sd, p + "mlp.down_proj.weight", L, transpose=True),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _own(sd["lm_head.weight"].t())
    return _cast(params, dtype)


def _weight_norm_conv(sd: StateDict, prefix: str) -> torch.Tensor:
    """A torch weight-normed conv weight (dim=2), w = g·v/||v||, from either
    spelling (``weight_g``/``weight_v`` or the parametrization's
    ``original0``/``original1``), computed in float32 numpy as the JAX
    converter computes it from float32 inputs (a torch reduction sums in
    another order); a plain ``weight`` passes through."""
    for g_key, v_key in (
        (prefix + "weight_g", prefix + "weight_v"),
        (prefix + "parametrizations.weight.original0", prefix + "parametrizations.weight.original1"),
    ):
        if g_key in sd:
            g, v = sd[g_key].float().numpy(), sd[v_key].float().numpy()
            norm = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))
            return torch.from_numpy(g * v / np.maximum(norm, 1e-12))
    return _own(sd[prefix + "weight"])


def convert_hubert(sd: StateDict, cfg: HubertConfig, dtype=torch.float32) -> dict:
    """HF HubertModel state dict → ``init_hubert_params`` layout: the
    layer-normed stem of hubert-large or the group-normed first layer of
    hubert-base."""
    L = cfg.num_layers
    conv_layers = []
    for i in range(len(cfg.conv_dims)):
        cp = f"feature_extractor.conv_layers.{i}."
        layer = {"w": _own(sd[cp + "conv.weight"])}
        if cp + "conv.bias" in sd:
            layer["b"] = _own(sd[cp + "conv.bias"])
        if cfg.feat_extract_norm == "layer":
            layer["ln_scale"] = _own(sd[cp + "layer_norm.weight"])
            layer["ln_bias"] = _own(sd[cp + "layer_norm.bias"])
        elif i == 0:
            layer["gn_scale"] = _own(sd[cp + "layer_norm.weight"])
            layer["gn_bias"] = _own(sd[cp + "layer_norm.bias"])
        conv_layers.append(layer)

    e = "encoder.layers.{i}."
    params = {
        "conv_layers": conv_layers,
        "fp_ln_scale": _own(sd["feature_projection.layer_norm.weight"]),
        "fp_ln_bias": _own(sd["feature_projection.layer_norm.bias"]),
        "fp_w": _own(sd["feature_projection.projection.weight"].t()),
        "fp_b": _own(sd["feature_projection.projection.bias"]),
        "pos_conv_w": _weight_norm_conv(sd, "encoder.pos_conv_embed.conv."),
        "pos_conv_b": _own(sd["encoder.pos_conv_embed.conv.bias"]),
        "layers": {
            "ln1_scale": _stack(sd, e + "layer_norm.weight", L),
            "ln1_bias": _stack(sd, e + "layer_norm.bias", L),
            "wq": _stack(sd, e + "attention.q_proj.weight", L, transpose=True),
            "bq": _stack(sd, e + "attention.q_proj.bias", L),
            "wk": _stack(sd, e + "attention.k_proj.weight", L, transpose=True),
            "bk": _stack(sd, e + "attention.k_proj.bias", L),
            "wv": _stack(sd, e + "attention.v_proj.weight", L, transpose=True),
            "bv": _stack(sd, e + "attention.v_proj.bias", L),
            "wo": _stack(sd, e + "attention.out_proj.weight", L, transpose=True),
            "bo": _stack(sd, e + "attention.out_proj.bias", L),
            "ln2_scale": _stack(sd, e + "final_layer_norm.weight", L),
            "ln2_bias": _stack(sd, e + "final_layer_norm.bias", L),
            "w1": _stack(sd, e + "feed_forward.intermediate_dense.weight", L, transpose=True),
            "b1": _stack(sd, e + "feed_forward.intermediate_dense.bias", L),
            "w2": _stack(sd, e + "feed_forward.output_dense.weight", L, transpose=True),
            "b2": _stack(sd, e + "feed_forward.output_dense.bias", L),
        },
        "encoder_ln_scale": _own(sd["encoder.layer_norm.weight"]),
        "encoder_ln_bias": _own(sd["encoder.layer_norm.bias"]),
    }
    return _cast(params, dtype)


def convert_hubert_ctc(sd: StateDict, cfg: HubertConfig, dtype=torch.float32) -> tuple:
    """HF HubertForCTC state dict → (encoder params, CTC head params): the
    word-offset model of the preprocessing job. HF prefixes the backbone
    with ``hubert.``."""
    backbone = {k[len("hubert."):]: v for k, v in sd.items() if k.startswith("hubert.")}
    enc = convert_hubert(backbone, cfg, dtype)
    head = _cast({"ctc_w": _own(sd["lm_head.weight"].t()), "ctc_b": _own(sd["lm_head.bias"])}, dtype)
    return enc, head


def convert_whisper_encoder(sd: StateDict, cfg: WhisperConfig, dtype=torch.float32) -> dict:
    """HF Whisper state dict → ``init_whisper_params`` layout. Accepts
    ``model.encoder.*`` (WhisperForConditionalGeneration, the stock
    openai/whisper-* layout), ``encoder.*`` (WhisperModel) or bare encoder
    keys."""
    if any(k.startswith("model.encoder.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.encoder.")}
    elif not any(k.startswith("encoder.") for k in sd):
        sd = {f"encoder.{k}": v for k, v in sd.items()}
    L = cfg.num_layers
    e = "encoder.layers.{i}."
    params = {
        "conv1_w": _own(sd["encoder.conv1.weight"]),
        "conv1_b": _own(sd["encoder.conv1.bias"]),
        "conv2_w": _own(sd["encoder.conv2.weight"]),
        "conv2_b": _own(sd["encoder.conv2.bias"]),
        "pos_embed": _own(sd["encoder.embed_positions.weight"]),
        "layers": {
            "ln1_scale": _stack(sd, e + "self_attn_layer_norm.weight", L),
            "ln1_bias": _stack(sd, e + "self_attn_layer_norm.bias", L),
            "wq": _stack(sd, e + "self_attn.q_proj.weight", L, transpose=True),
            "bq": _stack(sd, e + "self_attn.q_proj.bias", L),
            "wk": _stack(sd, e + "self_attn.k_proj.weight", L, transpose=True),
            "wv": _stack(sd, e + "self_attn.v_proj.weight", L, transpose=True),
            "bv": _stack(sd, e + "self_attn.v_proj.bias", L),
            "wo": _stack(sd, e + "self_attn.out_proj.weight", L, transpose=True),
            "bo": _stack(sd, e + "self_attn.out_proj.bias", L),
            "ln2_scale": _stack(sd, e + "final_layer_norm.weight", L),
            "ln2_bias": _stack(sd, e + "final_layer_norm.bias", L),
            "w1": _stack(sd, e + "fc1.weight", L, transpose=True),
            "b1": _stack(sd, e + "fc1.bias", L),
            "w2": _stack(sd, e + "fc2.weight", L, transpose=True),
            "b2": _stack(sd, e + "fc2.bias", L),
        },
        "final_ln_scale": _own(sd["encoder.layer_norm.weight"]),
        "final_ln_bias": _own(sd["encoder.layer_norm.bias"]),
    }
    return _cast(params, dtype)


def _cast(tree, dtype):
    """Every floating leaf to ``dtype``, whatever its stored float type
    (bfloat16 included); integer and bool leaves unchanged."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree
