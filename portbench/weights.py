"""Random weights made on the device from the seed, in the type they are
served in, as the nested trees the program takes: each group of leaves
(weights and biases at N(0, 0.02), the decoder's at N(0, ``init_std``)
where the configuration gives one, norm scales at 1 + N(0, 0.02), the
projector at N(0, in_dim^-1/2)) is one flat buffer filled by a few large
``normal_`` calls on a seeded ``torch.Generator``, and the leaves are views
of it. The same seed gives the same trees on the same device, so the
reference makes its own copy after the program's run."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 28  # elements per normal_ call
LLM_SEED, ENCODER_SEED = 1, 2
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed``."""
    hi, lo = np.random.SeedSequence([int(seed), stream]).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


def _fill(specs: List[Tuple[str, tuple, str]], gen: torch.Generator, dtype, device,
          std: Dict[str, Tuple[float, float]]) -> Dict[str, torch.Tensor]:
    """{path: tensor} for ``specs`` [(path, shape, group)]: one flat buffer
    per group, drawn as mean + std * N(0, 1)."""
    out = {}
    for group, (mean, sd) in std.items():
        mine = [(path, shape) for path, shape, g in specs if g == group]
        total = sum(math.prod(s) for _, s in mine)
        if not total:
            continue
        buf = torch.empty(total, dtype=dtype, device=device)
        for a in range(0, total, CHUNK):
            buf[a:a + CHUNK].normal_(mean, sd, generator=gen)
        at = 0
        for path, shape in mine:
            n = math.prod(shape)
            out[path] = buf[at:at + n].view(shape)
            at += n
    return out


def _nest(flat: Dict[str, torch.Tensor]):
    """'a/b/0/c' paths → nested dicts, with lists where keys are digits."""
    root: dict = {}
    for path, t in flat.items():
        node, parts = root, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def llm_specs(c: dict):
    D, I, L, V = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"], c["vocab_size"]
    q, kv = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    s = [("embed_tokens", (V, D), "w"), ("final_norm", (D,), "scale"),
         ("layers/input_norm", (L, D), "scale"), ("layers/post_attn_norm", (L, D), "scale"),
         ("layers/wq", (L, D, q), "w"), ("layers/wk", (L, D, kv), "w"),
         ("layers/wv", (L, D, kv), "w"), ("layers/wo", (L, q, D), "w"),
         ("layers/w_gate", (L, D, I), "w"), ("layers/w_up", (L, D, I), "w"),
         ("layers/w_down", (L, I, D), "w")]
    if not c["tie_word_embeddings"]:
        s.append(("lm_head", (D, V), "w"))
    return s


def _block_specs(prefix, L, D, Fi, k_bias=True):
    s = [(f"{prefix}/ln1_scale", (L, D), "scale"), (f"{prefix}/ln1_bias", (L, D), "w"),
         (f"{prefix}/ln2_scale", (L, D), "scale"), (f"{prefix}/ln2_bias", (L, D), "w"),
         (f"{prefix}/w1", (L, D, Fi), "w"), (f"{prefix}/b1", (L, Fi), "w"),
         (f"{prefix}/w2", (L, Fi, D), "w"), (f"{prefix}/b2", (L, D), "w")]
    for name in ("q", "k", "v", "o"):
        s.append((f"{prefix}/w{name}", (L, D, D), "w"))
        if name != "k" or k_bias:
            s.append((f"{prefix}/b{name}", (L, D), "w"))
    return s


def encoder_specs(config: dict):
    ec = config["encoder"]
    D = ec["hidden_size"]
    L, Fi = ec["num_layers"], ec["intermediate_size"]
    if ec["type"] == "whisper":
        s = [("encoder/conv1_w", (D, ec["num_mel_bins"], 3), "w"), ("encoder/conv1_b", (D,), "w"),
             ("encoder/conv2_w", (D, D, 3), "w"), ("encoder/conv2_b", (D,), "w"),
             ("encoder/final_ln_scale", (D,), "scale"), ("encoder/final_ln_bias", (D,), "w")]
        s += _block_specs("encoder/layers", L, D, Fi, k_bias=False)
    else:
        s, cin = [], 1
        for i, (dim, k) in enumerate(zip(ec["conv_dims"], ec["conv_kernels"])):
            s += [(f"encoder/conv_layers/{i}/w", (dim, cin, k), "w"),
                  (f"encoder/conv_layers/{i}/b", (dim,), "w"),
                  (f"encoder/conv_layers/{i}/ln_scale", (dim,), "scale"),
                  (f"encoder/conv_layers/{i}/ln_bias", (dim,), "w")]
            cin = dim
        C = ec["conv_dims"][-1]
        s += [("encoder/fp_ln_scale", (C,), "scale"), ("encoder/fp_ln_bias", (C,), "w"),
              ("encoder/fp_w", (C, D), "w"), ("encoder/fp_b", (D,), "w"),
              ("encoder/pos_conv_w", (D, D // ec["pos_conv_groups"], ec["pos_conv_kernel"]), "w"),
              ("encoder/pos_conv_b", (D,), "w"),
              ("encoder/encoder_ln_scale", (D,), "scale"), ("encoder/encoder_ln_bias", (D,), "w")]
        s += _block_specs("encoder/layers", L, D, Fi)
    E = config["projector"]["out"]
    s += [("proj_w", (D, E), "proj"), ("proj_b", (E,), "w")]
    return s


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions (length, channels)."""
    inc = math.log(10000) / (channels // 2 - 1)
    t = np.arange(length)[:, None] * np.exp(-inc * np.arange(channels // 2))[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def make_llm(config: dict, seed: int, device, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, LLM_SEED))
    std = config.get("init_std", 0.02)
    flat = _fill(llm_specs(config["llm"]), gen, dtype, device,
                 {"w": (0.0, std), "scale": (1.0, 0.02)})
    return _nest(flat)


def make_encoder(config: dict, seed: int, device, dtype):
    ec = config["encoder"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, ENCODER_SEED))
    flat = _fill(encoder_specs(config), gen, dtype, device,
                 {"w": (0.0, 0.02), "scale": (1.0, 0.02),
                  "proj": (0.0, ec["hidden_size"] ** -0.5)})
    if ec["type"] == "whisper":
        flat["encoder/pos_embed"] = torch.from_numpy(
            sinusoids(ec["max_source_positions"], ec["hidden_size"])).to(device, dtype)
    return _nest(flat)
