"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel call could take (its roofline bound), the bytes and operations of
each attention kernel from its shapes and windows, and the model FLOPs of
the work a window completed.

``bound_ms``, ``flash_work``, ``dense_work``, ``train_attn_work`` and
``f32_work`` are copies of ``chip_smoke.py``'s ``bound_ms``,
``_flash_work``, ``_dense_work``, ``_train_attn_work`` and ``_f32_work``
(the repository's kernel table uses them), kept here so that a later change
to the program cannot move the yardstick; ``fused_decode_work`` is the
bytes and operations chip_smoke's ``phase_fused`` gives B2.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 494.7e12 / 3  # float32 work as 3xTF32 on the tensor cores


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least milliseconds the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairs(c) -> int:
    """Valid (query, key) pairs over the windows [start, end) of a call."""
    total = 0
    for s0, e0 in zip(c["starts"], c["ends"]):
        n = max(e0 - s0, 0)
        total += n * (n + 1) // 2 if c["causal"] else n * n
    return total


def flash_work(c, T, elem_bytes=2):
    """(bytes, flops) of one B1 call: q, k, v read and out written once;
    2 flops per multiply-add of q.k and p.v over the valid pairs."""
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    n_bytes = elem_bytes * B * T * Dh * (2 * Hq + 2 * Hkv)
    return float(n_bytes), float(4 * Dh * Hq * _pairs(c))


def train_attn_work(c, T, elem_bytes=2, pairs=None):
    """(bytes, flops) of B1 + LSE ("fwd_lse"), B6 dq ("dq") and B6 dk/dv
    ("dkv"): each input read once and each output written once (float32
    lse and delta), two products in the forward, three for dq, four for
    dk/dv; "bwd" the whole backward's five."""
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    if pairs is None:
        pairs = _pairs(c)
    qo = elem_bytes * B * T * Hq * Dh
    kv = elem_bytes * B * T * Hkv * Dh
    rowf = 4 * B * Hq * T
    f = 2 * Dh * Hq * pairs
    return {
        "fwd_lse": (float(2 * qo + 2 * kv + rowf), float(2 * f)),
        "dq": (float(3 * qo + 2 * kv + 2 * rowf), float(3 * f)),
        "dkv": (float(2 * qo + 4 * kv + 2 * rowf), float(4 * f)),
        "bwd": (float(3 * qo + 4 * kv + 2 * rowf), float(5 * f)),
    }


def dense_work(valid_sum, B, T, Hq, Hkv, Dh, elem_bytes, quantized, writes):
    """(bytes, flops) of one dense decode call (B3, B8): the valid slots' k
    and v (with their bf16 scales when int8), q, the fresh k/v and the
    output, plus the written fresh rows; 2 flops per multiply-add of q.k
    and p.v over the valid slots and the causal fresh block."""
    slot_bytes = 2 * (Dh * elem_bytes + (2 if quantized else 0))
    n_bytes = valid_sum * Hkv * slot_bytes + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
    if writes:
        n_bytes += B * T * Hkv * slot_bytes
    flops = 4 * Dh * Hq * T * (valid_sum + B * (T + 1) / 2)
    return float(n_bytes), float(flops)


def f32_work(valid_sum, B, T, Hq, Hkv, Dh, elem_bytes, quantized, writes, q_bytes=4):
    """(bytes, flops) of one float32-body decode call (q, fresh k/v and
    out ``q_bytes`` each)."""
    slot_bytes = 2 * (Dh * elem_bytes + (2 if quantized else 0))
    n_bytes = int(valid_sum) * Hkv * slot_bytes + q_bytes * B * T * (2 * Hq + 2 * Hkv) * Dh
    if writes:
        n_bytes += B * T * Hkv * slot_bytes
    flops = 4 * Dh * Hq * T * (int(valid_sum) + B * (T + 1) / 2)
    return float(n_bytes), float(flops)


def fused_decode_work(valid_sum, B, T, Hq, Hkv, Dh):
    """(bytes, flops) of one B2 call over the int8 cache: the valid slots'
    int8 k and v with their bf16 scales, the bf16 q, fresh k/v and output,
    and the fresh slots written with their scales."""
    n_bytes = (valid_sum * Hkv * (2 * Dh + 4) + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
               + B * T * Hkv * 2 * (Dh + 2))
    flops = 4 * Dh * Hq * T * (valid_sum + B * (T + 1) / 2)
    return float(n_bytes), float(flops)


# --------------------------------------------------------------- calls


def call_bound_ms(rec: dict) -> float:
    """The bound of one recorded kernel call (see ``hooks.py``)."""
    e = rec["entry"]
    if e == "fused_decode":
        valid = sum(max(o - p, 0) for o, p in zip(rec["offsets"], rec["starts"]))
        nb, fl = fused_decode_work(valid, rec["B"], rec["T"], rec["Hq"], rec["Hkv"], rec["Dh"])
        return bound_ms(nb, fl)[0]
    rate = F32_FLOPS_PER_S if rec["elem"] == 4 else BF16_FLOPS_PER_S
    if e.startswith("flash_attention_fwd_lse"):
        nb, fl = train_attn_work(rec, rec["T"], rec["elem"])["fwd_lse"]
    elif e.startswith("flash_attention_fwd"):
        nb, fl = flash_work(rec, rec["T"], rec["elem"])
    elif e.startswith("flash_attention_bwd_dq"):
        nb, fl = train_attn_work(rec, rec["T"], rec["elem"])["dq"]
    else:
        nb, fl = train_attn_work(rec, rec["T"], rec["elem"])["dkv"]
    return bound_ms(nb, fl, rate)[0]


def roofline_pct(calls: Sequence[dict], entries: Sequence[str]):
    """100 x Σ bound / Σ device ms over the recorded calls of ``entries``
    whose device time the trace gave; None when it gave none."""
    mine = [c for c in calls if c["entry"] in entries and c.get("device_ms")]
    dev = sum(c["device_ms"] for c in mine)
    if not mine or dev <= 0:
        return None
    return 100.0 * sum(call_bound_ms(c) for c in mine) / dev


# --------------------------------------------------------------- model FLOPs


def block_params(c: dict) -> int:
    """Weights of the decoder's blocks (each used once per token)."""
    D, I, L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    q, kv = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    return L * (D * q + 2 * D * kv + q * D + 3 * D * I)


def llm_forward_flops(c: dict, n: int, context: int = 0) -> float:
    """n tokens after ``context`` cached ones: the block products, and q.k
    and p.v over each token's causal window."""
    pairs = n * context + n * (n + 1) // 2
    return 2.0 * block_params(c) * n + 4.0 * c["head_dim"] * c["num_attention_heads"] \
        * c["num_hidden_layers"] * pairs


def head_flops(c: dict, n: int) -> float:
    return 2.0 * c["hidden_size"] * c["vocab_size"] * n


def encoder_flops(config: dict, n_samples: int) -> float:
    """The encoder and projector over one clip's valid frames."""
    ec, pj = config["encoder"], config["projector"]
    D, Fi, L = ec["hidden_size"], ec["intermediate_size"], ec["num_layers"]
    fl = 0.0
    if ec["type"] == "whisper":
        mel = n_samples // ec["hop_length"]
        T = (mel + 1) // 2
        fl += 2.0 * D * ec["num_mel_bins"] * 3 * mel + 2.0 * D * D * 3 * T
    else:
        n, cin = n_samples, 1
        for cout, k, s in zip(ec["conv_dims"], ec["conv_kernels"], ec["conv_strides"]):
            n = (n - k) // s + 1
            fl += 2.0 * cout * cin * k * n
            cin = cout
        T = n
        fl += 2.0 * cin * D * T + 2.0 * D * (D // ec["pos_conv_groups"]) * ec["pos_conv_kernel"] * T
    fl += L * (2.0 * T * (4 * D * D + 2 * D * Fi) + 4.0 * D * T * T)
    e = embed_count(config, n_samples)
    return fl + 2.0 * D * pj["out"] * e


def embed_count(config: dict, n_samples: int) -> int:
    sr = config["encoder"]["sampling_rate"]
    frames = (n_samples - sr // 100) // (sr // 50)
    return max(frames // config["projector"]["downsample_factor"] - 1, 0)


def template_tokens(config: dict) -> int:
    tpl = config["template"]
    return 1 + len(tpl["prefix"].encode()) + len(tpl["suffix"].encode())


def bulk_utterance_flops(config: dict, n_samples: int, generated: int) -> float:
    """Encoder, prefill of the prompt (the last position's logits) and one
    decode step for each served token after the first."""
    c = config["llm"]
    n_p = template_tokens(config) + embed_count(config, n_samples)
    fl = encoder_flops(config, n_samples) + llm_forward_flops(c, n_p) + head_flops(c, 1)
    for j in range(1, generated):
        fl += llm_forward_flops(c, 1, n_p + j - 1) + head_flops(c, 1)
    return fl


def train_utterance_flops(config: dict, n_samples: int, n_text: int, n_resp: int) -> float:
    """One utterance of a KD step: the encoder's forward and backward (2x
    for the weights' and the inputs' gradients), the teacher's and the
    student's forwards over their valid positions, the student's
    input-gradient backward (its products once, attention's twice), and
    the fused loss's heads over the response positions (student, teacher,
    the student's backward). Recomputation is not counted."""
    c = config["llm"]
    tpl = template_tokens(config)
    n_s = tpl + embed_count(config, n_samples) + n_resp
    n_t = tpl + n_text + n_resp
    attn_s = llm_forward_flops(c, n_s) - 2.0 * block_params(c) * n_s
    return (3.0 * encoder_flops(config, n_samples) + llm_forward_flops(c, n_t)
            + 2.0 * llm_forward_flops(c, n_s) + attn_s + 3.0 * head_flops(c, n_resp))


def mfu_pct(flops: float, window_s: float) -> float:
    return 100.0 * flops / (window_s * BF16_FLOPS_PER_S)

