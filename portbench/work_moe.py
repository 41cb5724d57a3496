"""The yardstick's arithmetic for the DeepSeek-V3 decoder (Moonlight-16B-A3B):
the bytes and operations of its two kernels, K1 (the routed experts) and K2
(the latent decode), from the work counters the program keeps on the card,
and the model FLOPs of an utterance. Peaks and ``bound_ms`` are
``work.py``'s."""

from __future__ import annotations

from portbench import work


def expert_work(pairs: int, sets: int, c: dict):
    """(bytes, flops) of K1's two launches over ``pairs`` token-expert rows
    and ``sets`` expert weight sets read (an expert with a row, per call):
    each set's gate, up and down rows (bf16) read once; each row's input
    read (bf16), its intermediate written and read (bf16), its output
    written (float32); 2 flops a multiply-add of the three products."""
    D, Ie = c["hidden_size"], c["moe_intermediate_size"]
    n_bytes = sets * 3 * D * Ie * 2 + pairs * (2 * D + 2 * 2 * Ie + 4 * D)
    return float(n_bytes), float(pairs * 2 * 3 * D * Ie)


def latent_work(slots: int, fresh: int, c: dict):
    """(bytes, flops) of K2 over ``slots`` attended (query token, slot)
    pairs, ``fresh`` of them the tokens' own: each cached slot's int8 c and
    k_pe with their bf16 scales read once for all heads; each fresh token's
    query (heads x (R + r), bf16), its latent (bf16), its output (heads x R,
    bf16) and its written int8 slot; 2 flops a multiply-add of q.[c|k_pe]
    and p.c for every head."""
    H, R, r = c["num_attention_heads"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    slot = R + r + 4
    n_bytes = (slots - fresh) * slot + fresh * (2 * H * (R + r) + 2 * (R + r) + 2 * H * R + slot)
    return float(n_bytes), float(2 * H * slots * (2 * R + r))


def phase_bound_ms(n_bytes: float, flops: float) -> float:
    """The bound of a phase whose calls all lie on one side of the ridge
    (a decode step's calls on the bytes side, a prefill's on the
    operations side, at the cell's sizes): the sums' max."""
    return work.bound_ms(n_bytes, flops)[0]


def active_params(c: dict) -> int:
    """Weights a token passes through: every attention block, the dense
    layers, per MoE layer the router, k experts and the shared experts, and
    the head."""
    D, L, H = c["hidden_size"], c["num_hidden_layers"], c["num_attention_heads"]
    R, r = c["kv_lora_rank"], c["qk_rope_head_dim"]
    dn, dv = c["qk_nope_head_dim"], c["v_head_dim"]
    Ld = c["first_k_dense_replace"]
    Ie, E, k = c["moe_intermediate_size"], c["n_routed_experts"], c["num_experts_per_tok"]
    attn = D * H * (dn + r) + D * (R + r) + R * H * (dn + dv) + H * dv * D
    moe = D * E + 3 * D * Ie * (k + c["n_shared_experts"])
    return L * attn + Ld * 3 * D * c["intermediate_size"] + (L - Ld) * moe + D * c["vocab_size"]


def token_flops(c: dict, context: int) -> float:
    """One token at ``context`` keys (its own included): 2 x the active
    weights, and the expanded attention, q.k (nope + rope) and p.v, per
    head and layer."""
    H, L = c["num_attention_heads"], c["num_hidden_layers"]
    width = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    return 2.0 * active_params(c) + 2.0 * context * H * width * L


def bulk_utterance_flops(config: dict, n_samples: int, generated: int) -> float:
    """Encoder and projector over the clip's valid frames, the prefill of
    its prompt (every position's blocks, the last position's head), and one
    decode step for each served token after the first. Each position's head
    is counted with its blocks; the prefill's other positions take no
    head."""
    c = config
    head = 2.0 * c["hidden_size"] * c["vocab_size"]
    n_p = work.template_tokens(config) + work.embed_count(config, n_samples)
    fl = work.encoder_flops(config, n_samples)
    fl += sum(token_flops(c, j + 1) for j in range(n_p)) - (n_p - 1) * head
    for j in range(1, generated):
        fl += token_flops(c, n_p + j)
    return fl
