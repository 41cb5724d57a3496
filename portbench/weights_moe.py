"""Random weights of the DeepSeek-V3 decoder (Moonlight-16B-A3B) made on the
device from the seed, as the program's tree (``models/mla_moe.py``): the
same scheme as ``weights.py`` (each group of leaves one flat buffer filled
by a few large ``normal_`` calls on a seeded generator, the leaves views of
it): weights at N(0, ``init_std``), the router's correction bias among
them, norm scales at 1 + N(0, 0.02). The same seed gives the same tree on
the same device, so the reference makes its own copy after the program's
run. Shapes come from the HF config keys at the top level of the
configuration file."""

from __future__ import annotations

from portbench import weights


def llm_specs(c: dict):
    D, L, H = c["hidden_size"], c["num_hidden_layers"], c["num_attention_heads"]
    R, r = c["kv_lora_rank"], c["qk_rope_head_dim"]
    dn, dv = c["qk_nope_head_dim"], c["v_head_dim"]
    Ld = c["first_k_dense_replace"]
    Lm, E = L - Ld, c["n_routed_experts"]
    I, Ie = c["intermediate_size"], c["moe_intermediate_size"]
    Is = Ie * c["n_shared_experts"]
    V = c["vocab_size"]
    return [
        ("embed_tokens", (V, D), "w"), ("final_norm", (D,), "scale"), ("lm_head", (D, V), "w"),
        ("layers/input_norm", (L, D), "scale"), ("layers/post_attn_norm", (L, D), "scale"),
        ("layers/wq", (L, D, H * (dn + r)), "w"), ("layers/wkv_a", (L, D, R + r), "w"),
        ("layers/kv_norm", (L, R), "scale"), ("layers/wkv_b", (L, R, H * (dn + dv)), "w"),
        ("layers/wo", (L, H * dv, D), "w"),
        ("dense/w_gate", (Ld, D, I), "w"), ("dense/w_up", (Ld, D, I), "w"),
        ("dense/w_down", (Ld, I, D), "w"),
        ("moe/router", (Lm, E, D), "w"), ("moe/router_bias", (Lm, E), "w"),
        ("moe/w_gateup", (Lm, E, 2 * Ie, D), "w"), ("moe/w_down", (Lm, E, D, Ie), "w"),
        ("moe/shared_gate", (Lm, D, Is), "w"), ("moe/shared_up", (Lm, D, Is), "w"),
        ("moe/shared_down", (Lm, Is, D), "w"),
    ]


def make_llm(config: dict, seed: int, device, dtype):
    import torch

    gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, weights.LLM_SEED))
    std = config.get("init_std", 0.02)
    flat = weights._fill(llm_specs(config), gen, dtype, device,
                         {"w": (0.0, std), "scale": (1.0, 0.02)})
    return weights._nest(flat)
