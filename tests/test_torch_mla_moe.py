"""The DeepSeek-V3 decoder (``models/mla_moe.py``) and its kernels' plain
versions on the CPU at the tiny preset (1 dense and 2 MoE layers, 8 experts
top-2, 1 shared expert, latent 32, rope 16, nope and v 32, 4 heads), at
float32, against the plain reference ``portbench/reference/mla_moe.py``
(which imports nothing of the program)."""

import sys
from pathlib import Path
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from llm_speech_summarization_tpu_torch.infer.generate import greedy_generate  # noqa: E402
from llm_speech_summarization_tpu_torch.kernels.fused_decode import _quantize_kv  # noqa: E402
from llm_speech_summarization_tpu_torch.kernels.latent_decode import (  # noqa: E402
    latent_decode,
)
from llm_speech_summarization_tpu_torch.kernels.moe_experts import (  # noqa: E402
    moe_experts,
    sort_by_expert,
)
from llm_speech_summarization_tpu_torch.models import mla_moe as mm  # noqa: E402
from llm_speech_summarization_tpu_torch.models.convert import convert_mla_moe  # noqa: E402
from llm_speech_summarization_tpu_torch.ops.rope import (  # noqa: E402
    apply_rope_cached,
    rope_cos_sin,
    rope_inv_freq,
)
from portbench.reference import mla_moe as ref  # noqa: E402

CFG = mm.mla_moe_preset("tiny_mla_moe")
# float32 against float32: the two differ only in the order of their sums
# (batched products, absorbed against expanded attention); 2e-4 on logits of
# magnitude ~1 is ~50x the widest gap seen, and a routing flip or a wrong
# int8 rounding moves a logit by 1e-2 or more
TOL = 2e-4


def hf_config(cfg=CFG) -> dict:
    return {"hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "n_routed_experts": cfg.n_routed_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "n_shared_experts": cfg.n_shared_experts,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "intermediate_size": cfg.intermediate_size,
            "first_k_dense_replace": cfg.first_k_dense,
            "routed_scaling_factor": cfg.routed_scaling_factor, "norm_topk_prob": True,
            "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
            "vocab_size": cfg.vocab_size, "tie_word_embeddings": False}


def params(seed=0, std=0.1):
    """float32 weights at ``std`` (so every block has a say in the logits),
    norm scales around 1, a router bias of the weights' size."""
    g = torch.Generator().manual_seed(seed)
    flat = {}
    for path, shape in mm.param_shapes(CFG).items():
        w = torch.randn(shape, generator=g)
        flat[path] = 1 + 0.1 * w if path in mm.NORMS else std * w
    return mm.nest(flat)


def prompt_batch(seed=1, lens=(11, 7), T=12):
    g = torch.Generator().manual_seed(seed)
    B = len(lens)
    emb = torch.randn((B, T, CFG.hidden_size), generator=g)
    mask = torch.zeros((B, T), dtype=torch.bool)
    for b, n in enumerate(lens):
        mask[b, T - n:] = True
    return emb * mask[..., None], mask


def test_prefill_logits_match_the_reference():
    p = params()
    emb, mask = prompt_batch()
    out = mm.mla_moe_forward(p, CFG, inputs_embeds=emb, attn_mask=mask)
    for b in range(emb.shape[0]):
        real = emb[b][mask[b]]
        want, info = ref.mla_moe(p, hf_config(), real)
        got = out.logits[b][mask[b]]
        assert (got - want).abs().max() < TOL
        assert info["min_margin"] > 1e-3  # no near-tie hides a routing flip here


def test_every_decode_step_through_the_int8_latent_cache_matches_the_reference():
    p = params()
    emb, mask = prompt_batch()
    B, T = mask.shape
    steps = 5
    ids = torch.randint(0, CFG.vocab_size, (B, steps), generator=torch.Generator().manual_seed(3))
    cache = mm.init_latent_cache(CFG, B, T + steps)
    lens = mask.sum(1).to(torch.int32)
    pads = (T - lens).to(torch.int32)
    prefill = mm.mla_moe_forward(p, CFG, inputs_embeds=emb, attn_mask=mask, kv_cache=cache,
                                 cache_offset=0)
    got = [prefill.logits[:, -1]]
    for j in range(steps):
        out = mm.mla_moe_forward(p, CFG, input_ids=ids[:, j:j + 1], positions=(lens + j)[:, None],
                                 kv_cache=cache, cache_offset=T + j, kv_pad_lens=pads)
        got.append(out.logits[:, 0])
    for b in range(B):
        n = int(lens[b])
        seq = torch.cat([emb[b][mask[b]], p["embed_tokens"][ids[b]]])
        want, _ = ref.mla_moe(p, hf_config(), seq, n_prompt=n, logits_from=n - 1)
        for j in range(steps + 1):
            assert (got[j][b] - want[j]).abs().max() < TOL, (b, j)


def test_the_int8_cache_is_what_the_reference_reads():
    # the same check with the cache left exact in the reference fails: the
    # tolerance sees the int8 rounding
    p = params()
    emb, mask = prompt_batch(lens=(12,))
    T, steps = 12, 3
    ids = torch.randint(0, CFG.vocab_size, (1, steps), generator=torch.Generator().manual_seed(4))
    cache = mm.init_latent_cache(CFG, 1, T + steps)
    mm.mla_moe_forward(p, CFG, inputs_embeds=emb, attn_mask=mask, kv_cache=cache, cache_offset=0)
    for j in range(steps):
        out = mm.mla_moe_forward(p, CFG, input_ids=ids[:, j:j + 1],
                                 positions=torch.tensor([[T + j]]), kv_cache=cache,
                                 cache_offset=T + j, kv_pad_lens=torch.zeros(1, dtype=torch.int32))
    seq = torch.cat([emb[0], p["embed_tokens"][ids[0]]])
    exact, _ = ref.mla_moe(p, hf_config(), seq, logits_from=T + steps - 1)
    cached, _ = ref.mla_moe(p, hf_config(), seq, n_prompt=T, logits_from=T + steps - 1)
    assert (out.logits[0, 0] - cached[0]).abs().max() < TOL
    assert (out.logits[0, 0] - exact[0]).abs().max() > 10 * TOL


def test_greedy_generate_runs_the_decoder_through_its_cache():
    p = params()
    emb, mask = prompt_batch()
    tokens, lens = greedy_generate(p, CFG, emb, mask, max_new_tokens=4, eos_id=-1,
                                   cache_dtype=torch.int8)
    # greedy: each token is the argmax of the reference's logits given the previous ones
    for b in range(emb.shape[0]):
        n = int(mask[b].sum())
        seq = torch.cat([emb[b][mask[b]], p["embed_tokens"][tokens[b, :-1].long()]])
        want, _ = ref.mla_moe(p, hf_config(), seq, n_prompt=n, logits_from=n - 1)
        assert torch.equal(want.argmax(-1).to(torch.int32), tokens[b])
    assert lens.tolist() == [4, 4]


def _router(seed=5):
    g = torch.Generator().manual_seed(seed)
    E, D = CFG.n_routed_experts, CFG.hidden_size
    mp = {"router": torch.randn((E, D), generator=g),
          "router_bias": 0.01 * torch.randn(E, generator=g)}
    return mp, torch.randn((6, D), generator=g)


def test_routing_selects_on_score_plus_bias_and_weighs_by_score():
    mp, h = _router()
    sel, w = mm.route(CFG, mp, h)
    s = torch.sigmoid(h @ mp["router"].t())
    want = torch.topk(s + mp["router_bias"], CFG.num_experts_per_tok).indices
    assert torch.equal(sel, want)
    chosen = s.gather(1, sel)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * CFG.routed_scaling_factor)
    # a large bias on one expert puts it in every token's choice, and its
    # weight still comes from its score, not from score + bias
    mp["router_bias"][3] = 10.0
    sel2, w2 = mm.route(CFG, mp, h)
    assert (sel2 == 3).any(-1).all()
    assert not torch.equal(sel2, sel)
    chosen2 = s.gather(1, sel2)
    assert torch.allclose(w2, chosen2 / chosen2.sum(-1, keepdim=True) * CFG.routed_scaling_factor)


def test_the_shared_expert_and_the_dense_first_layer():
    p = params()
    x = torch.randn((2, 5, CFG.hidden_size), generator=torch.Generator().manual_seed(6))
    h = mm.rms_norm(x, p["layers"]["post_attn_norm"][0], CFG.rms_eps)
    d = {k: w[0] for k, w in p["dense"].items()}
    want = x + (F.silu(h @ d["w_gate"]) * (h @ d["w_up"])) @ d["w_down"]
    assert torch.allclose(mm._ffn(CFG, p, 0, x, None, 0), want, atol=1e-6)
    # with the routed experts silenced, an MoE layer adds the shared expert alone
    p["moe"]["w_down"] = torch.zeros_like(p["moe"]["w_down"])
    h = mm.rms_norm(x, p["layers"]["post_attn_norm"][1], CFG.rms_eps)
    m = {k: w[0] for k, w in p["moe"].items()}
    shared = (F.silu(h @ m["shared_gate"]) * (h @ m["shared_up"])) @ m["shared_down"]
    assert torch.allclose(mm._ffn(CFG, p, 1, x, None, 0), x + shared, atol=1e-6)


def test_the_routed_experts_plain_version_against_a_token_loop():
    g = torch.Generator().manual_seed(7)
    N, D, E, I, k = 9, 32, 5, 64, 2
    x = torch.randn((N, D), generator=g)
    wgu, wd = torch.randn((E, 2 * I, D), generator=g), torch.randn((E, D, I), generator=g)
    sel = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(N)])
    w = torch.rand((N, k), generator=g)
    valid = torch.ones(N, dtype=torch.bool)
    valid[2] = False
    routing = sort_by_expert(sel, E, valid)
    assert routing.offsets.tolist()[-1] == k * (N - 1)
    got = moe_experts(x, routing, w, wgu, wd)
    for t in range(N):
        want = torch.zeros(D)
        if valid[t]:
            for j in range(k):
                e = int(sel[t, j])
                want = want + w[t, j] * ((F.silu(x[t] @ wgu[e, :I].t()) * (x[t] @ wgu[e, I:].t()))
                                         @ wd[e].t())
        assert torch.allclose(got[t], want, rtol=1e-5, atol=1e-4), t


def test_absorbed_decode_attention_equals_the_expanded_heads():
    # one layer, B = 2 rows with their own pads, T = 2 fresh tokens: the
    # absorbed query through K2's plain version and W_uv against the
    # expanded heads over the dequantized cache plus the exact fresh latents
    p = params()
    lp = mm._layer(p, 0)
    g = torch.Generator().manual_seed(8)
    B, S, T, off = 2, 10, 2, 6
    H, R, r = CFG.num_heads, CFG.kv_lora_rank, CFG.qk_rope_head_dim
    cache = mm.init_latent_cache(CFG, B, S)
    c_old, pe_old = torch.randn((B, off, R), generator=g), torch.randn((B, off, r), generator=g)
    mm._write_latents(cache, 0, 0, c_old, pe_old)
    q = torch.randn((B, T, H, CFG.q_head_dim), generator=g)
    c_new, pe_new = torch.randn((B, T, R), generator=g), torch.randn((B, T, r), generator=g)
    pads = torch.tensor([0, 3], dtype=torch.int32)
    offsets = torch.full((B,), off, dtype=torch.int32)
    o_lat = latent_decode(mm._absorb(CFG, lp, q), *cache, c_new, pe_new, pads, offsets, 0,
                          max_offset=off, scale=CFG.softmax_scale)
    got = mm._latent_out(CFG, lp, o_lat)
    deq = lambda v, s: v.float() * s.float()[..., None]  # noqa: E731
    c_all = torch.cat([deq(cache.c[0, :, 0, :off], cache.c_scale[0, :, 0, :off]), c_new], 1)
    pe_all = torch.cat([deq(cache.pe[0, :, 0, :off], cache.pe_scale[0, :, 0, :off]), pe_new], 1)
    w_uk, w_uv = mm._wkv_b(CFG, lp)
    k = torch.cat([torch.einsum("bsr,rhd->bshd", c_all, w_uk),
                   pe_all[:, :, None].expand(B, off + T, H, r)], -1)
    v = torch.einsum("bsr,rhd->bshd", c_all, w_uv)
    s = torch.einsum("bthd,bshd->bhts", q, k) * CFG.softmax_scale
    slot = torch.arange(off + T)
    last = off + torch.arange(T)[None, :, None]  # each fresh token's own slot
    keep = (slot[None, None, :] >= pads[:, None, None]) & (slot[None, None, :] <= last)
    s = s.masked_fill(~keep[:, None], float("-inf"))
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v).reshape(B, T, -1)
    assert (got - want).abs().max() < 1e-4
    # the fresh latents went into the cache as _quantize_kv writes them
    for new, vals, sc in ((c_new, cache.c, cache.c_scale), (pe_new, cache.pe, cache.pe_scale)):
        qv, qs = _quantize_kv(new)
        assert torch.equal(vals[0, :, 0, off:off + T], qv)
        assert torch.equal(sc[0, :, 0, off:off + T], qs)


def test_the_stored_rope_order_is_the_published_interleaving():
    g = torch.Generator().manual_seed(9)
    n, H, r = 7, 3, CFG.qk_rope_head_dim
    q, k = torch.randn((n, H, r), generator=g), torch.randn((n, 1, r), generator=g)
    perm = mm.rope_permutation(r)
    cos, sin = rope_cos_sin(torch.arange(n)[None], rope_inv_freq(r, CFG.rope_theta))
    q_port = apply_rope_cached(q[..., perm][None], cos, sin)[0]
    k_port = apply_rope_cached(k[..., perm][None], cos, sin)[0]
    q_pub, k_pub = ref.rope_interleaved(q, CFG.rope_theta), ref.rope_interleaved(k, CFG.rope_theta)
    assert torch.allclose(q_port, q_pub, atol=1e-5) and torch.allclose(k_port, k_pub, atol=1e-5)
    assert torch.allclose(torch.einsum("nhd,mhd->hnm", q_port, k_port),
                          torch.einsum("nhd,mhd->hnm", q_pub, k_pub), atol=1e-4)


def test_a_decode_step_reads_no_device_value_on_the_host():
    p = params()
    emb, mask = prompt_batch()
    B, T = mask.shape
    cache = mm.init_latent_cache(CFG, B, T + 1)
    lens = mask.sum(1).to(torch.int32)
    mm.mla_moe_forward(p, CFG, inputs_embeds=emb, attn_mask=mask, kv_cache=cache, cache_offset=0)
    ids = torch.tensor([[5], [9]])

    def fail(*a, **kw):
        raise AssertionError("a device value was read on the host")

    with mock.patch.multiple(torch.Tensor, item=fail, tolist=fail, cpu=fail, numpy=fail,
                             __bool__=fail, __int__=fail, __float__=fail):
        out = mm.mla_moe_forward(p, CFG, input_ids=ids, positions=lens[:, None], kv_cache=cache,
                                 cache_offset=T, kv_pad_lens=(T - lens).to(torch.int32))
    assert out.logits.shape == (B, 1, CFG.vocab_size)


def _hf_state_dict(p):
    """A DeepseekV3ForCausalLM state dict whose weights give ``p`` after
    conversion, its rope columns in the published (interleaved) order."""
    H, r = CFG.num_heads, CFG.qk_rope_head_dim
    inverse = torch.argsort(mm.rope_permutation(r))

    def published(w, heads):  # (D, heads * cols) stored → published
        D, cols = w.shape
        v = w.reshape(D, heads, cols // heads).clone()
        v[..., -r:] = v[..., -r:][..., inverse]
        return v.reshape(D, cols)

    sd = {"model.embed_tokens.weight": p["embed_tokens"], "model.norm.weight": p["final_norm"],
          "lm_head.weight": p["lm_head"].t()}
    L, Ld, Ie = CFG.num_layers, CFG.first_k_dense, CFG.moe_intermediate_size
    for i in range(L):
        a = f"model.layers.{i}."
        lp = mm._layer(p, i)
        sd[a + "input_layernorm.weight"] = lp["input_norm"]
        sd[a + "post_attention_layernorm.weight"] = lp["post_attn_norm"]
        sd[a + "self_attn.q_proj.weight"] = published(lp["wq"], H).t()
        sd[a + "self_attn.kv_a_proj_with_mqa.weight"] = published(lp["wkv_a"], 1).t()
        sd[a + "self_attn.kv_a_layernorm.weight"] = lp["kv_norm"]
        sd[a + "self_attn.kv_b_proj.weight"] = lp["wkv_b"].t()
        sd[a + "self_attn.o_proj.weight"] = lp["wo"].t()
        if i < Ld:
            for name in ("gate", "up", "down"):
                sd[a + f"mlp.{name}_proj.weight"] = p["dense"][f"w_{name}"][i].t()
            continue
        m = {k: w[i - Ld] for k, w in p["moe"].items()}
        sd[a + "mlp.gate.weight"] = m["router"]
        sd[a + "mlp.gate.e_score_correction_bias"] = m["router_bias"]
        for j in range(CFG.n_routed_experts):
            sd[a + f"mlp.experts.{j}.gate_proj.weight"] = m["w_gateup"][j, :Ie]
            sd[a + f"mlp.experts.{j}.up_proj.weight"] = m["w_gateup"][j, Ie:]
            sd[a + f"mlp.experts.{j}.down_proj.weight"] = m["w_down"][j]
        for name in ("gate", "up", "down"):
            sd[a + f"mlp.shared_experts.{name}_proj.weight"] = m[f"shared_{name}"].t()
    return sd


def _published_tree(sd):
    """The reference's tree read straight off the HF keys (no regrouping)."""
    L, Ld = CFG.num_layers, CFG.first_k_dense
    a = "model.layers.{}."
    stack = lambda key, idx, t=False: torch.stack(  # noqa: E731
        [sd[a.format(i) + key].t() if t else sd[a.format(i) + key] for i in idx])
    everything, moe = range(L), range(Ld, L)
    return {
        "embed_tokens": sd["model.embed_tokens.weight"], "final_norm": sd["model.norm.weight"],
        "lm_head": sd["lm_head.weight"].t(),
        "layers": {"input_norm": stack("input_layernorm.weight", everything),
                   "post_attn_norm": stack("post_attention_layernorm.weight", everything),
                   "wq": stack("self_attn.q_proj.weight", everything, True),
                   "wkv_a": stack("self_attn.kv_a_proj_with_mqa.weight", everything, True),
                   "kv_norm": stack("self_attn.kv_a_layernorm.weight", everything),
                   "wkv_b": stack("self_attn.kv_b_proj.weight", everything, True),
                   "wo": stack("self_attn.o_proj.weight", everything, True)},
        "dense": {f"w_{n}": stack(f"mlp.{n}_proj.weight", range(Ld), True)
                  for n in ("gate", "up", "down")},
        "moe": {"router": stack("mlp.gate.weight", moe),
                "router_bias": stack("mlp.gate.e_score_correction_bias", moe),
                "w_gateup": torch.stack([torch.stack([torch.cat(
                    [sd[a.format(i) + f"mlp.experts.{j}.gate_proj.weight"],
                     sd[a.format(i) + f"mlp.experts.{j}.up_proj.weight"]])
                    for j in range(CFG.n_routed_experts)]) for i in moe]),
                "w_down": torch.stack([torch.stack(
                    [sd[a.format(i) + f"mlp.experts.{j}.down_proj.weight"]
                     for j in range(CFG.n_routed_experts)]) for i in moe]),
                **{f"shared_{n}": stack(f"mlp.shared_experts.{n}_proj.weight", moe, True)
                   for n in ("gate", "up", "down")}},
    }


def test_conversion_of_the_hf_layout_against_the_reference_on_it():
    p = params(seed=11)
    sd = _hf_state_dict(p)
    converted = convert_mla_moe(sd, CFG, torch.float32)
    for path in mm.param_shapes(CFG):
        group, _, leaf = path.rpartition("/")
        got = converted[group][leaf] if group else converted[leaf]
        want = p[group][leaf] if group else p[leaf]
        assert torch.equal(got, want), path
    emb, mask = prompt_batch(lens=(9,), T=9)
    out = mm.mla_moe_forward(converted, CFG, inputs_embeds=emb, attn_mask=mask)
    want, _ = ref.mla_moe(_published_tree(sd), hf_config(), emb[0], rope_stored=False)
    assert (out.logits[0] - want).abs().max() < TOL


def _moonlight_config(tmp_path):
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    cfg.model.llm_type = "moonshotai/Moonlight-16B-A3B"
    cfg.model.llm_preset = "tiny_mla_moe"
    cfg.model.kv_cache_dtype = "int8"
    cfg.log.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.log.log_dir = str(tmp_path / "logs")
    return cfg


@pytest.mark.parametrize("what", ["training", "speculative", "tensor parallel", "engine spec"])
def test_paths_not_ported_raise_naming_the_decoder(what, tmp_path):
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.infer.generate import speculative_generate
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    p = params()
    emb, mask = prompt_batch()
    with pytest.raises(NotImplementedError, match="DeepSeek-V3"):
        if what == "training":
            Trainer(_moonlight_config(tmp_path), device="cpu")
        elif what == "speculative":
            speculative_generate(p, CFG, emb, mask, max_new_tokens=2, eos_id=-1)
        elif what == "engine spec":
            LLMSpeechTextInference(_moonlight_config(tmp_path), device="cpu", speculative_k=2)
        else:
            mm.init_latent_cache(CFG, 2, 8, tp=2)


def test_the_engine_answers_audio_through_the_decoder(tmp_path):
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference

    from collections import Counter

    from llm_speech_summarization_tpu_torch.cli.infer import pipeline_report

    eng = LLMSpeechTextInference(_moonlight_config(tmp_path), device="cpu")
    assert isinstance(eng.llm_cfg, mm.MlaMoeConfig)
    before = mm.read_moe_counters("cpu", CFG.n_routed_experts)
    assert eng.template.prefix.endswith("<|im_user|>user<|im_middle|>")
    g = torch.Generator().manual_seed(12)
    clips = [0.1 * torch.randn(n, generator=g).numpy() for n in (8000, 12000, 16000)]
    outs = list(eng.iter_audio_response_batches([clips[:2], clips[2:]], max_new_tokens=3))
    assert [len(o) for o in outs] == [2, 1]
    assert eng.counts["decode_steps"] > 0
    after = mm.read_moe_counters("cpu", CFG.n_routed_experts)
    work = {ph: {k: v - before[ph][k] for k, v in after[ph].items()} for ph in after}
    # a decode step routes every row of its batch at every MoE layer
    moe_layers = CFG.num_layers - CFG.first_k_dense
    assert work["decode"]["pairs"] % (CFG.num_experts_per_tok * moe_layers) == 0
    assert work["prefill"]["pairs"] > 0 and work["decode"]["latent_slots"] > 0
    report = pipeline_report(eng.counts, Counter(), work)
    assert f"decode: {work['decode']['pairs']} token-expert pairs" in report


def test_the_shipped_config_names_the_published_decoder():
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

    cfg = load_config(str(YAML_DIR / "moonlight_whisper.yaml"))
    preset = mm.mla_moe_preset(cfg.model.llm_type)
    assert mm.is_mla_moe(cfg.model.llm_type) and preset == mm.mla_moe_preset("moonlight_16b_a3b")
    assert cfg.model.llm_embedding_channels == preset.hidden_size == 2048
    assert cfg.model.kv_cache_dtype == "int8" and cfg.model.compute_dtype == "bfloat16"
    total = sum(torch.Size(s).numel() for s in mm.param_shapes(preset).values())
    assert 15.9e9 < total < 16.0e9  # 15.96 B parameters, 31.9 GB in bf16
