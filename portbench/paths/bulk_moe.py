"""Runner of the ``bulk_moe`` kind: the ``bulk`` kind's closed-loop corpus
summarisation through ``iter_audio_response_batches`` and
``greedy_generate``, for a configuration whose decoder is DeepSeek-V3's
latent attention and sparse experts (``models/mla_moe.py``), with its own
program check, weights and reference.

As in ``bulk.py``: set-up (weights from the seed, the engine,
``warmup_batches`` batches: kernel builds, the graphs' one capture), then
the window; ``utt_per_s`` the utterances of the batches completed in it
over the time to the last completion; ``--trace 1`` a first untraced
phase for the host clocks, then a phase under the profiler, with the same
``pb.prompt_build``, ``pb.prefill`` and ``pb.decode_step`` ranges; the
faults ("token", "half") and the control as ``bulk.py`` plants them.

What this kind adds to the run record: the program's work counters (token-
expert pairs, expert weight sets, largest loads, latent slots; per phase)
over the traced phase, read on either side of it, and the device ms of
each kernel name inside the window (graph replays make no per-call range).
Its readings add the share of the window's decode steps replayed as
graphs, and the reference's smallest selection margin and near-ties.

``correct``: every utterance answered, and for the seeded sample the
reference (``reference/mla_moe.py``, float32, over the prompt and the
served tokens through the int8 latent cache) puts each served token's
logit within ``served_logit_gap`` of its best, and the median of those
gaps within ``served_gap_median``. Two numbers, since with random weights
the top-6 choice is near a tie at many (token, layer) pairs: rounding the
program's bf16 activations flips some, and the widest gap of a sound run
reaches values a lower precision also reads, while the typical gap stays
apart (the limits file's readings).
"""

from __future__ import annotations

import gc
import time
from collections import defaultdict
from types import SimpleNamespace

import torch

from portbench import gen, trace, weights, weights_moe
from portbench.core import Outcome, port_config, sync
from portbench.hooks import Hooks
from portbench.paths.bulk import PAD_SAMPLES, _drive, _plant
from portbench.reference import mla_moe as ref_moe
from portbench.reference import model as ref
from portbench.trace import Tracer

# the configuration's llm keys and the program's fields they set
LLM_FIELDS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
              "intermediate_size": "intermediate_size",
              "moe_intermediate_size": "moe_intermediate_size",
              "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
              "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
              "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
              "n_routed_experts": "n_routed_experts", "n_shared_experts": "n_shared_experts",
              "num_experts_per_tok": "num_experts_per_tok",
              "first_k_dense_replace": "first_k_dense",
              "routed_scaling_factor": "routed_scaling_factor", "rms_norm_eps": "rms_eps",
              "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
              "max_position_embeddings": "max_position_embeddings"}
# what the program implements of the rest: these must read as published
FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
         "norm_topk_prob": True, "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
         "hidden_act": "silu", "attention_bias": False, "num_nextn_predict_layers": 0,
         "ep_size": 1}


def check_program(config: dict, llm_cfg, enc_cfg, prefix_ids, suffix_ids, cfg) -> None:
    """Raise where the program would run another model than the
    configuration file states (decoder, encoder, template ids, dtypes)."""
    c, ec, tpl = config, config["encoder"], config["template"]
    checks = {
        "decoder": ({k: getattr(llm_cfg, f, None) for k, f in LLM_FIELDS.items()},
                    {k: c[k] for k in LLM_FIELDS}),
        "published settings": (FIXED, {k: c[k] for k in FIXED}),
        "encoder": ({"hidden_size": getattr(enc_cfg, "hidden_size",
                                            getattr(enc_cfg, "d_model", None)),
                     "num_layers": enc_cfg.num_layers, "num_heads": enc_cfg.num_heads},
                    {"hidden_size": ec["hidden_size"], "num_layers": ec["num_layers"],
                     "num_heads": ec["num_heads"]}),
        "template ids": ({"prefix": [int(i) for i in prefix_ids],
                          "suffix": [int(i) for i in suffix_ids]},
                         {"prefix": [tpl["bos_id"]] + list(tpl["prefix"].encode()),
                          "suffix": list(tpl["suffix"].encode())}),
        "dtypes": ({"cache": cfg.model.kv_cache_dtype, "param": cfg.model.param_dtype,
                    "compute": cfg.model.compute_dtype},
                   {"cache": config["dtypes"]["kv_cache"], "param": config["dtypes"]["param"],
                    "compute": config["dtypes"]["compute"]}),
    }
    for what, (g, w) in checks.items():
        if g != w:
            diff = {k: (g.get(k), w.get(k)) for k in set(g) | set(w) if g.get(k) != w.get(k)}
            raise RuntimeError(f"the program's {what} differs from {config['name']}.json: "
                               f"{diff} (program, file)")


def kernel_ms(events) -> dict:
    """Device ms of each operation name inside ``pb.window``."""
    windows = [e for e in events if e.device == "cpu" and e.name == trace.WINDOW]
    out = defaultdict(float)
    if not windows:
        return out
    ws, we = min(w.start for w in windows), max(w.end for w in windows)
    for e in events:
        if e.device == "device":
            s, en = max(e.start, ws), min(e.end, we)
            if en > s:
                out[e.name] += (en - s) / 1e6
    return dict(out)


def _install(hooks: Hooks, eng, eng_mod, gen_mod, dev, rec):
    """``bulk.py``'s ranges and host clocks around the prompt build, the
    prefill and each decode step of this decoder's forward; the kernels'
    device ms by name from the trace's events."""
    tracer = hooks.tracer
    state = {"prefill_end": None}

    def main_stream_done():
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return time.perf_counter()

    def build(orig):
        def wrapped(*a, **kw):
            with tracer.range("pb.prompt_build"):
                return orig(*a, **kw)
        return wrapped

    def forward(orig):
        def wrapped(*a, **kw):
            if kw.get("inputs_embeds") is None:
                with tracer.range("pb.decode_step"):
                    return orig(*a, **kw)
            with tracer.range("pb.prefill"):
                out = orig(*a, **kw)
            if rec.clocking:
                state["prefill_end"] = main_stream_done()
            return out
        return wrapped

    def generate(orig):
        def wrapped(*a, **kw):
            steps = eng.counts["decode_steps"]
            out = orig(*a, **kw)
            if rec.clocking and state["prefill_end"] is not None:
                rec.decode_wall_s += main_stream_done() - state["prefill_end"]
                rec.decode_steps += eng.counts["decode_steps"] - steps
            state["prefill_end"] = None
            return out
        return wrapped

    def summarize(orig):
        def wrapped(events, *a, **kw):
            rec.kernel_ms = kernel_ms(events)
            return orig(events, *a, **kw)
        return wrapped

    hooks.wrap(eng, "build_audio_prompt_batch", build)
    hooks.wrap(gen_mod, "mla_moe_forward", forward)
    hooks.wrap(eng_mod, "greedy_generate", generate)
    hooks.wrap(trace, "summarize", summarize)


def _delta(after: dict, before: dict) -> dict:
    return {ph: {k: after[ph][k] - before[ph][k] for k in after[ph] if k != "max_load"}
            | {"max_load": after[ph]["max_load"]} for ph in after}


def run(ctx) -> Outcome:
    from llm_speech_summarization_tpu_torch.infer import engine as eng_mod
    from llm_speech_summarization_tpu_torch.infer import generate as gen_mod
    from llm_speech_summarization_tpu_torch.models import mla_moe

    dev, cfg_file, tr = ctx.device, ctx.config, ctx.traffic
    phases = {"start": time.perf_counter() - ctx.t_start}
    cfg = port_config(ctx.root, cfg_file, ctx.workdir)
    dtype = weights.DTYPES[cfg_file["dtypes"]["param"]]
    llm = weights_moe.make_llm(cfg_file, ctx.seed, dev, dtype)
    enc = weights.make_encoder(cfg_file, ctx.seed, dev, dtype)
    sync(dev)
    phases["weights"] = time.perf_counter() - ctx.t_start
    eng = eng_mod.LLMSpeechTextInference(cfg, audio_encoder_params=enc, llm_params=llm,
                                         device=dev)
    phases["engine"] = time.perf_counter() - ctx.t_start
    check_program(cfg_file, eng.llm_cfg, eng.encoder_setup.encoder_cfg, eng.prefix_ids.tolist(),
                  eng.suffix_ids.tolist(), cfg)
    sr, vocab = cfg_file["encoder"]["sampling_rate"], cfg_file["vocab_size"]
    E = cfg_file["n_routed_experts"]
    B, new_tokens = tr["batch"], tr["new_tokens"]

    tracer = Tracer(ctx.trace)
    hooks = Hooks(tracer)
    served = []
    decode = eng.tokenizer.decode

    def record(ids, skip_special_tokens=True):
        served.append([int(i) for i in ids])
        return decode(ids, skip_special_tokens)

    eng.tokenizer.decode = record
    rec = SimpleNamespace(kind="bulk_moe", config=cfg_file, traffic=tr, decode_wall_s=0.0,
                          decode_steps=0, summary=None, calls=[], utterances=[], window_s=0.0,
                          clocking=False, moe_work=None, kernel_ms={})
    _plant(hooks, ctx.faults, eng, gen_mod, vocab)
    if ctx.trace:
        hooks.install_kernels()
        _install(hooks, eng, eng_mod, gen_mod, dev, rec)

    stream = gen.Stream(tr, ctx.seed, sr, vocab)
    batches = []

    def source():
        j = 0
        while True:
            clips = stream.clips(j)
            batches.append(clips)
            yield clips
            j += 1

    it = eng.iter_audio_response_batches(source(), max_new_tokens=new_tokens)
    for i in range(tr["warmup_batches"]):
        next(it)
        phases[f"batch{i + 1}"] = time.perf_counter() - ctx.t_start
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    done = []
    counts0 = dict(eng.counts)
    rec.clocking = ctx.trace
    t0 = _drive(it, tr["trace_seconds"] if ctx.trace else ctx.seconds, done)
    rec.clocking = False
    rec.window_s, n_clock = done[-1][0] - t0, len(done)
    steps = eng.counts["decode_steps"] - counts0.get("decode_steps", 0)
    graphed = eng.counts["decode_graph_steps"] - counts0.get("decode_graph_steps", 0)
    captures = eng.counts["decode_graph_captures"] - counts0.get("decode_graph_captures", 0)
    before = mla_moe.read_moe_counters(dev, E)  # outside the traced phase: it reads the card
    hooks.on = ctx.trace
    with tracer.session(dev.type == "cuda"):
        if ctx.trace:
            with tracer.range("pb.window"):
                _drive(it, tr["trace_seconds"], done)
        it.close()
    hooks.on = False
    sync(dev)
    if ctx.trace:
        rec.moe_work = _delta(mla_moe.read_moe_counters(dev, E), before)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answered = sum(n for _, n in done[:n_clock])
    warm = tr["warmup_batches"]
    attempted = B * len(done)
    failed = attempted - sum(n for _, n in done)
    rec.peak_bytes = peak
    rec.summary = tracer.summary
    rec.calls = hooks.resolve(tracer.summary.range_ms if tracer.summary else {})
    hooks.remove()
    first = warm * B
    rows = [(j, r) for j in range(warm, warm + len(done)) for r in range(B)]
    window_served = served[first:first + len(rows)]
    rec.utterances = [(len(batches[j][r]), len(ids)) for (j, r), ids
                      in zip(rows[:n_clock * B], window_served)]
    failed += len(rows) - len(window_served)

    pick = gen.rng(ctx.seed, 9)
    longest = max(range(len(window_served)), key=lambda i: len(batches[rows[i][0]][rows[i][1]]))
    others = [i for i in pick.permutation(len(window_served)) if i != longest]
    sample = [longest] + [int(i) for i in others[: tr["check_rows"] - 1]]
    checked = [(batches[rows[i][0]][rows[i][1]].copy(), window_served[i]) for i in sample]
    batch_samples = -(-int(stream.samples.max()) // PAD_SAMPLES) * PAD_SAMPLES

    del eng, llm, enc, it, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = reference_gaps(ctx, checked, batch_samples, new_tokens,
                              control="control" in ctx.faults)
    readings["setup_phases_s"] = phases
    readings["batch_s"] = [b - a for a, b in zip([t0] + [t for t, _ in done], [t for t, _ in done])]
    readings["reference_s"] = time.perf_counter() - t_ref
    readings["trace_s"] = tracer.seconds
    readings["decode_graph_share"] = 100.0 * graphed / steps if steps else None
    readings["decode_graph_captures_in_window"] = captures
    readings["moe_work"] = rec.moe_work
    readings["kernel_ms_top"] = sorted(rec.kernel_ms.items(), key=lambda kv: -kv[1])[:30]
    checks = [(name, readings[name], ctx.limits[name]["limit"])
              for name in ("served_logit_gap", "served_gap_median")]
    return Outcome(e2e={"utt_per_s": answered / rec.window_s, "setup_s": setup_s}, checks=checks,
                   attempted=attempted, failed=failed, memory_peak_bytes=peak, run=rec,
                   readings=readings)


@torch.no_grad()
def reference_gaps(ctx, checked, batch_samples: int, new_tokens: int, control: bool) -> dict:
    """``bulk.reference_gaps`` with this decoder's reference: the widest and
    the median gap between the reference's best logit and the served
    token's (with ``control``, the float8 reference's first choice in its
    place), and the reference's smallest selection margin and count of
    near-ties over the checked sequences."""
    dev, cfg = ctx.device, ctx.config
    ref.exact_float32()
    dtype = weights.DTYPES[cfg["dtypes"]["param"]]
    llm = weights_moe.make_llm(cfg, ctx.seed, dev, dtype)
    enc = weights.make_encoder(cfg, ctx.seed, dev, dtype)
    eos = cfg["template"]["eos_id"]
    widest, fp8_widest, tokens = 0.0, 0.0, 0
    margin, ties = float("inf"), 0
    gaps, first_gaps = [], []
    for wav, ids in checked:
        if not ids or len(ids) > new_tokens or (len(ids) < new_tokens and ids[-1] != eos):
            return {"served_logit_gap": float("inf"), "served_gap_median": float("inf"),
                    "served_tokens": tokens}
        wav_t = torch.from_numpy(wav).to(dev)
        x = ref.prompt(llm, cfg, ref.audio_embeds(enc, cfg, wav_t, batch_samples))
        n_p = x.shape[0]
        seq = torch.cat([x, ref.token_embeds(llm, ids[:-1])]) if len(ids) > 1 else x
        logits, info = ref_moe.mla_moe(llm, cfg, seq, n_prompt=n_p, logits_from=n_p - 1)
        margin, ties = min(margin, info["min_margin"]), ties + info["near_ties"]
        tok = torch.as_tensor(ids, device=dev)
        at = torch.arange(len(ids), device=dev)
        best = logits.max(-1).values
        gap = best - logits[at, tok]
        gaps.append(gap)
        first_gaps.append(float(gap[0]))
        widest = max(widest, float(gap.max()))
        tokens += len(ids)
        if control:
            lo = ref.Precision("float8")
            xc = ref.prompt(llm, cfg, ref.audio_embeds(enc, cfg, wav_t, batch_samples, lo))
            seqc = torch.cat([xc, ref.token_embeds(llm, ids[:-1])]) if len(ids) > 1 else xc
            lc, _ = ref_moe.mla_moe(llm, cfg, seqc, lo, n_prompt=n_p, logits_from=n_p - 1)
            first = lc.argmax(-1)
            gaps[-1] = best - logits[at, first]
            fp8_widest = max(fp8_widest, float(gaps[-1].max()))
    every = torch.cat(gaps).float()
    quantiles = torch.quantile(every, torch.tensor([0.5, 0.9, 0.99], device=every.device))
    return {"served_logit_gap": fp8_widest if control else widest,
            "served_gap_median": float(quantiles[0]), "served_tokens": tokens,
            "control": control, "min_selection_margin": margin, "near_ties": ties,
            "gap_p90_p99": [float(q) for q in quantiles[1:]], "first_token_gap": max(first_gaps)}
