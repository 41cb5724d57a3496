"""Runner of the ``bulk`` kind: summarizing a corpus of clips in batches
through the engine's pipelined batch path, ``generate_audio_response_
batches`` (``iter_audio_response_batches``: batch i+1's prompt built on the
builder thread and a side CUDA stream while batch i prefills and decodes),
closed loop: the next batch goes in as soon as the pipeline takes it.

Set-up: weights made from the seed, the engine, and ``warmup_batches``
batches through the same pipeline (kernel builds, allocator growth). The
window then runs for ``--seconds``; ``utt_per_s`` is the utterances of the
batches completed in it over the time from its start to the last
completion.

``correct``: every utterance of a completed batch is answered, and for a
sample of the window's utterances drawn from the seed (the longest clip
among them) the reference runs once over the prompt and the served tokens
(encoder, projector, splice, decoder with the int8 cache) and the widest
gap by which a served token's logit lies below the reference's best must
stay under the cell's limit. With the control planted, the tokens the
reference in float8 puts first at each position of the same prompts and
served tokens take the served tokens' place.

With ``--trace 1`` the window is two phases of ``trace_seconds``: the
first untraced, for the host-clock metrics (``decode_ms_per_step.bulk``,
``mfu.bulk``), the second under the profiler, for the device metrics.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench import gen, weights
from portbench.core import Outcome, check_program, port_config, sync
from portbench.hooks import Hooks
from portbench.reference import model as ref
from portbench.trace import Tracer

PAD_SAMPLES = 1600  # the engine's audio bucket



def _install_layers(hooks: Hooks, eng, eng_mod, gen_mod, dev, run):
    """Ranges around the prompt build, the prefill and each decode step,
    and, while ``run.clocking`` is set, the host wall of each generate from
    the prefill's end."""
    tracer = hooks.tracer
    state = {"prefill_end": None}

    def main_stream_done():  # not the builder's side stream
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
            if run.clocking:
                state["prefill_end"] = main_stream_done()
            return out
        return wrapped

    def generate(orig):
        def wrapped(*a, **kw):
            steps = eng.counts["decode_steps"]
            out = orig(*a, **kw)
            if run.clocking and state["prefill_end"] is not None:
                run.decode_wall_s += main_stream_done() - state["prefill_end"]
                run.decode_steps += eng.counts["decode_steps"] - steps
            state["prefill_end"] = None
            return out
        return wrapped

    hooks.wrap(eng, "build_audio_prompt_batch", build)
    hooks.wrap(gen_mod, "llama_forward", forward)
    hooks.wrap(eng_mod, "greedy_generate", generate)


def _plant(hooks: Hooks, faults, eng, gen_mod, vocab):
    """Faults the tests plant under the timed path: "token" alters the
    tokens served at one step of every generate; "half" answers half of
    each batch."""
    if "token" in faults:
        seen = {"n": 0}

        def sample(orig):
            def wrapped(logits, *a, **kw):
                out = orig(logits, *a, **kw)
                seen["n"] += 1
                if seen["n"] % 7 == 3:
                    out = (out + 1) % vocab
                return out
            return wrapped
        hooks.wrap(gen_mod, "_sample", sample)
    if "half" in faults:
        def half(orig):
            def wrapped(embeds, *a, **kw):
                got = orig(embeds, *a, **kw)
                return got[: (len(got) + 1) // 2]
            return wrapped
        hooks.wrap(eng, "_generate_from_embeds", half)


def _drive(it, seconds: float, done: list) -> float:
    """Take completed batches until one completes ``seconds`` after the
    start; the start."""
    t0 = time.perf_counter()
    for out in it:
        t = time.perf_counter()
        done.append((t, len(out)))
        if t - t0 >= seconds:
            break
    return t0


def run(ctx) -> Outcome:
    from llm_speech_summarization_tpu_torch.infer import engine as eng_mod
    from llm_speech_summarization_tpu_torch.infer import generate as gen_mod

    dev, cfg_file, tr = ctx.device, ctx.config, ctx.traffic
    phases = {"start": time.perf_counter() - ctx.t_start}
    cfg = port_config(ctx.root, cfg_file, ctx.workdir)
    dtype = weights.DTYPES[cfg_file["dtypes"]["param"]]
    llm = weights.make_llm(cfg_file, ctx.seed, dev, dtype)
    enc = weights.make_encoder(cfg_file, ctx.seed, dev, dtype)
    sync(dev)
    phases["weights"] = time.perf_counter() - ctx.t_start
    eng = eng_mod.LLMSpeechTextInference(cfg, audio_encoder_params=enc, llm_params=llm,
                                         device=dev)
    phases["engine"] = time.perf_counter() - ctx.t_start
    check_program(cfg_file, eng.llm_cfg, eng.encoder_setup.encoder_cfg, eng.prefix_ids.tolist(),
                  eng.suffix_ids.tolist(), cfg)
    sr, vocab = cfg_file["encoder"]["sampling_rate"], cfg_file["llm"]["vocab_size"]
    B, new_tokens = tr["batch"], tr["new_tokens"]

    tracer = Tracer(ctx.trace)
    hooks = Hooks(tracer)
    served = []  # every answered utterance's token ids, in order
    decode = eng.tokenizer.decode

    def record(ids, skip_special_tokens=True):
        served.append([int(i) for i in ids])
        return decode(ids, skip_special_tokens)

    eng.tokenizer.decode = record
    rec = SimpleNamespace(kind="bulk", config=cfg_file, traffic=tr, decode_wall_s=0.0,
                          decode_steps=0, summary=None, calls=[], utterances=[], window_s=0.0,
                          clocking=False)
    _plant(hooks, ctx.faults, eng, gen_mod, vocab)
    if ctx.trace:
        hooks.install_kernels()
        _install_layers(hooks, eng, eng_mod, gen_mod, dev, rec)

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
    done = []  # (completion time, answered) of each batch
    # traced: an untraced phase first, for the host clock; then the profiler's
    rec.clocking = ctx.trace
    t0 = _drive(it, tr["trace_seconds"] if ctx.trace else ctx.seconds, done)
    rec.clocking = False
    rec.window_s, n_clock = done[-1][0] - t0, len(done)
    hooks.on = ctx.trace
    with tracer.session(dev.type == "cuda"):
        if ctx.trace:
            with tracer.range("pb.window"):
                _drive(it, tr["trace_seconds"], done)
        it.close()  # the batch being built is drained, not decoded
    hooks.on = False
    sync(dev)
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

    # the sample, chosen before the reference runs
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
    checks = [("served_logit_gap", readings["served_logit_gap"],
               ctx.limits["served_logit_gap"]["limit"])]
    return Outcome(e2e={"utt_per_s": answered / rec.window_s, "setup_s": setup_s}, checks=checks,
                   attempted=attempted, failed=failed, memory_peak_bytes=peak, run=rec,
                   readings=readings)


@torch.no_grad()
def reference_gaps(ctx, checked, batch_samples: int, new_tokens: int, control: bool) -> dict:
    """The widest gap, over the checked utterances' served tokens, between
    the reference's best logit and the served token's; with ``control``
    that of the tokens the float8 reference puts first in their place."""
    dev, cfg = ctx.device, ctx.config
    ref.exact_float32()
    dtype = weights.DTYPES[cfg["dtypes"]["param"]]
    llm = weights.make_llm(cfg, ctx.seed, dev, dtype)
    enc = weights.make_encoder(cfg, ctx.seed, dev, dtype)
    eos = cfg["template"]["eos_id"]
    widest, fp8_widest, tokens = 0.0, 0.0, 0
    for wav, ids in checked:
        if not ids or len(ids) > new_tokens or (len(ids) < new_tokens and ids[-1] != eos):
            return {"served_logit_gap": float("inf"), "served_tokens": tokens}
        wav_t = torch.from_numpy(wav).to(dev)
        x = ref.prompt(llm, cfg, ref.audio_embeds(enc, cfg, wav_t, batch_samples))
        n_p = x.shape[0]
        seq = torch.cat([x, ref.token_embeds(llm, ids[:-1])]) if len(ids) > 1 else x
        logits, _ = ref.llama(llm, cfg["llm"], seq, n_prompt=n_p, logits_from=n_p - 1)
        tok = torch.as_tensor(ids, device=dev)
        at = torch.arange(len(ids), device=dev)
        best = logits.max(-1).values
        widest = max(widest, float((best - logits[at, tok]).max()))
        tokens += len(ids)
        if control:
            lo = ref.Precision("float8")
            xc = ref.prompt(llm, cfg, ref.audio_embeds(enc, cfg, wav_t, batch_samples, lo))
            seqc = torch.cat([xc, ref.token_embeds(llm, ids[:-1])]) if len(ids) > 1 else xc
            lc, _ = ref.llama(llm, cfg["llm"], seqc, lo, n_prompt=n_p, logits_from=n_p - 1)
            first = lc.argmax(-1)
            fp8_widest = max(fp8_widest, float((best - logits[at, first]).max()))
    return {"served_logit_gap": fp8_widest if control else widest, "served_tokens": tokens,
            "control": control}
