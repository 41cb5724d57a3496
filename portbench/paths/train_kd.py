"""Runner of the ``train_kd`` kind: knowledge-distillation training of the
audio encoder, the paper's contribution, through ``Trainer.train_step`` on
batches that the program's ``collate_batch`` makes from the benchmark's
seeded examples, collated on worker threads ahead of the step as
``Trainer.train`` does.

Set-up: weights made from the seed (the frozen decoder in bf16, the
trained encoder in float32) handed to one ``Trainer``, which then takes
its first ``warmup_steps`` steps through the window's own call and feed
(kernel builds, allocator growth); those steps are the ones the reference
follows. The window then steps for ``--seconds``; ``train_samples_per_s``
is the utterances stepped over the window's wall, which ends in
``torch.cuda.synchronize()``.

``correct``: the reference follows the first ``reference_steps`` steps in
float32 from the same weights and batches, and four numbers must stay
under the cell's limits: the first step's loss (its relative gap); each
row's feature-distillation loss in the first step, worked out from the
hidden states the program's step handed its loss (the worst row's
relative gap; a row the step left out reads 1); the first gradient as the
optimizer holds it after step 1 (its first moment over 1 - beta1),
|program - reference| over the larger of the leaf's reference norm and
the median leaf's, by the median leaf; and the norm of the parameters'
change after the last followed step by the worst leaf, |program norm -
reference norm| over the same. The change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's (a key bias
under softmax: Adam moves them by round-off alone). With the control
planted, the reference in float8 takes the program's place in all four.

With ``--trace 1`` the window is two phases of ``trace_seconds``: the
first untraced, for the host-clock metrics (``mfu.train``), the second
under the profiler, for the device metrics.
"""

from __future__ import annotations

import gc
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import torch

from portbench import gen, weights
from portbench.core import Outcome, check_program, port_config, sync
from portbench.hooks import Hooks
from portbench.reference import kd, model as ref
from portbench.trace import Tracer

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's moves by round-off
# the numbers held to limits (PERF.md §2): the first step's loss, each row's
# first-step FD loss, the first gradient's difference by the median leaf, the
# change's norm by the worst leaf
CHECKED = ("loss1_gap", "row_fd_gap", "grad_diff_median", "update_norm_gap")


def total_steps(config: dict) -> int:
    """The trainer's optimizer steps (its linear learning-rate decay runs
    over them): epochs x batches per epoch of the dataset it is given."""
    tr = config["train"]
    n = config["overrides"]["data.synthetic_num_samples"]
    return tr["epochs"] * max(-(-n // tr["batch_size"]), 1)


def lr_schedule(config: dict):
    lr, total = config["train"]["optimizer"]["lr"], total_steps(config)
    return lambda t: lr * max(1.0 - min(t, total) / total, 0.0)


class Feed:
    """Collated batches j = 0, 1, ... made ``workers`` ahead on threads."""

    def __init__(self, stream: gen.Stream, config: dict, workers: int):
        from llm_speech_summarization_tpu_torch.data.collate import collate_batch

        tr = config["train"]
        self.make = lambda j: collate_batch(stream.examples(j), audio_buckets=tr["audio_buckets"],
                                            max_text_tokens=tr["max_text_tokens"],
                                            max_response_tokens=tr["max_response_tokens"])
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.ahead = workers + 1
        self.next_j = 0
        self.taken = 0
        self.pending = []

    def __next__(self):
        self.taken += 1
        while len(self.pending) < self.ahead:
            self.pending.append(self.pool.submit(self.make, self.next_j))
            self.next_j += 1
        return self.pending.pop(0).result()

    def close(self):
        for f in self.pending:
            f.cancel()
        self.pool.shutdown(wait=True)


def _plant(hooks: Hooks, faults, trainer):
    """Faults the tests plant under the timed path: "frozen" steps leave the
    state unchanged; "half" steps on the first half of each batch (the mean
    taken over it)."""
    if "frozen" in faults:
        hooks.wrap(trainer.optimizer, "apply", lambda orig: (lambda state, grads: None))
    if "half" in faults:
        def half(orig):
            def wrapped(batch):
                n = (batch.wav.shape[0] + 1) // 2
                return orig(batch._replace(**{k: (None if v is None else v[:n])
                                              for k, v in batch._asdict().items()}))
            return wrapped
        hooks.wrap(trainer, "train_step", half)


def _row_fd_probe(hooks: Hooks, rows: list):
    """Each row's FD loss (the masked mean over its response positions and
    the hidden size, summed over the connector layers), from the hidden
    states the program's step hands ``feature_distillation_loss``."""
    from llm_speech_summarization_tpu_torch.train import step as step_mod

    def probe(orig):
        def wrapped(student_hidden, teacher_hidden, layers, mask, *a, **kw):
            with torch.no_grad():
                m = mask.float()[..., None]
                per_row = sum(((student_hidden[i].detach().float()
                                - teacher_hidden[i].float()).square() * m).sum((1, 2))
                              for i in layers)
                D = student_hidden[layers[0]].shape[-1]
                rows.extend(float(x) for x in
                            (per_row / (m.sum((1, 2)).clamp(min=1.0) * D)).cpu())
            return orig(student_hidden, teacher_hidden, layers, mask, *a, **kw)
        return wrapped
    hooks.wrap(step_mod, "feature_distillation_loss", probe)


def _steps(trainer, feed, seconds: float, dev) -> tuple:
    """Step for ``seconds``; (steps, wall ending in a synchronize)."""
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        trainer.train_step(next(feed))
        n += 1
    sync(dev)
    return n, time.perf_counter() - t0


def run(ctx):
    from llm_speech_summarization_tpu_torch.train.state import make_train_state
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    dev, cfg_file, tr = ctx.device, ctx.config, ctx.traffic
    phases = {"start": time.perf_counter() - ctx.t_start}
    cfg = port_config(ctx.root, cfg_file, ctx.workdir)
    llm = weights.make_llm(cfg_file, ctx.seed, dev, weights.DTYPES[cfg_file["dtypes"]["param"]])
    enc0 = weights.make_encoder(cfg_file, ctx.seed, dev,
                                weights.DTYPES[cfg_file["dtypes"]["trained_encoder"]])
    sync(dev)
    phases["weights"] = time.perf_counter() - ctx.t_start
    trainer = Trainer(cfg, run_name="portbench", device=dev)
    phases["trainer"] = time.perf_counter() - ctx.t_start
    check_program(cfg_file, trainer.llm_cfg, trainer.enc_setup.encoder_cfg, trainer.prefix_ids,
                  trainer.suffix_ids, cfg)
    if trainer.total_opt_steps != total_steps(cfg_file):
        raise RuntimeError(f"the trainer decays its rate over {trainer.total_opt_steps} steps, "
                           f"the configuration file over {total_steps(cfg_file)}")
    # the benchmark's weights in place of the trainer's own random ones
    trainer.llm_params = llm
    trainer.state, trainer.optimizer = make_train_state(cfg, enc0, trainer.total_opt_steps)
    b1 = cfg_file["train"]["optimizer"]["beta1"]

    tracer = Tracer(ctx.trace)
    hooks = Hooks(tracer)
    _plant(hooks, ctx.faults, trainer)
    stream = gen.Stream(tr, ctx.seed, cfg_file["encoder"]["sampling_rate"],
                        cfg_file["llm"]["vocab_size"])
    feed = Feed(stream, cfg_file, tr["workers"])
    n_ref = tr["reference_steps"]
    rows = []
    probe = Hooks(tracer)
    _row_fd_probe(probe, rows)
    for step in range(1, max(tr["warmup_steps"], n_ref) + 1):
        metrics = trainer.train_step(next(feed))
        if step == 1:
            probe.remove()
            loss1 = float(metrics["total_loss"])
            # the first gradient as the optimizer holds it, kept on the host
            g1 = {k: (m / (1.0 - b1)).to("cpu", copy=True)
                  for k, m in kd.leaves(trainer.state.opt_state["mu"]).items()}
        phases[f"step{step}"] = time.perf_counter() - ctx.t_start
        if step == n_ref:
            p0 = kd.leaves(enc0)
            delta = {k: float((p.detach() - p0[k]).norm())
                     for k, p in kd.leaves(trainer.state.enc_params).items()}
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    rec = SimpleNamespace(kind="train", config=cfg_file, traffic=tr, summary=None, calls=[],
                          utterances=[], window_s=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first_j = feed.taken
    if ctx.trace:
        # untraced first, for the host clock; then the profiler's phase
        steps, rec.window_s = _steps(trainer, feed, tr["trace_seconds"], dev)
        hooks.install_kernels()
        hooks.wrap(trainer, "train_step",
                   lambda orig: (lambda batch: _ranged(tracer, orig, batch)))
        hooks.on = True
        with tracer.session(dev.type == "cuda"):
            with tracer.range("pb.window"):
                _steps(trainer, feed, tr["trace_seconds"], dev)
        hooks.on = False
    else:
        steps, rec.window_s = _steps(trainer, feed, ctx.seconds, dev)
    feed.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec.peak_bytes = peak
    rec.summary = tracer.summary
    rec.calls = hooks.resolve(tracer.summary.range_ms if tracer.summary else {})
    hooks.remove()
    B = tr["batch"]
    for j in range(first_j, first_j + steps):
        rec.utterances += [(len(e["audio"]), len(e["text_input_ids"]), len(e["response_input_ids"]))
                           for e in stream.examples(j)]
    prog = {"loss1": loss1, "rows": rows, "grad1": g1, "delta": delta}

    del trainer, llm, enc0, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = reference_readings(ctx, stream, prog, control="control" in ctx.faults)
    readings["setup_phases_s"] = phases
    readings["reference_s"] = time.perf_counter() - t_ref
    readings["trace_s"] = tracer.seconds
    checks = [(name, readings[name], ctx.limits[name]["limit"]) for name in CHECKED]
    return Outcome(e2e={"train_samples_per_s": B * steps / rec.window_s, "setup_s": setup_s},
                   checks=checks, attempted=B * steps, failed=0, memory_peak_bytes=peak,
                   run=rec, readings=readings)


def _ranged(tracer, orig, batch):
    with tracer.range("pb.train_step"):
        return orig(batch)


def _ref_batches(stream: gen.Stream, config: dict, n: int, dev):
    """The first n batches as the reference takes them: each utterance's
    waveform, transcript and response as collated (cut to the caps), with
    the batch's padded length."""
    from numpy import asarray

    tr = config["train"]
    out = []
    for j in range(n):
        exs = stream.examples(j)
        longest = max(len(e["audio"]) for e in exs)
        bucket = next((b for b in sorted(tr["audio_buckets"]) if longest <= b),
                      max(tr["audio_buckets"]))
        out.append([{"wav": torch.from_numpy(asarray(e["audio"][:bucket], "float32")).to(dev),
                     "text_ids": [int(i) for i in e["text_input_ids"][: tr["max_text_tokens"]]],
                     "response_ids": [int(i) for i in
                                      e["response_input_ids"][: tr["max_response_tokens"]]],
                     "batch_samples": bucket} for e in exs])
    return out


def compare(prog: dict, want: dict) -> dict:
    """The held numbers of a run (``prog``: its first step's loss, each
    row's first-step FD loss, its first gradient by leaf and its parameter
    change norms by leaf) against the reference's."""
    ref_g = {k: float(g.norm()) for k, g in want["grad1"].items()}
    diff = {k: float((prog["grad1"][k].to(g.device).float() - g).norm())
            for k, g in want["grad1"].items()}
    ref_d = {k: float((want["params"][k] - want["params0"][k]).norm()) for k in ref_g}
    med = sorted(ref_g.values())[len(ref_g) // 2]
    moved = [k for k, v in ref_g.items() if v >= NOUGHT * med]
    d_gap, d_leaf = kd.leaf_norm_gaps(prog["delta"], ref_d, moved)
    # a row the step left out reads 1, as if its loss were nought
    got_rows = list(prog["rows"]) + [0.0] * (len(want["rows1"]) - len(prog["rows"]))
    row_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got_rows, want["rows1"]))
    if len(prog["rows"]) > len(want["rows1"]):
        row_gap = 1.0
    loss1 = abs(prog["loss1"] - want["loss"][0]) / max(abs(want["loss"][0]), 1e-30)
    return {"loss1_gap": loss1, "row_fd_gap": row_gap,
            "grad_diff_median": sorted(diff[k] / max(ref_g[k], med) for k in ref_g)[len(ref_g) // 2],
            "update_norm_gap": d_gap, "update_norm_leaf": d_leaf,
            "leaves_left_out": len(ref_g) - len(moved)}


def reference_readings(ctx, stream, prog: dict, control: bool) -> dict:
    """The held numbers against the float32 reference; with ``control``,
    those of the reference in float8 put in the program's place."""
    dev, cfg = ctx.device, ctx.config
    ref.exact_float32()
    n = ctx.traffic["reference_steps"]
    llm = weights.make_llm(cfg, ctx.seed, dev, weights.DTYPES[cfg["dtypes"]["param"]])
    enc0 = weights.make_encoder(cfg, ctx.seed, dev, weights.DTYPES[cfg["dtypes"]["trained_encoder"]])
    batches = _ref_batches(stream, cfg, n, dev)
    want = kd.kd_steps(llm, enc0, cfg, batches, lr_schedule(cfg))
    if control:
        lo = kd.kd_steps(llm, enc0, cfg, batches, lr_schedule(cfg), ref.Precision("float8"))
        prog = {"loss1": lo["loss"][0], "rows": lo["rows1"], "grad1": lo["grad1"],
                "delta": {k: float((lo["params"][k] - lo["params0"][k]).norm())
                          for k in lo["grad1"]}}
    out = compare(prog, want)
    out["control"] = control
    return out
