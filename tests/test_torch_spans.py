"""The port's spans and counters on the CPU, at the tiny config.

  * ``annotate``: with no profiler recording, one shared no-op context and
    no ``record_function`` call; under ``torch.profiler`` a span by name;
  * the generation loop: the same tokens with and without ``counts``, one
    ``decode_steps`` per decode forward, ``decode_issue_s`` growing, and one
    ``lss.generate.decode_step`` span per counted step;
  * the pipelined batch stream: ``pipeline_batches`` one per batch yielded,
    ``prompt_wait_s`` at least 0, one ``lss.batch.wait_prompt`` span each;
  * the KD step: ``Trainer.counts["valid_positions"]`` equal to the sum of
    the student splice's attention mask (pool, ctc_pool and Whisper), the
    share logged each log interval, and every ``lss.train.*`` span once a
    step.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import profile

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer import generate as gen_mod
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.obs import annotate
from llm_speech_summarization_tpu_torch.obs import profile as obs_profile
from llm_speech_summarization_tpu_torch.train import Trainer
from llm_speech_summarization_tpu_torch.train import step as step_mod

torch.set_num_threads(1)

TINY = str(YAML_DIR / "tiny_test.yaml")


def _span_counts(prof) -> Counter:
    return Counter(e.name for e in prof.events() if e.name.startswith("lss."))


def test_annotate_is_a_shared_no_op_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(obs_profile, "record_function", lambda name: calls.append(name))
    a, b = annotate("lss.x"), annotate("lss.y")
    assert a is b
    with a, b:  # re-entered, nested: no state
        pass
    assert calls == []


def test_annotate_records_its_name_under_the_profiler():
    with profile() as prof:
        with annotate("lss.test.outer"):
            with annotate("lss.test.inner"):
                torch.ones(4).sum()
        assert annotate("lss.test.kind") is not annotate("lss.test.kind")
    assert _span_counts(prof) == Counter({"lss.test.outer": 1, "lss.test.inner": 1})


def _tiny_prompt(seed=3, B=3, L=10):
    cfg = tllama.llama_preset("tiny")
    gen = torch.Generator().manual_seed(seed)
    params = tllama.init_llama_params(gen, cfg, dtype=torch.float32, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (B, L), generator=gen)
    mask = torch.arange(L)[None, :] >= torch.tensor([[0], [4], [7]])
    embeds = params["embed_tokens"][ids] * mask[..., None]
    return params, cfg, embeds, mask


@pytest.mark.parametrize("ends", ["eos", "cap"])
def test_greedy_generate_counts_and_spans(monkeypatch, ends):
    params, cfg, embeds, mask = _tiny_prompt()
    kw = dict(max_new_tokens=12, cache_dtype=torch.float32, repetition_penalty=1.5)
    eos = cfg.vocab_size  # never drawn: the step cap ends the loop
    if ends == "eos":  # the last row alone, its second token taken as its EOS
        embeds, mask = embeds[2:], mask[2:]
        (row,) = gen_mod.greedy_generate(params, cfg, embeds, mask, eos_id=eos, **kw)[0].tolist()
        eos = row[1]
        assert row[0] != eos
    forwards = Counter()
    orig = gen_mod.llama_forward

    def counted(*a, **kw):
        forwards["prefill" if kw.get("inputs_embeds") is not None else "decode"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(gen_mod, "llama_forward", counted)
    want_t, want_n = gen_mod.greedy_generate(params, cfg, embeds, mask, eos_id=eos, **kw)
    plain = forwards["decode"]
    counts = Counter()
    with profile() as prof:
        got_t, got_n = gen_mod.greedy_generate(params, cfg, embeds, mask, eos_id=eos,
                                               counts=counts, **kw)
    assert torch.equal(got_t, want_t) and torch.equal(got_n, want_n)
    steps = counts["decode_steps"]
    assert steps == plain == forwards["decode"] - plain == (1 if ends == "eos" else 11)
    assert counts["prefills"] == 1 and counts["decode_issue_s"] > 0
    spans = _span_counts(prof)
    assert spans["lss.generate.prefill"] == 1
    assert spans["lss.generate.decode_step"] == steps
    # a read before every step, and one more where the rows' EOS ended the loop
    assert spans["lss.generate.done_read"] == steps + (ends == "eos")


def test_pipeline_counts_batches_and_its_wait():
    te = LLMSpeechTextInference(load_config(TINY), device="cpu")
    rng = np.random.RandomState(5)
    batches = [[(0.05 * rng.randn(8000 + 700 * i + 300 * j)).astype(np.float32)
                for j in range(n)] for i, n in enumerate((2, 1, 3))]
    want = [te.generate_audio_response_batch(b, max_new_tokens=6) for b in batches]
    assert te.counts["pipeline_batches"] == 0 and te.counts["prompt_wait_s"] == 0
    steps = te.counts["decode_steps"]
    with profile() as prof:
        got = list(te.iter_audio_response_batches(iter(batches), max_new_tokens=6))
    assert got == want
    assert te.counts["pipeline_batches"] == len(got) == 3
    assert te.counts["prompt_wait_s"] >= 0
    assert te.counts["decode_steps"] - steps == steps  # the same steps as per-batch calls
    spans = _span_counts(prof)
    assert spans["lss.batch.wait_prompt"] == spans["lss.batch.detokenize"] == 3
    assert spans["lss.generate.prefill"] == 3


def _tiny_trainer(tmp_path, variant="pool"):
    cfg = load_config(TINY)
    if variant == "ctc_pool":
        cfg.model.audio_encoder.downsample_method = "ctc_pool"
    elif variant == "whisper":
        cfg.model.audio_encoder.base = "whisper"
        cfg.model.audio_encoder.whisper_dynamic_frames = True
    cfg.log.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.log.log_dir = str(tmp_path / "logs")
    return Trainer(cfg, run_name="spans", device="cpu")


def _batch(trainer, n):
    it = trainer._batches(trainer.train_ds, 2, True, 0)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("variant", ["pool", "ctc_pool", "whisper"])
def test_trainer_counts_valid_positions(tmp_path, monkeypatch, variant):
    """The host count from the batch's lengths against the student
    splice's attention mask, summed directly."""
    trainer = _tiny_trainer(tmp_path, variant)
    masks = []
    orig = step_mod.splice_sequences

    def spliced(*a, **kw):
        out = orig(*a, **kw)
        if torch.is_grad_enabled():  # the student's; the teacher's runs under no_grad
            masks.append(out.attn_mask)
        return out

    monkeypatch.setattr(step_mod, "splice_sequences", spliced)
    for batch in _batch(trainer, 3):
        trainer.train_step(batch)
    assert len(masks) == 3
    assert trainer.counts["positions"] == sum(m.numel() for m in masks)
    assert trainer.counts["valid_positions"] == sum(int(m.sum()) for m in masks)
    assert 0 < trainer.counts["valid_positions"] < trainer.counts["positions"]


def test_trainer_logs_the_valid_position_share(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    trainer.config.train.steps = 2
    trainer.config.log.num_generate_samples = 0
    shares = []
    orig = trainer.train_step

    def step(batch):
        before = Counter(trainer.counts)
        out = orig(batch)
        shares.append((trainer.counts["valid_positions"] - before["valid_positions"])
                      / (trainer.counts["positions"] - before["positions"]))
        return out

    trainer.train_step = step
    trainer.train()
    lines = [json.loads(x) for x in open(tmp_path / "logs" / "spans" / "metrics.jsonl")]
    logged = [x["train/valid_position_share"] for x in lines if "train/valid_position_share" in x]
    assert logged == pytest.approx(shares) and len(logged) == 2
    assert all(0 < v < 1 for v in logged)


def test_train_step_spans(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    batches = _batch(trainer, 3)
    trainer.train_step(batches[0])
    with profile() as prof:
        trainer.train_step(batches[1])
        trainer.train_step(batches[2])
    names = ("to_device", "encoder", "student", "teacher", "loss", "loss_backward",
             "backward", "optimizer")
    assert _span_counts(prof) == Counter({f"lss.train.{n}": 2 for n in names})
