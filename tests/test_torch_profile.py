"""The port's profiling on the CPU: ``obs/profile.py`` (``trace`` writes a
trace file holding an ``annotate``d region), the trainer's trace window
(``LSS_PROFILE_DIR`` / ``LSS_PROFILE_STEPS``) and the serving scheduler's
``LSS_SCHED_TRACE`` lines."""

import glob
import json
import os
import re

import pytest
import torch

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.obs import annotate, trace
from llm_speech_summarization_tpu_torch.serve.server import ContinuousBatchingEngine, _Request
from llm_speech_summarization_tpu_torch.train import Trainer

torch.set_num_threads(1)

TINY = str(YAML_DIR / "tiny_test.yaml")


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_annotated_region(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("encoder"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    assert prof is not None
    names = [e.get("name") for e in _trace_events(str(tmp_path))]
    assert "encoder" in names and "aten::matmul" in names


def test_trainer_trace_window(tmp_path, monkeypatch, capsys):
    """A 4-step tiny run with LSS_PROFILE_DIR and LSS_PROFILE_STEPS=2
    traces steps 3 and 4, and only them, into one file, and says so."""
    cfg = load_config(TINY)
    cfg.data.synthetic_num_samples = 8  # 4 train batches of 2
    cfg.train.batch_size = 2
    cfg.train.steps = 4
    cfg.log.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.log.log_dir = str(tmp_path / "logs")
    cfg.log.num_generate_samples = 0
    cfg.log.validation_interval = 0
    prof_dir = tmp_path / "trace"
    monkeypatch.setenv("LSS_PROFILE_DIR", str(prof_dir))
    monkeypatch.setenv("LSS_PROFILE_STEPS", "2")
    trainer = Trainer(cfg, run_name="trace", device="cpu")
    trainer.train()
    assert trainer.step == 4
    assert f"profile trace written to {prof_dir}" in capsys.readouterr().out
    names = [e.get("name") for e in _trace_events(str(prof_dir))]
    # the fused ntp + ld loss's backward runs once per KD step
    assert names.count("_FusedNtpLdBackward") == 2
    assert not [n for n in names if n and n.startswith("ProfilerStep")]  # one window


@pytest.mark.parametrize("on", [True, False])
def test_sched_trace_lines(capfd, monkeypatch, on):
    """LSS_SCHED_TRACE=1: one [build] line per wave and one [sched] line per
    scheduler iteration that ran a chunk, with the JAX scheduler's fields;
    unset, no line."""
    if on:
        monkeypatch.setenv("LSS_SCHED_TRACE", "1")
    else:
        monkeypatch.delenv("LSS_SCHED_TRACE", raising=False)
    engine = LLMSpeechTextInference(load_config(TINY), device="cpu")
    cb = ContinuousBatchingEngine(engine, n_slots=2, chunk_steps=2, max_prompt_len=256,
                                  max_new_tokens=8, device="cpu")
    try:
        out = cb.submit(_Request("text", "trace me", "", 6), timeout=120)
        assert isinstance(out, str)
        chunks = cb.batches_run
    finally:
        cb.shutdown()
    err = capfd.readouterr().err
    build = re.findall(r"^\[build\] wave n=(\d+) kind=(\w+) wall=\d+\.\d{3}s$", err, re.M)
    sched = re.findall(r"^\[sched\] it=(\d+) live=(\d+) k=(\d+) admit=\d+\.\d{3}s "
                       r"dispatch=\d+\.\d{3}s read=\d+\.\d{3}s total=\d+\.\d{3}s$", err, re.M)
    if not on:
        assert "[build]" not in err and "[sched]" not in err
        return
    assert build == [("1", "text")]
    assert len([s for s in sched if int(s[2]) > 0]) == chunks > 0
    its = [int(s[0]) for s in sched]
    assert its == sorted(its) and len(set(its)) == len(its)
