"""The sequence-parallel trainer end to end on the CPU, through the entry
point a user runs: ``python -m torch.distributed.run --nproc_per_node 2 -m
llm_speech_summarization_tpu_torch.cli.train --mesh 1,2,1 --device cpu``
on ``tiny_test.yaml`` with ``use_ring_attention`` and ``encoder_sp``. Two
steps, validate (the sharded eval on both ranks, a generation on rank 0)
and a checkpoint from rank 0; a second launch resumes from it and takes
two more steps, ending bit for bit where an uninterrupted four-step run
ends. Rank 0 alone writes the logs.
"""

import json

import torch
from torch_ring_worker import run_torchrun

from llm_speech_summarization_tpu_torch.configs import YAML_DIR
from llm_speech_summarization_tpu_torch.train import checkpoint as ckpt
from llm_speech_summarization_tpu_torch.train.state import tree_leaves

CLI = "llm_speech_summarization_tpu_torch.cli.train"


def _yaml(tmp_path, name):
    text = (YAML_DIR / "tiny_test.yaml").read_text().replace("/tmp/lss_tpu_test",
                                                              str(tmp_path / name))
    text = text.replace("  remat: False\n", "  remat: False\n  use_ring_attention: True\n"
                        "  encoder_sp: True\n")
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def _run(tmp_path, yaml_path, steps):
    # the test needs no HF tokenizer: a stub that refuses the import of
    # transformers sends load_tokenizer to its byte fallback at once (an
    # import that then fails to find a tokenizer costs each rank seconds)
    stub = tmp_path / "no_transformers"
    (stub / "transformers").mkdir(parents=True, exist_ok=True)
    (stub / "transformers" / "__init__.py").write_text(
        "raise ImportError('transformers is not used by this test')\n")
    return run_torchrun([CLI, "-c", yaml_path, "-n", "ring", "--mesh", "1,2,1", "--device", "cpu",
                         "--steps", str(steps)], 2, path_first=[stub])


def _state(tmp_path, name, step):
    path = tmp_path / name / "checkpoints" / "ring" / f"step_{step}" / ckpt.STATE_FILE
    return torch.load(path, weights_only=True)


def test_ring_trainer_cli_trains_and_resumes(tmp_path):
    straight = _yaml(tmp_path, "straight")
    _run(tmp_path, straight, 4)
    split = _yaml(tmp_path, "split")
    _run(tmp_path, split, 2)
    first = _state(tmp_path, "split", 2)
    assert (first["step"], first["epoch_step"]) == (2, 2)
    out = _run(tmp_path, split, 4)
    assert "Resumed from" in out and "at step 2" in out
    a, b = _state(tmp_path, "straight", 4), _state(tmp_path, "split", 4)
    assert (a["step"], a["epoch_step"]) == (b["step"], b["epoch_step"]) == (4, 4)
    for key in ("enc_params",):
        for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            assert torch.equal(x, y)
    for key in ("mu", "nu"):
        for x, y in zip(tree_leaves(a["opt_state"][key]), tree_leaves(b["opt_state"][key])):
            assert torch.equal(x, y)
    moved = [not torch.equal(x, y) for x, y in zip(tree_leaves(first["enc_params"]),
                                                     tree_leaves(a["enc_params"]))]
    assert sum(moved) > 0.9 * len(moved)
    records = [json.loads(line) for line in
               open(tmp_path / "straight" / "logs" / "ring" / "metrics.jsonl")]
    steps = [r["step"] for r in records if "train/total_loss" in r]
    assert steps == [1, 2, 3, 4]  # one writer: each step logged once
    assert any("validation/audio_perplexity" in r for r in records)
    assert any("audio_response" in r for r in records)
