"""The data- and tensor-parallel trainer through the entry point a user
runs, ``python -m torch.distributed.run --nproc_per_node 2 -m
llm_speech_summarization_tpu_torch.cli.train --mesh 2,1,1 --device cpu``,
on ``tiny_test.yaml`` (gloo CPU ranks), mirrors of the JAX package's
tests/test_trainer_burrs.py:84, :141, tests/test_ckpt_mesh.py:36, :110 and
tests/test_multihost.py:66, :90:

  * the loader: each data rank draws a disjoint strided shard of the
    epoch order, equal shards with the remainder dropped, together the
    rows of the unsharded run's batches;
  * two ranks (ZeRO-1) against one process: the same global batches, the
    same losses per step, validation perplexities and parameters, within
    the float32 bounds below; rank 0 alone logs;
  * a two-rank run checkpointed at step 2 and relaunched ends at step 4
    bit for bit where an unbroken two-rank run ends; the checkpoint holds
    the whole optimizer state;
  * across meshes: the two-rank checkpoint resumes in one process, and a
    one-process checkpoint resumes on two ranks, each landing within the
    bounds of the other meshes' runs;
  * ``--mesh 1,1,2``: the LLM sharded over the model group, two steps,
    validation with a generation through the engine over that group.

Bounds across meshes (another order of float32 sums): losses and
perplexities within 1e-5 relative; parameters after four steps within
1e-4 (AdamW moves a parameter by up to lr = 1e-3 a step, and moves driven
by gradients under Adam's eps differ by up to their own size, ~1e-4).
"""

import json
import shutil

import numpy as np
import pytest
import torch
from torch_ring_worker import run_torchrun

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.parallel.mesh import Mesh
from llm_speech_summarization_tpu_torch.train import Trainer
from llm_speech_summarization_tpu_torch.train import checkpoint as ckpt
from llm_speech_summarization_tpu_torch.train.state import tree_leaves

torch.set_num_threads(1)

CLI = "llm_speech_summarization_tpu_torch.cli.train"
PARAM_ATOL = 1e-4
REL = 1e-5


def _yaml(tmp_path, name):
    text = (YAML_DIR / "tiny_test.yaml").read_text().replace("/tmp/lss_tpu_test",
                                                              str(tmp_path / name))
    path = tmp_path / f"{name}.yaml"
    path.write_text(text.replace("validation_interval: 1000", "validation_interval: 2"))
    return str(path)


def _launch(tmp_path, yaml_path, mesh, steps):
    # a transformers that fails to import sends load_tokenizer to its byte
    # fallback at once (the real import costs each rank seconds)
    stub = tmp_path / "no_transformers"
    (stub / "transformers").mkdir(parents=True, exist_ok=True)
    (stub / "transformers" / "__init__.py").write_text(
        "raise ImportError('transformers is not used by this test')\n")
    return run_torchrun([CLI, "-c", yaml_path, "-n", "run", "--mesh", mesh, "--device", "cpu",
                         "--steps", str(steps)], 2, path_first=[stub])


def _one_process(yaml_path, steps):
    cfg = load_config(yaml_path)
    cfg.train.steps = steps
    t = Trainer(cfg, run_name="run", device="cpu")
    t.train()
    return t


def _state(tmp_path, name, step):
    path = tmp_path / name / "checkpoints" / "run" / f"step_{step}" / ckpt.STATE_FILE
    return torch.load(path, weights_only=True)


def _records(tmp_path, name):
    return [json.loads(line) for line in
            open(tmp_path / name / "logs" / "run" / "metrics.jsonl")]


def _train_logs(records):
    """{step: {metric: value}} of the train/ records (one per metric)."""
    per_step = {}
    for r in records:
        for k, v in r.items():
            if k.startswith("train/"):
                per_step.setdefault(r["step"], {})[k] = v
    return per_step


def _ppl(records):
    """[(step, audio ppl, text ppl)] of the validations."""
    audio = [(r["step"], r["validation/audio_perplexity"]) for r in records
             if "validation/audio_perplexity" in r]
    text = [r["validation/text_perplexity"] for r in records
            if "validation/text_perplexity" in r]
    return [(s, a, t) for (s, a), t in zip(audio, text)]


def _params_close(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), atol=PARAM_ATOL,
                                   rtol=0)


def test_loader_shards_are_disjoint_equal_and_cover_the_batches(tmp_path):
    """Nine rows over two data ranks at batch 4: each rank 2 rows a batch
    from its strided shard, the same batch sizes on both, the two ranks'
    batch t together the unsharded batch t's rows (the ninth dropped)."""
    cfg = load_config(_yaml(tmp_path, "loader"))
    cfg.data.synthetic_num_samples = 9
    cfg.train.batch_size = 4
    trainers = [Trainer(cfg, run_name=f"r{r}", device="cpu", mesh=Mesh(2, 1, 1, r))
                for r in range(2)]
    plain = Trainer(cfg, run_name="plain", device="cpu")
    ds = plain.train_ds

    def rows(batch):  # a row's identity: its audio checksum
        return [round(float(np.sum(batch.wav[i])), 3) for i in range(batch.wav.shape[0])]

    shards = [[rows(b) for b in t._batches(ds, 4, True, 7, data_shard=True)] for t in trainers]
    whole = [rows(b) for b in plain._batches(ds, 4, True, 7)]
    assert [len(b) for b in shards[0]] == [len(b) for b in shards[1]] == [2, 2]
    flat = [sum(s, []) for s in shards]
    assert not set(flat[0]) & set(flat[1])
    for t, (a, b) in enumerate(zip(*shards)):
        assert sorted(a + b) == sorted(whole[t])
    assert [len(b) for b in whole] == [4, 4, 1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An unbroken 2-rank run to step 4 (``dp``), a 2-rank run stopped at 2
    and relaunched (``split``), one process to step 4 (``one``), the
    2-rank step-2 checkpoint resumed in one process (``to_one``), and a
    one-process step-2 checkpoint resumed on 2 ranks (``to_two``)."""
    tmp = tmp_path_factory.mktemp("dp_trainer")
    paths = {name: _yaml(tmp, name) for name in ("dp", "split", "one", "to_one", "to_two")}
    out = {"dp": _launch(tmp, paths["dp"], "2,1,1", 4)}
    _launch(tmp, paths["split"], "2,1,1", 2)
    out["split"] = _launch(tmp, paths["split"], "2,1,1", 4)
    out["one"] = _one_process(paths["one"], 4)
    shutil.copytree(tmp / "split" / "checkpoints" / "run" / "step_2",
                    tmp / "to_one" / "checkpoints" / "run" / "step_2")
    out["to_one"] = _one_process(paths["to_one"], 4)
    _one_process(paths["to_two"], 2)
    out["to_two"] = _launch(tmp, paths["to_two"], "2,1,1", 4)
    return tmp, out


def test_two_ranks_match_one_process(runs):
    tmp, out = runs
    dp, one = _train_logs(_records(tmp, "dp")), _train_logs(_records(tmp, "one"))
    assert sorted(dp) == sorted(one) == [1, 2, 3, 4]
    # rank 0 alone logs: one record of each metric a step
    assert sum("train/total_loss" in r for r in _records(tmp, "dp")) == 4
    for step in dp:
        for key in ("train/ntp_loss", "train/ld_loss", "train/fd_loss", "train/total_loss",
                    "train/grad_norm"):
            assert abs(dp[step][key] - one[step][key]) <= REL * max(1.0, abs(one[step][key]))
    for (s1, a1, t1), (s2, a2, t2) in zip(_ppl(_records(tmp, "dp")), _ppl(_records(tmp, "one"))):
        assert s1 == s2 and abs(a1 - a2) <= REL * a2 and abs(t1 - t2) <= REL * t2
    assert any("audio_response" in r for r in _records(tmp, "dp"))
    _params_close(_state(tmp, "dp", 4)["enc_params"], out["one"].state.enc_params)


def test_relaunched_run_continues_bit_identically(runs):
    tmp, out = runs
    assert "Resumed from" in out["split"] and "at step 2" in out["split"]
    a, b = _state(tmp, "dp", 4), _state(tmp, "split", 4)
    assert (a["step"], a["epoch_step"]) == (b["step"], b["epoch_step"]) == (4, 4)
    for x, y in zip(tree_leaves(a["enc_params"]), tree_leaves(b["enc_params"])):
        assert torch.equal(x, y)
    for key in ("mu", "nu"):  # the whole moments, gathered from the ZeRO-1 slices
        for x, y, p in zip(tree_leaves(a["opt_state"][key]), tree_leaves(b["opt_state"][key]),
                           tree_leaves(a["enc_params"])):
            assert x.shape == p.shape and torch.equal(x, y)


def test_checkpoints_cross_meshes(runs):
    """2 ranks → 1 process and 1 process → 2 ranks: the resumed run loads
    the file's state bit for bit (sliced for ZeRO-1 on two ranks) and
    lands where the other runs land."""
    tmp, out = runs
    to_one = out["to_one"]
    assert to_one.step == 4
    saved = _state(tmp, "to_one", 4)
    for x, y in zip(tree_leaves(saved["enc_params"]), tree_leaves(to_one.state.enc_params)):
        assert torch.equal(x, y.detach())
    _params_close(to_one.state.enc_params, out["one"].state.enc_params)
    assert "Resumed from" in out["to_two"] and "at step 2" in out["to_two"]
    _params_close(_state(tmp, "to_two", 4)["enc_params"], out["one"].state.enc_params)
    first = _state(tmp, "split", 2)
    resumed = Trainer(load_config(str(tmp / "to_one.yaml")), run_name="run", device="cpu",
                      checkpoint_path=str(tmp / "split" / "checkpoints" / "run" / "step_2"))
    for key in ("mu", "nu"):
        for x, y in zip(tree_leaves(first["opt_state"][key]),
                        tree_leaves(resumed.state.opt_state[key])):
            assert torch.equal(x, y)


def test_tensor_parallel_cli_trains_and_validates(tmp_path):
    """--mesh 1,1,2: two steps, validation (the sharded eval step on both
    ranks, a generation from the engine over the model group) and a
    checkpoint; the losses within the float32 bound of one process's."""
    path = _yaml(tmp_path, "tp")
    _launch(tmp_path, path, "1,1,2", 2)
    one = _one_process(_yaml(tmp_path, "one"), 2)
    got = _train_logs(_records(tmp_path, "tp"))
    want = _train_logs(_records(tmp_path, "one"))
    assert sorted(got) == [1, 2]
    for step in got:
        for key in ("train/total_loss", "train/grad_norm"):
            assert abs(got[step][key] - want[step][key]) <= REL * max(1.0, abs(want[step][key]))
    records = _records(tmp_path, "tp")
    assert any("audio_response" in r for r in records)
    (s1, a1, t1), *_ = _ppl(records)
    (s2, a2, t2), *_ = _ppl(_records(tmp_path, "one"))
    assert s1 == s2 == 2 and abs(a1 - a2) <= REL * a2 and abs(t1 - t2) <= REL * t2
    _params_close(_state(tmp_path, "tp", 2)["enc_params"], one.state.enc_params)
