"""The ``bulk_moe`` kind at a tiny DeepSeek-V3 preset on the CPU, added as
files beside the tiny cells of ``conftest.make_tiny``: the benchmark
validates with it; a sound run comes out correct (the program against
``reference/mla_moe.py``); a served token altered, half of each batch left
out, and the control (the reference in float8 in the program's place)
come out not correct; a traced run reads the layers a CPU run can."""

import json

import pytest
import torch

from portbench.core import Bench, run_cell
from portbench.tests.conftest import REPO, TINY_WHISPER, make_tiny

SEED = 2 ** 31 + 91
CELL = "tiny_moonlight.tiny_bulk_moe"
TINY_MOE = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
            "moe_intermediate_size": 32, "num_hidden_layers": 3, "num_attention_heads": 4,
            "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 32,
            "qk_rope_head_dim": 16, "v_head_dim": 32, "n_routed_experts": 8,
            "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1}


def add_tiny_moe(root):
    """The tiny MoE configuration, traffic, limit and cell added as files."""
    pb = root / "portbench"
    cfg = json.loads((REPO / "portbench" / "configs" / "moonlight_whisper.json").read_text())
    cfg.update(TINY_MOE, name="tiny_moonlight", encoder=TINY_WHISPER, reduced=["tiny presets"],
               init_std=0.1, max_position_embeddings=2048)
    cfg["projector"] = dict(cfg["projector"], out=64)
    cfg["overrides"] = dict(cfg["overrides"], **{
        "model.llm_preset": "tiny_mla_moe", "model.audio_encoder.preset": "tiny",
        "model.llm_embedding_channels": 64})
    (pb / "configs" / "tiny_moonlight.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "portbench" / "traffic" / "bulk_moe.json").read_text())
    traffic.update(batch=8, clip_seconds=[0.5, 1.5], new_tokens=16, warmup_batches=1,
                   trace_seconds=0.3)
    (pb / "traffic" / "tiny_bulk_moe.json").write_text(json.dumps(traffic))
    # bf16 program against the float32 reference on the CPU
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps({
        "served_logit_gap": {"limit": 1.0}, "served_gap_median": {"limit": 0.1}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_moonlight", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny_moonlight.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_moonlight",
                               "traffic": "tiny_bulk_moe", "chips": 1, "why": "tests"})
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    cells_of = {m["name"]: m.get("workloads", []) for m in real["end_to_end"] + real["per_layer"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        real_cells = cells_of.get(m["name"], [])
        if real_cells == ["moonlight_whisper.bulk_moe"]:  # this cell's own metrics
            m["workloads"] = [CELL]
        elif "moonlight_whisper.bulk_moe" in real_cells:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(4)
    return Bench(add_tiny_moe(make_tiny(tmp_path_factory.mktemp("tiny_moe") / "checkout")))


def test_the_benchmark_validates_with_the_new_cell(bench):
    assert Bench(REPO).validate() == []
    assert bench.validate() == []
    names = {m["name"] for m in bench.per_layer(bench.cells[CELL])}
    assert {"expert_roofline.bulk_moe", "mla_roofline.bulk_moe", "expert_share.bulk_moe",
            "mfu.bulk_moe", "decode_ms_per_step.bulk"} <= names
    assert "mfu.bulk" not in names and "decode_roofline.bulk" not in names


@pytest.mark.parametrize("faults,correct", [((), True), (("token",), False), (("half",), False),
                                            (("control",), False)])
def test_correct_comes_out_false_under_each_fault(bench, faults, correct):
    line = run_cell(bench, CELL, SEED + len(faults), 0.3, False, "cpu", faults=faults)
    assert line["correct"] is correct, (line["checks"], line["readings"].get("served_tokens"))
    assert set(line["metrics"]) == {"utt_per_s", "setup_s"}
    if faults == ():
        r = line["readings"]
        assert r["served_tokens"] > 0 and r["min_selection_margin"] > 0
    if faults == ("control",):
        assert line["readings"]["control"] is True


def test_a_traced_run_reads_its_layers(bench):
    line = run_cell(bench, CELL, SEED, 0.3, True, "cpu")
    # no card: the device metrics find nothing to read and are left out
    assert set(line["metrics"]) == {"decode_ms_per_step.bulk", "mfu.bulk_moe"}
    work = line["readings"]["moe_work"]
    assert work["decode"]["pairs"] > 0 and work["prefill"]["pairs"] > 0
    assert work["decode"]["latent_slots"] > 0
