"""A copy of the benchmark at the tiny presets, for CPU tests: the
benchmark's folder copied into a temporary checkout (the port linked in
beside it), with a tiny configuration of each encoder, tiny traffic of
each kind, their limits and a ``BENCHMARK.json`` naming those cells, all
added as files, none of the copied ones edited."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

PORT = "llm_speech_summarization_tpu_torch"

TINY_LLM = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
            "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "rope_scaling": None,
            "tie_word_embeddings": True, "max_position_embeddings": 2048, "hidden_act": "silu"}
TINY_HUBERT = {"type": "hubert", "conv_dims": [32, 32, 32, 32], "conv_kernels": [10, 8, 4, 4],
               "conv_strides": [5, 4, 4, 4], "hidden_size": 64, "num_layers": 2, "num_heads": 4,
               "intermediate_size": 128, "eps": 1e-05, "pos_conv_kernel": 16,
               "pos_conv_groups": 4, "sampling_rate": 16000}
TINY_WHISPER = {"type": "whisper", "num_mel_bins": 80, "hidden_size": 64, "num_layers": 2,
                "num_heads": 4, "intermediate_size": 128, "max_source_positions": 1500,
                "eps": 1e-05, "sampling_rate": 16000, "n_fft": 400, "hop_length": 160,
                "dynamic_frames": True}


def tiny_config(name: str, encoder: dict) -> dict:
    with open(REPO / "portbench" / "configs" / f"{name.replace('tiny_', 'minichat_')}.json") as f:
        cfg = json.load(f)
    # the tiny decoder ties its head to its embeddings: at std 0.02 the last
    # token's own row wins every step by a wide margin, at 0.3 its blocks
    # have a say and the logits come close, as at the published widths
    cfg.update(name=name, llm=TINY_LLM, encoder=encoder, reduced=["tiny presets"], init_std=0.3)
    cfg["projector"] = dict(cfg["projector"], out=64)
    cfg["train"] = dict(cfg["train"], batch_size=4, fd_loss_connector_layers=[0, 1, 2],
                        audio_buckets=[16000, 32000], max_text_tokens=32, max_response_tokens=32)
    cfg["overrides"] = dict(cfg["overrides"], **{
        "data.synthetic_num_samples": 64, "model.llm_preset": "tiny",
        "model.audio_encoder.preset": "tiny", "model.llm_embedding_channels": 64,
        "train.batch_size": 4, "train.fd_loss_connector_layers": [0, 1, 2],
        "train.num_workers": 1, "train.buckets.audio_samples": [16000, 32000],
        "train.buckets.max_text_tokens": 32, "train.buckets.max_response_tokens": 32})
    return cfg


TRAFFIC = {
    "tiny_train": {"kind": "train_kd", "batch": 4, "clip_seconds": [0.5, 1.5],
                   "text_tokens_per_second": 8.0, "response_tokens": [8, 24], "workers": 2,
                   "warmup_steps": 3, "reference_steps": 3, "trace_seconds": 0.3},
    "tiny_bulk": {"kind": "bulk", "batch": 8, "clip_seconds": [0.5, 1.5], "new_tokens": 16,
                  "warmup_batches": 1, "check_rows": 8, "trace_seconds": 0.3},
}
# limits of the tiny cells on the CPU (bf16 program, float32 reference)
TINY_LIMITS = {"train_kd": {"loss1_gap": 0.02, "row_fd_gap": 0.05, "grad_diff_median": 0.2,
                            "update_norm_gap": 0.1},
               "bulk": {"served_logit_gap": 1.0}}


def make_tiny(root: Path) -> Path:
    """A checkout at ``root``: the benchmark's folder, the port linked in,
    the tiny files added and a BENCHMARK.json of the tiny cells."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / PORT, root / PORT)
    cells = [("tiny_hubert", "tiny_train"), ("tiny_hubert", "tiny_bulk"),
             ("tiny_whisper", "tiny_bulk")]
    for name, enc in (("tiny_hubert", TINY_HUBERT), ("tiny_whisper", TINY_WHISPER)):
        with open(root / "portbench" / "configs" / f"{name}.json", "w") as f:
            json.dump(tiny_config(name, enc), f)
    for name, t in TRAFFIC.items():
        with open(root / "portbench" / "traffic" / f"{name}.json", "w") as f:
            json.dump(t, f)
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [{"name": n, "source": "https://example.org/tiny",
                         "file": f"portbench/configs/{n}.json", "reduced": [], "why": "tests"}
                        for n in ("tiny_hubert", "tiny_whisper")]
    bench["workloads"] = [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
                           "why": "tests"} for c, t in cells]
    names = [w["name"] for w in bench["workloads"]]
    train = [n for n in names if n.endswith("train")]
    bulk = [n for n in names if n.endswith("bulk")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = train if m["name"].endswith("train") or \
                m["name"] == "train_samples_per_s" else bulk
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    for n in names:
        kind = TRAFFIC[n.split(".")[1]]["kind"]
        with open(root / "portbench" / "limits" / f"{n}.json", "w") as f:
            json.dump({k: {"limit": v} for k, v in TINY_LIMITS[kind].items()}, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path / "checkout")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run them with -m cuda")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    return torch.device("cuda")
