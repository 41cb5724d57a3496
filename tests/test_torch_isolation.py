"""The port stands alone: a fresh interpreter imports every module of it
(the training slice, ``cli.train``, ring attention, ``parallel/``, the
inference CLI, the audio loaders, the converters, the preprocessing job,
the evaluation harness and the tensor-parallel entry points among them)
without loading orbax, safetensors, transformers or datasets (the port
reads safetensors itself), reads a bf16 safetensors file, builds a CPU
engine and server and answers a request, shards and merges the engine's
LLM, and takes a training step through the ``Trainer``, without jax or any
module of the JAX package being loaded; and the port's copy of the config
loader reads every shipped YAML exactly as the JAX package's does."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

ROOT = Path(__file__).resolve().parent.parent
JAX_YAML_DIR = ROOT / "llm_speech_summarization_tpu" / "configs" / "yaml"

_SCRIPT = r"""
import importlib, json, pkgutil, sys, urllib.request
import torch
torch.set_num_threads(1)
import llm_speech_summarization_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("orbax", "safetensors", "transformers", "datasets"))
import struct, tempfile
from llm_speech_summarization_tpu_torch.models.convert import load_hf_state_dict
st_dir = tempfile.mkdtemp()
hdr = json.dumps({"__metadata__": {"format": "pt"},
                  "w": {"dtype": "BF16", "shape": [2], "data_offsets": [0, 4]}}).encode()
with open(st_dir + "/m.safetensors", "wb") as f:
    f.write(struct.pack("<Q", len(hdr)) + hdr + torch.tensor([1.5, -2.0]).to(torch.bfloat16)
            .view(torch.int16).numpy().tobytes())
st = load_hf_state_dict(st_dir)["w"]
st_ok = st.dtype == torch.bfloat16 and st.tolist() == [1.5, -2.0]
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.serve.server import SummarizationServer
cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
cfg.model.kv_cache_dtype = "int8"
eng = LLMSpeechTextInference(cfg, device="cpu")
srv = SummarizationServer(eng, port=0, continuous=True, paged=True, n_slots=2,
                          max_new_tokens=4, admit_wait_ms=10, device="cpu")
srv.start_background()
req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/text_response",
                             data=json.dumps({"text": "hi", "max_new_tokens": 3}).encode(),
                             method="POST")
with urllib.request.urlopen(req, timeout=120) as resp:
    status = resp.status
drained = srv.drain(timeout=30)
from llm_speech_summarization_tpu_torch.parallel.mesh import mesh_from_ranks
from llm_speech_summarization_tpu_torch.parallel.sharding import merge_llama_shards, shard_llama_params
from llm_speech_summarization_tpu_torch.serve.model_group import ModelGroupDecoder, follow
shards = [shard_llama_params(eng.llm_params, eng.llm_cfg, r, 2) for r in range(2)]
tp_ok = (mesh_from_ranks(model=1).model_group is None
         and merge_llama_shards(shards, eng.llm_cfg)["embed_tokens"].equal(eng.llm_params["embed_tokens"]))
import tempfile
from llm_speech_summarization_tpu_torch.train.trainer import Trainer
tmp = tempfile.mkdtemp()
cfg.log.checkpoint_dir, cfg.log.log_dir = tmp + "/ckpt", tmp + "/logs"
cfg.log.num_generate_samples = 0
cfg.train.steps = 1
trainer = Trainer(cfg, device="cpu")
trainer.train()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "llm_speech_summarization_tpu"))
print(json.dumps({"modules": len(names), "status": status, "drained": drained,
                  "trained": trainer.step, "names": names, "loaded": loaded, "heavy": heavy,
                  "safetensors_read": st_ok, "tp_ok": tp_ok}))
"""


def test_port_runs_without_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [] and out["heavy"] == [] and out["safetensors_read"]
    assert out["modules"] >= 20 and out["status"] == 200 and out["drained"]
    assert out["trained"] == 1 and out["tp_ok"]
    pkg = "llm_speech_summarization_tpu_torch."
    for name in ("train.trainer", "train.step", "train.state", "train.checkpoint", "cli.train",
                 "ops.losses", "data.datasets", "data.collate", "obs.writer",
                 "ops.ring_attention", "parallel.mesh", "parallel.comm", "cli.infer",
                 "data.audio_io", "data.flac", "data.native", "ops.pooling", "models.convert",
                 "cli.convert", "data.preprocess", "cli.preprocess", "eval.rouge",
                 "eval.bertscore", "eval.evaluate", "cli.evaluate", "cli.serve",
                 "parallel.sharding", "serve.model_group"):
        assert pkg + name in out["names"], name


YAMLS = ("llama3_hubert.yaml", "llama3_hubert_long.yaml", "llama3_whisper.yaml",
         "minichat_hubert.yaml", "minichat_whisper.yaml", "tiny_test.yaml")


@pytest.mark.parametrize("name", YAMLS)
def test_config_copy_loads_like_jax(name):
    assert (YAML_DIR / name).read_text() == (JAX_YAML_DIR / name).read_text()
    ours = dataclasses.asdict(load_config(str(YAML_DIR / name)))
    theirs = dataclasses.asdict(jax_load_config(str(JAX_YAML_DIR / name)))
    assert ours == theirs


def test_six_shipped_configs():
    for d in (YAML_DIR, JAX_YAML_DIR):
        assert tuple(sorted(p.name for p in d.glob("*.yaml"))) == YAMLS
