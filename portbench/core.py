"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
builds the program's configuration, runs the cell's runner, reads its
per-layer metrics and prints the result line.

Layout under ``portbench/`` (a cell, configuration, traffic mix or metric
is added by adding files; none is edited):
  * ``configs/<config>.json``: sizes, sources, the yaml the program loads
    and the overrides it runs with;
  * ``traffic/<mix>.json``: the mix's parameters, with its ``kind``;
  * ``paths/<kind>.py``: the runner of a kind (``run(ctx) -> Outcome``);
  * ``metrics/<metric>.py``: a per-layer metric's reader (``read(run)``,
    and ``LAYER``, ``UNIT``, ``MOVES`` as ``BENCHMARK.json`` gives them);
  * ``limits/<cell>.json``: the limits of the numbers that decide
    ``correct``, with the readings they were set from.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "llm_speech_summarization_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port's runs must not
    load (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def config(self, cell: dict) -> dict:
        return load_json(self.root / self.configs[cell["config"]]["file"])

    def traffic(self, cell: dict) -> dict:
        return load_json(self.root / "portbench" / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return load_json(self.root / "portbench" / "limits" / f"{cell['name']}.json")

    def runner(self, kind: str):
        return load_module(self.root / "portbench" / "paths" / f"{kind}.py", f"portbench_path_{kind}")

    def reader(self, metric: str):
        return load_module(self.root / "portbench" / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def end_to_end(self, cell: dict) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def per_layer(self, cell: dict) -> List[dict]:
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if ((cell["name"] in m["workloads"]) if "workloads" in m
                    else (m["moves"] in moves))]

    def validate(self) -> List[str]:
        """Everything a run would trip over, without running: names, files,
        runners, readers and their declared layer, unit and metric moved."""
        bad = []
        s = self.spec
        for m in s["end_to_end"] + s["per_layer"]:
            if not NAME.match(m["name"]):
                bad.append(f"metric name {m['name']!r}")
        for c in s["configs"]:
            if not (self.root / c["file"]).is_file():
                bad.append(f"config {c['name']}: no file {c['file']}")
        for cell in s["workloads"]:
            for key in ("name", "config", "traffic"):
                if not NAME.match(cell[key]):
                    bad.append(f"cell {cell['name']}: {key} {cell[key]!r}")
            if cell["config"] not in self.configs:
                bad.append(f"cell {cell['name']}: unknown config {cell['config']}")
                continue
            try:
                traffic = self.traffic(cell)
                self.runner(traffic["kind"])
                self.limits(cell)
                self.config(cell)
            except (OSError, KeyError, ValueError) as e:
                bad.append(f"cell {cell['name']}: {type(e).__name__}: {e}")
            names = {m["name"] for m in self.end_to_end(cell)}
            if "setup_s" not in names or len(names) < 2:
                bad.append(f"cell {cell['name']}: needs setup_s and another end-to-end metric")
            if not self.per_layer(cell):
                bad.append(f"cell {cell['name']}: no per-layer metric")
        for m in s["per_layer"]:
            try:
                r = self.reader(m["name"])
            except (OSError, SyntaxError) as e:
                bad.append(f"metric {m['name']}: {e}")
                continue
            for attr, key in (("LAYER", "layer"), ("UNIT", "unit"), ("MOVES", "moves")):
                if getattr(r, attr, None) != m[key]:
                    bad.append(f"metric {m['name']}: {attr} {getattr(r, attr, None)!r} != {m[key]!r}")
        return bad


# ------------------------------------------------------------- the program's config


def set_dotted(raw: dict, dotted: str, value) -> None:
    node = raw
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def port_config(root: Path, config: dict, workdir: str):
    """The program's ``Config``: the configuration's yaml with its
    overrides, logs and checkpoints under ``workdir``."""
    import yaml

    from llm_speech_summarization_tpu_torch.configs import load_config

    with open(root / config["yaml"]) as f:
        raw = yaml.safe_load(f)
    for dotted, value in config.get("overrides", {}).items():
        set_dotted(raw, dotted, value)
    set_dotted(raw, "log.checkpoint_dir", os.path.join(workdir, "checkpoints"))
    set_dotted(raw, "log.log_dir", os.path.join(workdir, "logs"))
    return load_config(raw)


def check_program(config: dict, llm_cfg, enc_cfg, prefix_ids, suffix_ids, cfg) -> None:
    """Raise where the program would run another model than the
    configuration file states (sizes, template tokens, training losses)."""
    c, ec = config["llm"], config["encoder"]
    want = {"vocab_size": c["vocab_size"], "hidden_size": c["hidden_size"],
            "intermediate_size": c["intermediate_size"], "num_layers": c["num_hidden_layers"],
            "num_heads": c["num_attention_heads"], "num_kv_heads": c["num_key_value_heads"],
            "head_dim": c["head_dim"], "rms_eps": c["rms_norm_eps"], "rope_theta": c["rope_theta"],
            "tie_embeddings": c["tie_word_embeddings"]}
    got = {k: getattr(llm_cfg, k) for k in want}
    if llm_cfg.rope_scaling is not None:
        got["rope_scaling"] = str(llm_cfg.rope_scaling)
    enc_want = {"hidden_size": ec["hidden_size"], "num_layers": ec["num_layers"],
                "num_heads": ec["num_heads"], "layer_norm_eps": ec["eps"]}
    enc_got = {"hidden_size": getattr(enc_cfg, "hidden_size", getattr(enc_cfg, "d_model", None)),
               "num_layers": enc_cfg.num_layers, "num_heads": enc_cfg.num_heads,
               "layer_norm_eps": enc_cfg.layer_norm_eps}
    tpl = config["template"]
    ids = {"prefix": [tpl["bos_id"]] + list(tpl["prefix"].encode()),
           "suffix": list(tpl["suffix"].encode())}
    prog_ids = {"prefix": [int(i) for i in prefix_ids], "suffix": [int(i) for i in suffix_ids]}
    tr = config["train"]
    t = cfg.train
    train_got = {"ntp": t.ntp_loss_weight, "ld": t.ld_loss_weight, "fd": t.fd_loss_weight,
                 "layers": list(t.fd_loss_connector_layers), "lr": t.optimizer.lr,
                 "b1": t.optimizer.beta1, "b2": t.optimizer.beta2, "wd": t.optimizer.weight_decay,
                 "use_ld": t.use_ld_loss, "use_fd": t.use_fd_loss, "batch": t.batch_size,
                 "cache": cfg.model.kv_cache_dtype, "param": cfg.model.param_dtype,
                 "compute": cfg.model.compute_dtype}
    train_want = {"ntp": tr["ntp_loss_weight"], "ld": tr["ld_loss_weight"],
                  "fd": tr["fd_loss_weight"], "layers": tr["fd_loss_connector_layers"],
                  "lr": tr["optimizer"]["lr"], "b1": tr["optimizer"]["beta1"],
                  "b2": tr["optimizer"]["beta2"], "wd": tr["optimizer"]["weight_decay"],
                  "use_ld": tr["use_ld_loss"], "use_fd": tr["use_fd_loss"],
                  "batch": tr["batch_size"], "cache": config["dtypes"]["kv_cache"],
                  "param": config["dtypes"]["param"], "compute": config["dtypes"]["compute"]}
    for what, g, w in (("decoder", got, want), ("encoder", enc_got, enc_want),
                       ("template ids", prog_ids, ids), ("training", train_got, train_want)):
        if g != w:
            diff = {k: (g.get(k), w.get(k)) for k in set(g) | set(w) if g.get(k) != w.get(k)}
            raise RuntimeError(f"the program's {what} differs from {config['name']}.json: "
                               f"{diff} (program, file)")


# ------------------------------------------------------------- running a cell


@dataclass
class Ctx:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    workdir: str
    faults: tuple = ()  # faults planted by the tests and the calibration script


@dataclass
class Outcome:
    """What a runner hands back."""

    e2e: Dict[str, float]
    checks: List[tuple]  # (name, value, limit): correct needs value <= limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    run: Any = None  # what the per-layer readers read
    readings: Dict[str, float] = field(default_factory=dict)  # every number compared


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def device_info(dev, peak: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, faults: tuple = ()) -> dict:
    """Run one cell once; the result line as a dict (``checks`` last)."""
    import tempfile

    import torch

    cell = bench.cells[name]
    traffic = bench.traffic(cell)
    ctx = Ctx(bench.root, cell, bench.config(cell), traffic, bench.limits(cell), int(seed),
              float(seconds), bool(trace), torch.device(device),
              t_start if t_start is not None else time.perf_counter(),
              tempfile.mkdtemp(prefix="portbench-"), tuple(faults))
    try:
        out = bench.runner(traffic["kind"]).run(ctx)
    finally:
        shutil.rmtree(ctx.workdir, ignore_errors=True)
    metrics = {}
    if trace:
        for m in bench.per_layer(cell):
            v = bench.reader(m["name"]).read(out.run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell):
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    correct = out.failed == 0 and all(v <= lim for _, v, lim in out.checks)
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device_info(ctx.device, out.memory_peak_bytes)}
    if trace and out.run is not None and out.run.summary is not None:
        sm = out.run.summary
        line["device"]["busy_s"] = sm.busy_s
        line["device"]["window_s"] = sm.window_s
        line["breakdown"] = {"device_ops": [[n, s] for n, s in sm.device_ops],
                             "idle_gaps": [[n, s] for n, s in sm.idle_gaps]}
    line["readings"] = out.readings
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line
