"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric are added as files, and the harness lists and
validates the new cell with no file edited. The traffic is a function of
the seed, and a run writes only inside its checkout and the HOME,
XDG_CACHE_HOME and TMPDIR it is given."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import gen
from portbench.core import Bench
from portbench.tests.conftest import REPO, make_tiny


def _files(root: Path):
    return {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and
            "__pycache__" not in p.parts}


def test_the_benchmark_validates():
    assert Bench(REPO).validate() == []


def test_a_cell_added_as_files(tmp_path):
    root = make_tiny(tmp_path / "checkout")
    before = _files(root / "portbench")
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny_hubert.json").read_text())
    cfg["name"] = "tiny_hubert_b"
    (pb / "configs" / "tiny_hubert_b.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "tiny_bulk.json").read_text())
    traffic["new_tokens"] = 3
    (pb / "traffic" / "tiny_bulk_short.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "answered.bulk.py").write_text(
        'LAYER = "engine prompt build"\nUNIT = "utt"\nMOVES = "utt_per_s"\n\n\n'
        'def read(run):\n    return len(run.utterances)\n')
    name = "tiny_hubert_b.tiny_bulk_short"
    (pb / "limits" / f"{name}.json").write_text(json.dumps({"served_logit_gap": {"limit": 0.1}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_hubert_b", "source": "https://example.org/b",
                             "file": "portbench/configs/tiny_hubert_b.json", "reduced": [],
                             "why": "added"})
    bench["workloads"].append({"name": name, "config": "tiny_hubert_b",
                               "traffic": "tiny_bulk_short", "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if m["name"] == "utt_per_s":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "answered.bulk", "unit": "utt", "better": "higher",
                               "source": "program_counter", "layer": "engine prompt build",
                               "moves": "utt_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = Bench(root)
    assert b.validate() == []
    assert name in b.cells
    assert b.traffic(b.cells[name])["new_tokens"] == 3
    assert [m["name"] for m in b.per_layer(b.cells[name])] == ["answered.bulk"]
    after = _files(root / "portbench")
    assert all(after[p] == data for p, data in before.items())  # nothing edited

    # a metric whose declared unit disagrees with BENCHMARK.json is caught
    (pb / "metrics" / "answered.bulk.py").write_text(
        'LAYER = "engine prompt build"\nUNIT = "ms"\nMOVES = "utt_per_s"\n\n\n'
        'def read(run):\n    return 1.0\n')
    assert any("answered.bulk" in p for p in Bench(root).validate())


@pytest.mark.parametrize("mix", ["train_kd", "bulk", "bulk_long"])
def test_traffic_is_a_function_of_the_seed(mix):
    t = json.loads((REPO / "portbench" / "traffic" / f"{mix}.json").read_text())
    seed = 2 ** 31 + 12345

    def draw(s, j):
        st = gen.Stream(t, s, 16000, 49216)
        if t["kind"] == "train_kd":
            return st.examples(j)
        return [{"audio": c} for c in st.clips(j)]

    a, b, c = draw(seed, 3), draw(seed, 3), draw(seed + 1, 3)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    # another seed: other waveforms and ids, the same sizes
    assert any(not np.array_equal(x["audio"], y["audio"]) for x, y in zip(a, c))
    assert sorted(len(x["audio"]) for x in a) == sorted(len(x["audio"]) for x in c)
    lo, hi = t["clip_seconds"]
    assert all(lo * 16000 <= len(x["audio"]) <= hi * 16000 for x in a)
    if t["kind"] == "train_kd":
        assert sorted(len(x["response_input_ids"]) for x in a) == \
            sorted(len(x["response_input_ids"]) for x in c)
        assert max(int(x["response_input_ids"].max()) for x in a) < 49216


RUN = r"""
import json, sys
sys.path.insert(0, {repo!r})
from portbench.core import Bench, forbidden_modules, run_cell
line = run_cell(Bench({root!r}), "tiny_hubert.tiny_bulk", 7, 0.3, False, "cpu")
print(json.dumps({{"correct": line["correct"], "forbidden": forbidden_modules()}}))
"""


def test_a_run_writes_only_where_it_may(tmp_path):
    root = make_tiny(tmp_path / "checkout")
    dirs = {k: tmp_path / k.lower() for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR")}
    for d in dirs.values():
        d.mkdir()
    cwd = tmp_path / "elsewhere"
    cwd.mkdir()
    env = dict(os.environ, **{k: str(v) for k, v in dirs.items()}, TORCH_NUM_THREADS="2")
    before = {p for p in tmp_path.rglob("*")}
    out = subprocess.run([sys.executable, "-c", RUN.format(repo=str(REPO), root=str(root))],
                         capture_output=True, text=True, timeout=600, cwd=str(cwd), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": []}
    new = {p for p in tmp_path.rglob("*")} - before
    allowed = [root, *dirs.values()]
    assert all(any(p.is_relative_to(a) for a in allowed) for p in new), sorted(new)
    assert not any(cwd.iterdir())
    assert not any(p.name.startswith("portbench-") for p in dirs["TMPDIR"].iterdir())
