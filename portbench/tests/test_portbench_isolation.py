"""What a run imports: each cell's runner (with the harness, the metric
readers and the program they drive) loads neither JAX nor the JAX package,
and the reference loads nothing of the program either. Top-level module
names are compared whole, since the port's name begins with the JAX
package's."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
what = {what!r}
if what == "reference":
    import portbench.reference.model, portbench.reference.kd
else:
    from portbench.core import Bench
    bench = Bench()
    cell = bench.cells[what]
    bench.runner(bench.traffic(cell)["kind"])
    for m in bench.per_layer(cell):
        bench.reader(m["name"])
    import llm_speech_summarization_tpu_torch.infer.engine
    import llm_speech_summarization_tpu_torch.train.trainer
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def top_level(what: str):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(REPO), what=what)],
                         capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("what", CELLS + ["reference"])
def test_no_jax_and_a_standalone_reference(what):
    names = top_level(what)
    assert not names & {"jax", "jaxlib", "flax", "llm_speech_summarization_tpu"}, names
    if what == "reference":
        assert "llm_speech_summarization_tpu_torch" not in names
    else:
        assert "llm_speech_summarization_tpu_torch" in names


def test_the_check_compares_whole_names():
    from portbench.core import FORBIDDEN, forbidden_modules

    assert "llm_speech_summarization_tpu" in FORBIDDEN
    sys.modules.setdefault("llm_speech_summarization_tpu_torch_lookalike", sys)
    try:
        assert "llm_speech_summarization_tpu" not in forbidden_modules()
    finally:
        sys.modules.pop("llm_speech_summarization_tpu_torch_lookalike", None)
