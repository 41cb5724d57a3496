"""On the card, at each cell's own size: the control (the reference put in
the program's place, computed in float8, the precision below the
configuration's bfloat16) fails one of the cell's limits on three seeds,
while the program on the same seeds passes them all. The benchmark's own
runs do not run this (``python -m pytest portbench/tests -m cuda``)."""

import gc
import json

import pytest
import torch

from portbench.core import Bench, run_cell
from portbench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    bench = Bench(REPO)
    for seed in SEEDS:
        line = _run(bench, cell, seed, card)
        assert line["correct"], (seed, line["checks"])
        line = _run(bench, cell, seed, card, ("control",))
        assert line["readings"]["control"] is True
        assert not line["correct"], (seed, line["checks"])


def _run(bench, cell, seed, card, faults=()):
    # each run in this process starts from a card the last one has left
    # empty, as a fresh process's does
    gc.collect()
    torch.cuda.empty_cache()
    return run_cell(bench, cell, seed, 5, False, card, faults=faults)
