"""A run of each kind at the tiny presets on the CPU, with the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath (a step that leaves its state unchanged, half of each batch
left out, a served token altered where it is produced) and with the
control (the reference in float8 put in the program's place), it does not.
One chip, so no exchange between chips to leave out."""

import pytest
import torch

from portbench.core import Bench, run_cell

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    from portbench.tests.conftest import make_tiny

    torch.set_num_threads(4)
    return Bench(make_tiny(tmp_path_factory.mktemp("tiny") / "checkout"))


CASES = [
    ("tiny_hubert.tiny_train", (), True),
    ("tiny_hubert.tiny_train", ("frozen",), False),
    ("tiny_hubert.tiny_train", ("half",), False),
    ("tiny_hubert.tiny_bulk", (), True),
    ("tiny_hubert.tiny_bulk", ("token",), False),
    ("tiny_hubert.tiny_bulk", ("half",), False),
    ("tiny_whisper.tiny_bulk", (), True),
    ("tiny_whisper.tiny_bulk", ("token",), False),
]


@pytest.mark.parametrize("cell,faults,correct", CASES)
def test_correct_comes_out_false_under_each_fault(bench, cell, faults, correct):
    line = run_cell(bench, cell, SEED, 0.3, False, "cpu", faults=faults)
    assert line["correct"] is correct, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in bench.end_to_end(bench.cells[cell])}


@pytest.mark.parametrize("cell", ["tiny_hubert.tiny_train", "tiny_hubert.tiny_bulk"])
def test_the_control_fails_a_limit(bench, cell):
    # the reference in float8 in the program's place, through the same checks
    line = run_cell(bench, cell, SEED + 1, 0.3, False, "cpu", faults=("control",))
    assert line["readings"]["control"] is True
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_traced_run_reads_its_layers(bench):
    line = run_cell(bench, "tiny_hubert.tiny_bulk", SEED, 0.3, True, "cpu")
    # no card: the device metrics find nothing to read and are left out
    assert set(line["metrics"]) == {"decode_ms_per_step.bulk", "mfu.bulk"}
    assert line["device"]["window_s"] > 0 and "breakdown" in line
