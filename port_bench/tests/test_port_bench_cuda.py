"""On the card: the control of each cell fails its limits.

The control is the plain reference computed in TF32 (the precision below the
configured float32) in the program's place, at the cell's own size; the
comparison of ``correct`` has to catch it. Run on the machine with the card:

    python3 -m pytest port_bench/tests -m cuda -q
"""

import json

import pytest

import tiny
from benchlib import compare
from benchlib.manifest import Manifest

pytestmark = pytest.mark.cuda

with open(f"{tiny.ROOT}/BENCHMARK.json") as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    import calibrate

    man = Manifest(tiny.ROOT)
    limits = man.limits(man.cell(cell))
    for row in calibrate.readings(cell, [2**31 + 5], ["program", "tf32"], emit=lambda s: None):
        judged = compare.judge(row["numbers"], limits)
        assert judged == (row["variant"] == "program"), row
