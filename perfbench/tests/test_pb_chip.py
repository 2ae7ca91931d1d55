"""On the card (``python -m pytest perfbench/tests -m chip``): each cell's
control at the cell's own size and load, on three seeds.  The program's
readings stay within the cell's limits and the control's, the reference
at float8, fail at least one of them on every seed."""
import json
from pathlib import Path

import pytest

from perfbench import control

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(card, cell):
    limits = json.loads((ROOT / "perfbench" / "checks" / f"{cell}.json").read_text())
    rows = control.readings(cell, [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303],
                            seconds=6.0, device=card)
    for r in rows:
        assert r["correct"], r
        assert any(v > limits[k] for k, v in r["control"].items() if k in limits), r
