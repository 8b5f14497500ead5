"""The control on the card: the plain reference with TF32 on, put in the
program's place, fails the comparison (at a size a test run holds; the
readings at each cell's own size are in PERF.md), while the program passes
it on the same seeds. Run on a card with
`python -m pytest -o addopts="" -m gpu perfbench/tests/test_control_gpu.py`."""
import pytest

from perfbench.control import readings
from perfbench.core.manifest import ROOT, Cell, load_manifest
from perfbench.tests.tiny import tiny

M = load_manifest(ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_control_fails_and_program_passes(workload, cuda):
    cell = Cell(M, workload)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = readings(cell, seed, cuda, overrides=tiny(cell))
        assert any(v > cell.limits[k] for k, v in r["control"].items()), r
        assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
