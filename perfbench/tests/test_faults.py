"""The run's comparison catches a broken timed path: with the program broken
underneath (and the harness's look for a card skipped: the run is on the
CPU at a tiny size), `correct` comes out false. One case per fault a cell
can have: a step that returns its state unchanged; half of the batch (the
view's rows) left out, the mean taken over the rest; an answer (a served
pixel) altered where it is produced. No cell spans chips, so none can leave
out an exchange between them."""
import time

import pytest
import torch

from perfbench.core.cell import run_cell
from perfbench.core.compare import correct
from perfbench.core.faults import SERVE_FAULTS, TRAIN_FAULTS
from perfbench.core.manifest import ROOT, Cell, load_manifest
from perfbench.tests.tiny import tiny

M = load_manifest(ROOT)
TRAIN = [w["name"] for w in M["workloads"] if Cell(M, w["name"]).traffic["kind"] == "train"]
SERVE = [w["name"] for w in M["workloads"] if Cell(M, w["name"]).traffic["kind"] == "serve"]


CASES = [(w, f) for w in TRAIN for f in TRAIN_FAULTS] + [(w, f) for w in SERVE for f in SERVE_FAULTS]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_fails_the_comparison(workload, fault, monkeypatch):
    torch.set_num_threads(2)
    fault(monkeypatch.setattr)
    run = run_cell(Cell(M, workload), 2**31 + 777, 0.2, False, "cpu", time.perf_counter(), tiny(workload))
    assert not correct(run.checks), run.checks
