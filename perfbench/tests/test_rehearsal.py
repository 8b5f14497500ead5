"""A CPU rehearsal of run.py's control flow at a tiny size: set-up, the
window, the reference comparison and the result line, for every cell, with
and without the trace. The program's CPU path is its plain versions, so the
comparison reads 0 here; the numbers of a CPU run are no device metrics."""
import json
import time

import pytest
import torch

from perfbench import run as runmod
from perfbench.core.cell import run_cell
from perfbench.core.manifest import ROOT, Cell, load_manifest
from perfbench.tests.tiny import tiny

WORKLOADS = [w["name"] for w in load_manifest(ROOT)["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cpu_rehearsal(workload, trace):
    cell = Cell(load_manifest(ROOT), workload)
    run = run_cell(cell, 2**31 + 12345, 0.5, bool(trace), "cpu", time.perf_counter(), tiny(workload))
    line = json.loads(json.dumps(runmod.result_line(run, "cpu", 1)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        assert names <= {m["name"] for m in cell.per_layer}
        assert "breakdown" in line and line["device"]["window_s"] > 0
        for m, v in line["metrics"].items():
            if "roofline" in m or "mfu" in m:
                assert 0 < v["value"] <= 100
    else:
        assert names == {m["name"] for m in cell.end_to_end}
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]
