"""BENCHMARK.json keeps to the contract's names and finds every file it
names; nothing in the harness names a cell."""
import json
import os
import re

import pytest

from perfbench.core.manifest import BENCH_DIR, ROOT, Cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def manifest():
    return load_manifest(ROOT)


def test_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    assert len(set(names)) == len(names)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(x["layer"]) and x["moves"] in e2e
    for word in m["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in load_manifest(ROOT)["workloads"]])
def test_every_cell_resolves(workload):
    m = manifest()
    cell = Cell(m, workload)
    reported = {x["name"] for x in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for x in cell.per_layer:
        assert x["moves"] in reported  # every cell that reports it reports what it moves
        assert hasattr(cell.readers[x["name"]], "read")
    assert set(cell.limits) - {"readings"}


def test_roofline_and_mfu_names():
    for x in manifest()["per_layer"]:
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_harness_names_no_cell():
    """The general code finds cells by name only: no workload, configuration
    or traffic name appears in it."""
    m = manifest()
    names = {w["name"] for w in m["workloads"]} | {c["name"] for c in m["configs"]}
    names |= {w["traffic"] for w in m["workloads"]}
    for sub in ("core", "cost"):
        for f in os.listdir(os.path.join(BENCH_DIR, sub)):
            if f.endswith(".py"):
                text = open(os.path.join(BENCH_DIR, sub, f)).read()
                for n in names:
                    assert f'"{n}"' not in text and f"'{n}'" not in text, (f, n)
