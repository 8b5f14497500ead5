"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root,
`configs/<config>.json`, `traffic/<traffic>.json` and `metrics/<metric>.py`
beside this package. A later change adds a configuration, a traffic mix or
a metric by adding files and manifest entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def load_metric(name: str, bench_dir: str = BENCH_DIR):
    """The reader module of one per-layer metric, `metrics/<name>.py` (a name
    may hold dots, so it is loaded by path)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic and the
    metrics it reports."""

    def __init__(self, manifest: dict, workload: str, bench_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        self.config = load_json("configs", self.workload["config"], bench_dir)
        self.traffic = load_json("traffic", self.workload["traffic"], bench_dir)
        # The limits of the comparison that decides `correct`, per cell.
        self.limits = load_json("limits", workload, bench_dir)
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m, manifest)]
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m, manifest)]
        self.readers = {m["name"]: load_metric(m["name"], bench_dir) for m in self.per_layer}

    def _reports(self, metric: dict, manifest: dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:
            # Without a workloads key: every cell that reports the metric it moves.
            e2e = {m["name"]: m for m in manifest["end_to_end"]}
            return self._reports(e2e[metric["moves"]], manifest)
        return True

    def spans(self) -> list:
        out = []
        for mod in self.readers.values():
            out += list(getattr(mod, "SPANS", []))
        return out
