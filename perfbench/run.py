"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`); its
per-layer metrics are read by `metrics/<name>.py` in a traced run; its
comparison limits are `limits/<workload>.json`. The run makes every input
from the seed on the card, warms up (set-up), measures for `--seconds`,
then compares what the timed path produced with the plain reference
(`reference/`) and prints one JSON line last on standard output, with the
compared numbers beside their limits as the last lines on standard error.
It needs a CUDA card and the program (`materialrefgs_torch`) beside this
folder, and fails without them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "materialrefgs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment():
    """Build caches at fixed paths inside the checkout (the program's nvcc
    libraries go to its own build/kernels there), and the checkout on the
    import path."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def result_line(run, device_name: str, count: int) -> dict:
    from perfbench.core.compare import correct

    device = {"platform": "gpu", "kind": device_name, "count": count, "memory_peak_bytes": run.peak_bytes}
    if run.trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.window_s
    out = {
        "correct": correct(run.checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in run.metrics.items()},
        "device": device,
    }
    if run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()

    import torch

    from perfbench.core.cell import run_cell
    from perfbench.core.manifest import Cell, load_manifest

    cell = Cell(load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"error: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(run, torch.cuda.get_device_name(0), cell.chips)
    print(f"card: {power_limit()}", file=sys.stderr)
    print("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in run.phases.items()), file=sys.stderr)
    for name, v, lim in run.checks:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
