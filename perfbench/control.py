"""The readings that the comparison's limits are set from, at a cell's own
size on the card, for a list of seeds:

    python3 perfbench/control.py --workload <name> --seeds 11 12 13 [--fault half_batch ...]

For each seed it prints one JSON line with the control's numbers: the plain
reference computed with TF32 on (the configuration states float32 with TF32
off; TF32 is the step below it) put in the program's place and compared with
the reference as the program is, the program's own numbers for the same
seed, and with --fault those of the program with that fault
(core/faults.py) planted (no measured window: the compared steps or views
only). The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def readings(cell, seed: int, device, overrides: dict | None = None, faults=()) -> dict:
    """{"control": {check: value}, "program": {...}, "fault:<name>": {...}}
    for one seed."""
    import time

    import numpy as np
    import torch

    from perfbench.core import compare, faults as faultmod
    from perfbench.core.cell import Run, train_readings
    from perfbench.core.system import PROGRAM, REFERENCE, Side, to_uint8, with_tf32

    run = Run(cell, seed, 0.0, False, device, time.perf_counter(), overrides)
    out = {}
    if run.traffic["kind"] == "train":
        ref = train_readings(run, REFERENCE)
        ctl = train_readings(run, REFERENCE, tf32=True)
        out["control"] = compare.train_gaps(ctl, ref)
        out["program"] = compare.train_gaps(train_readings(run, PROGRAM), ref)
        for name in faults:
            patches = faultmod.Patches()
            faultmod.BY_NAME[name](patches.set)
            try:
                out[f"fault:{name}"] = compare.train_gaps(train_readings(run, PROGRAM), ref)
            finally:
                patches.undo()
        return out

    n_views = len(run.scene().test)
    rng = np.random.default_rng(run.seed)
    ids = sorted(int(i) for i in rng.choice(n_views, size=min(int(run.traffic["compared_views"]), n_views),
                                            replace=False))

    def images(package, tf32):
        side = Side(package)
        with with_tf32(tf32), torch.no_grad():
            srv = side.server_for(run.cfg, run.traffic, run.scene(), run.device)
            imgs = {i: to_uint8(side.serve_view(srv, i)[0]["render"]).cpu() for i in ids}
        del srv
        run.free()
        return imgs

    ref = images(REFERENCE, False)
    out["control"] = {"image_gap_levels": compare.image_gap(images(REFERENCE, True), ref)}
    out["program"] = {"image_gap_levels": compare.image_gap(images(PROGRAM, False), ref)}
    for name in faults:
        patches = faultmod.Patches()
        faultmod.BY_NAME[name](patches.set)
        try:
            out[f"fault:{name}"] = {"image_gap_levels": compare.image_gap(images(PROGRAM, False), ref)}
        finally:
            patches.undo()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.run import set_environment

    set_environment()
    import torch

    from perfbench.core.manifest import Cell, load_manifest

    cell = Cell(load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("error: the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, "cuda", faults=args.fault)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
