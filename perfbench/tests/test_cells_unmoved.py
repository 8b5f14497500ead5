"""What a configuration may now ask for (preset overrides, a seeded env2, a
serve stage) leaves the cells that ask for none of it as they were: the same
preset on both sides, the same inputs bit for bit, and a request that no
side can serve refused when the Cell is built."""
import dataclasses
import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

from perfbench.core.cell import Run
from perfbench.core.manifest import BENCH_DIR, ROOT, Cell, load_json, load_manifest
from perfbench.core.system import PRESET_GROUPS, PROGRAM, REFERENCE, Side
from perfbench.tests.tiny import tiny

M = load_manifest(ROOT)

# sha256 (first 16 hex digits) of make_scene's output at each cell's tiny
# size and seed 2**31 + 12345 on the CPU, over SCENE_FIELDS in order: each
# tensor or array as its dtype, shape and raw bytes, lists and dicts (sorted
# keys) element by element, cameras field by field, numbers by repr. Taken
# with `digest` below at the commit before configurations could seed env2
# (torch 2.13.0+cpu, numpy 2.0.2; the same at 1, 2 and 4 threads).
SCENE_FIELDS = ("main", "main_alive", "env1", "env", "env_alive", "mesh", "train", "test", "images", "masks",
                "normal_priors", "ref_score_masks", "nearest_ids", "cameras_extent")
PARENT_DIGESTS = {
    "refnerf.surfel2_warp": "a68b84b89264797f",
    "refnerf.serve": "c8dda941a9cad542",
    "refreal.surfel_warp": "6f2522e1fb022b08",
}


def _feed(h, x):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        h.update(f"{x.dtype}{x.shape}".encode())
        h.update(x.tobytes())
    elif isinstance(x, dict):
        for k in sorted(x):
            h.update(k.encode())
            _feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for v in x:
            _feed(h, v)
        h.update(b"]")
    elif dataclasses.is_dataclass(x):
        _feed(h, {f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    else:
        h.update(repr(x).encode())


def digest(scene) -> str:
    h = hashlib.sha256()
    for name in SCENE_FIELDS:
        h.update(name.encode())
        _feed(h, getattr(scene, name))
    return h.hexdigest()[:16]


@pytest.mark.parametrize("workload", sorted(PARENT_DIGESTS))
def test_scene_inputs_bit_for_bit(workload):
    cell = Cell(M, workload)
    run = Run(cell, 2**31 + 12345, 0.0, False, "cpu", time.perf_counter(), tiny(cell))
    scene = run.scene()
    assert scene.env2 is None
    assert digest(scene) == PARENT_DIGESTS[workload]


@pytest.mark.parametrize("package", [PROGRAM, REFERENCE])
@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_preset_is_the_preset_but_for_its_overrides(config, package):
    cfg = load_json("configs", config)
    side = Side(package)
    plain = getattr(side.config, f"preset_{cfg['preset']}")()
    over = cfg.get("preset_overrides", {})
    for key, mine, theirs in zip(PRESET_GROUPS, side.preset(cfg), plain):
        assert type(mine) is type(theirs)
        moved = {f.name for f in dataclasses.fields(mine) if getattr(mine, f.name) != getattr(theirs, f.name)}
        assert moved <= set(over.get(key, {}))
        if not over:
            assert mine == theirs


@pytest.mark.parametrize("change,named", [
    ({"preset_overrides": {"opt": {"volume_render_until_itr": 18000}}}, "volume_render_until_itr"),
    ({"preset_overrides": {"optimizer": {"iterations": 1}}}, "optimizer"),
    ({"assumed": {"env2": "flat"}}, "env2"),
    ({"stage": "surfel3"}, "surfel3"),
], ids=["field", "group", "env2", "stage"])
def test_unservable_request_fails_at_cell(tmp_path, change, named):
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "reference", "tests"))
    cfg = load_json("configs", "refnerf")
    traffic = load_json("traffic", "test_orbit")
    if "stage" in change:
        traffic.update(change)
    elif "assumed" in change:
        cfg["assumed"].update(change["assumed"])
    else:
        cfg.update(change)
    (bench / "configs" / "refnerf.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "test_orbit.json").write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match=named):
        Cell(M, "refnerf.serve", bench_dir=str(bench))
