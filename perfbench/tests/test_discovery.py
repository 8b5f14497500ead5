"""A configuration, a traffic mix, a limit file and a per-layer metric added
under new names are found by the harness with no edit of its code; so is a
cell at another curriculum stage, which its configuration and mix ask for
by their keys alone."""
import json
import os
import shutil
import time

import pytest
import torch

from perfbench.core import faults, scene as scenemod
from perfbench.core.cell import run_cell
from perfbench.core.compare import correct
from perfbench.core.manifest import BENCH_DIR, ROOT, Cell, load_manifest
from perfbench.core.system import PROGRAM, REFERENCE, Side
from perfbench.tests.tiny import tiny


def test_new_cell_and_metric_found_from_files_alone(tmp_path):
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "reference", "tests"))
    cfg = json.load(open(os.path.join(BENCH_DIR, "configs", "refnerf.json")))
    cfg["name"] = "dummy_model"
    (bench / "configs" / "dummy_model.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps({"kind": "serve", "warmup_views": 1}))
    (bench / "limits" / "dummy_model.dummy_mix.json").write_text(json.dumps({"image_gap_levels": 0}))
    (bench / "metrics" / "dummy_count.serve.py").write_text(
        'SPANS = [("materialrefgs_torch.render.envgs", "render_surfel2", "dummy.render")]\n\n\n'
        "def read(t):\n    return t.counts.get('views')\n")
    m = load_manifest(ROOT)
    m["configs"].append({"name": "dummy_model", "source": "x", "file": "perfbench/configs/dummy_model.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "dummy_model.dummy_mix", "config": "dummy_model", "traffic": "dummy_mix",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "dummy_count.serve", "unit": "views", "better": "higher",
                           "source": "program_counter", "layer": "evaluate (serve loop)",
                           "moves": "serve_views_per_s", "workloads": ["dummy_model.dummy_mix"]})
    for e in m["end_to_end"]:
        if "workloads" in e and "refnerf.serve" in e["workloads"]:
            e["workloads"].append("dummy_model.dummy_mix")
    cell = Cell(m, "dummy_model.dummy_mix", bench_dir=str(bench))
    assert cell.config["name"] == "dummy_model" and cell.traffic["kind"] == "serve"
    assert [x["name"] for x in cell.per_layer] == ["dummy_count.serve"]
    assert ("materialrefgs_torch.render.envgs", "render_surfel2", "dummy.render") in cell.spans()

    class View:
        counts = {"views": 7}

    assert cell.readers["dummy_count.serve"].read(View()) == 7
    # The cells already there do not see the new metric.
    assert "dummy_count.serve" not in {x["name"] for x in Cell(m, "refnerf.serve", bench_dir=str(bench)).per_layer}


# A made-up configuration that asks for everything a volume-stage cell needs
# from files alone: a preset field overridden (the volume stage runs to
# 18,000, the reference's own default), env2 seeded, and its own CPU size.
VOLUME_CONFIG = {
    "name": "dummy_volume", "preset": "glossy", "width": 800, "height": 800,
    "camera_angle_x": 0.6911112070083618, "camera_radius": 4.0311288741492746, "train_views": 100,
    "test_views": 200, "test_elevation_deg": 30.0, "sh_degree": 3, "envmap_res": 128, "capacity": 524288,
    "white_background": True, "camera_model": "blender",
    "preset_overrides": {"opt": {"volume_render_until_iter": 18000}},
    "assumed": {"main_splats": 150000, "pair_capacity": 1 << 24, "env2": "seeded"},
    "tiny": {"width": 40, "height": 40, "train_views": 12, "test_views": 3, "capacity": 4096, "envmap_res": 16,
             "assumed": {"main_splats": 1500, "pair_capacity": 1 << 16}},
}
VOLUME_MIXES = {
    "dummy_vol_train": {"kind": "train", "start_iteration": 16001, "compared_steps": 2, "trainer_seed": 7,
                        "cost_views": 1, "loss_inputs": ["masks"]},
    "dummy_vol_serve": {"kind": "serve", "stage": "volume", "warmup_views": 1, "compared_views": 2,
                        "cost_views": 1, "tail_percentile": 88},
    "dummy_surfel_serve": {"kind": "serve", "stage": "surfel", "warmup_views": 1, "compared_views": 2,
                           "cost_views": 1, "tail_percentile": 88},
}
ZERO = {"train": {"loss_gap": 0, "grad_gap": 0, "change_gap": 0, "view_mismatch": 0},
        "serve": {"image_gap_levels": 0}}


@pytest.fixture
def volume_cells(tmp_path):
    """The made-up configuration with its three mixes as cells of a copy of
    the benchmark, every per-layer metric of their kind listing them; the
    limits are 0, since the CPU runs the program's plain versions."""
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "reference", "tests"))
    (bench / "configs" / "dummy_volume.json").write_text(json.dumps(VOLUME_CONFIG))
    m = load_manifest(ROOT)
    m["configs"].append({"name": "dummy_volume", "source": "x", "file": "perfbench/configs/dummy_volume.json",
                         "reduced": [], "why": "x"})
    for mix, traffic in VOLUME_MIXES.items():
        name = f"dummy_volume.{mix}"
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        (bench / "limits" / f"{name}.json").write_text(json.dumps(ZERO[traffic["kind"]]))
        m["workloads"].append({"name": name, "config": "dummy_volume", "traffic": mix, "chips": 1, "why": "x"})
        moves = "train_step_s" if traffic["kind"] == "train" else "serve_views_per_s"
        for x in m["end_to_end"] + m["per_layer"]:
            if x["name"] in (moves, "serve_p88_ms") or x.get("moves") == moves:
                x["workloads"].append(name)
    return {mix: Cell(m, f"dummy_volume.{mix}", bench_dir=str(bench)) for mix in VOLUME_MIXES}


def _run(cell, trace=False, seed=2**31 + 4321):
    torch.set_num_threads(2)
    return run_cell(cell, seed, 0.3, trace, "cpu", time.perf_counter(), tiny(cell))


def _all_zero(run):
    return all(v == 0 for _, v, _ in run.checks)


@pytest.mark.parametrize("trace", [0, 1])
def test_volume_train_mix_from_files(volume_cells, trace):
    cell = volume_cells["dummy_vol_train"]
    run = _run(cell, bool(trace))
    assert _all_zero(run), run.checks
    start = cell.traffic["start_iteration"]
    for package in (PROGRAM, REFERENCE):
        side = Side(package)
        opt = side.preset(run.cfg)[2]
        last = start + cell.traffic["compared_steps"] + run.attempted
        assert {side.trainer.select_stage(it, opt) for it in range(start, last + 1)} == {"volume"}
    if trace:
        for name, (value, unit) in run.metrics.items():
            assert unit != "%" or 0 < value <= 100, name
    # env2 is drawn after every draw there was before it.
    flat = {**run.cfg, "assumed": {k: v for k, v in run.cfg["assumed"].items() if k != "env2"}}
    seeded, plain = (scenemod.make_scene(c, cell.traffic, 5, "cpu") for c in (run.cfg, flat))
    assert plain.env2 is None and seeded.env2.shape == seeded.env1.shape
    assert torch.equal(seeded.env1, plain.env1)
    assert all(torch.equal(seeded.main[k], plain.main[k]) for k in plain.main)


@pytest.mark.parametrize("mix,renderer", [("dummy_vol_serve", "render_volume"),
                                          ("dummy_surfel_serve", "render_surfel")])
def test_serve_stage_from_files(volume_cells, monkeypatch, mix, renderer):
    calls = {name: 0 for name in ("render_initial", "render_volume", "render_surfel")}
    side = Side(PROGRAM)
    for name in calls:
        def counted(*a, _real=getattr(side.renderers, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(side.renderers, name, counted)
    monkeypatch.setattr(side.envgs, "render_surfel2", None)  # a surfel2 render would raise
    cell = volume_cells[mix]
    run = _run(cell)
    assert _all_zero(run), run.checks
    assert calls.pop(renderer) == cell.traffic["warmup_views"] + run.attempted
    assert not any(calls.values())


@pytest.mark.parametrize("mix,fault", [("dummy_vol_train", faults.unchanged_state),
                                       ("dummy_vol_serve", faults.altered_pixel),
                                       ("dummy_surfel_serve", faults.half_view)],
                         ids=["volume_train-unchanged_state", "volume_serve-altered_pixel",
                              "surfel_serve-half_view"])
def test_fault_fails_a_stage_from_files(volume_cells, monkeypatch, mix, fault):
    fault(monkeypatch.setattr)
    assert not correct(_run(volume_cells[mix], seed=2**31 + 777).checks)


def test_tiny_comes_from_the_configuration(volume_cells):
    cell = volume_cells["dummy_vol_train"]
    assert tiny(cell) == {"config": VOLUME_CONFIG["tiny"]}
    del cell.config["tiny"]
    with pytest.raises(ValueError, match='"tiny"'):
        tiny(cell)
