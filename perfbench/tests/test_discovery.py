"""A configuration, a traffic mix, a limit file and a per-layer metric added
under new names are found by the harness with no edit of its code."""
import json
import os
import shutil

from perfbench.core.manifest import BENCH_DIR, ROOT, Cell, load_manifest


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
