"""A long side-by-side run of the two packages (slow: minutes).

scripts/train.py (JAX, Pallas in interpret mode) and scripts/train_torch.py
train one scripts/make_synth_scene.py scene (48x48, 1,500 seed points) on
the CPU from seed 3407 for 200 iterations of refnerf's curriculum at x0.01,
with a volume stage: initial 1-30, volume 31-60, surfel 61-150 and surfel2
151-200 (env-GS, mesh visibility on a 32^3 TSDF), with the compressed
densification, the opacity and normal-propagation resets (dist_color after
the volume stage) and the volume -> surfel re-init. One-step parity
(tests/test_torch_train*.py) cannot see drift across these; this run can. The two runs draw their
random numbers from different generators (view order, split noise, the
re-init), so they are held statistically, by a criterion fixed before the
first run:

- each stage's mean training loss within 5 % (relative) of the other's;
- the test PSNR at every stage's end (30, 60, 150, 200) within 0.5 dB.

Run it with `python -m pytest tests/test_torch_long_run.py -m slow -s`;
it prints the per-stage table."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_ENDS = {"initial": 30, "volume": 60, "surfel": 150, "surfel2": 200}
LOSS_RTOL = 0.05
PSNR_ATOL = 0.5


def _stage(it: int) -> str:
    for name, end in STAGE_ENDS.items():
        if it <= end:
            return name
    raise ValueError(it)


@pytest.mark.slow
def test_long_run_tracks_jax(tmp_path, monkeypatch):
    import importlib.util

    scene = str(tmp_path / "scene")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_scene.py"), "--out", scene,
                    "--res", "48", "--n_train", "8", "--n_test", "2", "--n_points", "1500", "--spp", "1"],
                   check=True)
    flags = ["-s", scene, "--schedule_scale", "0.01", "--iterations", str(STAGE_ENDS["surfel2"]),
             "--volume_render_until_iter", str(STAGE_ENDS["volume"]),
             "--indirect_from_iter", str(STAGE_ENDS["surfel"]), "--capacity", str(1 << 12),
             "--pair_capacity", str(1 << 16), "--tracer_pair_capacity", str(1 << 18), "--mesh_every", "1000",
             "--envmap_max_res", "16", "--test_iterations", *map(str, STAGE_ENDS.values()), "--log_every", "1",
             "--device", "cpu", "--seed", "3407"]

    # The JAX run: its Trainer extracts the onset mesh on a 32^3 grid, as
    # the port's does below.
    from materialrefgs_tpu.train import trainer as jtr

    init = jtr.Trainer.__init__

    def small_mesh_init(self, *a, **kw):
        kw["mesh_resolution"] = 32
        init(self, *a, **kw)

    monkeypatch.setattr(jtr.Trainer, "__init__", small_mesh_init)
    spec = importlib.util.spec_from_file_location("jax_train", os.path.join(REPO, "scripts", "train.py"))
    jax_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_train)
    jrun = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["train.py", "-m", jrun, *flags])
    jax_train.main()

    from materialrefgs_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "MESH_RESOLUTION", 32)
    spec = importlib.util.spec_from_file_location("train_torch", os.path.join(REPO, "scripts", "train_torch.py"))
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    trun = str(tmp_path / "torch")
    train_torch.main(["-m", trun, *flags])

    runs = {}
    for side, path in (("jax", jrun), ("torch", trun)):
        with open(os.path.join(path, "train_log.json")) as f:
            log = json.load(f)
        with open(os.path.join(path, "psnr.json")) as f:
            psnr = {e["iteration"]: e["psnr"] for e in json.load(f)}
        losses = {}
        for m in log:
            losses.setdefault(_stage(int(m["iteration"])), []).append(m["loss"])
        runs[side] = {"loss": {k: float(np.mean(v)) for k, v in losses.items()}, "psnr": psnr,
                      "steps": {k: len(v) for k, v in losses.items()}}
    print("\nstage     steps  mean loss JAX  mean loss port  rel diff   test PSNR JAX  port     diff")
    failures = []
    for name, end in STAGE_ENDS.items():
        lj, lt = runs["jax"]["loss"][name], runs["torch"]["loss"][name]
        pj, pt = runs["jax"]["psnr"][end], runs["torch"]["psnr"][end]
        rel = abs(lt - lj) / abs(lj)
        print(f"{name:9s} {runs['torch']['steps'][name]:5d}  {lj:13.6f}  {lt:14.6f}  {rel:8.4f}   {pj:13.3f}  "
              f"{pt:7.3f}  {pt - pj:+.3f}")
        assert runs["jax"]["steps"][name] == runs["torch"]["steps"][name]
        if rel > LOSS_RTOL:
            failures.append(f"{name}: mean loss {lt:.6f} vs {lj:.6f} ({rel:.3f} relative)")
        if abs(pt - pj) > PSNR_ATOL:
            failures.append(f"{name} end ({end}): test PSNR {pt:.3f} vs {pj:.3f} dB")
    assert not failures, "; ".join(failures)
