"""The port's --detect_anomaly and --deadline_min (the JAX package's
tests/test_anomaly.py and scripts/train.py:87-95, :414-435): a NaN injected
into the parameters stops training with a report naming the nonfinite
gradient groups, a clean run records zero counts for every group, and a
wall-clock deadline stops the training CLI at an iteration boundary with a
checkpoint and the PLYs saved."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig  # noqa: E402
from materialrefgs_torch.train.checkpoint import load_checkpoint  # noqa: E402
from materialrefgs_torch.train.trainer import Trainer  # noqa: E402
from test_torch_train import _load_script, _write_blender_scene  # noqa: E402


def _tiny_trainer(rng, detect_anomaly):
    P, W, H = 32, 24, 24
    pts = rng.normal(size=(P, 3)).astype(np.float32) * 0.4
    cols = rng.uniform(size=(P, 3)).astype(np.float32)
    model = tgm.create_from_points(pts, cols, capacity=64, device="cpu")
    cam = look_at_camera(np.array([0.0, 0.3, -3.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, W, H,
                         device="cpu")
    images = [rng.uniform(size=(H, W, 3)).astype(np.float32)]
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=10_000,
        densify_from_iter=10_000, feature_rest_from_iter=100_000, lambda_normal_render_depth=0.0, lambda_dist=0.0,
    )
    return Trainer(model, [cam], images, opt, tcfg.PipelineParams(),
                   raster_cfg=RasterizeConfig(pair_capacity=1 << 12), envmap_res=16, detect_anomaly=detect_anomaly)


def test_nan_param_raises_named_report():
    trainer = _tiny_trainer(np.random.default_rng(0), detect_anomaly=True)
    with torch.no_grad():
        trainer.state.model.xyz[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="nonfinite") as ei:
        trainer.train(1)
    # The injected xyz NaN poisons the geometry chain; the report names it.
    assert "grad.param.xyz" in str(ei.value) and "iteration 1" in str(ei.value)
    # Without the flag the same step runs on (and records no counts).
    plain = _tiny_trainer(np.random.default_rng(0), detect_anomaly=False)
    with torch.no_grad():
        plain.state.model.xyz[0, 0] = float("nan")
    plain.train(1, log_every=1)
    assert not any(k.startswith("nonfinite/") for k in plain.metrics_log[-1])


def test_clean_run_passes_and_reports_zero():
    trainer = _tiny_trainer(np.random.default_rng(1), detect_anomaly=True)
    trainer.train(2, log_every=1)
    last = trainer.metrics_log[-1]
    nf = {k: v for k, v in last.items() if k.startswith("nonfinite/")}
    assert {"nonfinite/loss", "nonfinite/grad.param.xyz", "nonfinite/grad.env1",
            "nonfinite/grad.screen_offset"} <= set(nf)
    assert all(v == 0 for v in nf.values()), nf
    assert last["gradmax/grad.param.xyz"] > 0 and np.isfinite(last["gradmax/loss"])


def test_train_cli_deadline_and_detect_anomaly(tmp_path):
    """--deadline_min stops at the first mark past the budget: the iteration
    reached gets a checkpoint that resumes, its PLYs and the log, and no
    later mark trains. --detect_anomaly reaches the Trainer."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene)
    train = _load_script("train_torch")
    argv = ["-s", scene, "-m", run, "--device", "cpu", "--schedule_scale", "0.002", "--iterations", "8",
            "--capacity", "1024", "--pair_capacity", "16384", "--envmap_max_res", "16", "--log_every", "1",
            "--checkpoint_iterations", "2", "4", "6", "--detect_anomaly"]
    # 6 ms: the first mark starts within it, the next one after two steps.
    res = train.main(argv + ["--deadline_min", "1e-4"])
    assert res["deadline_hit"] and res["trainer"].detect_anomaly
    log = res["trainer"].metrics_log
    assert [m["iteration"] for m in log] == [1, 2]
    assert all(m["nonfinite/loss"] == 0 for m in log)
    assert res["ply"] == os.path.join(run, "point_cloud", "iteration_2", "point_cloud.ply")
    assert os.path.exists(res["ply"])
    with open(os.path.join(run, "train_log.json")) as f:
        assert [m["iteration"] for m in json.load(f)] == [1, 2]
    state, it = load_checkpoint(run, device="cpu")
    assert it == 2 and state.step == 2
    # Without a deadline the run goes to the end.
    full = train.main(argv)
    assert not full["deadline_hit"] and full["trainer"].metrics_log[-1]["iteration"] == 8
