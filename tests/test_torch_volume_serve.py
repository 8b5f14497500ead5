"""A `volume`-stage checkpoint through both CLIs against the JAX package:
scripts/train_torch.py trains across initial -> volume -> surfel and saves
in the volume stage; scripts/eval_torch.py serves that checkpoint through
render_volume with env2 and is held to scripts/eval.py's PSNR within 0.01
dB and SSIM within 1e-4 (test_eval_end_to_end_matches_jax's bounds).

The JAX side runs as its own tests run it (Pallas in interpret mode on the
CPU)."""
import dataclasses
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test worker (see tests/test_torch_train.py).
torch.set_num_threads(1)

from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.render import renderers as trend  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def same_texel_grid(monkeypatch):
    """JAX's texel-center directions for the port's prefilter (the grids
    differ by one float32 ulp; see tests/test_torch_shading.py)."""
    monkeypatch.setattr(
        tcm, "face_dirs", lambda res, device=None: torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)
    )


def _write_blender_scene(root, n_views=3, size=32):
    """Cameras on a ring looking at the origin (0.6 rad apart), RGBA ground
    truth whose alpha is a centered disc, and a small seed cloud."""
    import json

    from materialrefgs_torch.utils import png
    from materialrefgs_torch.utils.ply import write_point_cloud_ply

    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split))
    rng = np.random.default_rng(7)
    frames = {"train": [], "test": []}
    for i in range(n_views):
        split = "test" if i == n_views - 1 else "train"
        ang = 0.6 * i
        eye = np.array([3.5 * np.sin(ang), 0.4, -3.5 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye  # OpenGL axes
        frames[split].append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        yy, xx = np.mgrid[0:size, 0:size] / size
        rgb = 0.5 + 0.4 * np.sin(6 * xx + i)[..., None] * np.array([1.0, 0.6, 0.3]) + 0.05 * rng.normal(
            size=(size, size, 3))
        alpha = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.16)[..., None] * 1.0
        img = np.clip(np.concatenate([rgb, alpha], -1), 0, 1)
        png.write_png(os.path.join(root, split, f"r_{i}.png"), (img * 255 + 0.5).astype(np.uint8))
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames[split]}, f)
    pts = rng.normal(size=(300, 3)) * 0.4
    write_point_cloud_ply(os.path.join(root, "points3d.ply"), pts, rng.uniform(size=(300, 3)))


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_volume_checkpoint_trains_and_serves_like_jax(tmp_path, monkeypatch, same_texel_grid):
    """scripts/train_torch.py trains across initial (1) -> volume (2-3) ->
    surfel (4), saving at 3; scripts/eval_torch.py serves that volume-stage
    checkpoint through render_volume with env2 and equals scripts/eval.py's
    PSNR and SSIM on the same directory."""
    scene = str(tmp_path / "scene")
    _write_blender_scene(scene)
    run = str(tmp_path / "torch")
    train_torch = _load_script("train_torch", os.path.join(REPO, "scripts", "train_torch.py"))
    res = train_torch.main([
        "-s", scene, "-m", run, "--device", "cpu", "--iterations", "4", "--capacity", "256",
        "--envmap_max_res", "16", "--init_until_iter", "1", "--volume_render_until_iter", "3",
        "--indirect_from_iter", "100", "--densify_from_iter", "1000",
        "--save_iterations", "3", "4", "--log_every", "1",
    ])
    log = res["trainer"].metrics_log
    assert [m["stage"] for m in log] == ["initial", "volume", "volume", "surfel"]
    assert all(np.isfinite(m["loss"]) for m in log)
    shutil.rmtree(os.path.join(run, "point_cloud", "iteration_4"))
    jrun = str(tmp_path / "jax")
    shutil.copytree(run, jrun)
    m_, p_, o_, extra = tcfg.load_config(run)
    jcfg.dump_config(jrun, jcfg.ModelParams(**dataclasses.asdict(m_)), jcfg.PipelineParams(**dataclasses.asdict(p_)),
                     jcfg.OptimizationParams(**dataclasses.asdict(o_)), extra=extra)
    assert os.path.exists(os.path.join(run, "point_cloud", "iteration_3", "point_cloud2.map.npz"))

    argv = ["-s", scene, "--skip_train", "--device", "cpu"]
    jax_eval = _load_script("jax_eval", os.path.join(REPO, "scripts", "eval.py"))
    monkeypatch.setattr(sys, "argv", ["eval.py", "-m", jrun, *argv])
    jax_eval.main()
    with open(os.path.join(jrun, "eval_3", "metric.txt")) as f:
        ref = {k: v.strip() for k, v in (line.split(":", 1) for line in f)}
    eval_torch = _load_script("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    seen = []
    real = trend.render_volume
    monkeypatch.setattr("materialrefgs_torch.evaluate.render_volume",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    m = eval_torch.main(["-m", run, *argv])["test"]
    assert len(seen) == 1 and m["overflow"] == 0
    assert abs(m["psnr"] - float(ref["psnr"])) < 0.01, (m["psnr"], ref["psnr"])
    assert abs(m["ssim"] - float(ref["ssim"])) < 1e-4, (m["ssim"], ref["ssim"])
    assert os.path.exists(os.path.join(run, "env2.png"))
