"""The port's camera-batch data parallelism (parallel/data_parallel.py,
parallel/dp_trainer.py and the --dp path of scripts/train_torch.py) against
the JAX package's, with gloo process groups on the CPU.

- At world size 1 (one process, a FileStore group) the DP production step
  equals the plain TrainStep exactly, DPTrainer reproduces the Trainer over
  40 steps with densification exactly, and `--dp 1` writes the losses of a
  run without --dp.
- Two gloo processes run the DP production step with the warp on and
  without it; they are held to JAX make_dp_production_step on 2 virtual
  devices (tests/test_data_parallel.py's cases): the averaged loss, the
  averaged gradients (from the Adam moments) at 3e-3 x scale + 1e-5, and the
  densification statistics (denom at 1e-6; the per-view norm sums at rtol
  1e-4 as test_dp_densify_stats_sum_per_view_norms, where no kink of the
  loss is within rounding). The same processes train DPTrainer over 16
  iterations with densification and end with equal parameters.
- `--dp 2 --device cpu` trains initial -> surfel -> surfel2 through the CLI
  with rank 0 alone writing; `--dp 2` with one card raises.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.config import OptimizationParams as JOpt, PipelineParams as JPipe  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as jgm  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.parallel.data_parallel import make_dp_production_step as jax_dp_step  # noqa: E402
from materialrefgs_tpu.parallel.data_parallel import stack_cameras  # noqa: E402
from materialrefgs_tpu.train.trainer import init_train_state as jax_init_state  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.parallel.data_parallel import make_dp_production_step  # noqa: E402
from materialrefgs_torch.parallel.dp_trainer import DPTrainer  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from test_torch_train import _load_script, _state_to_torch, _synthetic_scene, _write_blender_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32
ENV_RES = 16
PARAMS = list(tgm.PARAM_SHAPES) + ["env1", "env2"]


def _cam_kw(i, n):
    ang = 2 * np.pi * i / n
    return dict(eye=np.array([3.0 * np.sin(ang), 0.4, -3.0 * np.cos(ang)]), target=np.zeros(3),
                up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.9, width=W, height=H)


def _jax_state(seed):
    """tests/test_data_parallel.py's _state: 48 points at capacity 64."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(48, 3)).astype(np.float32)
    cols = rng.uniform(size=(48, 3)).astype(np.float32)
    return jax_init_state(jgm.create_from_points(pts, cols, capacity=64), JOpt(), envmap_res=ENV_RES)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _snapshot(state):
    out = {k: v.detach().clone() for k, v in state.params().items()}
    out.update({f"mu.{k}": v.clone() for k, v in state.adam.mu.items()})
    out.update({f"nu.{k}": v.clone() for k, v in state.adam.nu.items()})
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out[k] = getattr(state.model, k).clone()
    return out


# ------------------------------------------------------------ world size 1 --

def test_dp_one_rank_equals_plain_step(one_rank_group):
    """An all_reduce over one rank is the identity: the DP production step
    (surfel, with the warp) leaves every parameter, Adam moment and
    densification statistic and every metric exactly as the plain step."""
    opt, pipe = tcfg.OptimizationParams(), tcfg.PipelineParams()
    it = float(opt.multi_view_weight_from_iter + 100)
    gen = torch.Generator().manual_seed(0)
    cam, near = torch_camera(**_cam_kw(0, 8), device="cpu"), torch_camera(**_cam_kw(1, 8), device="cpu")
    gt, ngt = torch.rand(H, W, 3, generator=gen), torch.rand(H, W, 3, generator=gen)
    extra = {"iteration": it, "lambda_normal_render_depth": 0.05, "bg": torch.zeros(3), "nearest_camera": near,
             "nearest_gt": ngt, "warp_photo_weight": 1.0, "warp_uniforms": torch.rand(H * W, generator=gen)}
    outs = []
    for group in (None, dist.group.WORLD):
        state = _state_to_torch(_jax_state(3))
        kw = dict(envmap_n_samples=4, with_warp=True)
        step = (make_dp_production_step(group, "surfel", opt, pipe, 3.0, TRaster(pair_capacity=1 << 12), **kw)
                if group is not None else ttr.make_train_step("surfel", opt, pipe, 3.0,
                                                              TRaster(pair_capacity=1 << 12), **kw))
        metrics = step(state, cam, gt, dict(extra))
        outs.append((_snapshot(state), {k: float(v) for k, v in metrics.items()}))
    (s1, m1), (s2, m2) = outs
    assert m2.pop("dp_allreduce_bytes") > 4 * sum(v.numel() for k, v in s2.items() if k in PARAMS)
    assert m2.pop("dp_allreduce_ms") >= 0
    assert m1 == m2
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


def _dp_scene_trainer(cls, **kw):
    cams, images, gt_means, rng = _synthetic_scene(n_cams=8, size=24, P=48)
    pts = (gt_means + rng.normal(size=gt_means.shape) * 0.1).astype(np.float32)
    cols = rng.uniform(size=(len(pts), 3)).astype(np.float32)
    model = tgm.create_from_points(pts, cols, capacity=128, device="cpu")
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=10_000,
        densify_from_iter=10, densification_interval=25, feature_rest_from_iter=100_000,
        lambda_normal_render_depth=0.0, lambda_dist=0.0,
    )
    return cls(model, cams, images, opt, tcfg.PipelineParams(), cameras_extent=3.0,
               raster_cfg=TRaster(pair_capacity=1 << 12), envmap_res=16, seed=3407, **kw)


def test_dp_trainer_one_rank_reproduces_trainer(one_rank_group):
    """DPTrainer at world size 1 reproduces the Trainer over 40 steps with
    densification (at 25), exactly: the same draws, the same losses, the
    same final state (JAX test_dp_trainer_one_device_matches_single_chip)."""
    t1 = _dp_scene_trainer(ttr.Trainer)
    t2 = _dp_scene_trainer(DPTrainer, group=None)
    t1.train(40, log_every=1)
    t2.train(40, log_every=1)
    assert [m["loss"] for m in t1.metrics_log] == [m["loss"] for m in t2.metrics_log]
    assert t1.metrics_log[-1]["n_alive"] == t2.metrics_log[-1]["n_alive"] != 48
    s1, s2 = _snapshot(t1.state), _snapshot(t2.state)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


# ---------------------------------------------------- two gloo processes --

_WORKER = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
from materialrefgs_torch import config as tcfg
from materialrefgs_torch.cameras import look_at_camera
from materialrefgs_torch.ops import cubemap as tcm
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
from materialrefgs_torch.parallel.data_parallel import make_dp_production_step
from materialrefgs_torch.parallel.dp_trainer import DPTrainer

d, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
job = torch.load(f"{d}/job.pt", weights_only=False)
tcm.face_dirs = lambda res, device=None: torch.tensor(job["face_dirs"][res])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
out = {"cases": []}
for case in job["cases"]:
    state = case["state"]
    cam = look_at_camera(**case["cams"][rank], device="cpu")
    extra = dict(case["extras"][rank])
    if case["with_warp"]:
        extra["nearest_camera"] = look_at_camera(**case["ncams"][rank], device="cpu")
    step = make_dp_production_step(None, "surfel", tcfg.OptimizationParams(), tcfg.PipelineParams(), 3.0,
                                   RasterizeConfig(pair_capacity=1 << 12), envmap_n_samples=4,
                                   with_warp=case["with_warp"])
    metrics = step(state, cam, case["gts"][rank], extra)
    res = {k: v.detach().numpy().copy() for k, v in state.params().items()}
    res.update({f"mu.{k}": v.numpy().copy() for k, v in state.adam.mu.items()})
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        res[k] = getattr(state.model, k).numpy().copy()
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["cases"].append(res)
sys.path.insert(0, sys.argv[5])
from test_torch_data_parallel import _dp_scene_trainer
t = _dp_scene_trainer(DPTrainer, group=None)
t.train(16, log_every=1)
out["trainer"] = {"params": {k: v.detach().numpy().copy() for k, v in t.state.params().items()},
                  "log": t.metrics_log, "alive": t.state.model.alive.numpy().copy()}
torch.save(out, f"{d}/out{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two gloo processes' results and the JAX DP steps on 2 virtual
    devices for the same cases: (case 0) surfel with the warp past the gate,
    (case 1) surfel without it (the densification-sums case)."""
    d = tmp_path_factory.mktemp("dp2")
    cases, jax_in = [], []
    for with_warp, seed in ((True, 5), (False, 123)):
        opt = JOpt()
        rng = np.random.default_rng(seed + 1)
        gts = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
        ngts = rng.uniform(size=(2, H, W, 3)).astype(np.float32) if with_warp else gts
        it = float(opt.multi_view_weight_from_iter + 100) if with_warp else 5000.0
        keys = jax.random.split(jax.random.PRNGKey(7), 2)
        cams = [_cam_kw(i, 2) for i in range(2)]
        # Distinct nearest views (test_dp_production_step_two_devices).
        ncams = [_cam_kw(i + 0.3, 2) for i in range(2)] if with_warp else cams
        jstate = _jax_state(seed)
        jax_in.append((with_warp, jstate, cams, ncams, gts, ngts, it, keys))
        extras = []
        for r in range(2):
            e = {"iteration": it, "lambda_normal_render_depth": 0.05, "bg": torch.zeros(3)}
            if with_warp:
                e.update(nearest_gt=torch.from_numpy(ngts[r]), warp_photo_weight=1.0,
                         warp_uniforms=torch.from_numpy(np.array(jax.random.uniform(keys[r], (H * W,)))))
            extras.append(e)
        cases.append({"state": _state_to_torch(jstate), "with_warp": with_warp, "cams": cams, "ncams": ncams,
                      "gts": [torch.from_numpy(g) for g in gts], "extras": extras})
    torch.save({"cases": cases, "face_dirs": {ENV_RES: np.asarray(jcm.face_dirs(ENV_RES))}}, d / "job.pt")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d), str(r), str(port), REPO,
                               os.path.dirname(os.path.abspath(__file__))],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        # The JAX steps compile while the ranks run.
        mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        jax_out = []
        for with_warp, jstate, cams, ncams, gts, ngts, it, keys in jax_in:
            jextra = {"iteration": jnp.full((2,), it, jnp.float32),
                      "lambda_normal_render_depth": jnp.full((2,), 0.05, jnp.float32),
                      "normal_gamma": jnp.zeros((2,), jnp.float32), "warp_key": keys,
                      "bg": jnp.zeros((2, 3), jnp.float32)}
            step = jax_dp_step(mesh, "surfel", JOpt(), JPipe(), 3.0, JRaster(pair_capacity=1 << 12, interpret=True),
                               envmap_n_samples=4, with_warp=with_warp)
            jax_out.append(step(jstate, stack_cameras([jax_camera(**c) for c in cams]), jnp.asarray(gts), jextra,
                                stack_cameras([jax_camera(**c) for c in ncams]), jnp.asarray(ngts), None))
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(2)], jax_out


def _jax_leaves(js, prefix=""):
    tree = js.opt_state.mu if prefix == "mu." else None
    if tree is None:
        p = {k: np.asarray(getattr(js.model.params, k)) for k in tgm.PARAM_SHAPES}
        p["env1"], p["env2"] = np.asarray(js.env1.base), np.asarray(js.env2.base)
        return p
    mp, me1, me2 = tree
    p = {k: np.asarray(getattr(mp, k)) for k in tgm.PARAM_SHAPES}
    p["env1"], p["env2"] = np.asarray(me1.base), np.asarray(me2.base)
    return p


@pytest.mark.parametrize("case", [0, 1], ids=["warp", "no_warp"])
def test_dp_step_two_ranks_matches_jax(two_ranks, case):
    """Both ranks hold the same state after the step; the averaged loss and
    gradients and the summed densification statistics match JAX's DP step
    on 2 devices."""
    (r0, r1), jax_out = two_ranks
    a, b = r0["cases"][case], r1["cases"][case]
    for k in a:
        if k != "metrics":
            assert np.array_equal(a[k], b[k]), k  # replicated
    ms = a["metrics"].pop("dp_allreduce_ms"), b["metrics"].pop("dp_allreduce_ms")  # each rank's own clock
    assert min(ms) >= 0 and a["metrics"] == b["metrics"]
    js, jm = jax_out[case]
    np.testing.assert_allclose(a["metrics"]["loss"], float(jm["loss"]), rtol=1e-5)
    for k in ("loss_l1", "ssim", "psnr") + (("loss_warp_geo", "loss_warp_ncc") if case == 0 else ()):
        np.testing.assert_allclose(a["metrics"][k], float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    jmu = _jax_leaves(js, "mu.")
    for k in PARAMS:
        # A fresh Adam: mu = (1 - b1) * g, so g = mu / 0.1 in both packages.
        g, gj = a[f"mu.{k}"] / 0.1, jmu[k] / 0.1
        s = max(float(np.abs(gj).max()), 1e-3)
        np.testing.assert_allclose(g, gj, atol=3e-3 * s + 1e-5, err_msg=f"grad {k}")
    np.testing.assert_allclose(a["denom"], np.asarray(js.model.denom), atol=1e-6)
    np.testing.assert_allclose(a["xyz_gradient_accum"], np.asarray(js.model.xyz_gradient_accum),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(a["max_radii2d"], np.asarray(js.model.max_radii2d), atol=1e-6)
    assert a["denom"].max() == 2  # a gaussian seen by both views counts both


def test_dp_trainer_two_ranks_stay_replicated(two_ranks):
    """16 DPTrainer iterations on two ranks (densify at 25 does not fire;
    the epoch of 8 views is drawn 2 a step): the ranks end with identical
    parameters and alive masks, and the loss is finite and falls."""
    (r0, r1), _ = two_ranks
    a, b = r0["trainer"], r1["trainer"]
    for k in a["params"]:
        assert np.array_equal(a["params"][k], b["params"][k]), k
    assert np.array_equal(a["alive"], b["alive"])
    losses = [m["loss"] for m in a["log"]]
    assert losses == [m["loss"] for m in b["log"]]
    assert np.all(np.isfinite(losses)) and np.mean(losses[-4:]) < np.mean(losses[:4])
    assert all(ma["dp_cam"] != mb["dp_cam"] for ma, mb in zip(a["log"], b["log"]))  # one view per rank


# ------------------------------------------------------------------ CLI --

def test_train_cli_dp(tmp_path, monkeypatch):
    """--dp 1 writes the losses of a run without --dp; --dp 2 --device cpu
    trains initial -> surfel -> surfel2 over two gloo ranks with rank 0
    alone writing; --dp 2 with one card raises and names the count."""
    scene = str(tmp_path / "scene")
    _write_blender_scene(scene, n_views=4)
    train = _load_script("train_torch")
    base = ["-s", scene, "--device", "cpu", "--schedule_scale", "0.0005", "--iterations", "8",
            "--indirect_from_iter", "6",
            "--capacity", "1024", "--pair_capacity", "16384", "--tracer_pair_capacity", "16384",
            "--envmap_max_res", "16", "--log_every", "1", "--mesh_every", "1000", "--no_mesh_visibility",
            "--opacity_reset_interval", "1000", "--env_reset_interval", "1000",
            "--multi_view_weight_from_iter", "1000"]
    run2 = str(tmp_path / "dp2")
    # One thread a rank: the test's own worker and the suite's others share the cores.
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "train_torch.py"), *base, "-m", run2, "--dp", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        logs = {}  # while the two ranks train
        for name, extra in (("plain", []), ("dp1", ["--dp", "1"])):
            run = str(tmp_path / name)
            train.main(base + ["-m", run, "--iterations", "4"] + extra)
            with open(os.path.join(run, "train_log.json")) as f:
                logs[name] = [m["loss"] for m in json.load(f)]
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert logs["plain"] == logs["dp1"] and len(logs["plain"]) == 4
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    assert out.count("[dp] rank") == 2
    assert out.count("saved;") == 1  # rank 0 alone saves
    with open(os.path.join(run2, "train_log.json")) as f:
        log = json.load(f)
    assert [m["iteration"] for m in log] == list(range(1, 9))
    assert [m["stage"] for m in log] == ["initial"] * 2 + ["surfel"] * 4 + ["surfel2"] * 2
    assert all(np.isfinite(m["loss"]) for m in log)
    assert os.path.exists(os.path.join(run2, "point_cloud", "iteration_8", "env_point_cloud.ply"))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="only 1 CUDA cards"):
        train.main(base[:2] + base[4:] + ["-m", str(tmp_path / "x"), "--dp", "2"])
