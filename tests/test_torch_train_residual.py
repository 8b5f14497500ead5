"""The port's `raytracing_residual` flavor against the JAX package: one
`surfel2` step whose indirect light is the mesh-traced one-bounce shading
(render_surfel(mesh=...)), from a carried-across JAX TrainState without an
env-GS model, held as tests/test_torch_train_surfel2.py holds the env-GS
step; then the Trainer across the surfel2 onset in this flavor, the
counterpart of tests/test_mesh_visibility.py:147: it extracts a mesh, spawns
no env-GS model and trains on; and scripts/train_torch.py --indirect_type
raytracing_residual across the onset, with its PLY, checkpoint and test
render, served and exported by scripts/eval_torch.py.

The JAX side runs as its own tests run it (jitted, Pallas in interpret mode
on the CPU). Gradients within tests/test_rasterize_grad.py:93's 2e-3 x
scale."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import mesh_tracer as jmt  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.ops.tracer.api import TracerConfig as JTracer  # noqa: E402
from materialrefgs_tpu.train import trainer as jtr  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.ops.tracer.api import TracerConfig as TTracer  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from test_torch_envgs import _jax_texel_grid, _mesh, _models  # noqa: E402
from materialrefgs_torch.train.mesh_extract import read_mesh_ply  # noqa: E402
from materialrefgs_torch.train.mesh_material import read_material_mesh_ply  # noqa: E402
from test_torch_train import _load_script, _state_to_torch, _synthetic_scene, _write_blender_scene  # noqa: E402
from test_torch_train_surfel2 import (  # noqa: E402
    ITERATION, PAIRS, W, H, _check_grads_and_update, _env_kink_gaussians, _grad_tol, _gt, _moments,
    _normal_kink_sensitivity,
)


def test_residual_step_matches_jax(monkeypatch):
    """One residual-flavor surfel2 step in both packages from the same
    state (a JAX state after a warm-up step, carried across): loss, every
    gradient leaf (the env light's through the one-bounce shading too), the
    updated parameters and the densification statistics. The gaussians
    under an env-map kink or whose gradient the normal loss's kink can move
    by half its tolerance are left out, as in the env-GS step's test."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    _, pipe, opt = jcfg.preset_refnerf()
    pipe = dataclasses.replace(pipe, indirect_type="raytracing_residual")
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    tpipe = tcfg.PipelineParams(**dataclasses.asdict(pipe))
    (jm, _), _, env_base = _models()
    js = jtr.init_train_state(jm, opt, envmap_res=16)
    js = js.replace(env1=JEnv(base=jnp.asarray(env_base)))
    kw = dict(eye=np.array([0.3, -0.4, -3.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.8, fovy=0.8, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    verts, faces = _mesh()
    jmesh, tmesh = jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu")
    gt = _gt(1)
    lam = jtr.normal_loss_weight_schedule(ITERATION, opt)
    jextra = {"iteration": jnp.float32(ITERATION), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(0.0), "warp_key": jax.random.PRNGKey(0), "bg": jnp.ones(3),
              "env_geo_lr_scale": jnp.float32(1.0)}
    jstep = jtr.make_train_step("surfel2", opt, pipe, 3.0, JRaster(pair_capacity=PAIRS, interpret=True),
                                envmap_n_samples=4, tracer_cfg=JTracer(interpret=True, mesh_cull_cap=512))
    js, _ = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt), jmesh)  # warm-up: live moments
    assert js.env_gs is None
    ts = _state_to_torch(js)
    mu0 = {k: v.clone().numpy() for k, v in ts.adam.mu.items()}
    js, jmet = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt), jmesh)

    textra = {"iteration": float(ITERATION), "lambda_normal_render_depth": lam, "bg": torch.ones(3),
              "env_geo_lr_scale": 1.0}
    tstep = ttr.make_train_step("surfel2", topt, tpipe, 3.0, TRaster(pair_capacity=PAIRS), envmap_n_samples=4,
                                tracer_cfg=TTracer(mesh_cull_cap=512))
    assert tstep.residual
    pkg, _ = tstep.render(ts, tc, textra, tmesh)
    assert float((1 - pkg["visibility"]).sum()) > 10 and float(pkg["indirect_light"].abs().max()) > 0
    assert "tracer_pairs" not in pkg  # no env-GS trace
    skip, n_kink = _env_kink_gaussians(tstep, ts, tc, textra, tmesh)
    assert n_kink <= 2 and len(skip) <= 16, (n_kink, skip)
    nsens, n_near = _normal_kink_sensitivity(tstep, ts, tc, textra, tmesh, gt, lam)
    launches = (tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches)
    tmet = tstep(ts, tc, torch.from_numpy(gt), textra, tmesh)
    assert (tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches) == launches

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    for k in ("loss_l1", "ssim", "loss_normal_render_depth"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for k in ("tracer_overflow", "tracer_pairs", "mesh_cull_dropped", "overflow"):
        assert int(tmet[k]) == int(jmet[k]) == 0, k
    assert ts.env_gs is None and ts.step == int(js.step) and ts.adam.count == int(js.opt_state.count)

    count = int(js.opt_state.count)
    jmu = _moments(*js.opt_state.mu)
    nskip = sorted({int(i) for k, b in nsens.items()
                    for i in np.nonzero((b.reshape(len(b), -1) > 0.5 * _grad_tol(jmu[k], mu0[k])).any(-1))[0]})
    assert n_near <= 128 and len(nskip) <= 4, (n_near, nskip)
    skip = sorted(set(skip) | set(nskip))
    jparams = _moments(js.model.params, js.env1, js.env2)
    tparams = {k: v.detach().numpy() for k, v in ts.params().items()}
    lrs = ttr.param_lrs(topt, 3.0, ts.step - 1, ts.opacity_lr_scale)
    _check_grads_and_update(mu0, {k: v.numpy() for k, v in ts.adam.mu.items()}, jmu,
                            _moments(*js.opt_state.nu), tparams, jparams, lrs, count, 8, "main", skip)
    g_env = (ts.adam.mu["env1"].numpy() - 0.9 * mu0["env1"]) / 0.1
    assert np.abs(g_env).max() > 0  # the env light learns through the shading and the bounce
    keep = np.ones(ts.model.capacity, bool)
    keep[skip] = False
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        a, b = getattr(ts.model, k).numpy()[keep], np.asarray(getattr(js.model, k))[keep]
        np.testing.assert_allclose(a, b, atol=2e-3 * max(float(np.abs(b).max()), 1e-3) + 1e-6, err_msg=k)


def test_trainer_raytracing_residual_branch():
    """tests/test_mesh_visibility.py:147 in the port: past indirect_from_iter
    the residual flavor extracts a mesh (without mesh visibility), spawns no
    env-GS model, probes no tracer budget, and trains on with finite losses;
    the env light's gradient is live and no env-GS upkeep runs."""
    cams, images, gt_means, rng = _synthetic_scene(n_cams=3, size=24, P=32)
    pts = (gt_means + rng.normal(size=gt_means.shape) * 0.05).astype(np.float32)
    model = tgm.create_from_points(pts, rng.uniform(size=(len(pts), 3)).astype(np.float32), capacity=64,
                                   device="cpu")
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=0, init_until_iter=0,
        volume_render_until_iter=0, indirect_from_iter=2, densify_from_iter=10_000,
        feature_rest_from_iter=100_000, lambda_normal_render_depth=0.0, lambda_dist=0.0,
        env_densify_interval=1, env_reset_interval=1)
    tracer_cfg = TTracer(pair_capacity=1 << 6, mesh_cull_cap=512)
    trainer = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(indirect_type="raytracing_residual"),
                          cameras_extent=3.0, raster_cfg=TRaster(pair_capacity=1 << 12), envmap_res=16,
                          tracer_cfg=tracer_cfg, use_mesh_visibility=False)
    trainer.MESH_RESOLUTION = 24
    env0 = trainer.state.env1.base.detach().clone()
    trainer.train(4, log_every=1)
    assert trainer.mesh is not None, "the residual branch must extract a mesh"
    assert trainer.state.env_gs is None, "the residual flavor spawns no env-GS model"
    assert trainer.tracer_cfg == tracer_cfg  # nothing was probed
    assert [it for it, _, _ in trainer.mesh_log] == [3] and trainer.mesh_log[0][1] > 0
    log = trainer.metrics_log
    assert [m["stage"] for m in log] == ["surfel", "surfel", "surfel2", "surfel2"]
    for m in log[2:]:
        assert np.isfinite(m["loss"]) and m["mesh_cull_dropped"] == 0 and m["tracer_pairs"] == 0, m
        assert "env_n_alive" not in m
    assert float((trainer.state.env1.base.detach() - env0).abs().max()) > 0
    for name, p in trainer.state.params().items():
        assert torch.isfinite(p).all(), name
    # An unknown flavor is refused by name.
    with pytest.raises(ValueError, match="indirect_type"):
        ttr.make_train_step("surfel2", opt, tcfg.PipelineParams(indirect_type="bogus"), 3.0, TRaster())


def test_train_cli_raytracing_residual(tmp_path, monkeypatch):
    """scripts/train_torch.py --indirect_type raytracing_residual --device cpu
    across the surfel2 onset: it extracts the mesh, writes no env PLY,
    records the flavor in cfg_args.json, renders its test mark, resumes from
    its checkpoint (re-extracting the mesh), and scripts/eval_torch.py
    serves the run and exports its material mesh."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene, step=0.15)
    train = _load_script("train_torch")
    # tests/test_torch_train_surfel2.py's CLI sizes: a 32^3 TSDF, a
    # 2048-triangle traced mesh, indirect_from_iter 10 at schedule 0.0005.
    monkeypatch.setattr(ttr.Trainer, "MESH_RESOLUTION", 32)
    monkeypatch.setattr(ttr.Trainer, "MESH_TRI_CAPACITY", 2048)
    argv = ["-s", scene, "-m", run, "--device", "cpu", "--schedule_scale", "0.0005",
            "--iterations", "12", "--capacity", "1024", "--pair_capacity", "16384",
            "--envmap_max_res", "16", "--log_every", "1", "--mesh_every", "4",
            "--opacity_reset_interval", "1000", "--multi_view_weight_from_iter", "1000",
            "--indirect_type", "raytracing_residual",
            "--checkpoint_iterations", "11", "--test_iterations", "12"]
    res = train.main(argv)
    tr = res["trainer"]
    log = tr.metrics_log
    assert [m["iteration"] for m in log] == list(range(1, 13))
    assert [m["stage"] for m in log][-2:] == ["surfel2", "surfel2"]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert tr.state.env_gs is None and tr.mesh is not None
    assert all(m["mesh_cull_dropped"] == 0 for m in log[-2:])
    ply_dir = os.path.dirname(res["ply"])
    assert res["ply"] == os.path.join(run, "point_cloud", "iteration_12", "point_cloud.ply")
    assert not os.path.exists(os.path.join(ply_dir, "env_point_cloud.ply"))
    meshes = sorted(os.listdir(os.path.join(run, "meshes")))
    assert meshes and meshes[-1] == "test_000012.ply", meshes
    assert tcfg.load_config(run)[1].indirect_type == "raytracing_residual"
    assert np.isfinite(res["test"][12]["psnr"])

    resumed = train.main(argv[:-4] + ["--start_checkpoint", run, "--iterations", "12"])
    rt = resumed["trainer"]
    assert [m["iteration"] for m in rt.metrics_log] == [12]
    assert rt.state.env_gs is None and rt.mesh is not None and np.isfinite(rt.metrics_log[0]["loss"])

    ev = _load_script("eval_torch")
    m = ev.main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu"])["test"]
    assert np.isfinite(m["psnr"]) and m["overflow"] == 0
    out = ev.main(["-m", run, "-s", scene, "--skip_train", "--skip_test", "--export_material_mesh",
                   "--device", "cpu"])["material_mesh"]
    mv, mf, ma = read_material_mesh_ply(out)
    fv, ff = read_mesh_ply(os.path.join(run, "meshes", meshes[-1]))
    np.testing.assert_array_equal(mv, fv)
    np.testing.assert_array_equal(mf, ff)
    assert all(np.isfinite(v).all() for v in ma.values())
