"""The port's multi-view supervision inside training against the JAX package:
the Trainer's warp view selection, one `surfel` step with the warp, the
mono-normal prior and the ref-score masks, and one `surfel2` step past the
warp gate in the refnerf and glossy presets, each from a JAX state carried
across by models/convert.py; then port-only runs: the nearest render's
overflow redo and the training CLI across the warp gate.

The JAX side runs as its own tests run it (jitted, Pallas in interpret mode
on the CPU). Gradient and parameter tolerances are the step-parity ones of
tests/test_torch_train.py and tests/test_torch_train_surfel2.py."""
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
from materialrefgs_torch.ops.rasterize import api as tapi  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.ops.tracer.api import TracerConfig as TTracer  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402
from test_torch_envgs import _jax_texel_grid, _mesh, _models  # noqa: E402
from test_torch_train import _gt_image, _load_script, _synthetic_scene, _write_blender_scene  # noqa: E402
from test_torch_train import jax_model, to_torch_model  # noqa: E402
from test_torch_train import _state_to_torch as surfel_state_to_torch  # noqa: E402
from test_torch_train_surfel2 import (  # noqa: E402
    _check_grads_and_update,
    _env_kink_gaussians,
    _grad_tol,
    _gt,
    _moments,
    _normal_kink_sensitivity,
    _state_to_torch,
)

WARP_TB = ("loss_warp_geo", "loss_warp_ncc", "loss_warp_bc", "loss_warp_mtl", "loss_warp_rgh")


def _cams(eye, deg, w, h, fov):
    """(JAX, port) cameras at `eye` and at `eye` turned by `deg` about the
    vertical axis, both looking at the origin."""
    t = np.deg2rad(deg)
    rot = np.array([[np.cos(t), 0.0, np.sin(t)], [0.0, 1.0, 0.0], [-np.sin(t), 0.0, np.cos(t)]])
    out = []
    for e in (eye, rot @ eye):
        kw = dict(eye=np.asarray(e, np.float64), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
                  fovx=fov, fovy=fov, width=w, height=h)
        out.append((jax_camera(**kw), torch_camera(**kw, device="cpu")))
    return out


def _warp_extras(jextra, textra, near, near_gt, key, H, W):
    """The nearest view and the warp's random scores in both packages' extras."""
    (jn, tn) = near
    jextra.update(warp_key=key, warp_photo_weight=jnp.float32(1.0))
    textra.update(nearest_camera=tn, nearest_gt=torch.from_numpy(near_gt), warp_photo_weight=1.0,
                  warp_uniforms=torch.from_numpy(np.array(jax.random.uniform(key, (H * W,)))))
    return jn


def _smooth_normals(rng, H, W):
    yy, xx = np.mgrid[0:H, 0:W] / H
    n = np.stack([np.sin(3 * xx + rng.uniform(0, 6)), np.cos(2 * yy + rng.uniform(0, 6)), -np.ones_like(xx)], -1)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def _check_tb(tmet, jmet, keys):
    for k in keys:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-7, err_msg=k)


# ---------------------------------------------------------- _select_warp --

@pytest.mark.parametrize("virtual", [False, True], ids=["neighbours", "virtual"])
def test_select_warp_sequence_matches_jax(virtual):
    """20 iterations of the Trainers' view and warp choice from one seed: the
    same views, warp gates, neighbours or virtual cameras (drawn from the
    rng in the JAX order) and photo weights. View 4 has no neighbour."""
    W = H = 16
    eyes = [np.array([3.0 * np.sin(a), 0.3, -3.0 * np.cos(a)]) for a in np.deg2rad(8.0 * np.arange(5))]
    kws = [dict(eye=e, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]), fovx=0.8, fovy=0.8, width=W, height=H)
           for e in eyes]
    jcs, tcs = [jax_camera(**k) for k in kws], [torch_camera(**k, device="cpu") for k in kws]
    images = [np.full((H, W, 3), i / 5, np.float32) for i in range(5)]
    nids = [[1], [0, 2], [1, 3], [2, 1, 0], []]
    _, pipe, opt = jcfg.preset_refnerf()
    opt = dataclasses.replace(opt, multi_view_weight_from_iter=5, use_virtul_cam=virtual, virtul_cam_prob=0.4)
    jm = jax_model(0, P=16, cap=32)
    kw = dict(nearest_ids=nids, with_warp=True, seed=11, envmap_res=8, virtual_cam_trans_noise=1.2,
              virtual_cam_deg_noise=20.0)
    jt = jtr.Trainer(jm, jcs, images, opt, pipe, **kw)
    tt = ttr.Trainer(to_torch_model(jm), tcs, images, tcfg.OptimizationParams(**dataclasses.asdict(opt)),
                     tcfg.PipelineParams(**dataclasses.asdict(pipe)), **kw)
    kinds = []
    for it in range(1, 21):
        stage = "initial" if it < 3 else "surfel"
        jcid, tcid = jt._pick_view(), tt._pick_view()
        assert int(jcid) == tcid
        jon, jcam, jgt, jpw = jt._select_warp(it, stage, jcid)
        ton, tcam, tgt, tpw, tnid = tt._select_warp(it, stage, tcid)
        assert (ton, tpw) == (jon, jpw), it
        np.testing.assert_array_equal(tcam.world_view.numpy(), np.asarray(jcam.world_view))
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jgt))
        kinds.append("off" if not ton else "virtual" if tnid < 0 else "neighbour")
    assert kinds[:5] == ["off"] * 5
    assert "neighbour" in kinds and (("virtual" in kinds) == virtual)
    assert (tt.rng.random(), tt.rng.integers(1000)) == (jt.rng.random(), jt.rng.integers(1000))


# ------------------------------------------------- one step against JAX --

def test_surfel_step_with_warp_mono_normal_and_ref_score_matches_jax(monkeypatch):
    """One `surfel` step (iteration 12000) of JAX make_train_step(with_warp=True,
    with_mono_normal=True) and of the port's make_train_step(with_warp=True),
    whose mono-normal term follows "normal_prior" in extra, from the same
    state, with every
    warp term on (refreal's geo and gated NCC, the directional
    metallic/roughness warps; dilate_size 1 at 48x40), a normal prior and a
    ref-score mask: the loss and its terms, every gradient leaf, the
    parameters after the update and the densification statistics."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    W, H, it = 48, 40, 12000
    _, pipe, opt = jcfg.preset_refnerf()
    opt = dataclasses.replace(opt, multi_view_weight_from_iter=7000, use_warp_geo_loss=True, use_warp_ncc_loss=True,
                              use_metallic_warp_loss=True, use_roughness_warp_loss=True, dilate_size=1)
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    tpipe = tcfg.PipelineParams(**dataclasses.asdict(pipe))
    rng = np.random.default_rng(8)
    jm = jax_model(9, sh_degree=1)
    jm = jm.replace(max_radii2d=jnp.zeros(jm.capacity), xyz_gradient_accum=jnp.zeros(jm.capacity),
                    denom=jnp.zeros(jm.capacity))
    js = jtr.init_train_state(jm, opt, envmap_res=32)
    js = js.replace(env1=JEnv(base=jnp.asarray(rng.normal(size=(6, 32, 32, 3)).astype(np.float32))))
    (jc, tc), near = _cams(np.array([0.4, -0.5, -3.5]), 9.0, W, H, 0.9)
    gt, near_gt = _gt_image(it), _gt_image(it + 1)
    mask = (np.add.outer((np.arange(H) - H / 2) ** 2, (np.arange(W) - W / 2) ** 2) < 15**2).astype(np.float32)
    prior = _smooth_normals(rng, H, W)
    rs_mask = (rng.uniform(size=(H, W)) > 0.6).astype(np.float32)
    lam = jtr.normal_loss_weight_schedule(it, opt)
    gamma = jtr.normal_gamma_schedule(it, opt)
    assert gamma == ttr.normal_gamma_schedule(it, topt) == 0.5
    jextra = {"iteration": jnp.float32(it), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(gamma), "bg": jnp.ones(3), "image_mask": jnp.asarray(mask),
              "normal_prior": jnp.asarray(prior), "ref_score_mask": jnp.asarray(rs_mask)}
    textra = {"iteration": float(it), "lambda_normal_render_depth": lam, "normal_gamma": gamma, "bg": torch.ones(3),
              "image_mask": torch.from_numpy(mask), "normal_prior": torch.from_numpy(prior),
              "ref_score_mask": torch.from_numpy(rs_mask)}
    jn = _warp_extras(jextra, textra, near, near_gt, jax.random.PRNGKey(3), H, W)
    jstep = jtr.make_train_step("surfel", opt, pipe, 3.0, JRaster(pair_capacity=1 << 14, interpret=True),
                                with_warp=True, with_mono_normal=True)
    js, _ = jstep(js, jc, jnp.asarray(gt), jextra, jn, jnp.asarray(near_gt))  # warm-up: live moments
    ts = surfel_state_to_torch(js)
    mu0 = {k: v.clone().numpy() for k, v in ts.adam.mu.items()}
    js, jmet = jstep(js, jc, jnp.asarray(gt), jextra, jn, jnp.asarray(near_gt))
    tstep = ttr.make_train_step("surfel", topt, tpipe, 3.0, TRaster(pair_capacity=1 << 14), with_warp=True)
    tmet = tstep(ts, tc, torch.from_numpy(gt), textra)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    _check_tb(tmet, jmet, ("loss_l1", "ssim", "loss_mask_entropy", "loss_mono_normal", "loss_ref_score") + WARP_TB)
    assert all(float(jmet[k]) > 0 for k in WARP_TB + ("loss_mono_normal", "loss_ref_score")), jmet
    assert int(tmet["overflow"]) == int(tmet["nearest_overflow"]) == 0
    lrs = ttr.param_lrs(topt, 3.0, ts.step - 1, ts.opacity_lr_scale)
    _check_grads_and_update(mu0, {k: v.numpy() for k, v in ts.adam.mu.items()}, _moments(*js.opt_state.mu),
                            _moments(*js.opt_state.nu), {k: v.detach().numpy() for k, v in ts.params().items()},
                            _moments(js.model.params, js.env1, js.env2), lrs, int(js.opt_state.count), 8, "surfel")
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        a, b = getattr(ts.model, k).numpy(), np.asarray(getattr(js.model, k))
        np.testing.assert_allclose(a, b, atol=2e-3 * max(float(np.abs(b).max()), 1e-3) + 1e-6, err_msg=k)


@pytest.mark.parametrize("preset", ["refnerf", "glossy"])
def test_surfel2_step_past_the_warp_gate_matches_jax(preset, monkeypatch):
    """One `surfel2` step at iteration 25,001, just past the presets' warp
    gate (mesh visibility, exact order), from a carried-across JAX state
    with env-GS: refnerf's base-colour warp, and glossy's roughness warp
    beside it (dilate_size 1 at 32x32; the preset's 7 would mask every
    sample of so small an image). As tests/test_torch_train_surfel2.py, the
    gaussians under an env-map or normal-loss kink are left out."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    W = H = 32
    pairs, it = 1 << 12, 25001
    _, pipe, opt = {"refnerf": jcfg.preset_refnerf, "glossy": jcfg.preset_glossy}[preset]()
    if preset == "glossy":
        opt = dataclasses.replace(opt, dilate_size=1)
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    tpipe = tcfg.PipelineParams(**dataclasses.asdict(pipe))
    (jm, _), (jenv, _), env_base = _models()
    js = jtr.init_train_state(jm, opt, envmap_res=16)
    js = js.replace(env1=JEnv(base=jnp.asarray(env_base)), env_gs=jenv,
                    env_gs_opt_state=jtr.make_optimizer().init(jenv.params))
    (jc, tc), near = _cams(np.array([0.3, -0.4, -3.0]), 8.0, W, H, 0.8)
    verts, faces = _mesh()
    jmesh, tmesh = jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu")
    gt, near_gt = _gt(1), _gt(2)
    mask = (np.add.outer((np.arange(H) - H / 2) ** 2, (np.arange(W) - W / 2) ** 2) < 13**2).astype(np.float32)
    lam = jtr.normal_loss_weight_schedule(it, opt)
    jextra = {"iteration": jnp.float32(it), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(0.0), "bg": jnp.ones(3), "image_mask": jnp.asarray(mask),
              "env_geo_lr_scale": jnp.float32(1.0)}
    textra = {"iteration": float(it), "lambda_normal_render_depth": lam, "bg": torch.ones(3),
              "image_mask": torch.from_numpy(mask), "env_geo_lr_scale": 1.0}
    jn = _warp_extras(jextra, textra, near, near_gt, jax.random.PRNGKey(5), H, W)
    tr_kw = dict(pair_capacity=pairs, cluster_pair_capacity=1 << 9, mesh_cull_cap=512, exact_order=True)
    jstep = jtr.make_train_step("surfel2", opt, pipe, 3.0, JRaster(pair_capacity=pairs, interpret=True),
                                envmap_n_samples=4, tracer_cfg=JTracer(interpret=True, **tr_kw), with_warp=True)
    js, _ = jstep(js, jc, jnp.asarray(gt), jextra, jn, jnp.asarray(near_gt), jmesh)  # warm-up: live moments
    ts = _state_to_torch(js)
    mu0 = {k: v.clone().numpy() for k, v in ts.adam.mu.items()}
    emu0 = {k: v.clone().numpy() for k, v in ts.env_adam.mu.items()}
    js, jmet = jstep(js, jc, jnp.asarray(gt), jextra, jn, jnp.asarray(near_gt), jmesh)
    tstep = ttr.make_train_step("surfel2", topt, tpipe, 3.0, TRaster(pair_capacity=pairs), envmap_n_samples=4,
                                tracer_cfg=TTracer(**tr_kw), with_warp=True)
    skip, n_kink = _env_kink_gaussians(tstep, ts, tc, textra, tmesh)
    assert n_kink <= 2 and len(skip) <= 16, (n_kink, skip)
    nsens, n_near = _normal_kink_sensitivity(tstep, ts, tc, textra, tmesh, gt, lam)
    tmet = tstep(ts, tc, torch.from_numpy(gt), textra, tmesh)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    _check_tb(tmet, jmet, ("loss_l1", "ssim", "loss_mask_entropy") + WARP_TB)
    live = {k for k in WARP_TB if float(jmet[k]) != 0.0}
    assert live == ({"loss_warp_bc", "loss_warp_rgh"} if preset == "glossy" else {"loss_warp_bc"}), live
    for k in ("tracer_overflow", "tracer_pairs", "mesh_cull_dropped", "overflow"):
        assert int(tmet[k]) == int(jmet[k]), k
    assert int(tmet["nearest_overflow"]) == 0 and tmet["tracer_pairs"] > 0
    jmu = _moments(*js.opt_state.mu)
    nskip = sorted({int(i) for k, b in nsens.items()
                    for i in np.nonzero((b.reshape(len(b), -1) > 0.5 * _grad_tol(jmu[k], mu0[k])).any(-1))[0]})
    assert n_near <= 128 and len(nskip) <= 4, (n_near, nskip)
    skip = sorted(set(skip) | set(nskip))
    lrs = ttr.param_lrs(topt, 3.0, ts.step - 1, ts.opacity_lr_scale)
    _check_grads_and_update(mu0, {k: v.numpy() for k, v in ts.adam.mu.items()}, jmu, _moments(*js.opt_state.nu),
                            {k: v.detach().numpy() for k, v in ts.params().items()},
                            _moments(js.model.params, js.env1, js.env2), lrs, int(js.opt_state.count), 8, "main",
                            skip)
    _check_grads_and_update(emu0, {k: v.numpy() for k, v in ts.env_adam.mu.items()},
                            _moments(js.env_gs_opt_state.mu), _moments(js.env_gs_opt_state.nu),
                            {k: v.detach().numpy() for k, v in ts.env_params().items()}, _moments(js.env_gs.params),
                            ttr.param_lrs(topt, 3.0, ts.step), int(js.env_gs_opt_state.count), 4, "env")


# ------------------------------------------------------------- port only --

def test_trainer_redoes_an_overflowing_nearest_render(monkeypatch):
    """The nearest view's geometry-only render is a second rasterization: at
    a pair capacity the view fits and its nearest view does not, the step is
    redone at the escalated capacity before the update, and
    renders_redone counts it."""
    cams, images, gt_means, rng = _synthetic_scene(n_cams=2, size=64)
    cams[0] = torch_camera(np.array([0.0, 0.5, -9.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, 64, 64,
                           device="cpu")  # far: fewer tiles, fewer pairs than its nearest view
    model = tgm.create_from_points(gt_means.astype(np.float32), rng.uniform(size=(64, 3)).astype(np.float32),
                                   capacity=128, device="cpu")
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=0, volume_render_until_iter=0, indirect_from_iter=100,
        multi_view_weight_from_iter=0, densify_from_iter=10**9, feature_rest_from_iter=100_000)
    needs = []
    for cam in cams:
        out = tapi.rasterize(model.xyz, model.get_scaling, model.get_rotation, model.get_opacity[:, 0],
                             model.get_colors(cam.camera_center), torch.zeros((model.capacity, 9)), cam,
                             torch.zeros(3), config=TRaster(pair_capacity=1 << 7))
        needs.append((1 << 7) + int(out["overflow"]))
    cap = -(-needs[0] // 128) * 128  # the view fits (capacities are multiples of 128)
    assert needs[1] > cap, needs
    trainer = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(), raster_cfg=TRaster(pair_capacity=cap),
                          envmap_res=16, nearest_ids=[[1], [0]], with_warp=True)
    monkeypatch.setattr(trainer, "_pick_view", lambda: 0)
    trainer.train(2, log_every=1)
    first, second = trainer.metrics_log
    assert first["warp_on"] == 1 and first["warp_near"] == 1
    assert first["renders_redone"] == 1 and first["overflow_redone"] == needs[1] - cap
    assert first["overflow"] == 0 and first["nearest_overflow"] == 0
    assert trainer.raster_cfg.pair_capacity >= needs[1]
    assert second["renders_redone"] == 0 and np.isfinite(second["loss_warp_bc"])


def test_train_cli_crosses_the_warp_gate_with_priors_and_mined_masks(tmp_path):
    """scripts/train_torch.py --device cpu past the warp gate on a 3-view
    Blender scene whose views are neighbours (8.6 deg apart): the warp runs
    on every step past multi_view_weight_from_iter, the normal priors are
    read from --metric3d_path and the masks are mined at
    ref_score_start_iter (--ref_score_path auto); a run resumed past that
    point mines at once."""
    scene, run, normals = str(tmp_path / "scene"), str(tmp_path / "run"), str(tmp_path / "normals")
    _write_blender_scene(scene, n_views=3, step=0.15)
    os.makedirs(normals)
    rng = np.random.default_rng(0)
    for i in range(3):
        n = _smooth_normals(rng, 32, 32)
        png.write_png(os.path.join(normals, f"r_{i}.png"), ((n + 1) / 2 * 255 + 0.5).astype(np.uint8))
    train = _load_script("train_torch")
    argv = ["-s", scene, "-m", run, "--device", "cpu", "--schedule_scale", "0.002", "--iterations", "9",
            "--capacity", "1024", "--pair_capacity", "16384", "--envmap_max_res", "16", "--log_every", "1",
            "--multi_view_weight_from_iter", "6", "--basecolor_warp_from_iter", "6", "--ref_score_start_iter", "7",
            "--metric3d_path", normals, "--ref_score_path", "auto", "--checkpoint_iterations", "8"]
    res = train.main(argv)
    tr = res["trainer"]
    log = tr.metrics_log
    assert [m["iteration"] for m in log] == list(range(1, 10))
    assert [m["warp_on"] for m in log] == [0] * 6 + [1] * 3
    assert all(m["warp_near"] in (0, 1, 2) and np.isfinite(m["loss_warp_bc"]) and m["loss_warp_bc"] > 0
               for m in log[6:])
    assert all(m["nearest_overflow"] == 0 and m["overflow"] == 0 for m in log[6:])
    assert all(len(n) > 0 for n in tr.nearest_ids)
    assert len(tr.normal_priors) == 3 and all(m["loss_mono_normal"] > 0 for m in log[6:])
    assert len(tr.ref_score_log) == 1 and len(tr.ref_score_masks) == 3
    assert "loss_ref_score" in log[-1] and all(np.isfinite(m["loss"]) for m in log)
    resumed = train.main(argv[:-2] + ["--start_checkpoint", run])
    assert [m["iteration"] for m in resumed["trainer"].metrics_log] == [9]
    assert len(resumed["trainer"].ref_score_log) == 1  # mined at the start of the resumed run
