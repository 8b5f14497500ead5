"""The port's surfel2 training slice against the JAX package: one `surfel2`
train step (env-GS traced indirect light, with a mesh in exact order and
without one in list order) from a carried-across JAX TrainState, TSDF mesh
extraction, then port-only runs of the Trainer across the surfel2 onset and
of the training CLI across `surfel` -> `surfel2`.

The JAX side runs as its own tests run it (jitted, Pallas in interpret mode
on the CPU). Gradient tolerances are tests/test_rasterize_grad.py:93's, as in
tests/test_torch_train.py."""
import dataclasses
import importlib.util
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
from materialrefgs_tpu.train import mesh_extract as jme  # noqa: E402
from materialrefgs_tpu.train import trainer as jtr  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd  # noqa: E402
from materialrefgs_torch.ops.tracer.api import TracerConfig as TTracer  # noqa: E402
from materialrefgs_torch.train import mesh_extract as tme  # noqa: E402
from materialrefgs_torch.render.shading import camera_rays_world  # noqa: E402
from materialrefgs_torch.train import losses as tlosses  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from materialrefgs_torch.utils.transforms import normalize, reflect  # noqa: E402
from test_torch_envgs import _jax_texel_grid, _mesh, _models  # noqa: E402
from test_torch_train import _load_script, _synthetic_scene, _write_blender_scene  # noqa: E402

W = H = 32
PAIRS = 1 << 12
ITERATION = 21000  # refnerf: past indirect_from_iter, before the warp gate


def _moments(p, e1=None, e2=None):
    d = {k: np.asarray(getattr(p, k)) for k in PARAM_SHAPES}
    if e1 is not None:
        d["env1"], d["env2"] = np.asarray(e1.base), np.asarray(e2.base)
    return d


def _state_to_torch(js):
    """A JAX TrainState with env-GS as the port's (models/convert.py)."""
    m, e = js.model, js.env_gs
    stats = ("xyz_gradient_accum", "denom", "max_radii2d")
    return convert.train_state_from_numpy(
        _moments(m.params), np.asarray(m.alive), int(m.active_sh_degree),
        {k: np.asarray(getattr(m, k)) for k in stats}, np.asarray(js.env1.base), np.asarray(js.env2.base),
        _moments(*js.opt_state.mu), _moments(*js.opt_state.nu), int(js.opt_state.count), int(js.step),
        float(js.opacity_lr_scale), device="cpu",
        env_gs={"params": _moments(e.params), "alive": np.asarray(e.alive),
                "active_sh_degree": int(e.active_sh_degree), "stats": {k: np.asarray(getattr(e, k)) for k in stats},
                "adam_mu": _moments(js.env_gs_opt_state.mu), "adam_nu": _moments(js.env_gs_opt_state.nu),
                "adam_count": int(js.env_gs_opt_state.count)},
    )


def _gt(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / H
    rgb = 0.5 + 0.4 * np.sin(5 * xx + 3 * yy)[..., None] * np.array([1.0, 0.6, 0.3])
    return np.clip(rgb + 0.03 * rng.normal(size=rgb.shape), 0, 1).astype(np.float32)


def _check_grads_and_update(mu0, mu_t, mu_j, nu_j, p_t, p_j, lrs, count, min_nonzero, what, skip=()):
    """Each gradient leaf, read from the new first moments as
    (mu_new - b1 mu_old) / (1 - b1), within 2e-3 x its scale + 1e-4; the
    updated parameters within what that tolerance carries through Adam. The
    gaussians in `skip` (under an env-map kink, _env_kink_gaussians) are left
    out of both."""
    n_nonzero = 0
    for k in mu_j:
        keep = np.ones(len(mu_j[k]), bool)
        if k in PARAM_SHAPES:
            keep[list(skip)] = False
        gj = (mu_j[k] - 0.9 * mu0[k])[keep] / 0.1
        gt_ = (mu_t[k] - 0.9 * mu0[k])[keep] / 0.1
        scale = max(float(np.abs(gj).max()), 1e-3)
        np.testing.assert_allclose(gt_, gj, atol=2e-3 * scale + 1e-4, err_msg=f"{what} grad {k}")
        dmu_hat = 0.1 * (2e-3 * scale + 1e-4) / (1 - 0.9**count)
        sq = np.sqrt(nu_j[k][keep] / (1 - 0.999**count)) + 1e-15
        err = np.abs(p_t[k] - p_j[k])[keep]
        assert np.all(err <= 2 * lrs[k] * dmu_hat / sq + 1e-6), f"{what} param {k}: {err.max()}"
        n_nonzero += bool(np.abs(gj).max() > 0)
    assert n_nonzero >= min_nonzero, (what, n_nonzero)


def _env_kink_gaussians(tstep, ts, camera, extra, mesh):
    """(main gaussians, pixel count) of the pixels whose specular env-map
    lookup lies within 1e-4 texel of a bilinear kink. There the texels the
    lookup blends change (tu or tv crosses an integer), so d specular /
    d normal jumps by the texels' second difference while the value is
    continuous. The two packages' normal maps differ by float32 rounding,
    which can put such a lookup on either side: at this test's seed, one
    pixel of the splat-visibility case does, and the gradients of the
    gaussians under it differ by up to a quarter of themselves (as much with
    the env trace's rays detached: the tracer plays no part)."""
    pkg, _ = tstep.render(ts, camera, extra, mesh)
    nmap = pkg["rend_normal"] / torch.clamp(pkg["rend_alpha"], min=1e-6)
    rays_d, _ = camera_rays_world(camera)
    _, u, v = tcm.dir_to_cube_uv(normalize(reflect(-rays_d, nmap)))
    R = ts.env1.base.shape[1]  # the one specular level at envmap_res 16
    tex = torch.stack([(u + 1.0) * (R / 2.0) - 0.5, (v + 1.0) * (R / 2.0) - 0.5]).detach()
    kink = ((tex - torch.round(tex)).abs() < 1e-4).any(0) & (pkg["rend_alpha"][..., 0].detach() > 0)
    if not bool(kink.any()):
        return [], 0
    g = torch.autograd.grad(pkg["rend_normal"][kink].sum(), ts.model.rotation)[0]
    return torch.nonzero(g.abs().sum(-1) > 0)[:, 0].tolist(), int(kink.sum())


def _normal_kink_sensitivity(tstep, ts, camera, extra, mesh, gt, lam):
    """How far float32 rounding can move each main gaussian's gradient
    through the normal-consistency loss mean(w |sn - rn|), per parameter
    leaf it reaches, and how many components of sn - rn lie at its kink.

    Where one flat surfel covers a pixel, its surf_normal (from the depth
    map's finite differences) and its rend_normal are the same vector up to
    float32 rounding: components of sn - rn of 1e-9..5e-7 at alphas of
    0.02-0.33, whose signs the two packages' roundings set independently (at
    ground-truth seed 3, 36-47 components of 20-24 pixels have opposite
    signs). d|x|/dx there is +-1, so each such component moves the gradient
    by up to 2 lam w / (H W) |d(sn - rn)/d param|. At seed 3 one xyz
    gradient of one gaussian differs by 1.6-2.2e-4 (2-2.6 % of itself, above
    its 1.4e-4 tolerance) in both visibility modes, and the case passes with
    lambda_normal_render_depth at 0: the loss's kink, not the port, sets the
    difference. Returns ({leaf: (P, ...) bound}, number of components within
    1e-6 of the kink)."""
    pkg, _ = tstep.render(ts, camera, extra, mesh)
    d = pkg["surf_normal"] - pkg["rend_normal"]
    near = (d.detach().abs() <= 1e-6) & (pkg["rend_alpha"].detach() > 0) & (pkg["rend_normal"].detach() != 0)
    iw = torch.clamp(1.0 - tlosses.get_img_grad_weight(torch.from_numpy(gt)), 0, 1) ** 2
    leaves = {k: getattr(ts.model, k) for k in ("xyz", "scaling", "rotation", "opacity")}
    sens = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for y, x, c in torch.nonzero(near).tolist():
        grads = torch.autograd.grad(d[y, x, c], list(leaves.values()), retain_graph=True, allow_unused=True)
        for k, g in zip(leaves, grads):
            if g is not None:
                sens[k] += (2.0 * lam * float(iw[y, x]) / (H * W)) * g.abs()
    return {k: v.detach().numpy() for k, v in sens.items()}, int(near.sum())


def _grad_tol(mu_new, mu_old):
    """_check_grads_and_update's tolerance of one leaf's gradient."""
    g = (mu_new - 0.9 * mu_old) / 0.1
    return 2e-3 * max(float(np.abs(g).max()), 1e-3) + 1e-4


@pytest.mark.parametrize("visibility, seed", [
    pytest.param("mesh_exact", 1, id="mesh_exact"), pytest.param("splat_list", 1, id="splat_list"),
    pytest.param("mesh_exact", 3, id="mesh_exact-seed3"), pytest.param("splat_list", 3, id="splat_list-seed3")])
def test_surfel2_step_matches_jax(visibility, seed, monkeypatch):
    """One surfel2 step in both packages from the same state (a JAX state
    with env-GS after one warm-up step, carried across, so both Adams are
    live): loss, every gradient leaf of both models (read from the new first
    moments), the parameters after the update, and both models' statistics.
    The main gaussians under an env-map kink (_env_kink_gaussians) or whose
    gradient the normal loss's kink can move by half its tolerance
    (_normal_kink_sensitivity) are left out."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    exact = visibility == "mesh_exact"
    _, pipe, opt = jcfg.preset_refnerf()
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    tpipe = tcfg.PipelineParams(**dataclasses.asdict(pipe))
    (jm, _), (jenv, _), env_base = _models()
    js = jtr.init_train_state(jm, opt, envmap_res=16)
    js = js.replace(env1=JEnv(base=jnp.asarray(env_base)), env_gs=jenv,
                    env_gs_opt_state=jtr.make_optimizer().init(jenv.params))
    kw = dict(eye=np.array([0.3, -0.4, -3.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.8, fovy=0.8, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    verts, faces = _mesh()
    jmesh = jmt.build_mesh(verts, faces) if exact else None
    tmesh = tmt.build_mesh(verts, faces, device="cpu") if exact else None
    gt = _gt(seed)
    mask = (np.add.outer((np.arange(H) - H / 2) ** 2, (np.arange(W) - W / 2) ** 2) < 13**2).astype(np.float32)
    lam = jtr.normal_loss_weight_schedule(ITERATION, opt)
    jextra = {"iteration": jnp.float32(ITERATION), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(0.0), "warp_key": jax.random.PRNGKey(0), "bg": jnp.ones(3),
              "image_mask": jnp.asarray(mask), "env_geo_lr_scale": jnp.float32(1.0)}
    tr_kw = dict(pair_capacity=PAIRS, cluster_pair_capacity=1 << 9, mesh_cull_cap=512, exact_order=exact)
    jstep = jtr.make_train_step("surfel2", opt, pipe, 3.0, JRaster(pair_capacity=PAIRS, interpret=True),
                                envmap_n_samples=4, tracer_cfg=JTracer(interpret=True, **tr_kw))
    js, _ = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt), jmesh)  # warm-up: live moments
    ts = _state_to_torch(js)
    mu0 = {k: v.clone().numpy() for k, v in ts.adam.mu.items()}
    emu0 = {k: v.clone().numpy() for k, v in ts.env_adam.mu.items()}
    js, jmet = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt), jmesh)

    textra = {"iteration": float(ITERATION), "lambda_normal_render_depth": lam, "bg": torch.ones(3),
              "image_mask": torch.from_numpy(mask), "env_geo_lr_scale": 1.0}
    tstep = ttr.make_train_step("surfel2", topt, tpipe, 3.0, TRaster(pair_capacity=PAIRS), envmap_n_samples=4,
                                tracer_cfg=TTracer(**tr_kw))
    skip, n_kink = _env_kink_gaussians(tstep, ts, tc, textra, tmesh)
    assert n_kink <= 2 and len(skip) <= 16, (n_kink, skip)  # one or two pixels and the gaussians under them
    nsens, n_near = _normal_kink_sensitivity(tstep, ts, tc, textra, tmesh, gt, lam)
    launches = (trace_fwd.trace_bundles_fwd.launches, trace_bwd.trace_bundles_bwd.launches)
    tmet = tstep(ts, tc, torch.from_numpy(gt), textra, tmesh)
    assert (trace_fwd.trace_bundles_fwd.launches, trace_bwd.trace_bundles_bwd.launches) == launches

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    for k in ("loss_l1", "ssim", "loss_normal_render_depth", "loss_mask_entropy"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for k in ("tracer_overflow", "tracer_pairs", "mesh_cull_dropped", "overflow"):
        assert int(tmet[k]) == int(jmet[k]), k
    assert tmet["tracer_pairs"] > 0 and tmet["tracer_overflow"] == 0
    assert ts.step == int(js.step) and ts.adam.count == int(js.opt_state.count)
    assert ts.env_adam.count == int(js.env_gs_opt_state.count) == 2

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
    # The env-GS model: its own Adam, learning rates at the step after the
    # increment, gradients from the trace only.
    elrs = ttr.param_lrs(topt, 3.0, ts.step)
    _check_grads_and_update(emu0, {k: v.numpy() for k, v in ts.env_adam.mu.items()},
                            _moments(js.env_gs_opt_state.mu), _moments(js.env_gs_opt_state.nu),
                            {k: v.detach().numpy() for k, v in ts.env_params().items()},
                            _moments(js.env_gs.params), elrs, int(js.env_gs_opt_state.count), 4, "env")
    g_env = (ts.env_adam.mu["xyz"].numpy() - 0.9 * emu0["xyz"]) / 0.1
    assert np.abs(g_env).max() > 0 and np.abs((ts.env_adam.mu["opacity"].numpy() - 0.9 * emu0["opacity"])).max() > 0
    for model_t, model_j, drop in ((ts.model, js.model, skip), (ts.env_gs, js.env_gs, [])):
        keep = np.ones(model_t.capacity, bool)
        keep[drop] = False
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            a, b = getattr(model_t, k).numpy()[keep], np.asarray(getattr(model_j, k))[keep]
            np.testing.assert_allclose(a, b, atol=2e-3 * max(float(np.abs(b).max()), 1e-3) + 1e-6, err_msg=k)
    assert float(ts.env_gs.denom.sum()) > 0


def test_extract_mesh_matches_jax():
    """TSDF fusion, marching tetrahedra and the largest component on the
    same depth and alpha maps: the same triangles."""
    cams_t, cams_j, depths, alphas = [], [], [], []
    for i in range(3):
        ang = 2.0 * i
        kw = dict(eye=np.array([3.0 * np.sin(ang), 0.4, -3.0 * np.cos(ang)]), target=np.zeros(3),
                  up=np.array([0.0, 1.0, 0.0]), fovx=0.8, fovy=0.8, width=40, height=36)
        cams_t.append(torch_camera(**kw, device="cpu"))
        cams_j.append(jax_camera(**kw))
        # Depth of a sphere of radius 0.8 at the origin seen from this camera.
        c = cams_t[-1]
        yy, xx = np.mgrid[0:36, 0:40].astype(np.float64)
        d = np.stack([(xx - c.cx) / c.fx, (yy - c.cy) / c.fy, np.ones_like(xx)], -1)
        wv = c.world_view.numpy().astype(np.float64)
        R, o = wv[:3, :3], c.camera_center.numpy().astype(np.float64)
        dw = d @ R.T
        b = np.sum(dw * o, -1)
        qa = np.sum(dw * dw, -1)
        disc = b * b - qa * (o @ o - 0.64)
        z = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / qa, 0.0)
        depths.append(z.astype(np.float32))
        alphas.append((disc > 0).astype(np.float32))
    jv, jf = jme.extract_mesh(cams_j, depths, alphas, resolution=40)
    tv, tf = tme.extract_mesh(cams_t, depths, alphas, resolution=40)
    assert len(jf) > 200
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    dv, df = tme.decimate_vertex_clustering(tv, tf, 100)
    jdv, jdf = jme.decimate_vertex_clustering(jv, jf, 100)
    np.testing.assert_array_equal(df, jdf)
    np.testing.assert_allclose(dv, jdv, atol=1e-5)


def _onset_trainer(cams, images, gt_means, rng, opt_kw=None, **kw):
    model = tgm.create_from_points(gt_means.astype(np.float32), rng.uniform(size=(len(gt_means), 3)).astype(np.float32),
                                   capacity=128, device="cpu")
    opt = dataclasses.replace(tcfg.OptimizationParams(), **{
        **dict(use_perceptual_loss=False, initial=1, init_until_iter=1, volume_render_until_iter=0,
               indirect_from_iter=2, multi_view_weight_from_iter=10**9, densify_from_iter=10**9,
               feature_rest_from_iter=100_000, lambda_normal_render_depth=0.0, lambda_dist=0.0,
               env_densify_interval=2, env_reset_interval=4, env_update_until_iter=100, env_prune_grace=3),
        **(opt_kw or {}),
    })
    kw.setdefault("cameras_extent", 3.0)
    return ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(),
                       raster_cfg=TRaster(pair_capacity=1 << 12), envmap_res=16, **kw)


def test_trainer_across_the_surfel2_onset():
    """tests/test_trainer_e2e.py:159-200 in the port, at 32x32: the demand
    probe presizes the tracer budget at the onset, so every surfel2 step
    traces env pairs without overflow and without a redo; env densify and
    reset run on their schedule; and a cloud pruned to nothing is re-seeded
    from the main model."""
    cams, images, gt_means, rng = _synthetic_scene(n_cams=2)
    trainer = _onset_trainer(cams, images, gt_means, rng, use_mesh_visibility=False,
                             tracer_cfg=TTracer(pair_capacity=1 << 6, cluster_pair_capacity=1 << 9))
    trainer.train(6, log_every=1)
    assert trainer.tracer_cfg.pair_capacity > 1 << 6
    log = trainer.metrics_log
    assert [m["stage"] for m in log] == ["initial", "surfel"] + ["surfel2"] * 4
    for m in log[2:]:
        assert m["tracer_overflow"] == 0 and m["tracer_overflow_redone"] == 0 and m["tracer_pairs"] > 0, m
        assert m["env_n_alive"] > 0 and np.isfinite(m["loss"])
    # The env reset at 4 (and its grace: the densify at 6 pruned nothing);
    # env densify at 6 zeroed the env statistics.
    assert trainer._env_reset_at == 4 and trainer.state.env_adam.count == 4
    env = trainer.state.env_gs
    assert float(env.denom.abs().sum()) == 0.0
    for name, p in trainer.state.env_params().items():
        assert torch.isfinite(p).all(), name

    # Extinction: past the grace, the env densify at 8 prunes every env
    # gaussian; the step after it (9) re-seeds the cloud from the main model.
    with torch.no_grad():
        env.opacity.fill_(-15.0)
    trainer._env_signal_steps = 10
    trainer.train(3, start_iter=7, log_every=1)
    log = trainer.metrics_log
    n_main = int(trainer.state.model.n_alive)
    assert [m["env_n_alive"] for m in log[-2:]] == [0, n_main] and n_main > 0
    assert trainer._env_reset_at is None and trainer.state.env_adam.count == 0


def test_trainer_surfel2_with_mesh_and_list_order():
    """With mesh visibility the onset extracts a mesh (and mesh_every
    re-extracts it), and the env trace runs over the occluded bundles only;
    list order trains too."""
    cams, images, gt_means, rng = _synthetic_scene(n_cams=2)
    trainer = _onset_trainer(cams, images, gt_means, rng, mesh_every=4,
                             tracer_cfg=TTracer(pair_capacity=1 << 12, cluster_pair_capacity=1 << 9,
                                                mesh_cull_cap=512, exact_order=False))
    trainer.MESH_RESOLUTION = 32
    trainer.train(5, log_every=1)
    assert [it for it, _, _ in trainer.mesh_log] == [3, 4]
    assert trainer.mesh is not None and all(n > 0 for _, n, _ in trainer.mesh_log)
    for m in trainer.metrics_log[2:]:
        assert m["mesh_cull_dropped"] == 0 and m["tracer_overflow"] == 0 and np.isfinite(m["loss"])


def test_trainer_surfel2_with_main_densify_prune_and_reset():
    """The main model's densify, prune and opacity reset inside surfel2, while
    the env-GS model, the traced mesh and the onset's tracer budgets are live:
    densify every step from the onset (3) clones every gaussian into the free
    slots (an extent of 100 makes each small enough to clone), the mesh is
    re-extracted from the densified model at 4, the prune at 5 removes the
    gaussians whose opacity was pulled below the threshold, the reset at 5
    drops the rest to 0.01, and the densify at 6 (in the reset's grace)
    clones into the freed slots; every step traces env pairs within the
    onset's budgets over the mesh."""
    cams, images, gt_means, rng = _synthetic_scene(n_cams=2)
    trainer = _onset_trainer(
        cams, images, gt_means, rng, mesh_every=4, cameras_extent=100.0,
        opt_kw=dict(densify_from_iter=2, densify_until_iter=100, densification_interval_when_prop=1,
                    densify_grad_threshold=0.0, opacity_reset_interval=5, prune_grace=2),
        tracer_cfg=TTracer(pair_capacity=1 << 12, cluster_pair_capacity=1 << 9, mesh_cull_cap=512,
                           exact_order=True))
    trainer.MESH_RESOLUTION = 32
    trainer.train(4, log_every=1)
    model, env = trainer.state.model, trainer.state.env_gs
    n_env_cap = env.capacity
    assert int(model.n_alive) == model.capacity  # the clones at 3 filled every free slot
    doomed = torch.nonzero(model.alive)[:8, 0]
    with torch.no_grad():
        model.opacity[doomed] = -6.0  # below prune_opacity_threshold
    trainer.train(1, start_iter=5, log_every=1)
    assert not bool(model.alive[doomed].any())
    alive = model.alive
    assert float(model.get_opacity[alive].detach().max()) <= 0.01 + 1e-6  # the reset at 5
    trainer.train(1, start_iter=6, log_every=1)
    assert int(model.n_alive) == model.capacity  # the clones at 6 took the pruned slots

    log = trainer.metrics_log
    assert [m["stage"] for m in log] == ["initial", "surfel"] + ["surfel2"] * 4
    assert [it for it, _, _ in trainer.mesh_log] == [3, 4] and all(n > 0 for _, n, _ in trainer.mesh_log)
    for m in log[2:]:
        assert m["tracer_overflow"] == 0 and m["mesh_cull_dropped"] == 0 and m["tracer_pairs"] > 0, m
        assert np.isfinite(m["loss"]) and m["env_n_alive"] > 0 and m["env_grad_opacity"] > 0, m
    assert env.capacity == n_env_cap and trainer.state.env_adam.count == 4
    for name, p in list(trainer.state.params().items()) + list(trainer.state.env_params().items()):
        assert torch.isfinite(p).all(), name


def test_train_cli_across_the_surfel2_onset(tmp_path, monkeypatch):
    """scripts/train_torch.py --device cpu across surfel -> surfel2: it writes
    the env PLY and the mesh, scripts/eval_torch.py serves them, a checkpoint
    resumes past the onset, --start_ply with an env cloud warm-starts it, and
    the refnerf schedule's warp gate opens on the way (the two views are
    neighbours)."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene, step=0.15)
    train = _load_script("train_torch")
    # A 32^3 TSDF and a 2048-triangle traced mesh keep the five extractions
    # and the plain mesh tracer short at 32x32.
    monkeypatch.setattr(ttr.Trainer, "MESH_RESOLUTION", 32)
    monkeypatch.setattr(ttr.Trainer, "MESH_TRI_CAPACITY", 2048)
    # schedule 0.0005: indirect_from_iter 10, mesh_every 1 -> 4 via the flag;
    # the resets' cadences (2 and 3 at this scale) moved out of the way so
    # the clouds the test reads stay alive.
    argv = ["-s", scene, "-m", run, "--device", "cpu", "--schedule_scale", "0.0005",
            "--iterations", "12", "--capacity", "1024", "--pair_capacity", "16384",
            "--tracer_pair_capacity", "16384", "--envmap_max_res", "16", "--log_every", "1",
            "--mesh_every", "4", "--opacity_reset_interval", "1000", "--env_reset_interval", "1000",
            "--multi_view_weight_from_iter", "1000",
            "--checkpoint_iterations", "11", "--test_iterations", "12"]
    res = train.main(argv)
    log = res["trainer"].metrics_log
    assert [m["iteration"] for m in log] == list(range(1, 13))
    assert [m["stage"] for m in log][-2:] == ["surfel2", "surfel2"]
    assert all(np.isfinite(m["loss"]) for m in log)
    ply_dir = os.path.dirname(res["ply"])
    assert os.path.exists(os.path.join(ply_dir, "env_point_cloud.ply"))
    meshes = sorted(os.listdir(os.path.join(run, "meshes")))
    assert meshes == ["test_000011.ply", "test_000012.ply"], meshes
    assert np.isfinite(res["test"][12]["psnr"])
    m = _load_script("eval_torch").main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu"])["test"]
    assert np.isfinite(m["psnr"]) and m["tracer_overflow"] == 0

    resumed = train.main(argv[:-4] + ["--start_checkpoint", run, "--iterations", "12"])
    assert [m["iteration"] for m in resumed["trainer"].metrics_log] == [12]
    assert resumed["trainer"].state.env_adam.count == 2  # the env Adam's count came with it
    warm = train.main(argv[:-4] + ["--start_ply", ply_dir, "--start_iter", "12", "--iterations", "13"])
    st = warm["trainer"].state
    assert [m["iteration"] for m in warm["trainer"].metrics_log] == [13]
    assert st.env_gs is not None and st.env_adam.count == 1 and warm["trainer"].metrics_log[-1]["env_n_alive"] > 0
    # Without the override the refnerf schedule's warp gate (25000 x 0.0005
    # = 12) opens at 13: the step renders its neighbour and adds the
    # base-colour warp.
    i = argv.index("--multi_view_weight_from_iter")
    plain = argv[:i] + argv[i + 2 : -4]
    past = train.main(plain + ["--start_ply", ply_dir, "--start_iter", "12", "--iterations", "13"])
    m = past["trainer"].metrics_log[-1]
    assert m["iteration"] == 13 and m["stage"] == "surfel2" and m["warp_on"] == 1 and m["warp_near"] in (0, 1)
    assert m["loss_warp_bc"] > 0 and np.isfinite(m["loss"]) and m["nearest_overflow"] == 0
