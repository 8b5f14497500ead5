"""The refreal preset in the port's training against the JAX package: one
`surfel` step past the warp gate and one `surfel2` step, each with the LPIPS
term at random weights, the ref-score supervision, lambda_dist = 1000 and
refreal's geometric and NCC warp terms, from a JAX state carried across by
models/convert.py, at a non-square frame whose sides are not multiples of 16
(45x29) seen by a COLMAP-style camera (fx != fy, off-centre principal
point); then the training CLI on a COLMAP scene at -r 2 and the eval of its
checkpoint.

The JAX side runs as its own tests run it (jitted, Pallas in interpret mode
on the CPU). Tolerances are the step-parity ones of
tests/test_torch_train_warp.py."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_train_surfel2 as s2t  # noqa: E402
from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.data import readers as jrd  # noqa: E402
from materialrefgs_tpu.models import scene as jscene  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import mesh_tracer as jmt  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.ops.tracer.api import TracerConfig as JTracer  # noqa: E402
from materialrefgs_tpu.train import lpips as jlp  # noqa: E402
from materialrefgs_tpu.train import trainer as jtr  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.data import readers as trd  # noqa: E402
from materialrefgs_torch.models import scene as tscene  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.ops.tracer.api import TracerConfig as TTracer  # noqa: E402
from materialrefgs_torch.train import lpips as tlp  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402
from test_lpips import make_fake_weights  # noqa: E402
from test_torch_colmap import look_at_qt, ring_eyes, write_colmap  # noqa: E402
from test_torch_envgs import _jax_texel_grid, _mesh, _models  # noqa: E402
from test_torch_train import _load_script, jax_model  # noqa: E402
from test_torch_train import _state_to_torch as surfel_state_to_torch  # noqa: E402
from test_torch_train_warp import WARP_TB, _check_tb, _warp_extras  # noqa: E402

W, H = 45, 29
IT = 161  # refreal x 0.01: past the warp gate (70), ref-score (100), LPIPS (160)


def _colmap_cams(eye, deg):
    """(JAX, port) cameras built from COLMAP intrinsics (fx != fy by 1.3 %,
    principal point off centre) at `eye` and at `eye` turned by `deg` about
    the vertical axis, both looking at the origin."""
    from materialrefgs_torch.data.colmap_loader import qvec2rotmat

    t = np.deg2rad(deg)
    rot = np.array([[np.cos(t), 0.0, np.sin(t)], [0.0, 1.0, 0.0], [-np.sin(t), 0.0, np.cos(t)]])
    f = 0.9 * W
    K = np.array([[f, 0.0, W / 2 + 1.3], [0.0, 1.013 * f, H / 2 - 0.9], [0.0, 0.0, 1.0]])
    out = []
    for e in (eye, rot @ eye):
        q, tv = look_at_qt(np.asarray(e, np.float64))
        kw = dict(uid=0, R=qvec2rotmat(q).T, T=tv, K=K, FovY=2 * np.arctan(H / (2 * K[1, 1])),
                  FovX=2 * np.arctan(W / (2 * K[0, 0])), image_path="", image_name="v", width=W, height=H)
        out.append((jscene.build_camera(jrd.CameraInfo(**kw)), tscene.build_camera(trd.CameraInfo(**kw), 1, "cpu")))
    return out


def _refreal(stage):
    _, pipe, opt = jcfg.preset_refreal()
    opt = jcfg.scale_schedule(opt, 0.01)
    # dilate_size 1: the preset's 7 would mask every warp sample of so small
    # a frame (as tests/test_torch_train_warp.py does at 48x40 and 32x32).
    opt = dataclasses.replace(opt, dilate_size=1)
    assert opt.lambda_dist == 1000.0 and opt.use_perceptual_loss and opt.use_warp_geo_loss and opt.use_warp_ncc_loss
    assert IT > max(opt.multi_view_weight_from_iter, opt.perceptual_loss_start_iter, opt.ref_score_start_iter,
                    opt.dist_loss_start)
    assert jtr.select_stage(IT, opt) == "surfel2"  # the surfel step is called past its stage, as a step can be
    return pipe, opt, tcfg.PipelineParams(**dataclasses.asdict(pipe)), tcfg.OptimizationParams(**dataclasses.asdict(opt))


def _extras(rng, it, lam, jn_near, near_gt, key):
    mask = (np.add.outer((np.arange(H) - H / 2) ** 2, (np.arange(W) - W / 2) ** 2) < 12**2).astype(np.float32)
    rs_mask = (rng.uniform(size=(H, W)) > 0.6).astype(np.float32)
    jextra = {"iteration": jnp.float32(it), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(0.0), "bg": jnp.zeros(3), "image_mask": jnp.asarray(mask),
              "ref_score_mask": jnp.asarray(rs_mask), "env_geo_lr_scale": jnp.float32(1.0)}
    textra = {"iteration": float(it), "lambda_normal_render_depth": lam, "bg": torch.zeros(3),
              "image_mask": torch.from_numpy(mask), "ref_score_mask": torch.from_numpy(rs_mask),
              "env_geo_lr_scale": 1.0}
    jn = _warp_extras(jextra, textra, jn_near, near_gt, key, H, W)
    return jextra, textra, jn


def _lpips_render_sensitivity(tstep, ts, camera, extra, jrender, gt, weights, lam):
    """How far the other package's rounding of the render can move each
    gradient through the LPIPS term: the port's gradient of lam x LPIPS with
    its cotangent taken at its own render and at the JAX package's render of
    the same state ({leaf: |difference|}). With random VGG weights the
    distance has kinks (ReLU and max-pool switches) within float32 rounding
    of a render: at this test's `surfel` state a 1e-6 perturbation of the
    render moves the LPIPS cotangent by 15 % of its largest value, and the
    two packages' renders differ by up to 3e-5, which moves one gaussian's
    xyz gradient by 6 % of itself. The LPIPS gradient itself, on the same
    input, is held in tests/test_torch_lpips.py."""
    from materialrefgs_torch.train import lpips as lp

    pkg, _ = tstep.render(ts, camera, extra)
    r = pkg["render"]
    assert float((r.detach() - torch.from_numpy(jrender)).abs().max()) < 1e-4  # the same render, up to rounding
    leaves = {k: v for k, v in ts.params().items() if k not in ("env1", "env2")}
    gtt = torch.from_numpy(gt)
    g1 = torch.autograd.grad(lam * lp.lpips(r, gtt, weights), list(leaves.values()), retain_graph=True,
                             allow_unused=True)
    g2 = torch.autograd.grad(lam * lp.lpips(r - r.detach() + torch.from_numpy(jrender), gtt, weights),
                             list(leaves.values()), allow_unused=True)
    return {k: (a - b).abs().numpy() for k, a, b in zip(leaves, g1, g2) if a is not None}


REFREAL_TB = ("loss_l1", "ssim", "loss_mask_entropy", "loss_ref_score", "perceptual_loss", "loss_dist")


@pytest.mark.parametrize("stage", ["surfel", "surfel2"])
def test_refreal_step_matches_jax(stage, monkeypatch, tmp_path):
    """One refreal step of each deferred stage at iteration 161 (x0.01
    schedule): the loss and its terms (LPIPS, distortion at 1000, ref-score,
    the warp terms), every gradient leaf, the parameters after the update
    and, in `surfel`, the densification statistics. The gaussians under a
    normal-loss kink (in `surfel2`, mesh visibility and exact order, also an
    env-map kink) are left out, as in tests/test_torch_train_surfel2.py (at
    this frame the `surfel` step has 3 of them), and in `surfel` those whose
    gradient the LPIPS term's kinks can move by the packages' render
    rounding (_lpips_render_sensitivity)."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    monkeypatch.setattr(s2t, "H", H)
    monkeypatch.setattr(s2t, "W", W)
    pipe, opt, tpipe, topt = _refreal(stage)
    wpath = make_fake_weights(str(tmp_path / "w.npz"), np.random.default_rng(4))
    jw, tw = jlp.load_weights(wpath), tlp.load_weights(wpath)
    rng = np.random.default_rng(12)
    lam = jtr.normal_loss_weight_schedule(IT, opt)
    gt, near_gt = s2t._gt(1), s2t._gt(2)
    pairs = 1 << 14
    if stage == "surfel":
        jm = jax_model(9, sh_degree=1)
        jm = jm.replace(max_radii2d=jnp.zeros(jm.capacity), xyz_gradient_accum=jnp.zeros(jm.capacity),
                        denom=jnp.zeros(jm.capacity))
        js = jtr.init_train_state(jm, opt, envmap_res=32)
        js = js.replace(env1=JEnv(base=jnp.asarray(rng.normal(size=(6, 32, 32, 3)).astype(np.float32))))
        (jc, tc), near = _colmap_cams(np.array([0.4, -0.5, -3.5]), 9.0)
        jmesh = tmesh = None
        tr_kw = {}
    else:
        (jm, _), (jenv, _), env_base = _models()
        js = jtr.init_train_state(jm, opt, envmap_res=16)
        js = js.replace(env1=JEnv(base=jnp.asarray(env_base)), env_gs=jenv,
                        env_gs_opt_state=jtr.make_optimizer().init(jenv.params))
        (jc, tc), near = _colmap_cams(np.array([0.3, -0.4, -3.0]), 8.0)
        verts, faces = _mesh()
        jmesh, tmesh = jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu")
        tr_kw = dict(pair_capacity=1 << 12, cluster_pair_capacity=1 << 9, mesh_cull_cap=512, exact_order=True)
    jextra, textra, jn = _extras(rng, IT, lam, near, near_gt, jax.random.PRNGKey(7))
    jkw = dict(envmap_n_samples=4, tracer_cfg=JTracer(interpret=True, **tr_kw)) if stage == "surfel2" else {}
    tkw = dict(envmap_n_samples=4, tracer_cfg=TTracer(**tr_kw)) if stage == "surfel2" else {}
    jstep = jtr.make_train_step(stage, opt, pipe, 3.0, JRaster(pair_capacity=pairs, interpret=True),
                                with_warp=True, lpips_weights=jw, **jkw)
    args = (jnp.asarray(gt), jextra, jn, jnp.asarray(near_gt)) + ((jmesh,) if jmesh is not None else ())
    js, _ = jstep(js, jc, *args)  # warm-up: live moments
    jrender = None
    if stage == "surfel":
        from materialrefgs_tpu.models.env_light import EnvLightMips as JMips
        from materialrefgs_tpu.render import renderers as jrend

        jrender = np.asarray(jrend.render_surfel(
            js.model, jc, jextra["bg"], JMips.build(js.env1, n_samples=32),
            jrend.RenderOptions(depth_ratio=pipe.depth_ratio, unbiased_depth=pipe.unbiased_depth, srgb=opt.srgb,
                                raster=JRaster(pair_capacity=pairs, interpret=True)))["render"])
    ts = s2t._state_to_torch(js) if stage == "surfel2" else surfel_state_to_torch(js)
    mu0 = {k: v.clone().numpy() for k, v in ts.adam.mu.items()}
    js, jmet = jstep(js, jc, *args)
    tstep = ttr.make_train_step(stage, topt, tpipe, 3.0, TRaster(pair_capacity=pairs), with_warp=True,
                                lpips_weights=tw, **tkw)
    skip = []
    if stage == "surfel2":
        emu0 = {k: v.clone().numpy() for k, v in ts.env_adam.mu.items()}
        skip, n_kink = s2t._env_kink_gaussians(tstep, ts, tc, textra, tmesh)
        assert n_kink <= 2 and len(skip) <= 16, (n_kink, skip)
    nsens, n_near = s2t._normal_kink_sensitivity(tstep, ts, tc, textra, tmesh, gt, lam)
    lsens = {}
    if jrender is not None:
        lsens = _lpips_render_sensitivity(tstep, ts, tc, textra, jrender, gt, tw, opt.lambda_perceptual_loss)
    tmet = tstep(ts, tc, torch.from_numpy(gt), textra, tmesh)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    live = {k for k in WARP_TB if float(jmet[k]) != 0.0}
    assert {"loss_warp_geo", "loss_warp_bc"} <= live, live
    _check_tb(tmet, jmet, REFREAL_TB + tuple(sorted(live)))
    assert all(float(jmet[k]) > 0 for k in ("perceptual_loss", "loss_dist", "loss_ref_score")), jmet
    assert int(tmet["overflow"]) == int(tmet["nearest_overflow"]) == 0
    jmu = s2t._moments(*js.opt_state.mu)
    if stage == "surfel2":
        for k in ("tracer_overflow", "tracer_pairs", "mesh_cull_dropped"):
            assert int(tmet[k]) == int(jmet[k]), k
        assert tmet["tracer_pairs"] > 0
    nskip = sorted({int(i) for k, b in nsens.items()
                    for i in np.nonzero((b.reshape(len(b), -1) > 0.5 * s2t._grad_tol(jmu[k], mu0[k])).any(-1))[0]})
    lskip = sorted({int(i) for k, b in lsens.items() if k in jmu
                    for i in np.nonzero((b.reshape(len(b), -1) > 0.5 * s2t._grad_tol(jmu[k], mu0[k])).any(-1))[0]})
    # tests/test_torch_train_surfel2.py's bounds, the components' per pixel
    # of its 32x32 frame.
    assert n_near <= 128 * H * W // 1024 and len(nskip) <= 4, (n_near, nskip)
    assert len(lskip) <= 8, lskip  # 8 of the 200 gaussians at this state
    skip = sorted(set(skip) | set(nskip) | set(lskip))
    lrs = ttr.param_lrs(topt, 3.0, ts.step - 1, ts.opacity_lr_scale)
    s2t._check_grads_and_update(mu0, {k: v.numpy() for k, v in ts.adam.mu.items()}, jmu,
                                s2t._moments(*js.opt_state.nu), {k: v.detach().numpy() for k, v in ts.params().items()},
                                s2t._moments(js.model.params, js.env1, js.env2), lrs, int(js.opt_state.count), 8,
                                stage, skip)
    if stage == "surfel":
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            a, b = getattr(ts.model, k).numpy(), np.asarray(getattr(js.model, k))
            np.testing.assert_allclose(a, b, atol=2e-3 * max(float(np.abs(b).max()), 1e-3) + 1e-6, err_msg=k)
    else:
        s2t._check_grads_and_update(emu0, {k: v.numpy() for k, v in ts.env_adam.mu.items()},
                                    s2t._moments(js.env_gs_opt_state.mu), s2t._moments(js.env_gs_opt_state.nu),
                                    {k: v.detach().numpy() for k, v in ts.env_params().items()},
                                    s2t._moments(js.env_gs.params), ttr.param_lrs(topt, 3.0, ts.step),
                                    int(js.env_gs_opt_state.count), 4, "env")


def test_train_cli_refreal_on_a_colmap_scene(tmp_path, monkeypatch):
    """scripts/train_torch.py --preset refreal -r 2 --device cpu on a COLMAP
    scene of 106x74 PNG photos (trained at 53x37) with the preset's mask/ dir
    (masks at the photos' size, resized NEAREST), across every refreal stage
    at x0.0005: the warp, the mined ref-score masks, the surfel2 onset with
    the unbounded TSDF, and LPIPS at random weights from 9; then
    scripts/eval_torch.py serves the checkpoint at the run's resolution.
    Without weights the run goes on and cfg_args.json says lpips_disabled."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    write_colmap(scene, [e * 3.5 / 3.2 for e in ring_eyes(4)], (106, 74))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:74, 0:106]
    for d in ("images", "mask"):
        os.makedirs(os.path.join(scene, d))
    for i in range(4):
        disc = ((xx - 53) ** 2 + (yy - 37) ** 2 < 28**2)
        rgb = np.clip(0.5 + 0.4 * np.sin(0.1 * xx + 0.07 * yy + i)[..., None] * [1.0, 0.6, 0.3]
                      + 0.03 * rng.normal(size=(74, 106, 3)), 0, 1) * disc[..., None]
        png.write_png(os.path.join(scene, "images", f"view_{i:03d}.png"), (rgb * 255 + 0.5).astype(np.uint8))
        png.write_png(os.path.join(scene, "mask", f"view_{i:03d}.png"),
                      np.repeat((disc * 255).astype(np.uint8)[..., None], 3, -1))
    monkeypatch.setenv(tlp.DEFAULT_WEIGHTS_ENV, make_fake_weights(str(tmp_path / "w.npz"), rng))
    monkeypatch.setattr(ttr.Trainer, "MESH_RESOLUTION", 32)
    monkeypatch.setattr(ttr.Trainer, "MESH_TRI_CAPACITY", 2048)
    train = _load_script("train_torch")
    argv = ["-s", scene, "-m", run, "--preset", "refreal", "-r", "2", "--device", "cpu", "--schedule_scale", "0.0005",
            "--iterations", "10", "--capacity", "1024", "--pair_capacity", "16384", "--tracer_pair_capacity", "16384",
            "--envmap_max_res", "16", "--log_every", "1", "--mesh_every", "1000", "--ref_score_path", "auto",
            "--opacity_reset_interval", "1000", "--normal_prop_interval", "1000", "--env_reset_interval", "1000"]
    res = train.main(argv)
    tr = res["trainer"]
    log = tr.metrics_log
    assert [m["iteration"] for m in log] == list(range(1, 11))
    assert [m["stage"] for m in log] == ["initial"] * 2 + ["surfel"] * 4 + ["surfel2"] * 4
    assert tr.images[0].shape == (37, 53, 3) and tr.masks[0].shape == (37, 53) and len(tr.cameras) == 3
    assert all(np.isfinite(m["loss"]) for m in log)
    assert [m["warp_on"] for m in log] == [0] * 4 + [1] * 6
    assert len(tr.ref_score_log) == 1 and "loss_ref_score" in log[-1]
    assert [("perceptual_loss" in m) for m in log] == [False] * 8 + [True] * 2
    assert all(m["perceptual_loss"] > 0 for m in log[8:])
    assert tr.opt.unbounded_mesh and [it for it, _, _ in tr.mesh_log] == [7]
    with open(os.path.join(run, "cfg_args.json")) as f:
        dumped = json.load(f)
    assert dumped["model"]["resolution"] == 2 and "lpips_disabled" not in dumped["extra"]
    m = _load_script("eval_torch").main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu"])["test"]
    assert np.isfinite(m["psnr"]) and m["tracer_overflow"] == 0 and len(m["per_view_psnr"]) == 1
    assert m["lpips"] is not None and np.isfinite(m["lpips"])
    out = png.read_png(os.path.join(run, "eval_10", "test", "renders", "00000.png"))
    assert out.shape == (37, 53, 3)

    monkeypatch.setenv(tlp.DEFAULT_WEIGHTS_ENV, str(tmp_path / "absent.npz"))
    off = train.main(argv[:argv.index("--iterations")] + ["--iterations", "2"] + argv[argv.index("--capacity"):])
    assert off["trainer"].lpips_disabled
    with open(os.path.join(run, "cfg_args.json")) as f:
        dumped = json.load(f)
    assert dumped["extra"]["lpips_disabled"] is True and dumped["optimization"]["use_perceptual_loss"] is False
