"""The port's ASG indirect light (use_asg) against the JAX package:
eval_asg_indirect's values and gradients on shared inputs (rtol 1e-5;
gradients within 1e-5 of their scale), render_surfel with use_asg (maps at
tests/test_rasterize_pallas.py's atol 3e-4 / rtol 1e-3, gradients at
tests/test_rasterize_grad.py:93's 2e-3 x scale), and one `surfel` train step
with use_asg from a carried-across state, held as tests/test_torch_train.py
holds the step; and scripts/train_torch.py --use_asg across the initial ->
surfel switch, its PLY, checkpoint and test render, served by
scripts/eval_torch.py.

In both packages' Trainer the rasterized indirect map reaches no loss term
(no flavor shades with it), so the step's gradient into the ASG lobes is
exactly zero; the render case puts a loss on the indirect map that
render_surfel returns, to hold that gradient too."""
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
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.render import renderers as jren  # noqa: E402
from materialrefgs_tpu.train import trainer as jtr  # noqa: E402
from materialrefgs_tpu.utils import asg as jasg  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import gaussian_io as tio  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightParams as TEnv  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.render import renderers as tren  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from materialrefgs_torch.utils import asg as tasg  # noqa: E402
from materialrefgs_torch.utils.transforms import rotation_between_z  # noqa: E402
from test_torch_train import (  # noqa: E402
    _gt_image, _load_script, _state_to_torch, _write_blender_scene, jax_model, to_torch_model,
)

W, H = 48, 40


@pytest.fixture
def same_texel_grid(monkeypatch):
    monkeypatch.setattr(
        tcm, "face_dirs", lambda res, device=None: torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)
    )


def _asg_model(seed):
    """tests/test_torch_train.py's model with random ASG lobes: amplitudes
    around e^-3..e^-1, sharpness through the softplus on both sides of 20."""
    jm = jax_model(seed, sh_degree=1)
    rng = np.random.default_rng(seed + 100)
    asg = np.zeros((jm.capacity, 32, 5), np.float32)
    asg[:, :, :3] = rng.normal(size=(jm.capacity, 32, 3)) + 1.0
    asg[:, :, 3:] = rng.normal(size=(jm.capacity, 32, 2)) * 8.0 + 4.0
    asg[:4, :, 3] = 30.0  # softplus past torch's identity threshold
    return jm.replace(params=jm.params.replace(indirect_asg=jnp.asarray(asg)))


def test_eval_asg_indirect_matches_jax():
    rng = np.random.default_rng(0)
    P = 300
    asg = (rng.normal(size=(P, 32, 5)) * 2.0).astype(np.float32)
    asg[:8, :, 3:] = 25.0
    n = rng.normal(size=(P, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0] = [0.0, 0.0, -1.0]  # rotation_between_z's -I fallback
    n[1] = [0.0, 0.0, 1.0]
    refl = rng.normal(size=(P, 3)).astype(np.float32)
    refl[2] = n[2] * -1.0  # every lobe's smooth term at or below 0
    wgt = rng.uniform(size=(P, 3)).astype(np.float32)
    from materialrefgs_tpu.utils.transforms import rotation_between_z as jrot

    np.testing.assert_allclose(rotation_between_z(torch.from_numpy(n)).numpy(), np.asarray(jrot(jnp.asarray(n))),
                               rtol=1e-6, atol=1e-7)
    for a, b in zip(tasg.init_predefined_omega(4, 8), jasg.init_predefined_omega(4, 8)):
        np.testing.assert_array_equal(a, b)

    def jloss(a, nn, r):
        out = jasg.eval_asg_indirect(a, nn, r)
        return jnp.sum(out * wgt), out

    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(asg), jnp.asarray(n), jnp.asarray(refl))
    ta, tn, tr = (torch.tensor(x, requires_grad=True) for x in (asg, n, refl))
    tout = tasg.eval_asg_indirect(ta, tn, tr)
    tg = torch.autograd.grad(torch.sum(tout * torch.from_numpy(wgt)), [ta, tn, tr])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert float(tout.min()) == 0.0 and float(tout.max()) > 0
    for name, g, j in zip(("asg", "normal", "reflection"), tg, jg):
        scale = float(np.abs(np.asarray(j)).max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5 * scale, err_msg=name)


def test_render_surfel_with_asg_matches_jax(same_texel_grid):
    """use_asg: every map, and the gradients of a weighted sum of the render
    and the rasterized indirect map with respect to the lobes, the geometry
    and the cubemap logits."""
    jm = _asg_model(3)
    tm = to_torch_model(jm)
    kw = dict(eye=np.array([0.4, -0.5, -3.5]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.9, fovy=0.75, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    rng = np.random.default_rng(1)
    base = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    wgt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    wgt_i = rng.uniform(size=(H, W, 3)).astype(np.float32)
    jopts = jren.RenderOptions(use_asg=True, raster=JRaster(pair_capacity=1 << 14, interpret=True))
    topts = tren.RenderOptions(use_asg=True, raster=TRaster(pair_capacity=1 << 14))

    def jloss(params, b):
        pkg = jren.render_surfel(jm.replace(params=params), jc, jnp.ones(3),
                                 JMips.build(JEnv(base=b), n_samples=4), jopts)
        return jnp.sum(pkg["render"] * wgt) + jnp.sum(pkg["indirect_map"] * wgt_i), pkg

    (jl, jpkg), (jgp, jgb) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jm.params, jnp.asarray(base))
    tenv = TEnv(torch.tensor(base))
    tpkg = tren.render_surfel(tm, tc, torch.ones(3), TMips.build(tenv, n_samples=4), topts)
    names = ("indirect_asg", "xyz", "rotation", "opacity", "refl_strength", "ori_color")
    tl = (torch.sum(tpkg["render"] * torch.from_numpy(wgt))
          + torch.sum(tpkg["indirect_map"] * torch.from_numpy(wgt_i)))
    tg = torch.autograd.grad(tl, [tenv.base] + [getattr(tm, k) for k in names])
    for k in ("render", "indirect_map", "specular_map"):
        np.testing.assert_allclose(tpkg[k].detach().numpy(), np.asarray(jpkg[k]), atol=3e-4, rtol=1e-3, err_msg=k)
    assert float(tpkg["indirect_map"].abs().max()) > 0.05
    for name, g, j in zip(("env",) + names, tg, [jgb] + [getattr(jgp, k) for k in names]):
        scale = max(float(np.abs(np.asarray(j)).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=2e-3 * scale, err_msg=name)
    assert float(np.abs(np.asarray(jgp.indirect_asg)).max()) > 0


def test_surfel_step_with_asg_matches_jax(same_texel_grid):
    """One `surfel` step with use_asg in both packages from the same state
    (a JAX state after a warm-up step, carried across): loss, every gradient
    leaf read from the new first moments, the updated parameters and the
    densification statistics; the ASG lobes' gradient is zero in both."""
    _, pipe, opt = jcfg.preset_refnerf()
    pipe = dataclasses.replace(pipe, use_asg=True)
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    tpipe = tcfg.PipelineParams(**dataclasses.asdict(pipe))
    iteration = 3500
    jm = _asg_model(9)
    js = jtr.init_train_state(jm, opt, envmap_res=32)
    rng = np.random.default_rng(8)
    js = js.replace(env1=JEnv(base=jnp.asarray(rng.normal(size=(6, 32, 32, 3)).astype(np.float32))))
    kw = dict(eye=np.array([0.4, -0.5, -3.5]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.9, fovy=0.75, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    gt = _gt_image(iteration)
    lam = jtr.normal_loss_weight_schedule(iteration, opt)
    jextra = {"iteration": jnp.float32(iteration), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(0.0), "warp_key": jax.random.PRNGKey(0), "bg": jnp.ones(3)}
    jstep = jtr.make_train_step("surfel", opt, pipe, 3.0, JRaster(pair_capacity=1 << 14, interpret=True))
    js, _ = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt))  # warm-up: live moments
    ts = _state_to_torch(js)
    mu0 = {k: v.clone().numpy() for k, v in ts.adam.mu.items()}
    js, jmet = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt))
    tstep = ttr.make_train_step("surfel", topt, tpipe, 3.0, TRaster(pair_capacity=1 << 14))
    assert tstep.ropts.use_asg
    tmet = tstep(ts, tc, torch.from_numpy(gt), {"iteration": float(iteration), "lambda_normal_render_depth": lam,
                                               "bg": torch.ones(3)})

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    jmu_p, jmu_e1, jmu_e2 = js.opt_state.mu
    jnu_p, jnu_e1, jnu_e2 = js.opt_state.nu
    jmu = {k: np.asarray(getattr(jmu_p, k)) for k in PARAM_SHAPES}
    jnu = {k: np.asarray(getattr(jnu_p, k)) for k in PARAM_SHAPES}
    jmu["env1"], jnu["env1"] = np.asarray(jmu_e1.base), np.asarray(jnu_e1.base)
    jpar = {k: np.asarray(getattr(js.model.params, k)) for k in PARAM_SHAPES}
    jpar["env1"] = np.asarray(js.env1.base)
    tpar = {k: v.detach().numpy() for k, v in ts.params().items()}
    lrs = ttr.param_lrs(topt, 3.0, ts.step - 1, ts.opacity_lr_scale)
    count = int(js.opt_state.count)
    assert ts.adam.count == count
    n_nonzero = 0
    for k in jmu:
        gj = (jmu[k] - 0.9 * mu0[k]) / 0.1
        gt_ = (ts.adam.mu[k].numpy() - 0.9 * mu0[k]) / 0.1
        scale = max(float(np.abs(gj).max()), 1e-3)
        np.testing.assert_allclose(gt_, gj, atol=2e-3 * scale + 1e-4, err_msg=f"grad {k}")
        dmu_hat = 0.1 * (2e-3 * scale + 1e-4) / (1 - 0.9**count)
        sq = np.sqrt(jnu[k] / (1 - 0.999**count)) + 1e-15
        assert np.all(np.abs(tpar[k] - jpar[k]) <= 2 * lrs[k] * dmu_hat / sq + 1e-6), k
        n_nonzero += bool(np.abs(gj).max() > 0)
    assert n_nonzero >= 8
    assert float(np.abs(ts.adam.mu["indirect_asg"].numpy()).max()) == 0.0 == float(np.abs(jmu["indirect_asg"]).max())
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        a, b = getattr(ts.model, k).numpy(), np.asarray(getattr(js.model, k))
        np.testing.assert_allclose(a, b, atol=2e-3 * max(float(np.abs(b).max()), 1e-3) + 1e-6, err_msg=k)


def test_train_cli_use_asg(tmp_path):
    """scripts/train_torch.py --use_asg --device cpu across initial ->
    surfel: cfg_args.json records the flavor, the PLY carries the trained
    lobes, the test mark renders, the checkpoint resumes with the lobes'
    Adam moments, and scripts/eval_torch.py serves the run with them."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene)
    train = _load_script("train_torch")
    # schedule 0.002: init_until_iter 6, so 7 and 8 are `surfel` steps.
    argv = ["-s", scene, "-m", run, "--device", "cpu", "--schedule_scale", "0.002", "--iterations", "8",
            "--capacity", "1024", "--pair_capacity", "16384", "--envmap_max_res", "16", "--log_every", "1",
            "--use_asg", "--checkpoint_iterations", "7", "--test_iterations", "8"]
    res = train.main(argv)
    tr = res["trainer"]
    log = tr.metrics_log
    assert [m["iteration"] for m in log] == list(range(1, 9))
    assert [m["stage"] for m in log][-2:] == ["surfel", "surfel"]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert tcfg.load_config(run)[1].use_asg
    assert "indirect_asg" in tr.state.adam.mu
    n = int(tr.state.model.n_alive)
    saved = tio.load_ply(res["ply"], capacity=tr.state.model.capacity, device="cpu")[0]
    np.testing.assert_array_equal(saved.indirect_asg[:n].detach().numpy(),
                                  tr.state.model.indirect_asg[:n].detach().numpy())
    assert np.isfinite(res["test"][8]["psnr"])

    resumed = train.main(argv[:-4] + ["--start_checkpoint", run, "--iterations", "8"])
    rt = resumed["trainer"]
    assert [m["iteration"] for m in rt.metrics_log] == [8] and np.isfinite(rt.metrics_log[0]["loss"])
    assert "indirect_asg" in rt.state.adam.mu

    m = _load_script("eval_torch").main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu"])["test"]
    assert np.isfinite(m["psnr"]) and m["overflow"] == 0
    assert os.path.exists(os.path.join(run, "eval_8", "test", "renders"))
