"""The port's `volume` stage against the JAX package: per-gaussian shading
(full_color_volume), render_volume's maps and gradients, the four model
functions of the volume -> surfel transition, the Trainer across
initial -> volume -> surfel. (The one-step parity case of the volume stage
is in tests/test_torch_train.py; a volume-stage checkpoint trained and
served through the CLIs in tests/test_torch_volume_serve.py.)

The JAX side runs as its own tests run it (Pallas in interpret mode on the
CPU). Tolerances: shading rtol 1e-5 / atol 1e-6; forward maps atol 3e-4
(depth maps 1e-3), rtol 1e-3 (tests/test_torch_slice.py); gradients atol
2e-3 x scale (tests/test_rasterize_grad.py:93)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test worker (see tests/test_torch_train.py).
torch.set_num_threads(1)

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as jgm  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.render import renderers as jrend  # noqa: E402
from materialrefgs_tpu.render import shading as jshade  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightParams as TEnv  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.render import renderers as trend  # noqa: E402
from materialrefgs_torch.render import shading as tshade  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402

W, H = 48, 40
DEPTH_MAPS = {"surf_depth", "render_depth_expected", "render_depth_median", "surf_normal", "rend_dist"}
CAM = dict(eye=np.array([0.4, -0.5, -3.5]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
           fovx=0.9, fovy=0.75, width=W, height=H)


@pytest.fixture
def same_texel_grid(monkeypatch):
    """JAX's texel-center directions for the port's prefilter (the grids
    differ by one float32 ulp; see tests/test_torch_shading.py)."""
    monkeypatch.setattr(
        tcm, "face_dirs", lambda res, device=None: torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)
    )


def _leaves(seed=0, P=200, cap=256):
    """Raw parameters of a fixed-capacity model, every material leaf set."""
    rng = np.random.default_rng(seed)
    K = 16
    leaves = {name: np.zeros((cap,) + shape(K), np.float32) for name, shape in PARAM_SHAPES.items()}
    leaves["xyz"][:P] = rng.normal(size=(P, 3)) * 0.5
    leaves["scaling"][:] = -10.0
    leaves["scaling"][:P] = rng.normal(size=(P, 2)) * 0.4 - 1.7
    leaves["rotation"][:, 0] = 1.0
    leaves["rotation"][:P] = rng.normal(size=(P, 4))
    leaves["opacity"][:] = -15.0
    leaves["opacity"][:P] = rng.normal(size=(P, 1)) + 0.5
    for name in ("refl_strength", "roughness", "ori_color", "metalness", "diffuse_color"):
        leaves[name][:P] = rng.normal(size=leaves[name][:P].shape)
    for name in ("features_dc", "indirect_dc"):
        leaves[name][:P] = rng.normal(size=(P, 1, 3)) * 0.8
    for name in ("features_rest", "indirect_rest"):
        leaves[name][:P] = rng.normal(size=(P, K - 1, 3)) * 0.2
    return leaves, np.arange(cap) < P, rng


def _jax_model(leaves, alive):
    cap = len(alive)
    return jgm.GaussianModel(
        params=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        alive=jnp.asarray(alive), max_radii2d=jnp.zeros(cap), xyz_gradient_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap), active_sh_degree=jnp.int32(3), max_sh_degree=3, capacity=cap,
    )


def _torch_model(leaves, alive):
    return convert.gaussian_model_from_numpy(leaves, alive, 3, device="cpu")


def test_full_color_volume_matches_jax(same_texel_grid):
    """Diffuse, specular and direct light per gaussian (rtol 1e-5 / atol
    1e-6), also with the visibility / indirect blend, and the gradients of
    a scalar of them w.r.t. xyz, normal, albedo, refl, rough and the
    cubemap (through the mip chain). The gradients are held to rtol 1e-5 +
    1e-4 x their scale: the FG LUT's roughness derivative is a difference
    of nearly equal taps times the LUT's 256 rows, whose float32
    cancellation the two packages' autodiff orders round apart by up to
    1.7e-5 x the scale (measured; 2e-6 elsewhere)."""
    rng = np.random.default_rng(4)
    P = 300
    n = rng.normal(size=(P, 3))
    inputs = dict(
        xyz=rng.normal(size=(P, 3)) * 0.6,
        albedo=rng.uniform(size=(P, 3)),
        normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
        refl_strength=rng.uniform(size=(P, 1)),
        roughness=rng.uniform(0.02, 0.98, size=(P, 1)),
    )
    blend = dict(visibility=rng.uniform(size=(P, 1)), indirect_light=rng.uniform(size=(P, 3)))
    inputs, blend = ({k: v.astype(np.float32) for k, v in d.items()} for d in (inputs, blend))
    base = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    jc, tc = jax_camera(**CAM), torch_camera(**CAM, device="cpu")
    names = list(inputs) + ["base"]

    def jfun(*args):
        kw = dict(zip(names, args))
        mips = JMips.build(JEnv(base=kw.pop("base")), min_res=4)
        d, s, x = jshade.full_color_volume(mips, camera=jc, **kw)
        loss = jnp.sum(jnp.sin(3 * d)) + jnp.sum(jnp.cos(2 * s)) + 0.5 * jnp.sum(x["direct_light"])
        _, s_blend, _ = jshade.full_color_volume(mips, camera=jc, **kw, **{k: jnp.asarray(v) for k, v in blend.items()})
        return loss, (d, s, x["direct_light"], s_blend)

    jargs = [jnp.asarray(inputs[k]) for k in inputs] + [jnp.asarray(base)]
    jgrads, ref = jax.jit(jax.grad(jfun, argnums=tuple(range(len(names))), has_aux=True))(*jargs)

    targs = [torch.from_numpy(inputs[k]).requires_grad_(True) for k in inputs]
    env = TEnv(torch.from_numpy(base))
    mips = TMips.build(env, min_res=4)
    d, s, x = tshade.full_color_volume(mips, camera=tc, **dict(zip(inputs, targs)))
    _, s_blend, _ = tshade.full_color_volume(mips, camera=tc, **dict(zip(inputs, targs)),
                                             **{k: torch.from_numpy(v) for k, v in blend.items()})
    out = (d, s, x["direct_light"], s_blend)
    for a, b, name in zip(ref, out, ("diffuse", "specular", "direct_light", "specular with the blend")):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-6, err_msg=name)
    loss = torch.sum(torch.sin(3 * d)) + torch.sum(torch.cos(2 * s)) + 0.5 * torch.sum(x["direct_light"])
    tgrads = torch.autograd.grad(loss, targs + [env.base])
    for name, g, r in zip(names, tgrads, jgrads):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-4 * float(np.abs(r).max()), err_msg=f"grad {name}")


def test_render_volume_matches_jax(same_texel_grid):
    """render_volume's maps (the same keys as JAX's) and the gradients of a
    smooth scalar of them w.r.t. every raw parameter and env2's logits."""
    leaves, alive, rng = _leaves(seed=5, P=120, cap=128)
    base = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    cam = dict(CAM, width=32, height=24)
    jc, tc = jax_camera(**cam), torch_camera(**cam, device="cpu")
    bg = np.float32([1.0, 0.9, 0.8])
    jopts = jrend.RenderOptions(raster=JRaster(pair_capacity=1 << 14, interpret=True))
    topts = trend.RenderOptions(raster=TRaster(pair_capacity=1 << 14))
    keys = {"render": 1.0, "refl_strength_map": 0.7, "roughness_map": 0.6, "base_color_map": 0.5,
            "rend_normal": 0.4, "surf_depth": 0.2, "rend_alpha": 0.3, "rend_dist": 0.1}

    def jloss(params, env_base):
        m = _jax_model(leaves, alive).replace(params=params)
        mips = JMips.build(JEnv(base=env_base), min_res=4)
        out = jrend.render_volume(m, jc, jnp.asarray(bg), mips, jopts)
        return sum(w * jnp.sum(jnp.sin(3 * out[k] + 0.3)) for k, w in keys.items()), out

    jparams = _jax_model(leaves, alive).params
    (gp, genv), ref = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(base))

    tm = _torch_model(leaves, alive)
    env = TEnv(torch.from_numpy(base))
    fwd0, bwd0 = tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches
    out = trend.render_volume(tm, tc, torch.from_numpy(bg), TMips.build(env, min_res=4), topts)
    assert set(out) == set(ref)
    assert int(out["overflow"]) == int(ref["overflow"]) == 0
    assert float(out["rend_alpha"].detach().max()) > 0.5
    for key, val in ref.items():
        if key == "overflow":
            continue
        a, b = np.asarray(val), out[key].detach().numpy()
        if a.dtype == bool or a.dtype.kind in "iu":
            assert np.array_equal(a, b), key
        else:
            np.testing.assert_allclose(b, a, atol=1e-3 if key in DEPTH_MAPS else 3e-4, rtol=1e-3, err_msg=key)
    loss = sum(w * torch.sum(torch.sin(3 * out[k] + 0.3)) for k, w in keys.items())
    names = list(PARAM_SHAPES)
    tgrads = torch.autograd.grad(loss, [getattr(tm, k) for k in names] + [env.base], allow_unused=True)
    assert (tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches) == (fwd0, bwd0)
    n_nonzero = 0
    for name, g in zip(names + ["env2"], tgrads):
        r = np.asarray(genv if name == "env2" else getattr(gp, name))
        g = np.zeros_like(r) if g is None else g.numpy()
        scale = max(float(np.abs(r).max()), 1e-3)
        np.testing.assert_allclose(g, r, atol=2e-3 * scale + 1e-4, err_msg=f"grad {name}")
        n_nonzero += bool(np.abs(r).max() > 0)
    # xyz, scaling, rotation, opacity, refl, rough, ori_color and env2.
    assert n_nonzero == 8


def test_volume_model_functions_match_jax():
    """dist_color, reset_ori_color, reset_roughness and reset_refl_strength,
    the random ones given the JAX package's draw."""
    leaves, alive, rng = _leaves(seed=6, P=150, cap=192)
    leaves["refl_strength"][::3] = -6.0  # below dist_color's 0.02 threshold
    jm, tm = _jax_model(leaves, alive), _torch_model(leaves, alive)
    outside = rng.uniform(size=len(alive)) > 0.8
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    jm = jgm.dist_color(jm, k1, exclusive_msk=jnp.asarray(outside))
    tgm.dist_color(tm, exclusive_msk=torch.from_numpy(outside),
                   noise=torch.from_numpy(np.array(jax.random.uniform(k1, tm.features_dc.shape))))
    moved = np.any(np.asarray(jm.params.features_dc) != leaves["features_dc"], axis=(1, 2))
    assert 0 < moved.sum() < len(alive)
    jm = jgm.reset_ori_color(jm, k2)
    tgm.reset_ori_color(tm, noise=torch.from_numpy(np.array(jax.random.uniform(k2, tm.ori_color.shape))))
    jm = jgm.reset_refl_strength(jgm.reset_roughness(jm, 0.37), 0.1)
    tgm.reset_roughness(tm, 0.37)
    tgm.reset_refl_strength(tm, 0.1)
    for k in PARAM_SHAPES:
        a, b = getattr(tm, k).detach().numpy(), np.asarray(getattr(jm.params, k))
        if k in ("roughness", "refl_strength"):
            assert np.array_equal(a, b), k  # one constant, bit for bit
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)


def _ring_scene(n_cams=3, size=32, P=64, seed=0):
    """Ground truth rendered by the port from a ring of cameras."""
    from materialrefgs_torch.ops.rasterize import api as tapi

    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(P, 3)) * 0.5, np.exp(rng.normal(size=(P, 2)) * 0.3 - 1.3),
            rng.normal(size=(P, 4)), rng.uniform(0.5, 0.95, size=(P,)), rng.uniform(size=(P, 3)), np.zeros((P, 1))]
    args = [torch.tensor(a, dtype=torch.float32) for a in args]
    cams, images = [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        eye = np.array([3.5 * np.sin(ang), 0.5, -3.5 * np.cos(ang)])
        cam = torch_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, size, size, device="cpu")
        with torch.no_grad():
            images.append(tapi.rasterize(*args, cam, torch.zeros(3), config=TRaster(pair_capacity=1 << 13))["render"]
                          .numpy())
        cams.append(cam)
    return cams, images, args[0].numpy(), rng


def test_trainer_runs_initial_volume_surfel(monkeypatch, tmp_path):
    """The Trainer across initial (1-2) -> volume (3-4) -> surfel (5-6): the
    re-init at 5 (volume_render_until_iter + 1) gives the JAX functions'
    values on the model it found, given the JAX draw, and zeroes the three
    parameters' Adam moments; dist_color runs inside the normal-propagation
    reset at 6 (6 > 4 > init_until_iter); the volume step trains env2 and
    leaves env1 alone; a volume-stage visualisation renders with env2."""
    cams, images, gt_means, rng = _ring_scene()
    pts = (gt_means + rng.normal(size=gt_means.shape) * 0.1).astype(np.float32)
    model = tgm.create_from_points(pts, rng.uniform(size=(len(pts), 3)).astype(np.float32), capacity=128,
                                   device="cpu")
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=2,
        volume_render_until_iter=4, indirect_from_iter=100, iterations=6, densify_from_iter=10**6,
        densify_until_iter=100, normal_prop_until_iter=100, normal_prop_interval=6, opac_lr0_interval=0,
        opacity_reset_interval=10**6, feature_rest_from_iter=10**6,
    )
    trainer = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(), cameras_extent=3.0,
                          raster_cfg=TRaster(pair_capacity=1 << 13), envmap_res=16, vis_dir=str(tmp_path),
                          vis_every=3)
    draws = {}
    real_reset, real_dist = tgm.reset_ori_color, tgm.dist_color

    def reset_ori_color(m, generator=None, **kw):
        u = np.array(jax.random.uniform(jax.random.PRNGKey(3), m.ori_color.shape))
        draws["before"] = {k: getattr(m, k).detach().numpy().copy() for k in PARAM_SHAPES}
        draws["alive"] = m.alive.numpy().copy()
        real_reset(m, noise=torch.from_numpy(u))

    def dist_color(m, generator=None, exclusive_msk=None, **kw):
        draws["dist_at"] = trainer.metrics_log[-1]["iteration"] + 1 if trainer.metrics_log else None
        draws["dc_before"] = m.features_dc.detach().numpy().copy()
        u = np.array(jax.random.uniform(jax.random.PRNGKey(4), m.features_dc.shape))
        real_dist(m, exclusive_msk=exclusive_msk, noise=torch.from_numpy(u))

    monkeypatch.setattr(tgm, "reset_ori_color", reset_ori_color)
    monkeypatch.setattr(tgm, "dist_color", dist_color)
    env1_0 = trainer.state.env1.base.detach().clone()
    trainer.train(4, log_every=1)
    st = trainer.state
    assert [m["stage"] for m in trainer.metrics_log] == ["initial", "initial", "volume", "volume"]
    assert torch.equal(st.env1.base, env1_0) and float((st.env2.base.detach() != 0).float().mean()) > 0.5
    assert os.path.exists(tmp_path / "000003.png")  # the volume-stage visualisation
    for k in ("ori_color", "refl_strength", "roughness", "xyz"):
        assert float(st.adam.nu[k].abs().max()) > 0, k
    real_step = trainer._run_step
    after = {}

    def run_step(iteration, stage):
        if iteration == 5:  # right after the re-init, before the step
            after["params"] = {k: getattr(st.model, k).detach().numpy().copy() for k in PARAM_SHAPES}
            after["moments"] = {k: (float(st.adam.mu[k].abs().max()), float(st.adam.nu[k].abs().max()))
                                for k in st.adam.names}
        if iteration == 6:
            # Every other gaussian below dist_color's reflection threshold
            # (the re-init left them all at 0.1).
            with torch.no_grad():
                st.model.refl_strength[::2] = -6.0
        return real_step(iteration, stage)

    monkeypatch.setattr(trainer, "_run_step", run_step)
    trainer.train(2, start_iter=5, log_every=1)
    log = trainer.metrics_log
    assert [m["stage"] for m in log] == ["initial", "initial", "volume", "volume", "surfel", "surfel"]
    assert all(np.isfinite(m["loss"]) and m["overflow"] == 0 for m in log)
    # The re-init against the JAX functions on the model it found.
    jm = _jax_model(draws["before"], draws["alive"])
    jm = jgm.reset_roughness(jgm.reset_refl_strength(jgm.reset_ori_color(jm, jax.random.PRNGKey(3)), 0.1),
                             opt.init_roughness_value)
    for k in PARAM_SHAPES:
        np.testing.assert_allclose(after["params"][k], np.asarray(getattr(jm.params, k)), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert all(after["moments"][k] == (0.0, 0.0) for k in ttr.VOLUME_REINIT)
    assert all(min(after["moments"][k]) > 0 for k in ("xyz", "opacity", "features_dc", "env2"))
    # dist_color after step 6, in its normal-propagation reset, against
    # JAX's on the same features and draw (nothing touches f_dc after it).
    assert draws["dist_at"] == 6 and not opt.use_env_scope
    jm = _jax_model({**draws["before"], "features_dc": draws["dc_before"],
                     "refl_strength": st.model.refl_strength.detach().numpy()}, draws["alive"])
    jd = np.asarray(jgm.dist_color(jm, jax.random.PRNGKey(4)).params.features_dc)
    assert np.any(jd != draws["dc_before"])
    np.testing.assert_allclose(st.model.features_dc.detach().numpy(), jd, rtol=1e-6, atol=1e-6)
