"""The port's training slice against the JAX package: KNN init, model
creation, densification statistics, densify/prune, resets, Adam, and one
`initial` and one `surfel` train step from a state carried across by
models/convert.py; then a port-only training run and the training CLI.

The JAX side runs as its own tests run it (jitted, Pallas in interpret mode
on the CPU). Gradient tolerances are tests/test_rasterize_grad.py:93's."""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test worker: the suite runs in several worker
# processes, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as jgm  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.ops.knn import mean_knn_dist2 as jax_knn  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.train import losses as jloss  # noqa: E402
from materialrefgs_tpu.train import trainer as jtr  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops.knn import mean_knn_dist2 as torch_knn  # noqa: E402
from materialrefgs_torch.ops.rasterize import api as tapi  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.train import losses as tloss  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from materialrefgs_torch.train.optim import Adam  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 40
CAP = 256


@pytest.fixture
def same_texel_grid(monkeypatch):
    """JAX's texel-center directions for the port's prefilter (the grids
    differ by one float32 ulp; see test_torch_shading.py)."""
    monkeypatch.setattr(
        tcm, "face_dirs", lambda res, device=None: torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)
    )


def jax_model(seed=0, P=200, cap=CAP, sh_degree=0):
    """A fixed-capacity JAX model with every material leaf non-trivial."""
    rng = np.random.default_rng(seed)
    K = 16
    leaves = {name: np.zeros((cap,) + shape(K), np.float32) for name, shape in PARAM_SHAPES.items()}
    leaves["xyz"][:P] = rng.normal(size=(P, 3)) * 0.5
    leaves["scaling"][:] = -10.0
    leaves["scaling"][:P] = rng.normal(size=(P, 2)) * 0.4 - 1.9
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
    return jgm.GaussianModel(
        params=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        alive=jnp.arange(cap) < P,
        max_radii2d=jnp.asarray(rng.uniform(0, 30, size=cap).astype(np.float32)),
        xyz_gradient_accum=jnp.asarray(rng.uniform(0, 1e-2, size=cap).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 20, size=cap).astype(np.float32)),
        active_sh_degree=jnp.int32(sh_degree),
        max_sh_degree=3,
        capacity=cap,
    )


def to_torch_model(jm):
    m = convert.gaussian_model_from_numpy(
        {k: np.asarray(getattr(jm.params, k)) for k in PARAM_SHAPES},
        np.asarray(jm.alive), int(jm.active_sh_degree), device="cpu",
    )
    with torch.no_grad():
        for name in ("xyz_gradient_accum", "denom", "max_radii2d"):
            getattr(m, name).copy_(torch.from_numpy(np.array(getattr(jm, name))))
    return m


def assert_model_close(tm, jm, atol=1e-6):
    assert np.array_equal(tm.alive.numpy(), np.asarray(jm.alive))
    for k in PARAM_SHAPES:
        np.testing.assert_allclose(getattr(tm, k).detach().numpy(), np.asarray(getattr(jm.params, k)),
                                   atol=atol, rtol=1e-6, err_msg=k)
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                   atol=atol, rtol=1e-6, err_msg=k)


def test_knn_and_create_from_points_match_jax():
    rng = np.random.default_rng(0)
    pts = (rng.random((3000, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.random((3000, 3)).astype(np.float32)
    np.testing.assert_allclose(torch_knn(torch.from_numpy(pts)).numpy(),
                               np.asarray(jax_knn(jnp.asarray(pts))), atol=1e-6, rtol=1e-5)
    jm = jgm.create_from_points(pts, cols, capacity=4096, rng=np.random.default_rng(7),
                                init_refl=0.2, init_roughness=0.3)
    tm = tgm.create_from_points(pts, cols, capacity=4096, rng=np.random.default_rng(7),
                                init_refl=0.2, init_roughness=0.3, device="cpu")
    assert_model_close(tm, jm)
    assert int(tm.active_sh_degree) == int(jm.active_sh_degree) == 0
    tm.oneup_sh_degree()
    assert int(tm.active_sh_degree) == int(jm.oneup_sh_degree().active_sh_degree) == 1


def test_densification_stats_and_resets_match_jax():
    jm = jax_model(1)
    tm = to_torch_model(jm)
    rng = np.random.default_rng(2)
    grad = rng.normal(size=(CAP, 2)).astype(np.float32) * 1e-3
    radii = (rng.uniform(size=CAP) * 20 * (rng.uniform(size=CAP) > 0.3)).astype(np.float32)
    jm = jgm.add_densification_stats(jm, jnp.asarray(grad), jnp.asarray(radii), ndc_scale=(24.0, 20.0))
    tgm.add_densification_stats(tm, torch.from_numpy(grad), torch.from_numpy(radii), ndc_scale=(24.0, 20.0))
    assert_model_close(tm, jm)

    outside = rng.uniform(size=CAP) > 0.7
    steps = [
        (lambda m: jgm.reset_opacity0(m), lambda m: tgm.reset_opacity0(m)),
        (lambda m: jgm.reset_opacity1(m, exclusive_msk=jnp.asarray(outside)),
         lambda m: tgm.reset_opacity1(m, exclusive_msk=torch.from_numpy(outside))),
        (lambda m: jgm.reset_refl(m), lambda m: tgm.reset_refl(m)),
        (lambda m: jgm.reset_refl(m, exclusive_msk=jnp.asarray(outside), rst_value=0.3),
         lambda m: tgm.reset_refl(m, exclusive_msk=torch.from_numpy(outside), rst_value=0.3)),
        (lambda m: jgm.reset_scale(m, exclusive_msk=jnp.asarray(outside)),
         lambda m: tgm.reset_scale(m, exclusive_msk=torch.from_numpy(outside))),
    ]
    for jf, tf in steps:
        jm = jf(jm)
        tf(tm)
        assert_model_close(tm, jm)


@pytest.mark.parametrize("cap,max_screen_size", [(CAP, None), (CAP, 20.0), (224, None)])
def test_densify_and_prune_matches_jax(cap, max_screen_size):
    """Same slots written, same survivors, same parameters, with the JAX
    package's split noise injected. cap=224 leaves fewer free slots than
    candidates, so late candidates are dropped."""
    jm = jax_model(3, P=180, cap=cap)
    tm = to_torch_model(jm)
    tx = jtr.make_optimizer()
    jopt = tx.init((jm.params, JEnv.create(8), JEnv.create(8)))
    jopt = jopt._replace(
        mu=jax.tree_util.tree_map(lambda a: jnp.ones_like(a), jopt.mu),
        nu=jax.tree_util.tree_map(lambda a: jnp.ones_like(a), jopt.nu),
    )
    adam = Adam({k: getattr(tm, k).detach() for k in PARAM_SHAPES})
    for k in adam.names:
        adam.mu[k].fill_(1.0)
        adam.nu[k].fill_(1.0)

    key = jax.random.PRNGKey(4)
    kw = dict(max_grad=4e-4, min_opacity=0.3, extent=3.0, max_screen_size=max_screen_size)
    jm2, jopt2 = jgm.densify_and_prune(jm, jopt, key, **kw)
    noise, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (cap, 2))))
    written = tgm.densify_and_prune(tm, adam, None, noise=torch.from_numpy(np.stack(noise)), **kw)
    assert int(written.sum()) > 0 and int((~np.asarray(jm.alive) & np.asarray(jm2.alive)).sum()) > 0
    assert_model_close(tm, jm2)
    jmu = jopt2.mu[0]
    for name in PARAM_SHAPES:
        np.testing.assert_array_equal(adam.mu[name].numpy(), np.asarray(getattr(jmu, name)), err_msg=name)


def test_adam_matches_optax():
    rng = np.random.default_rng(5)
    shapes = {"xyz": (CAP, 3), "opacity": (CAP, 1), "env1": (6, 4, 4, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jtr.make_optimizer()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    adam = Adam(tp)
    lrs = {"xyz": 1e-3, "opacity": 0.05, "env1": 0.01}
    rows = rng.uniform(size=CAP) > 0.5
    for i in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        if i == 2:
            st = jgm.zero_adam_rows(st, jnp.asarray(rows))
            adam.zero_rows(torch.from_numpy(rows))
        if i == 4:
            st = st._replace(mu=dict(st.mu, opacity=jnp.zeros_like(st.mu["opacity"])),
                             nu=dict(st.nu, opacity=jnp.zeros_like(st.nu["opacity"])))
            adam.zero_param("opacity")
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = {k: jp[k] - lrs[k] * u[k] for k in jp}
        adam.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, lrs)
    assert adam.count == int(st.count) == 6
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(adam.nu[k].numpy(), np.asarray(st.nu[k]), atol=1e-7, rtol=1e-5, err_msg=k)


LOSSES = {
    "l1_loss": lambda L, x, y: L.l1_loss(x, y),
    "get_img_grad_weight": lambda L, x, y: L.get_img_grad_weight(y),
    "spatial_gradient": lambda L, x, y: L.spatial_gradient(x),
    "first_order_edge_aware_loss": lambda L, x, y: L.first_order_edge_aware_loss(x[..., :1], y),
    "smooth_loss_simple": lambda L, x, y: L.smooth_loss_simple(x),
    "lap_loss": lambda L, x, y: L.lap_loss(x, y),
    "ssim": lambda L, x, y: L.ssim(x, y),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    """Each loss-library function and its gradient against the JAX one."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(37, 45, 3)).astype(np.float32)
    y = rng.uniform(size=(37, 45, 3)).astype(np.float32)
    y[:10] = 1.0  # a flat region: the SSIM variance clamp sits at 0
    fn = LOSSES[name]
    ref = np.asarray(fn(jloss, jnp.asarray(x), jnp.asarray(y)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fn(tloss, tx, torch.from_numpy(y))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    # A scalar loss is differentiated as is, a map through sum(sin(.)).
    scalar = ref.ndim == 0
    jg = np.asarray(jax.grad(
        lambda a: (lambda v: v if scalar else jnp.sum(jnp.sin(v)))(fn(jloss, a, jnp.asarray(y)))
    )(jnp.asarray(x)))
    if out.requires_grad:
        (tg,) = torch.autograd.grad(out if scalar else torch.sin(out).sum(), tx)
        tg = tg.numpy()
    else:  # a function of the ground truth alone
        tg = np.zeros_like(x)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6 * max(np.abs(jg).max(), 1.0))


def test_calculate_loss_matches_jax():
    """Every gated term on (distortion, normal smoothness, depth smoothness,
    the normal-consistency term with the image weight)."""
    _, _, opt = jcfg.preset_refnerf()
    opt = dataclasses.replace(opt, lambda_dist=10.0, lambda_normal_smooth=0.1, lambda_depth_smooth=0.1,
                              normal_smooth_until_iter=10**6)
    rng = np.random.default_rng(4)
    pkg = {k: rng.uniform(size=(30, 34, c)).astype(np.float32)
           for k, c in (("render", 3), ("rend_normal", 3), ("surf_normal", 3), ("rend_dist", 1))}
    pkg["surf_depth"] = rng.uniform(size=(30, 34)).astype(np.float32)
    gt = rng.uniform(size=(30, 34, 3)).astype(np.float32)
    w = np.clip(1.0 - np.asarray(jloss.get_img_grad_weight(jnp.asarray(gt))), 0, 1) ** 2
    jl, jtb = jloss.calculate_loss(jnp.asarray(gt), {k: jnp.asarray(v) for k, v in pkg.items()}, opt,
                                   jnp.float32(5000), jnp.asarray(w))
    tl, ttb = tloss.calculate_loss(torch.from_numpy(gt), {k: torch.from_numpy(v) for k, v in pkg.items()},
                                   tcfg.OptimizationParams(**dataclasses.asdict(opt)), 5000.0,
                                   torch.from_numpy(w))
    assert set(ttb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(ttb[k]), float(jtb[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def _state_to_torch(js):
    mu_p, mu_e1, mu_e2 = js.opt_state.mu
    nu_p, nu_e1, nu_e2 = js.opt_state.nu

    def moments(p, e1, e2):
        d = {k: np.asarray(getattr(p, k)) for k in PARAM_SHAPES}
        d["env1"], d["env2"] = np.asarray(e1.base), np.asarray(e2.base)
        return d

    m = js.model
    return convert.train_state_from_numpy(
        {k: np.asarray(getattr(m.params, k)) for k in PARAM_SHAPES}, np.asarray(m.alive),
        int(m.active_sh_degree),
        {k: np.asarray(getattr(m, k)) for k in ("xyz_gradient_accum", "denom", "max_radii2d")},
        np.asarray(js.env1.base), np.asarray(js.env2.base),
        moments(mu_p, mu_e1, mu_e2), moments(nu_p, nu_e1, nu_e2),
        int(js.opt_state.count), int(js.step), float(js.opacity_lr_scale), device="cpu",
    )


def _gt_image(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W])[:, None, None]
    rgb = 0.5 + 0.4 * np.sin(5 * xx + 3 * yy)[..., None] * np.array([1.0, 0.6, 0.3])
    return np.clip(rgb + 0.03 * rng.normal(size=rgb.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("stage,iteration", [("initial", 700), ("surfel", 3500)])
def test_train_step_matches_jax(stage, iteration, same_texel_grid):
    """One step of make_train_step in both packages from the same state (a
    JAX state after one warm-up step, carried across by convert.py, so the
    Adam moments and step count are live): loss, every gradient leaf (read
    from the new first moments), the parameters after the update, and the
    densification statistics."""
    _, pipe, opt = jcfg.preset_refnerf()
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    tpipe = tcfg.PipelineParams(**dataclasses.asdict(pipe))
    rng = np.random.default_rng(8)
    jm = jax_model(9, sh_degree=1)
    jm = jm.replace(max_radii2d=jnp.zeros(CAP), xyz_gradient_accum=jnp.zeros(CAP), denom=jnp.zeros(CAP))
    js = jtr.init_train_state(jm, opt, envmap_res=32)
    js = js.replace(env1=JEnv(base=jnp.asarray(rng.normal(size=(6, 32, 32, 3)).astype(np.float32))))
    kw = dict(eye=np.array([0.4, -0.5, -3.5]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.9, fovy=0.75, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    gt = _gt_image(iteration)
    mask = (np.add.outer(np.arange(H) - H / 2, 0 * np.arange(W)) ** 2
            + np.add.outer(0 * np.arange(H), np.arange(W) - W / 2) ** 2 < 15**2).astype(np.float32)
    lam = jtr.normal_loss_weight_schedule(iteration, opt)
    assert lam == ttr.normal_loss_weight_schedule(iteration, topt) > 0
    jextra = {"iteration": jnp.float32(iteration), "lambda_normal_render_depth": jnp.float32(lam),
              "normal_gamma": jnp.float32(0.0), "warp_key": jax.random.PRNGKey(0),
              "bg": jnp.ones(3), "image_mask": jnp.asarray(mask)}
    jstep = jtr.make_train_step(stage, opt, pipe, 3.0, JRaster(pair_capacity=1 << 14, interpret=True))
    js, _ = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt))  # warm-up: live moments
    ts = _state_to_torch(js)
    mu0 = {k: v.clone() for k, v in ts.adam.mu.items()}
    js, jmet = jstep(js, jc, jnp.asarray(gt), jextra, jc, jnp.asarray(gt))

    textra = {"iteration": float(iteration), "lambda_normal_render_depth": lam,
              "bg": torch.ones(3), "image_mask": torch.from_numpy(mask)}
    tstep = ttr.make_train_step(stage, topt, tpipe, 3.0, TRaster(pair_capacity=1 << 14))
    fwd0, bwd0 = tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches
    tmet = tstep(ts, tc, torch.from_numpy(gt), textra)
    assert (tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches) == (fwd0, bwd0)

    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    for k in ("loss_l1", "ssim", "loss_normal_render_depth"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    if stage == "surfel":
        np.testing.assert_allclose(float(tmet["loss_mask_entropy"]), float(jmet["loss_mask_entropy"]), rtol=1e-5)
    assert ts.step == int(js.step) and ts.adam.count == int(js.opt_state.count)

    jmu_p, jmu_e1, jmu_e2 = js.opt_state.mu
    jmu = {k: np.asarray(getattr(jmu_p, k)) for k in PARAM_SHAPES}
    jmu["env1"], jmu["env2"] = np.asarray(jmu_e1.base), np.asarray(jmu_e2.base)
    jparams = {k: np.asarray(getattr(js.model.params, k)) for k in PARAM_SHAPES}
    jparams["env1"], jparams["env2"] = np.asarray(js.env1.base), np.asarray(js.env2.base)
    tparams = {k: v.detach().numpy() for k, v in ts.params().items()}
    lrs = ttr.param_lrs(topt, 3.0, ts.step - 1, ts.opacity_lr_scale)
    jnu_p, jnu_e1, jnu_e2 = js.opt_state.nu
    jnu = {k: np.asarray(getattr(jnu_p, k)) for k in PARAM_SHAPES}
    jnu["env1"], jnu["env2"] = np.asarray(jnu_e1.base), np.asarray(jnu_e2.base)
    n_nonzero = 0
    for k in jmu:
        # g = (mu_new - b1 * mu_old) / (1 - b1), in both packages.
        gj = (jmu[k] - 0.9 * mu0[k].numpy()) / 0.1
        gt_ = (ts.adam.mu[k].numpy() - 0.9 * mu0[k].numpy()) / 0.1
        scale = max(float(np.abs(gj).max()), 1e-3)
        np.testing.assert_allclose(gt_, gj, atol=2e-3 * scale + 1e-4, err_msg=f"grad {k}")
        # The updated parameters agree as far as the gradient tolerance
        # carries through Adam: dp = lr * dmu_hat / sqrt(nu_hat) (x2 for
        # the nu term), per element.
        count = int(js.opt_state.count)
        dmu_hat = 0.1 * (2e-3 * scale + 1e-4) / (1 - 0.9**count)
        sq = np.sqrt(jnu[k] / (1 - 0.999**count)) + 1e-15
        err = np.abs(tparams[k] - jparams[k])
        assert np.all(err <= 2 * lrs[k] * dmu_hat / sq + 1e-6), f"param {k}: {err.max()}"
        n_nonzero += bool(np.abs(gj).max() > 0)
        if k == "env1":
            # The surfel step rebuilds the mips from env1 differentiably.
            assert (np.abs(gj).max() > 0) == (stage == "surfel")
    assert n_nonzero >= (8 if stage == "surfel" else 6)
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        a, b = getattr(ts.model, k).numpy(), np.asarray(getattr(js.model, k))
        np.testing.assert_allclose(a, b, atol=2e-3 * max(float(np.abs(b).max()), 1e-3) + 1e-6, err_msg=k)


def _synthetic_scene(n_cams=4, size=32, P=64, seed=0):
    """Ground-truth gaussians rendered by the port from a ring of cameras."""
    rng = np.random.default_rng(seed)
    args = [
        rng.normal(size=(P, 3)) * 0.5, np.exp(rng.normal(size=(P, 2)) * 0.3 - 1.3),
        rng.normal(size=(P, 4)), rng.uniform(0.5, 0.95, size=(P,)),
        rng.uniform(size=(P, 3)), np.zeros((P, 1)),
    ]
    args = [torch.tensor(a, dtype=torch.float32) for a in args]
    cams, images = [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        eye = np.array([3.5 * np.sin(ang), 0.5, -3.5 * np.cos(ang)])
        cam = torch_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, size, size, device="cpu")
        with torch.no_grad():
            out = tapi.rasterize(*args, cam, torch.zeros(3), config=TRaster(pair_capacity=1 << 13))
        cams.append(cam)
        images.append(out["render"].numpy())
    return cams, images, args[0].numpy(), rng


def test_trainer_improves_psnr_with_densification():
    """The port's Trainer alone on the CPU: 40 `initial` steps at 32x32 with
    densification raise the train PSNR by 0.5 dB (the JAX package's
    tests/test_trainer_e2e.py:41-77, which is `slow` there)."""
    cams, images, gt_means, rng = _synthetic_scene()
    pts = (gt_means + rng.normal(size=gt_means.shape) * 0.1).astype(np.float32)
    cols = rng.uniform(size=(len(pts), 3)).astype(np.float32)
    model = tgm.create_from_points(pts, cols, capacity=256, device="cpu")
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=10_000,
        densify_from_iter=10, densification_interval=20, feature_rest_from_iter=100_000,
        lambda_normal_render_depth=0.0, lambda_dist=0.0,
    )
    trainer = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(), cameras_extent=3.0,
                          raster_cfg=TRaster(pair_capacity=1 << 13), envmap_res=16)
    alive0 = int(model.n_alive)
    trainer.train(40, log_every=1)
    log = trainer.metrics_log
    first = np.mean([m["psnr"] for m in log[:5]])
    last = np.mean([m["psnr"] for m in log[-5:]])
    assert np.isfinite(last) and last > first + 0.5, (first, last)
    assert log[-1]["n_alive"] != alive0  # densify/prune changed the cloud
    for name, p in trainer.state.params().items():
        assert torch.isfinite(p).all(), name


def test_trainer_escalates_overflow_and_refuses_later_slices(monkeypatch, tmp_path):
    cams, images, gt_means, rng = _synthetic_scene(n_cams=1)
    model = tgm.create_from_points(gt_means.astype(np.float32), rng.uniform(size=(64, 3)).astype(np.float32),
                                   capacity=128, device="cpu")
    opt = dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=3,
        volume_render_until_iter=0, indirect_from_iter=4, densify_from_iter=10**9,
        feature_rest_from_iter=100_000,
    )
    trainer = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(), cameras_extent=3.0,
                          raster_cfg=TRaster(pair_capacity=1 << 7), envmap_res=16)
    trainer.train(2, log_every=1)
    assert trainer.raster_cfg.pair_capacity > 1 << 7
    trainer.train(2, start_iter=3, log_every=1)  # initial -> surfel
    log = trainer.metrics_log
    assert [m["stage"] for m in log] == ["initial", "initial", "initial", "surfel"]
    # The overflowed render of step 1 was redone at the escalated capacity
    # before the update: no step applied a truncated render.
    assert log[0]["overflow_redone"] > 0 and all(m["overflow"] == 0 for m in log)
    # At the ceiling the step is applied truncated, as in the JAX package.
    trainer.raster_cfg = dataclasses.replace(trainer.raster_cfg, pair_capacity=1 << 7)
    trainer._steps.clear()
    trainer.MAX_PAIR_CAPACITY = 1 << 7
    trainer.train(1, start_iter=4, log_every=1)
    assert trainer.metrics_log[-1]["overflow"] > 0
    # Past indirect_from_iter the surfel2 stage runs: env-GS init, the mesh,
    # the traced step (still truncated by the rasterizer's ceiling).
    trainer.MESH_RESOLUTION = 32
    trainer.train(1, start_iter=5, log_every=1)
    m = trainer.metrics_log[-1]
    assert m["stage"] == "surfel2" and m["env_n_alive"] > 0 and np.isfinite(m["loss"])
    assert trainer.state.env_gs is not None and trainer.state.env_adam.count == 1
    # A run that asks for the warp loss trains past its gate (the one view
    # has no neighbour: a virtual camera stands in), with normal priors and
    # ref-score masks.
    H, W = images[0].shape[:2]
    warp = ttr.Trainer(model, cams, images,
                       dataclasses.replace(opt, multi_view_weight_from_iter=3, use_virtul_cam=True,
                                           ref_score_start_iter=3),
                       tcfg.PipelineParams(), with_warp=True, envmap_res=16, nearest_ids=[[]],
                       normal_priors=[np.tile(np.float32([0.0, 0.0, -1.0]), (H, W, 1))],
                       ref_score_masks=[np.float32(rng.uniform(size=(H, W)) > 0.5)])
    warp.train(4, log_every=1)
    log = warp.metrics_log
    assert [m["iteration"] for m in log] == [1, 2, 3, 4] and [m["warp_on"] for m in log] == [0, 0, 0, 1]
    assert log[-1]["warp_near"] == -1 and log[-1]["stage"] == "surfel"  # the virtual camera
    assert all(np.isfinite(log[-1][k]) for k in ("loss", "loss_warp_bc", "loss_mono_normal", "loss_ref_score"))
    # The perceptual loss trains now (tests/test_torch_lpips.py); without
    # weights the Trainer turns it off and records that.
    monkeypatch.setenv("MATERIALREFGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    lp = ttr.Trainer(model, cams, images, dataclasses.replace(opt, use_perceptual_loss=True),
                     tcfg.PipelineParams())
    assert lp.lpips_disabled and not lp.opt.use_perceptual_loss and lp.lpips_weights is None
    vol = dataclasses.replace(opt, initial=0, volume_render_until_iter=5)
    with pytest.raises(NotImplementedError, match="volume"):
        ttr.Trainer(model, cams, images, vol, tcfg.PipelineParams(), envmap_res=16).train(1)


def _write_blender_scene(root, n_views=2, size=32, step=0.6):
    """Cameras on a ring looking at the origin, `step` radians apart (0.6:
    no view has a neighbour in the nearest-view graph), RGBA ground truth
    whose alpha is a centered disc (the train/ masks)."""
    os.makedirs(os.path.join(root, "train"))
    rng = np.random.default_rng(7)
    frames = []
    for i in range(n_views):
        ang = step * i
        eye = np.array([3.5 * np.sin(ang), 0.4, -3.5 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye  # OpenGL axes
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
        yy, xx = np.mgrid[0:size, 0:size] / size
        rgb = 0.5 + 0.4 * np.sin(6 * xx + i)[..., None] * np.array([1.0, 0.6, 0.3]) + 0.05 * rng.normal(size=(size, size, 3))
        alpha = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.16)[..., None] * 1.0
        img = np.clip(np.concatenate([rgb, alpha], -1), 0, 1)
        png.write_png(os.path.join(root, "train", f"r_{i}.png"), (img * 255 + 0.5).astype(np.uint8))
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    # A small seed cloud keeps the CPU run short.
    from materialrefgs_torch.utils.ply import write_point_cloud_ply

    pts = rng.normal(size=(300, 3)) * 0.4
    write_point_cloud_ply(os.path.join(root, "points3d.ply"), pts, rng.uniform(size=(300, 3)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_cpu_writes_a_ply_that_eval_loads(tmp_path):
    """scripts/train_torch.py --device cpu across initial -> surfel on a
    2-view Blender scene, masks from train/; the saved PLY loads through
    scripts/eval_torch.py; a checkpoint resumes."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene)
    train = _load_script("train_torch")
    argv = ["-s", scene, "-m", run, "--device", "cpu", "--schedule_scale", "0.002",
            "--iterations", "8", "--capacity", "1024", "--pair_capacity", "16384",
            "--envmap_max_res", "16", "--log_every", "1", "--checkpoint_iterations", "4",
            "--test_iterations", "8"]
    res = train.main(argv)
    log = res["trainer"].metrics_log
    assert [m["iteration"] for m in log] == list(range(1, 9))
    assert {m["stage"] for m in log} == {"initial", "surfel"}
    assert "loss_mask_entropy" in log[-1]  # masks were read from train/
    assert all(np.isfinite(m["loss"]) for m in log)
    assert res["ply"] == os.path.join(run, "point_cloud", "iteration_8", "point_cloud.ply")
    assert np.isfinite(res["test"][8]["psnr"])
    m = _load_script("eval_torch").main(["-m", run, "-s", scene, "--skip_train", "--device", "cpu"])["test"]
    assert np.isfinite(m["psnr"]) and len(m["per_view_psnr"]) == 2

    resumed = train.main(argv[:-4] + ["--start_checkpoint", run, "--iterations", "6"])
    assert [m["iteration"] for m in resumed["trainer"].metrics_log] == [5, 6]
    warm = train.main(argv[:-4] + ["--start_ply", os.path.dirname(res["ply"]), "--start_iter", "8",
                                   "--iterations", "9"])
    assert [m["iteration"] for m in warm["trainer"].metrics_log] == [9]
    assert warm["trainer"].state.step == 9  # the LR clock starts at --start_iter
    # --dp N needs N cards (data parallelism: tests/test_torch_data_parallel.py);
    # --ref_score_path reads one mask per train view (the scene's root has none).
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="--dp 2 but only 1 CUDA cards"):
            train.main([a for a in argv if a not in ("--device", "cpu")] + ["--dp", "2"])
    with pytest.raises(FileNotFoundError):
        train.main(argv + ["--ref_score_path", scene])
