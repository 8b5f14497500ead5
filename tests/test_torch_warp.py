"""The port's multi-view supervision (materialrefgs_torch/train/warp.py, the
patch NCC, the camera helpers) against the JAX package's, function by
function and for calc_warp_loss as a whole, values and gradients, on inputs
made from a numpy seed.

Tolerances are the step-parity ones of tests/test_torch_train.py: values rtol
1e-5, gradients rtol 1e-4 / atol 1e-6 x max(|g|, 1). The patch NCC alone is
held to a bound of float32 summation order (_ncc_order_bound), since its
variances cancel and the two packages sum a patch in different orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test worker (the suite runs several workers).
torch.set_num_threads(1)

from materialrefgs_tpu import cameras as jcams  # noqa: E402
from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.train import losses as jloss  # noqa: E402
from materialrefgs_tpu.train import warp as jwarp  # noqa: E402

from materialrefgs_torch import cameras as tcams  # noqa: E402
from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.train import losses as tloss  # noqa: E402
from materialrefgs_torch.train import warp as twarp  # noqa: E402
from materialrefgs_torch.utils.transforms import clip  # noqa: E402

W = H = 32


def assert_grad_close(tg, jg, what):
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6 * max(float(np.abs(jg).max()), 1.0), err_msg=what)


def grads_match(jfn, tfn, arrays, what):
    """Values of fn(*arrays) and the gradients of sum(sin(fn)) w.r.t. every
    float input, in both packages."""
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    tin = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    tout = tfn(*tin)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6, err_msg=what)
    argnums = tuple(i for i, a in enumerate(arrays) if a.dtype == np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jnp.sin(jfn(*a))), argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    tg = torch.autograd.grad(torch.sin(tout).sum(), [tin[i] for i in argnums])
    for i, a, b in zip(argnums, tg, jg):
        assert_grad_close(a.numpy(), b, f"{what}: d/d input {i}")


def cameras(eyes, w=W, h=H, fov=0.8):
    kw = [dict(eye=np.asarray(e, np.float64), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
               fovx=fov, fovy=fov, width=w, height=h) for e in eyes]
    return [jcams.look_at_camera(**k) for k in kw], [tcams.look_at_camera(**k, device="cpu") for k in kw]


def ring_eyes(n, radius=3.0, step_deg=8.0, y=0.3):
    a = np.deg2rad(step_deg) * np.arange(n)
    return [np.array([radius * np.sin(t), y, -radius * np.cos(t)]) for t in a]


def sphere_maps(cam, rng, radius=1.15, wobble=0.0):
    """Depth (H, W), world normal (H, W, 3), plane distance (H, W, 1) and
    alpha (H, W) of a sphere at the origin seen from a port camera (zero off
    the sphere); `wobble` perturbs the depth smoothly."""
    yy, xx = np.mgrid[0 : cam.height, 0 : cam.width].astype(np.float64)
    d = np.stack([(xx - cam.cx) / cam.fx, (yy - cam.cy) / cam.fy, np.ones_like(xx)], -1)
    R = cam.world_view.numpy().astype(np.float64)[:3, :3]
    o = cam.camera_center.numpy().astype(np.float64)
    dw = d @ R.T
    b = np.sum(dw * o, -1)
    qa = np.sum(dw * dw, -1)
    disc = b * b - qa * (o @ o - radius**2)
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / qa, 0.0)
    t = t * (1 + wobble * np.sin(0.7 * xx + 0.3 * yy + rng.uniform(0, 6)))
    n = np.where(hit[..., None], (o + t[..., None] * dw) / radius, 0.0)
    dist = np.abs(np.sum((n @ R) * (d * t[..., None]), -1, keepdims=True))
    return t.astype(np.float32), n.astype(np.float32), dist.astype(np.float32), hit.astype(np.float32)


def smooth_field(rng, c, lo=0.0, hi=1.0):
    yy, xx = np.mgrid[0:H, 0:W] / H
    f = [0.5 + 0.5 * np.sin(rng.uniform(2, 7) * xx + rng.uniform(2, 7) * yy + rng.uniform(0, 6)) for _ in range(c)]
    return (lo + (hi - lo) * np.stack(f, -1)).astype(np.float32)


# ------------------------------------------------------------- functions --

def test_grid_sample_values_and_coordinate_gradients():
    """Off-integer points and exact integer texel coordinates, where the
    bilinear weight's clip takes half the gradient (jnp.clip's tie); (W-1)
    and (H-1) are powers of two, so the normalized coordinates hit the
    texels exactly. Out-of-range points exercise the zero padding."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(5, 9, 3)).astype(np.float32)
    off = rng.uniform(-1.15, 1.15, size=(60, 2)).astype(np.float32)
    px, py = np.meshgrid(np.arange(9.0), np.arange(5.0))
    on = np.stack([px.ravel() / 4 - 1, py.ravel() / 2 - 1], -1).astype(np.float32)
    coords = np.concatenate([off, on])
    grads_match(jwarp.grid_sample, twarp.grid_sample, [img, coords], "grid_sample")
    # At the integer points the coordinate gradient is jnp.clip's, not
    # F.grid_sample's: torch's clamp would give another value.
    tc = torch.tensor(on, requires_grad=True)
    g = torch.autograd.grad(twarp.grid_sample(torch.from_numpy(img), tc).sum(), tc)[0]
    jg = jax.grad(lambda c: jnp.sum(jwarp.grid_sample(jnp.asarray(img), c)))(jnp.asarray(on))
    assert_grad_close(g.numpy(), jg, "integer points")
    ref = torch.nn.functional.grid_sample(torch.from_numpy(img).permute(2, 0, 1)[None], tc[None, None],
                                          align_corners=True)
    gf = torch.autograd.grad(ref.sum(), tc)[0]
    assert not np.allclose(gf.numpy(), g.numpy())


def test_patch_offsets_and_patch_warp():
    np.testing.assert_array_equal(twarp.patch_offsets(3).numpy(), np.asarray(jwarp.patch_offsets(3)))
    rng = np.random.default_rng(1)
    Hm = (np.eye(3) + 0.1 * rng.normal(size=(7, 3, 3))).astype(np.float32)
    uv = rng.uniform(0, 30, size=(7, 9, 2)).astype(np.float32)
    grads_match(jwarp.patch_warp, twarp.patch_warp, [Hm, uv], "patch_warp")


def test_edges_mask_from_normal():
    rng = np.random.default_rng(2)
    n = np.zeros((H, W, 3), np.float32)
    n[:, : W // 2] = [0.0, 0.0, 1.0]
    n[:, W // 2 :] = [1.0, 0.0, 0.0]
    n[H // 3 : H // 2, 5:9] = [0.0, 1.0, 0.0]
    n += 0.05 * rng.normal(size=n.shape).astype(np.float32)
    for k in (2, 7):
        t = twarp.edges_mask_from_normal(torch.from_numpy(n), dilate_size=k).numpy()
        j = np.asarray(jwarp.edges_mask_from_normal(jnp.asarray(n), dilate_size=k))
        assert 0 < t.sum() < t.size
        np.testing.assert_array_equal(t, j)


def test_points_from_depth_and_depth_map_sampling():
    rng = np.random.default_rng(3)
    (jc, jn), (tc, tn) = cameras(ring_eyes(2, step_deg=10.0))
    depth = (2.5 + 0.3 * rng.uniform(size=(H, W))).astype(np.float32)
    grads_match(lambda d: jwarp.points_from_depth(jc, d), lambda d: twarp.points_from_depth(tc, d), [depth],
                "points_from_depth")
    pts = np.asarray(jwarp.points_from_depth(jc, jnp.asarray(depth)))
    pts_near = (pts @ np.asarray(jn.world_view)[:3, :3] + np.asarray(jn.world_view)[3, :3]).astype(np.float32)
    dmap = (2.4 + 0.5 * rng.uniform(size=(H, W))).astype(np.float32)
    jz, jm = jwarp.points_depth_in_depth_map(jn, jnp.asarray(dmap), jnp.asarray(pts_near))
    tz, tm = twarp.points_depth_in_depth_map(tn, torch.from_numpy(dmap), torch.from_numpy(pts_near))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < int(tm.sum()) < tm.numel()
    grads_match(lambda m, p: jwarp.points_depth_in_depth_map(jn, m, p)[0],
                lambda m, p: twarp.points_depth_in_depth_map(tn, m, p)[0], [dmap, pts_near],
                "points_depth_in_depth_map")


def _ncc_order_bound(ref, nea):
    """(relative, absolute) bounds per patch on how far two float32
    summation orders can move lncc. Each of the patch's five sums may be off
    by (P-1) u sum|x_i| in any order (u = 2^-24); the variances
    sum(x^2) - sum(x)^2 / P and the cross term cancel, which multiplies that
    by sum(x^2) / var (about 30 at these patches), and cc = cross^2 / (var_r
    var_n) adds the relative errors of its factors. Two packages' results
    can lie on both sides: twice that, times cc, bounds the NCC values."""
    r, n = ref.astype(np.float64), nea.astype(np.float64)
    P = r.shape[1]
    e = 3 * (P - 1) * 2.0**-24
    sr, sn = r.sum(1), n.sum(1)
    vr = (r * r).sum(1) - sr * sr / P
    vn = (n * n).sum(1) - sn * sn / P
    cr = (r * n).sum(1) - sr * sn / P
    rel = 2 * e * (2 * np.abs(r * n).sum(1) / np.abs(cr) + (r * r).sum(1) / vr + (n * n).sum(1) / vn)
    return rel, rel * cr * cr / (vr * vn)


def _lncc_left_to_right(ref, nea):
    """losses.lncc with each patch summed left to right, the order of the
    JAX package's eager reduction on the CPU."""
    tps = nea.shape[1]
    sums = torch.stack([ref, nea, ref * ref, nea * nea, ref * nea])
    acc = sums[..., 0]
    for i in range(1, tps):
        acc = acc + sums[..., i]
    ref_sum, nea_sum, ref2_sum, nea2_sum, rn_sum = acc
    cross = rn_sum - nea_sum / tps * ref_sum
    ref_var = ref2_sum - ref_sum / tps * ref_sum
    nea_var = nea2_sum - nea_sum / tps * nea_sum
    ncc = clip(1.0 - cross * cross / (ref_var * nea_var + 1e-8), 0.0, 2.0)[:, None]
    return ncc, ncc < 0.9


def test_robust_L_and_lncc():
    rng = np.random.default_rng(4)
    d = np.concatenate([rng.uniform(0, 0.4, size=50), [0.0, 0.2]]).astype(np.float32)
    grads_match(jwarp.robust_L, twarp.robust_L, [d], "robust_L")
    # Patches of moderate contrast, from correlated to not.
    ref = (0.35 + 0.3 * rng.uniform(size=(40, 49))).astype(np.float32)
    mix = np.linspace(0.05, 0.95, 40)[:, None]
    nea = (mix * ref + (1 - mix) * (0.35 + 0.3 * rng.uniform(size=(40, 49)))).astype(np.float32)
    # The port sums each patch with torch.sum, whose order differs from
    # XLA's; the variances cancel, so values and gradients are held to the
    # most that float32 summation order can move them (_ncc_order_bound).
    rel, vbound = _ncc_order_bound(ref, nea)
    jout = np.asarray(jloss.lncc(jnp.asarray(ref), jnp.asarray(nea))[0])[:, 0]
    tin = [torch.tensor(a, requires_grad=True) for a in (ref, nea)]
    tout = tloss.lncc(*tin)[0][:, 0]
    np.testing.assert_array_less(np.abs(tout.detach().numpy() - jout), vbound + 1e-6)
    jg = jax.grad(lambda a, b: jnp.sum(jnp.sin(jloss.lncc(a, b)[0])), argnums=(0, 1))(jnp.asarray(ref),
                                                                                     jnp.asarray(nea))
    tg = torch.autograd.grad(torch.sin(tout).sum(), tin)
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        tol = 1e-4 * np.abs(b) + rel[:, None] * np.abs(b).max(1, keepdims=True) + 1e-6 * max(np.abs(b).max(), 1.0)
        np.testing.assert_array_less(np.abs(a.numpy() - b), tol, err_msg=f"lncc: d/d input {i}")
    jm = np.asarray(jloss.lncc(jnp.asarray(ref), jnp.asarray(nea))[1])
    tm = tloss.lncc(torch.from_numpy(ref), torch.from_numpy(nea))[1].numpy()
    np.testing.assert_array_equal(tm, jm)
    assert 0 < tm.sum() < tm.size


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_mono_normal_loss(masked):
    rng = np.random.default_rng(5)
    (jc,), (tc,) = cameras(ring_eyes(1))
    sn, rn, prior = (rng.normal(size=(H, W, 3)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32) if masked else None

    def jfn(a, b, p):
        return jnp.stack(jwarp.mono_normal_loss(jc, a, b, p, None if mask is None else jnp.asarray(mask)))

    def tfn(a, b, p):
        return torch.stack(twarp.mono_normal_loss(tc, a, b, p, None if mask is None else torch.from_numpy(mask)))

    grads_match(jfn, tfn, [sn, rn, prior], "mono_normal_loss")


def test_camera_intrinsics_and_virtual_camera():
    (jc,), (tc,) = cameras(ring_eyes(1), w=40, h=30, fov=0.9)
    for s in (1.0, 0.5):
        np.testing.assert_array_equal(tc.get_K(s).numpy(), np.asarray(jc.get_K(s)))
        np.testing.assert_array_equal(tc.get_inv_K(s).numpy(), np.asarray(jc.get_inv_K(s)))
    for seed in range(3):
        jv = jcams.gen_virtual_cam(jc, np.random.default_rng(seed), trans_noise=1.5, deg_noise=30.0)
        tv = tcams.gen_virtual_cam(tc, np.random.default_rng(seed), trans_noise=1.5, deg_noise=30.0)
        for name in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)), err_msg=name)
        assert (tv.fx, tv.fy, tv.cx, tv.cy) == tuple(float(getattr(jv, k)) for k in ("fx", "fy", "cx", "cy"))
    # The draws come in the JAX order: three angles, then three translations.
    rng = np.random.default_rng(0)
    ang, tn = rng.uniform(-30, 30, 3), rng.uniform(-1.5, 1.5, 3) * 0.1
    from scipy.spatial.transform import Rotation

    wv = tc.world_view.numpy().T.astype(np.float64)
    want = Rotation.from_euler("xyz", np.deg2rad(ang)).as_matrix() @ wv[:3, :3]
    tv = tcams.gen_virtual_cam(tc, np.random.default_rng(0))
    np.testing.assert_allclose(tv.world_view.numpy().T[:3, :3], want, atol=1e-6)
    np.testing.assert_allclose(tv.world_view.numpy().T[:3, 3], wv[:3, 3] + tn, atol=1e-6)


# -------------------------------------------------------- calc_warp_loss --

MAPS = ("surf_depth", "rend_normal", "rend_distance", "diffuse_map", "refl_strength_map", "roughness_map")


def warp_inputs(seed=6):
    """Two views of a sphere (the current view's depth wobbled, so the
    reprojection noise varies), smooth material maps with a low-metallic
    region (the NCC's reflectivity gate), grey images, a foreground mask."""
    rng = np.random.default_rng(seed)
    (jc, jn), (tc, tn) = cameras(ring_eyes(2, step_deg=9.0))
    pkgs = []
    for cam, wob in ((tc, 4e-3), (tn, 0.0)):
        depth, normal, dist, alpha = sphere_maps(cam, rng, wobble=wob)
        refl = smooth_field(rng, 1, 0.0, 0.5)
        refl[: H // 2] *= 0.2
        pkgs.append({"surf_depth": depth, "rend_normal": normal, "rend_distance": dist,
                     "diffuse_map": smooth_field(rng, 3) * alpha[..., None], "refl_strength_map": refl,
                     "roughness_map": smooth_field(rng, 1, 0.05, 0.9)})
    grays = [smooth_field(rng, 1)[..., 0] for _ in range(2)]
    mask = sphere_maps(tc, rng)[3]
    return (jc, jn), (tc, tn), pkgs, grays, mask


WARP_CASES = {
    # refreal's geo and reflectivity-gated NCC, plus the directional
    # metallic/roughness warps: every term on.
    "all_terms": dict(use_warp_geo_loss=True, use_warp_ncc_loss=True, use_metallic_warp_loss=True,
                      use_roughness_warp_loss=True, dilate_size=1),
    "refnerf": {},
    "undirected": dict(use_metallic_warp_loss=True, use_roughness_warp_loss=True,
                       directional_rghmtl_warp_alignment=False, dilate_size=1),
    # Fewer samples than valid pixels: the injected uniforms pick them.
    "subset": dict(use_warp_geo_loss=True, use_warp_ncc_loss=True, use_metallic_warp_loss=True,
                   use_roughness_warp_loss=True, dilate_size=1, multi_view_sample_num=150),
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_calc_warp_loss_matches_jax(case, monkeypatch):
    # The patch NCC sums in the JAX order here, so that the loss's values
    # and gradients are held at the step tolerances; test_robust_L_and_lncc
    # bounds what torch.sum's order changes, and the jitted step parity in
    # tests/test_torch_train_warp.py runs the port's own lncc.
    monkeypatch.setattr(twarp, "lncc", _lncc_left_to_right)
    _, _, jopt = jcfg.preset_refnerf()
    jopt = dataclasses.replace(jopt, **WARP_CASES[case])
    topt = tcfg.OptimizationParams(**dataclasses.asdict(jopt))
    use_ncc = jopt.use_warp_ncc_loss
    (jc, jn), (tc, tn), pkgs, grays, mask = warp_inputs()
    key = jax.random.PRNGKey(11)
    uniforms = np.array(jax.random.uniform(key, (H * W,)))
    it = 26000.0

    names = ("geo_loss", "ncc_loss", "base_color_loss", "metallic_warp_loss", "roughness_warp_loss")

    def jfn(maps):
        wl = jwarp.calc_warp_loss(jc, jn, maps[0], maps[1], jnp.asarray(grays[0]), jnp.asarray(grays[1]),
                                  jnp.asarray(mask), jopt, it, key, use_ncc=use_ncc)
        return sum(getattr(wl, n) for n in names), wl

    jmaps = [{k: jnp.asarray(p[k]) for k in MAPS} for p in pkgs]
    # Eager, as the JAX package's own warp tests run it (under jit XLA's
    # fusion rounds the cancelling NCC sums in another order).
    (_, jl), jg = jax.value_and_grad(jfn, has_aux=True)(jmaps)
    tmaps = [{k: torch.tensor(p[k], requires_grad=True) for k in MAPS} for p in pkgs]
    tl = twarp.calc_warp_loss(tc, tn, tmaps[0], tmaps[1], torch.from_numpy(grays[0]), torch.from_numpy(grays[1]),
                              torch.from_numpy(mask), topt, it, torch.from_numpy(uniforms), use_ncc=use_ncc)
    for n in names:
        np.testing.assert_allclose(float(getattr(tl, n).detach()), float(getattr(jl, n)), rtol=1e-5, atol=1e-9,
                                   err_msg=n)
    # The same valid pixels (the weights themselves enter every term).
    np.testing.assert_array_equal(tl.weights_map.numpy() > 0, np.asarray(jl.weights_map) > 0)
    live = {n for n in names if float(getattr(jl, n)) != 0.0}
    want = {"refnerf": {"base_color_loss"}, "undirected": {"base_color_loss", "metallic_warp_loss",
                                                           "roughness_warp_loss"}}.get(case, set(names))
    assert live == want, live
    n_valid = int((np.asarray(jl.weights_map) > 0).sum())
    assert n_valid > (150 if case == "subset" else 100), n_valid

    total = sum(getattr(tl, n) for n in names)
    leaves = [tmaps[i][k] for i in range(2) for k in MAPS]
    tg = torch.autograd.grad(total, leaves, allow_unused=True)
    n_nonzero = 0
    for (i, k), g in zip([(i, k) for i in range(2) for k in MAPS], tg):
        ref = np.asarray(jg[i][k])
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert_grad_close(got, ref, f"view {i} {k}")
        n_nonzero += bool(np.abs(ref).max() > 0)
    assert n_nonzero >= (1 if case == "refnerf" else 3), n_nonzero
