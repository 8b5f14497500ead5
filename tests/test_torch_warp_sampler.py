"""The warp's bilinear sampler (materialrefgs_torch/ops/warp_sample.py).

On the CPU: the autograd Function `WarpSample`, whose wrappers take the
plain expression there (`grid_sample_plain` without autograd forward, its
autograd gradients `grid_sample_plain_grads` backward), against the plain
expression under autograd, over coordinate kinds (random, exactly on
texels where jnp.clip's tie gradient applies, on and past the border, NaN
and +-inf), C = 1 and 3, and the gradients asked for; the memory contract
(every tensor the Function saves shares storage with an input, and none is
saved when no input needs a gradient); the refusal of second-order
gradients; and calc_warp_loss with the Function in place of the plain
expression.

Marked `gpu` (skip without a card): the CUDA gather and splat against the
plain expression (forward) and its autograd gradients (backward) at the
benchmark cells' shapes, the launches of one calc_warp_loss forward and
backward, and the card's peak memory of that forward and backward against
the plain expression's. This file imports neither JAX nor the JAX package:
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_warp_sampler.py

Gradient tolerance on the card (the splat's atomics sum the map's gradient
in no fixed order; the coordinates' gradient sums channels and corners in
another order than autograd): the one of tests/test_torch_warp.py, rtol
1e-4 / atol 1e-6 x max(|g|, 1), and for the map 2^-14 of each texel's sum
of its terms' magnitudes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.ops import warp_sample as ws  # noqa: E402
from materialrefgs_torch.train import warp as twarp  # noqa: E402

H, W = 5, 9  # (W - 1) and (H - 1) powers of two: texel coordinates are exact in [-1, 1]
NAN, INF = float("nan"), float("inf")


def _coords(kind: str, rng) -> torch.Tensor:
    if kind == "random":
        c = rng.uniform(-1.0, 1.0, size=(80, 2))
    elif kind == "integer":
        px, py = np.meshgrid(np.arange(W), np.arange(H))
        c = np.stack([2 * px.ravel() / (W - 1) - 1, 2 * py.ravel() / (H - 1) - 1], -1)
    elif kind == "border":
        edge = np.array([-1.0, 1.0, -1.0 - 1e-7, 1.0 + 1e-7, -1.2, 1.2, -1.0 - 2 / (W - 1), 1.0 + 1 / (W - 1)])
        a, b = np.meshgrid(edge, np.concatenate([edge, rng.uniform(-1, 1, 4)]))
        c = np.concatenate([np.stack([a.ravel(), b.ravel()], -1), np.stack([b.ravel(), a.ravel()], -1)])
    else:  # nonfinite
        v = np.array([NAN, INF, -INF, 0.3, -1.0, 1e30, -1e30])
        a, b = np.meshgrid(v, v)
        c = np.stack([a.ravel(), b.ravel()], -1)
    return torch.tensor(c, dtype=torch.float32)


def _map(C: int, rng, nonfinite: bool = False) -> torch.Tensor:
    img = torch.tensor(rng.normal(size=(H, W, C)), dtype=torch.float32)
    if nonfinite:
        img[2, 3, 0] = NAN
        img[0, W - 1, C - 1] = INF
    return img


def assert_same(a: torch.Tensor, b: torch.Tensor, what: str):
    """Bit for bit, NaN where the other has NaN."""
    torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True, msg=what)


def assert_grad_close(a: torch.Tensor, b: torch.Tensor, what: str):
    assert torch.equal(torch.isnan(a), torch.isnan(b)), f"{what}: NaN at other entries"
    fin = torch.isfinite(b)
    assert torch.equal(a[~fin & ~torch.isnan(b)], b[~fin & ~torch.isnan(b)]), f"{what}: infinities"
    scale = max(float(b[fin].abs().max()) if fin.any() else 0.0, 1.0)
    torch.testing.assert_close(a[fin], b[fin], rtol=1e-4, atol=1e-6 * scale, msg=what)


NEEDS = {"map": (True, False), "coords": (False, True), "map_coords": (True, True)}


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize("need", sorted(NEEDS))
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", ["random", "integer", "border", "nonfinite"])
def test_function_matches_plain_expression(kind, C, need):
    rng = np.random.default_rng([ord(ch) for ch in f"{kind}{C}{need}"])
    img0, c0 = _map(C, rng, nonfinite=kind == "nonfinite"), _coords(kind, rng)
    need_map, need_coords = NEEDS[need]
    g = torch.tensor(rng.normal(size=(c0.shape[0], C)), dtype=torch.float32)

    def run(fn):
        img, c = img0.clone().requires_grad_(need_map), c0.clone().requires_grad_(need_coords)
        out = fn(img, c)
        grads = torch.autograd.grad(out, [t for t in (img, c) if t.requires_grad], g)
        return out.detach(), grads

    out, grads = run(ws.WarpSample.apply)
    ref, ref_grads = run(ws.grid_sample_plain)
    assert_same(out, ref, "values")
    assert len(grads) == len(ref_grads)
    for got, want, name in zip(grads, ref_grads, [n for n, on in (("map", need_map), ("coords", need_coords)) if on]):
        assert_same(got, want, f"d/d {name}")


def test_second_order_is_refused():
    """The splat is not itself differentiable: create_graph=True raises, as
    the rasterizer's Function does, instead of returning gradients with no
    graph."""
    img = torch.randn(H, W, 3, requires_grad=True)
    c = (torch.rand(10, 2) * 2 - 1).requires_grad_()
    out = ws.WarpSample.apply(img, c)
    with pytest.raises(NotImplementedError):
        torch.autograd.grad(out.sum(), (img, c), create_graph=True)


def test_integer_coordinates_take_half_the_gradient():
    """At a texel the clipped weight's gradient is half of the one-sided
    slope, as jnp.clip's tie gives it: for a linear ramp along x the
    coordinate gradient is half the slope times (W - 1) / 2."""
    ramp = torch.arange(W, dtype=torch.float32).repeat(H, 1)[..., None]
    c = _coords("integer", np.random.default_rng(0)).requires_grad_()
    (dc,) = torch.autograd.grad(ws.WarpSample.apply(ramp, c).sum(), c)
    inner = (c[:, 0] > -1) & (c[:, 0] < 1)
    assert torch.all(dc[inner, 0] == 0.5 * (W - 1) / 2)
    (dp,) = torch.autograd.grad(ws.grid_sample_plain(ramp, c).sum(), c)
    assert torch.equal(dc, dp)


@pytest.mark.parametrize("need", sorted(NEEDS))
def test_function_saves_only_its_inputs(need):
    """Every tensor WarpSample saves shares storage with an input: no
    indices, weights, masks or corner values are kept for the backward."""
    rng = np.random.default_rng(3)
    need_map, need_coords = NEEDS[need]
    wide = torch.tensor(rng.normal(size=(H, W, 5)), dtype=torch.float32, requires_grad=need_map)
    img = wide[..., 1:4]  # a channel slice, as the rasterizer's feature maps are
    c = (torch.tensor(rng.uniform(-1, 1, size=(6, 7, 2)), dtype=torch.float32)).requires_grad_(need_coords)
    inputs = {img.untyped_storage().data_ptr(), c.untyped_storage().data_ptr()}
    saved = []

    def pack(t):
        saved.append((t.untyped_storage().data_ptr(), t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ws.WarpSample.apply(img, c.reshape(-1, 2))
    assert len(saved) == 2
    assert all(ptr in inputs for ptr, _, _ in saved), saved
    leaves = [t for t in (wide, c) if t.requires_grad]
    assert all(g is not None for g in torch.autograd.grad(out.sum(), leaves))


def test_plain_expression_saves_more_than_its_inputs():
    """The hook sees what the plain expression keeps: int64 indices among
    them (the contract above is not vacuous)."""
    img = torch.randn(H, W, 3, requires_grad=True)
    c = torch.rand(10, 2) * 2 - 1
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        ws.grid_sample_plain(img, c)
    inputs = {img.untyped_storage().data_ptr(), c.untyped_storage().data_ptr()}
    assert any(t.dtype == torch.int64 for t in saved)
    assert any(t.untyped_storage().data_ptr() not in inputs for t in saved)


def test_no_gradient_no_graph():
    """When neither input needs a gradient, nothing is saved and the output
    has no graph."""
    saved = []
    img, c = torch.randn(H, W, 1), torch.rand(10, 2) * 2 - 1
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = ws.WarpSample.apply(img, c)
        with torch.no_grad():
            out2 = ws.WarpSample.apply(img.requires_grad_(), c)
    assert saved == [] and out.grad_fn is None and out2.grad_fn is None


def test_strided_inputs_read_in_place():
    """A channel slice of a wider map, coordinates with a row stride and an
    expanded output gradient (stride 0) give what contiguous copies give."""
    rng = np.random.default_rng(5)
    wide = torch.tensor(rng.normal(size=(H, W, 6)), dtype=torch.float32)
    img = wide[..., 2:5]
    c4 = torch.tensor(rng.uniform(-1.1, 1.1, size=(40, 4)), dtype=torch.float32)
    c = c4[:, 1:3]
    g = torch.tensor(rng.normal(size=(1, 3)), dtype=torch.float32).expand(40, 3)
    assert not img.is_contiguous() and not c.is_contiguous() and g.stride(0) == 0
    out = ws.warp_sample_fwd(img, c)
    assert_same(out, ws.warp_sample_fwd(img.contiguous(), c.contiguous()), "values")
    got = ws.warp_sample_bwd(img, c, g, need_map=True, need_coords=True)
    want = ws.warp_sample_bwd(img.contiguous(), c.contiguous(), g.contiguous(), need_map=True, need_coords=True)
    for a, b in zip(got, want):
        assert_same(a, b, "gradients")


def test_backward_computes_only_what_is_asked():
    img, c = torch.randn(H, W, 3), torch.rand(10, 2) * 2 - 1
    g = torch.randn(10, 3)
    for (nm, nc) in NEEDS.values():
        dm, dc = ws.warp_sample_bwd(img, c, g, need_map=nm, need_coords=nc)
        assert (dm is not None) == nm and (dc is not None) == nc
        if nm:
            assert dm.shape == (H, W, 3)
        if nc:
            assert dc.shape == (10, 2)


def test_inputs_are_checked():
    img, c = torch.randn(H, W, 3), torch.rand(10, 2)
    with pytest.raises(ValueError):
        ws.warp_sample_fwd(img.double(), c)
    with pytest.raises(ValueError):
        ws.warp_sample_fwd(img[..., 0], c)
    with pytest.raises(ValueError):
        ws.warp_sample_fwd(img, c[:, :1])
    with pytest.raises(ValueError):
        ws.warp_sample_bwd(img, c, torch.randn(10, 2), need_map=True, need_coords=False)


def test_grid_sample_on_the_cpu_is_the_plain_expression():
    """warp.grid_sample (every caller's name) takes the plain expression on
    CPU tensors, keeping (..., 2) coordinates' leading shape."""
    assert twarp.grid_sample is ws.grid_sample
    rng = np.random.default_rng(7)
    img = torch.tensor(rng.normal(size=(H, W, 3)), dtype=torch.float32, requires_grad=True)
    c = torch.tensor(rng.uniform(-1, 1, size=(4, 6, 2)), dtype=torch.float32)
    out = ws.grid_sample(img, c)
    assert out.shape == (4, 6, 3)
    assert out.grad_fn is not None
    assert_same(out, ws.grid_sample_plain(img, c), "values")


# Two views of a sphere at the origin (tests/test_torch_warp.py's geometry,
# without the JAX side).
def _cameras(w, h, device, step_deg=9.0, radius=3.0, fov=0.8):
    cams = []
    for t in np.deg2rad(step_deg) * np.arange(2):
        eye = np.array([radius * np.sin(t), 0.3, -radius * np.cos(t)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), fov, fov, w, h, device=device))
    return cams


def _sphere_maps(cam, rng, wobble=0.0, radius=1.15):
    h, w = cam.height, cam.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.stack([(xx - cam.cx) / cam.fx, (yy - cam.cy) / cam.fy, np.ones_like(xx)], -1)
    R = cam.world_view.cpu().numpy().astype(np.float64)[:3, :3]
    o = cam.camera_center.cpu().numpy().astype(np.float64)
    dw = d @ R.T
    b = np.sum(dw * o, -1)
    qa = np.sum(dw * dw, -1)
    disc = b * b - qa * (o @ o - radius**2)
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / qa, 0.0)
    t = t * (1 + wobble * np.sin(0.7 * xx + 0.3 * yy + rng.uniform(0, 6)))
    n = np.where(hit[..., None], (o + t[..., None] * dw) / radius, 0.0)
    dist = np.abs(np.sum((n @ R) * (d * t[..., None]), -1))
    return t, n, dist, hit.astype(np.float64)


def _warp_inputs(w, h, device, seed=6):
    """Camera pair, render packages (leaves that need gradients), grey
    images and a mask; material maps are smooth fields."""
    rng = np.random.default_rng(seed)
    cams = _cameras(w, h, device)
    f32 = dict(dtype=torch.float32, device=device)
    yy, xx = np.mgrid[0:h, 0:w] / h

    def field(c):
        return np.stack([0.5 + 0.5 * np.sin(rng.uniform(2, 7) * xx + rng.uniform(2, 7) * yy + rng.uniform(0, 6))
                         for _ in range(c)], -1)

    pkgs = []
    for cam, wob in zip(cams, (4e-3, 0.0)):
        depth, normal, dist, alpha = _sphere_maps(cam, rng, wobble=wob)
        feature = field(2)
        feature[..., 0] *= 0.5
        feature[: h // 2, :, 0] *= 0.2  # a low-metallic region: the NCC's reflectivity gate
        feature = torch.tensor(feature, **f32).requires_grad_()
        pkgs.append({
            "surf_depth": torch.tensor(depth, **f32).requires_grad_(),
            "rend_normal": torch.tensor(normal, **f32).requires_grad_(),
            "rend_distance": torch.tensor(dist, **f32).requires_grad_(),
            "diffuse_map": torch.tensor(field(3) * alpha[..., None], **f32).requires_grad_(),
            "refl_strength_map": feature[..., 0:1],  # channel slices, as the renderer's
            "roughness_map": feature[..., 1:2],
            "_feature": feature,
        })
    grays = [torch.tensor(field(1)[..., 0], **f32) for _ in range(2)]
    mask = torch.tensor(_sphere_maps(cams[0], rng)[3], **f32)
    uniforms = torch.tensor(rng.uniform(size=(h * w,)), **f32)
    return cams, pkgs, grays, mask, uniforms


PRESETS = {
    "refnerf": {},
    "refreal": dict(use_warp_geo_loss=True, use_warp_ncc_loss=True),
    "all_terms": dict(use_warp_geo_loss=True, use_warp_ncc_loss=True, use_metallic_warp_loss=True,
                      use_roughness_warp_loss=True, dilate_size=1),
}


def _warp_loss_and_grads(w, h, device, preset, sample_num=None):
    _, _, opt = tcfg.preset_refnerf()
    opt = dataclasses.replace(opt, **PRESETS[preset])
    if sample_num is not None:
        opt = dataclasses.replace(opt, multi_view_sample_num=sample_num)
    cams, pkgs, grays, mask, uniforms = _warp_inputs(w, h, device)
    wl = twarp.calc_warp_loss(cams[0], cams[1], pkgs[0], pkgs[1], grays[0], grays[1], mask, opt, 26000.0, uniforms,
                              use_ncc=opt.use_warp_ncc_loss)
    names = ("geo_loss", "ncc_loss", "base_color_loss", "metallic_warp_loss", "roughness_warp_loss")
    total = sum(getattr(wl, n) for n in names)
    leaves = [p[k] for p in pkgs for k in ("surf_depth", "rend_normal", "rend_distance", "diffuse_map", "_feature")]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return [float(getattr(wl, n).detach()) for n in names], grads


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_calc_warp_loss_through_the_function(preset, monkeypatch):
    """calc_warp_loss with every sample taken by WarpSample (map-only,
    coordinate-only and both-gradient nodes, by term) against the plain
    expression: the same losses bit for bit, the same gradients."""
    monkeypatch.setattr(twarp, "grid_sample", lambda img, c: ws.WarpSample.apply(img, c.reshape(-1, 2)).reshape(
        *c.shape[:-1], img.shape[2]))
    got_l, got_g = _warp_loss_and_grads(32, 32, "cpu", preset)
    monkeypatch.setattr(twarp, "grid_sample", ws.grid_sample_plain)
    ref_l, ref_g = _warp_loss_and_grads(32, 32, "cpu", preset)
    assert got_l == ref_l
    assert sum(v != 0.0 for v in ref_l) == {"refnerf": 1, "refreal": 3, "all_terms": 5}[preset]
    for a, b in zip(got_g, ref_g):
        assert (a is None) == (b is None)
        if a is not None:
            assert_grad_close(a, b, "leaf gradient")


# ---------------------------------------------------------------- card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _patch_coords(h, w, n, rng, device):
    """n patches of 7 x 7 pixels, each centre's patch warped by a random
    near-identity affine map (as the plane homographies move them), some
    past the border; (n * 49, 2) in [-1, 1] units."""
    centre = rng.uniform([0, 0], [w - 1, h - 1], size=(n, 1, 2))
    r = np.arange(-3, 4, dtype=np.float64)
    off = np.stack(np.meshgrid(r, r), -1).reshape(1, 49, 2)
    A = np.eye(2) + rng.normal(scale=0.15, size=(n, 2, 2))
    p = centre + np.einsum("nij,npj->npi", A, np.broadcast_to(off, (n, 49, 2))) + rng.normal(scale=2.0, size=(n, 1, 2))
    p = p.reshape(-1, 2)
    c = np.stack([2 * p[:, 0] / (w - 1) - 1, 2 * p[:, 1] / (h - 1) - 1], -1)
    return torch.tensor(c, dtype=torch.float32, device=device)


def _depth_coords(h, w, rng, device):
    """Every pixel reprojected by a small smooth shift: (h * w, 2)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    px = xx + 3.0 * np.sin(yy / 40.0) + rng.normal(scale=0.5, size=xx.shape)
    py = yy + 2.0 * np.cos(xx / 50.0) + rng.normal(scale=0.5, size=xx.shape)
    c = np.stack([px.ravel() / ((w - 1) / 2) - 1, py.ravel() / ((h - 1) / 2) - 1], -1)
    return torch.tensor(c, dtype=torch.float32, device=device)


# (H, W, C, coordinates): refnerf's diffuse map and refreal's grey image,
# each sampled by 102,400 patches of 49 (5,017,600 coordinates), and
# refreal's depth sample (1236 x 821 = 1,014,756 points).
CELL_SHAPES = {
    "refnerf_patches": (800, 800, 3, "patches"),
    "refreal_patches": (821, 1236, 1, "patches"),
    "refreal_depth": (821, 1236, 1, "depth"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CELL_SHAPES))
def test_kernels_match_plain_at_cell_shapes(cuda_device, case):
    h, w, C, kind = CELL_SHAPES[case]
    rng = np.random.default_rng(17)
    img = torch.tensor(rng.uniform(size=(h, w, C)), dtype=torch.float32, device=cuda_device)
    coords = _patch_coords(h, w, 102_400, rng, cuda_device) if kind == "patches" else _depth_coords(h, w, rng, cuda_device)
    assert coords.shape[0] == (5_017_600 if kind == "patches" else 1_014_756)
    g = torch.tensor(rng.normal(size=(coords.shape[0], C)), dtype=torch.float32, device=cuda_device)

    f0, b0 = ws.warp_sample_fwd.launches, ws.warp_sample_bwd.launches
    out = ws.warp_sample_fwd(img, coords)
    torch.cuda.synchronize()
    assert ws.warp_sample_fwd.launches == f0 + 1
    with torch.no_grad():
        ref = ws.grid_sample_plain(img, coords)
    assert torch.equal(out, ref)  # bit for bit

    dm, dc = ws.warp_sample_bwd(img, coords, g, need_map=True, need_coords=True)
    torch.cuda.synchronize()
    assert ws.warp_sample_bwd.launches == b0 + 1
    rm, rc = ws.grid_sample_plain_grads(img, coords, g, need_map=True, need_coords=True)
    # The map's gradient sums each texel's terms by atomics, in no fixed
    # order: each texel within 2^-14 of the sum of its terms' magnitudes
    # (recursive summation's bound for up to 2^10 terms a texel).
    mag, _ = ws.grid_sample_plain_grads(img, coords, g.abs(), need_map=True, need_coords=False)
    assert torch.all((dm - rm).abs() <= 2.0**-14 * mag + 1e-30)
    # The coordinates' gradient: per coordinate, its channels and corners
    # summed in another order than autograd's.
    assert_grad_close(dc, rc, "coordinates")
    dm2, dc2 = ws.warp_sample_bwd(img, coords, g, need_map=True, need_coords=False)
    assert dc2 is None and torch.all((dm2 - rm).abs() <= 2.0**-14 * mag + 1e-30)


@pytest.mark.gpu
def test_kernel_nonfinite_and_strided_inputs_match_plain(cuda_device):
    rng = np.random.default_rng(2)
    wide = torch.tensor(rng.normal(size=(H, W, 5)), dtype=torch.float32, device=cuda_device)
    wide[2, 3, 1] = NAN
    wide[0, W - 1, 3] = INF
    img = wide[..., 1:4]
    c = torch.cat([_coords(k, rng) for k in ("random", "integer", "border", "nonfinite")]).to(cuda_device)
    assert_same(ws.warp_sample_fwd(img, c), ws.grid_sample_plain(img, c), "values")
    g = torch.tensor(rng.normal(size=(c.shape[0], 3)), dtype=torch.float32, device=cuda_device)
    got = ws.warp_sample_bwd(img, c, g, need_map=True, need_coords=True)
    want = ws.grid_sample_plain_grads(img, c, g, need_map=True, need_coords=True)
    for a, b in zip(got, want):
        assert_grad_close(a, b, "gradients")


# Launches of one calc_warp_loss forward and backward. refnerf: the depth
# sample, bc_ref and bc_near forward, bc_near's map gradient backward (the
# depth sample feeds only detached weights). refreal: + the four NCC
# samples forward; backward the depth sample (map and coordinates), the
# nearest grey patch (coordinates) and bc_near (map).
LAUNCHES = {"refnerf": (3, 1), "refreal": (7, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("preset", sorted(LAUNCHES))
def test_calc_warp_loss_launches(cuda_device, preset):
    f0, b0 = ws.warp_sample_fwd.launches, ws.warp_sample_bwd.launches
    _warp_loss_and_grads(64, 48, cuda_device, preset)
    torch.cuda.synchronize()
    assert (ws.warp_sample_fwd.launches - f0, ws.warp_sample_bwd.launches - b0) == LAUNCHES[preset]


@pytest.mark.gpu
def test_calc_warp_loss_peak_memory_at_most_the_plain_expressions(cuda_device, monkeypatch):
    """At refnerf's shapes (800 x 800, 102,400 samples of 49), one
    calc_warp_loss forward and backward raises the card's peak allocation by
    no more with the kernels than with the plain expression."""

    def peak_rise():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, _ = _warp_loss_and_grads(800, 800, cuda_device, "refnerf")
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, losses

    kernel_rise, kernel_losses = peak_rise()
    monkeypatch.setattr(twarp, "grid_sample", ws.grid_sample_plain)
    plain_rise, plain_losses = peak_rise()
    assert kernel_losses == plain_losses
    assert kernel_rise <= plain_rise, (kernel_rise, plain_rise)
