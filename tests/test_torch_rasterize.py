"""PyTorch port vs the JAX package: rasterizer preprocess, binning, the tile
forward kernel's plain version, and the whole forward `rasterize`.

The JAX side runs its Pallas kernel in interpret mode on the CPU. Tolerances
are those of tests/test_rasterize_pallas.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.ops.rasterize import api as japi  # noqa: E402
from materialrefgs_tpu.ops.rasterize import binning as jbin  # noqa: E402
from materialrefgs_tpu.ops.rasterize.pallas_fwd import rasterize_tiles_fwd as jax_tiles_fwd  # noqa: E402
from materialrefgs_tpu.ops.rasterize.preprocess import PreprocessOut as JPre  # noqa: E402
from materialrefgs_tpu.ops.rasterize.preprocess import preprocess as jax_preprocess  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api as tapi  # noqa: E402
from materialrefgs_torch.ops.rasterize import binning as tbin  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_fwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.layout import out_layout  # noqa: E402
from materialrefgs_torch.ops.rasterize.preprocess import PreprocessOut as TPre  # noqa: E402
from materialrefgs_torch.ops.rasterize.preprocess import preprocess as torch_preprocess  # noqa: E402

CAPACITY = 1 << 14
TOLS = {
    "render": 2e-4, "feature": 2e-4, "normal": 2e-4, "alpha": 2e-4,
    "final_T": 2e-4, "M1": 2e-4, "M2": 2e-4,
    "depth": 1e-3, "median_depth": 1e-3, "distortion": 5e-4,
}


def cameras(W, H):
    kw = dict(
        eye=np.array([0.0, 0.0, -4.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
        fovx=0.9, fovy=0.7, width=W, height=H,
    )
    return jax_camera(**kw), torch_camera(**kw, device="cpu")


def random_scene(seed, P, S):
    """Splats spread over a 48x32 view; P=300 puts > 128 pairs in a tile."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(P, 3)).astype(np.float32) * 0.6,
        np.exp(rng.normal(size=(P, 2)).astype(np.float32) * 0.5 - 1.6),
        rng.normal(size=(P, 4)).astype(np.float32),
        rng.uniform(0.2, 0.95, size=(P,)).astype(np.float32),
        rng.uniform(size=(P, 3)).astype(np.float32),
        rng.uniform(size=(P, S)).astype(np.float32),
    )


def jax_sorted_pre(arrays, cam):
    """The JAX pipeline's depth-sorted, opacity-culled preprocess output."""
    means, scales, rots, opac = (jnp.asarray(a) for a in arrays[:4])
    pre = jax_preprocess(means, scales, rots, cam)
    valid = pre.valid & (opac >= 1.0 / 255.0)
    pre = pre._replace(
        valid=valid,
        tiles_touched=jnp.where(valid, pre.tiles_touched, 0),
        radius=jnp.where(valid, pre.radius, 0.0),
    )
    order = jnp.argsort(pre.depth, stable=True)
    return JPre(*(a[order] for a in pre)), order


def to_torch_pre(pre):
    return TPre(*(torch.from_numpy(np.array(a)) for a in pre))


def test_preprocess_matches_jax():
    jc, tc = cameras(48, 32)
    arrays = random_scene(0, 300, 1)
    jp = jax_preprocess(*(jnp.asarray(a) for a in arrays[:3]), jc)
    tp = torch_preprocess(*(torch.from_numpy(a) for a in arrays[:3]), tc)
    for name in JPre._fields:
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize(
    "with_opacity,capacity", [(True, CAPACITY), (False, CAPACITY), (True, 512)]
)
def test_bin_pairs_matches_jax(with_opacity, capacity):
    """Integer-exact binning on the same preprocess output (capacity 512
    drops pairs and reports overflow)."""
    jc, _ = cameras(48, 32)
    arrays = random_scene(1, 300, 1)
    pre, order = jax_sorted_pre(arrays, jc)
    opac = jnp.asarray(arrays[3])[order]
    jb = jbin.bin_pairs(pre, 3, 2, capacity, opacities=opac if with_opacity else None)
    tb = tbin.bin_pairs(
        to_torch_pre(pre), 3, 2, capacity,
        opacities=torch.from_numpy(np.array(opac)) if with_opacity else None,
    )
    n = int(jb.num_pairs)
    assert int(tb.num_pairs) == n
    assert np.array_equal(tb.g_sorted[:n].numpy(), np.asarray(jb.g_sorted)[:n])
    for f in ("tile_start", "tile_count", "chunk_base"):
        assert np.array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f))), f
    assert int(tb.overflow) == int(jb.overflow)
    assert (int(jb.overflow) > 0) == (capacity < CAPACITY)


def test_bin_pairs_int32_wrap_matches_jax():
    """Pair totals that wrap int32 report the same huge positive overflow and
    the same ranges as the JAX package."""
    P = 4
    fields = dict(
        T_rows=np.zeros((P, 3, 3), np.float32),
        normal=np.zeros((P, 3), np.float32),
        depth=np.arange(P, dtype=np.float32),
        mean2d=np.zeros((P, 2), np.float32),
        radius=np.ones(P, np.float32),
        rect_min=np.zeros((P, 2), np.int32),
        rect_max=np.full((P, 2), 2, np.int32),
        tiles_touched=np.full((P,), 2**30, np.int32),
        valid=np.ones(P, bool),
    )
    jb = jbin.bin_pairs(JPre(**{k: jnp.asarray(v) for k, v in fields.items()}), 4, 4, 256)
    tb = tbin.bin_pairs(TPre(**{k: torch.from_numpy(v) for k, v in fields.items()}), 4, 4, 256)
    assert int(tb.overflow) == int(jb.overflow) > 0
    assert np.array_equal(tb.g_sorted.numpy(), np.asarray(jb.g_sorted))
    for f in ("tile_start", "tile_count", "chunk_base"):
        assert np.array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f))), f


def _compare_tiles(a, b, S):
    lay = out_layout(S)
    groups = {
        "render": "color", "feature": "feature", "normal": "normal", "depth": "depth",
        "M1": "M1", "M2": "M2", "distortion": "distortion",
        "median_depth": "median_depth", "final_T": "final_T",
    }
    for tol_key, ch in groups.items():
        lo, hi = lay[ch]
        np.testing.assert_allclose(
            b[..., lo:hi], a[..., lo:hi], atol=TOLS[tol_key], rtol=1e-3, err_msg=ch
        )
    for ch in ("n_contrib", "median_contrib"):
        lo, hi = lay[ch]
        assert np.array_equal(b[..., lo:hi], a[..., lo:hi]), ch
    assert np.all(b[..., lay["_channels"]:] == 0.0)


def test_tiles_fwd_plain_matches_jax_kernel():
    """The plain version against the Pallas kernel (interpret mode) on the
    same payload arrays."""
    S, W, H = 9, 48, 32
    jc, _ = cameras(W, H)
    arrays = random_scene(2, 300, S)
    pre, order = jax_sorted_pre(arrays, jc)
    opac, colors, feats = (jnp.asarray(a)[order] for a in arrays[3:])
    bins = jbin.bin_pairs(pre, 3, 2, CAPACITY, opacities=opac)
    assert int(np.max(np.asarray(bins.tile_count))) > 128  # multi-chunk tiles
    pp = japi._gather_pairs(japi._build_payload(pre, opac, colors, feats, S), bins)
    ref = np.asarray(jax_tiles_fwd(
        pp, bins.tile_start, bins.tile_count, S=S, grid_x=3, grid_y=2, W=W, H=H, interpret=True
    ))
    before = tiles_fwd.rasterize_tiles_fwd.launches
    out = tiles_fwd.rasterize_tiles_fwd(
        torch.from_numpy(np.array(pp)),
        torch.from_numpy(np.array(bins.tile_start)),
        torch.from_numpy(np.array(bins.tile_count)),
        S=S, grid_x=3, grid_y=2, W=W, H=H,
    )
    assert tiles_fwd.rasterize_tiles_fwd.launches == before  # CPU: the plain version ran
    _compare_tiles(ref, out.numpy(), S)


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("size", [(48, 32), (41, 29)])
def test_rasterize_matches_jax(S, size):
    W, H = size
    jc, tc = cameras(W, H)
    arrays = random_scene(3, 300, S)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = japi.rasterize(
        *(jnp.asarray(a) for a in arrays), jc, jnp.asarray(bg),
        config=japi.RasterizeConfig(pair_capacity=CAPACITY, interpret=True),
    )
    t_in = [torch.from_numpy(a) for a in arrays]
    cfg = tapi.RasterizeConfig(pair_capacity=CAPACITY)
    ti = tapi.tile_inputs(*t_in, tc, config=cfg)
    assert int(ti.bins.tile_count.max()) > 128
    with torch.no_grad():
        out = tapi.rasterize(*t_in, tc, torch.from_numpy(bg), config=cfg)
    for key, tol in TOLS.items():
        np.testing.assert_allclose(
            out[key].numpy(), np.asarray(ref[key]), atol=tol, rtol=1e-3, err_msg=key
        )
    for key in ("n_contrib", "median_contrib"):
        assert np.array_equal(out[key].numpy(), np.asarray(ref[key])), key
    np.testing.assert_allclose(out["mean2d"].numpy(), np.asarray(ref["mean2d"]), atol=1e-4, rtol=1e-5)
    assert np.array_equal(out["radii"].numpy(), np.asarray(ref["radii"]))
    assert int(out["overflow"]) == int(ref["overflow"]) == 0


def test_rasterize_refuses_autograd():
    """First-order gradients flow through the tile kernels (the hand-derived
    backward); a second-order gradient is refused, as the backward is not
    itself differentiable."""
    _, tc = cameras(16, 16)
    arrays = [torch.from_numpy(a) for a in random_scene(4, 8, 1)]
    arrays[0].requires_grad_(True)
    out = tapi.rasterize(*arrays, tc, torch.zeros(3))
    (g,) = torch.autograd.grad(out["render"].sum(), arrays[0])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    out = tapi.rasterize(*arrays, tc, torch.zeros(3))
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(out["render"].sum(), arrays[0], create_graph=True)
