"""PyTorch port vs the JAX package: the tile backward kernel's plain version
and the gradients of the whole `rasterize`.

The JAX side runs its Pallas kernels in interpret mode on the CPU. Gradient
tolerances are those of tests/test_rasterize_grad.py (:93 and :185)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test worker: the suite runs in several worker
# processes, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.ops.rasterize import api as japi  # noqa: E402
from materialrefgs_tpu.ops.rasterize import binning as jbin  # noqa: E402
from materialrefgs_tpu.ops.rasterize.pallas_fwd import rasterize_tiles_fwd as jax_tiles_fwd  # noqa: E402
from materialrefgs_tpu.ops.rasterize.preprocess import PreprocessOut as JPre  # noqa: E402
from materialrefgs_tpu.ops.rasterize.preprocess import preprocess as jax_preprocess  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api as tapi  # noqa: E402
from materialrefgs_torch.ops.rasterize import tiles_bwd  # noqa: E402
from materialrefgs_torch.ops.rasterize.layout import (  # noqa: E402
    ROW_LIN,
    ROW_MEAN2D,
    ROW_OPACITY,
    ROW_TU,
    acc_channels,
    out_layout,
)

CAPACITY = 1 << 14
# Row groups of the per-gaussian payload gradient.
GROUPS = {"dT": (ROW_TU, ROW_MEAN2D), "dmean2d": (ROW_MEAN2D, ROW_OPACITY),
          "dopacity": (ROW_OPACITY, ROW_LIN)}


def cameras(W, H):
    kw = dict(
        eye=np.array([0.0, 0.0, -4.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
        fovx=0.9, fovy=0.7, width=W, height=H,
    )
    return jax_camera(**kw), torch_camera(**kw, device="cpu")


def random_scene(seed, P, S, opacity=(0.2, 0.95)):
    """Splats spread over a 48x32 view; P=300 puts > 128 pairs in a tile."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(P, 3)).astype(np.float32) * 0.6,
        np.exp(rng.normal(size=(P, 2)).astype(np.float32) * 0.5 - 1.6),
        rng.normal(size=(P, 4)).astype(np.float32),
        rng.uniform(*opacity, size=(P,)).astype(np.float32),
        rng.uniform(size=(P, 3)).astype(np.float32),
        rng.uniform(size=(P, S)).astype(np.float32),
    )


@pytest.mark.parametrize("S,opacity", [(1, (0.2, 0.95)), (9, (0.2, 0.95)), (9, (0.97, 1.0))])
def test_tiles_bwd_plain_matches_jax_kernel(S, opacity):
    """Per-gaussian gradients: the plain version + index_add_ against the
    Pallas kernel (interpret mode) + the JAX package's scatter-add, on the
    same payload, bins, forward output and cotangent. Opacities near 1 put
    alpha at the 0.99 clamp, whose gradient both pass through."""
    W, H, gx, gy = 48, 32, 3, 2
    jc, _ = cameras(W, H)
    arrays = random_scene(11 + S, 300, S, opacity)
    means, scales, rots, opac = (jnp.asarray(a) for a in arrays[:4])
    pre = jax_preprocess(means, scales, rots, jc)
    valid = pre.valid & (opac >= 1.0 / 255.0)
    pre = pre._replace(valid=valid, tiles_touched=jnp.where(valid, pre.tiles_touched, 0))
    order = jnp.argsort(pre.depth, stable=True)
    pre = JPre(*(a[order] for a in pre))
    opac_s, colors, feats = (jnp.asarray(a)[order] for a in arrays[3:])
    bins = jbin.bin_pairs(pre, gx, gy, CAPACITY, opacities=opac_s)
    assert int(np.max(np.asarray(bins.tile_count))) > 128  # multi-chunk tiles
    payload_g = japi._build_payload(pre, opac_s, colors, feats, S)
    pp = japi._gather_pairs(payload_g, bins)
    fwd = jax_tiles_fwd(pp, bins.tile_start, bins.tile_count, S=S, grid_x=gx, grid_y=gy,
                        W=W, H=H, interpret=True)
    lay = out_layout(S)
    n_contrib = np.asarray(fwd)[..., lay["n_contrib"][0]]
    if opacity[0] > 0.9:
        alpha_at_clamp = np.asarray(opac_s) * 1.0 >= 0.99
        assert alpha_at_clamp.any()
    rng = np.random.default_rng(S)
    cot = rng.normal(size=fwd.shape).astype(np.float32)
    cot[..., lay["_channels"]:] = 0.0
    P = payload_g.shape[1]
    ref = np.asarray(japi._render_pairs_bwd(
        S, gx, gy, W, H, True, (pp, bins, fwd, P), jnp.asarray(cot)
    )[0])

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    before = tiles_bwd.rasterize_tiles_bwd.launches
    dpair = tiles_bwd.rasterize_tiles_bwd(
        t(pp), t(bins.tile_start), t(bins.tile_count),
        torch.from_numpy(n_contrib.max(axis=1).astype(np.int32)), t(fwd), t(cot),
        S=S, grid_x=gx, grid_y=gy, W=W, H=H,
    )
    assert tiles_bwd.rasterize_tiles_bwd.launches == before  # CPU: the plain version ran
    B = bins.g_sorted.shape[0]
    NG = tiles_bwd.grad_rows(S)
    assert dpair.shape == (pp.shape[1], NG)
    assert float(dpair[int(bins.tile_start[-1]):].abs().max()) == 0.0
    out = torch.zeros((P, pp.shape[0]))
    out[:, :NG].index_add_(0, t(bins.g_sorted).long(), dpair[:B])
    out = out.numpy().T
    assert np.all(out[NG:] == 0.0) and np.all(ref[NG:] == 0.0)
    groups = dict(GROUPS, dlin=(ROW_LIN, ROW_LIN + acc_channels(S)))
    for name, (lo, hi) in groups.items():
        a, b = out[lo:hi], ref[lo:hi]
        assert np.all(np.isfinite(a)), name
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, atol=1e-4 * scale + 1e-7, rtol=0, err_msg=name)


def _loss_of(out):
    weights = {"render": 1.0, "feature": 0.7, "normal": 0.5, "depth": 0.3, "alpha": 0.4,
               "distortion": 0.2, "median_depth": 0.1}
    return sum(lam * (out[k] * 3.0 + 0.3).sin().sum() for k, lam in weights.items())


def _jloss_of(out):
    weights = {"render": 1.0, "feature": 0.7, "normal": 0.5, "depth": 0.3, "alpha": 0.4,
               "distortion": 0.2, "median_depth": 0.1}
    return sum(lam * jnp.sum(jnp.sin(out[k] * 3.0 + 0.3)) for k, lam in weights.items())


def _compare_grads(arrays, W, H, rel, loss=_loss_of, jloss=_jloss_of):
    jc, tc = cameras(W, H)
    bg = np.array([0.2, 0.4, 0.1], np.float32)
    P = arrays[0].shape[0]
    cfg = japi.RasterizeConfig(pair_capacity=CAPACITY, interpret=True)

    def f(*a):
        *inputs, off = a
        return jloss(japi.rasterize(*inputs, camera=jc, bg_color=jnp.asarray(bg), config=cfg,
                                    mean2d_offset=off))

    jargs = [jnp.asarray(a) for a in arrays] + [jnp.zeros((P, 2), jnp.float32)]
    ref = jax.grad(f, argnums=tuple(range(7)))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    off = torch.zeros((P, 2), requires_grad=True)
    out = tapi.rasterize(*targs, tc, torch.from_numpy(bg),
                         config=tapi.RasterizeConfig(pair_capacity=CAPACITY), mean2d_offset=off)
    assert int(out["overflow"]) == 0
    grads = torch.autograd.grad(loss(out), targs + [off])
    names = ["means", "scales", "rots", "opacity", "colors", "features", "mean2d_offset"]
    for n, g, r in zip(names, grads, ref):
        g, r = g.numpy(), np.asarray(r)
        assert np.all(np.isfinite(g)), n
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(g, r, atol=rel * scale + (1e-4 if rel == 2e-3 else 1e-5), err_msg=n)
    return out


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("size", [(48, 32), (41, 29)])
def test_rasterize_grads_match_jax(S, size):
    """Gradients of all six inputs and of mean2d_offset against jax.grad of
    the JAX package's rasterize (atol 2e-3 x scale + 1e-4,
    tests/test_rasterize_grad.py:93)."""
    arrays = random_scene(21, 300, S)
    _compare_grads(arrays, *size, rel=2e-3)


def test_rasterize_grads_match_jax_multichunk():
    """> 128 contributing pairs per pixel (the JAX kernel's cross-chunk carry;
    tests/test_rasterize_grad.py:138): 400 low-opacity splats piled on the
    image center (atol 4e-3 x scale + 1e-5, :185)."""
    rng = np.random.default_rng(5)
    P = 400
    arrays = (
        (rng.normal(size=(P, 3)) * 0.05).astype(np.float32),
        np.exp(rng.normal(size=(P, 2)).astype(np.float32) * 0.3 - 1.2),
        rng.normal(size=(P, 4)).astype(np.float32),
        rng.uniform(0.015, 0.03, size=(P,)).astype(np.float32),
        rng.uniform(size=(P, 3)).astype(np.float32),
        rng.uniform(size=(P, 4)).astype(np.float32),
    )

    def loss(o):
        return ((o["render"] - 0.4) ** 2).mean() + 0.05 * o["feature"].mean() \
            + 0.01 * o["depth"].mean() + 0.01 * o["distortion"].mean()

    def jloss(o):
        return jnp.mean((o["render"] - 0.4) ** 2) + 0.05 * jnp.mean(o["feature"]) \
            + 0.01 * jnp.mean(o["depth"]) + 0.01 * jnp.mean(o["distortion"])

    out = _compare_grads(arrays, 32, 32, rel=4e-3, loss=loss, jloss=jloss)
    assert int(out["n_contrib"].max()) > 128
