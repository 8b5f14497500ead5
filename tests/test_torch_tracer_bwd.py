"""PyTorch port vs the JAX package: the bundle tracer's backward. The plain
version of `trace_bundles_bwd` against the Pallas kernel in interpret mode on
identical inputs, and the gradients of the whole `trace` (the autograd
Function over both kernels) against `jax.grad` of the JAX `trace`.

Tolerances: the backward's values each within 1e-4 x the largest magnitude
of their group (a payload row group, ray origin, ray direction) + 1e-6, the
sums over a bundle's rays and a chunk's lanes being taken in another order;
`trace`'s gradients within 2e-3 x the leaf's largest magnitude + 1e-4, the
train-step tests' tolerance (tests/test_torch_train.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.ops.tracer import api as japi  # noqa: E402
from materialrefgs_tpu.ops.tracer import pallas_kernels as pk  # noqa: E402
from materialrefgs_tpu.utils import sh as jsh  # noqa: E402

from materialrefgs_torch.ops.tracer import api as tapi  # noqa: E402
from materialrefgs_torch.ops.tracer import layout  # noqa: E402
from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd  # noqa: E402
from materialrefgs_torch.utils import sh as tsh  # noqa: E402
from test_torch_tracer import _kernel_case, _trace_scene  # noqa: E402

GROUPS = {"center": (0, 3), "tu": (3, 6), "tv": (6, 9), "normal": (9, 12), "opacity": (12, 13)}


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_sh_basis_grad_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 50)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0)
    ref = pk.sh_basis_grad(*(jnp.asarray(c) for c in v), 16)
    out = tsh.sh_basis_grad(*(_t(c) for c in v), 16)
    for k, (a, b) in enumerate(zip(out, ref)):
        for i in range(3):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b[i]), rtol=1e-6, atol=1e-7, err_msg=f"{k},{i}")
    # The Jacobian of sh_basis itself, by central differences in float64.
    x = torch.tensor(v.astype(np.float64))
    eps = 1e-6
    for i in range(3):
        dp, dm = x.clone(), x.clone()
        dp[i] += eps
        dm[i] -= eps
        num = [(a - b) / (2 * eps) for a, b in zip(tsh.sh_basis(*dp, 16), tsh.sh_basis(*dm, 16))]
        ana = tsh.sh_basis_grad(*x, 16)
        for k in range(16):
            np.testing.assert_allclose(ana[k][i].numpy(), num[k].numpy(), atol=1e-6, err_msg=f"{k},{i}")
    assert jsh.C0 == tsh.C0


def _bwd_case(n_sh, exact):
    """_kernel_case's four bundles (a 3-chunk segment, an empty one, one that
    exits early, a 90-pair one), the JAX forward's output, the walk bound as
    the autograd Functions compute it, and a cotangent from a numpy seed on
    rgb, depth, normal and final_T."""
    payload, rays, start, count = _kernel_case(n_sh)
    fwd = np.asarray(pk.trace_bundles_fwd(
        jnp.asarray(payload), jnp.asarray(rays), jnp.asarray(start), jnp.asarray(count),
        n_sh=n_sh, tmin=1e-3, interpret=True, exact_order=exact,
    ))
    if exact:
        active = fwd[..., layout.OUT_NPROC].max(1).astype(np.int32) * layout.K_CHUNK
    else:
        active = fwd[..., layout.OUT_NCONTRIB].max(1).astype(np.int32)
    cot = np.zeros(fwd.shape, np.float32)
    cot[..., :8] = np.random.default_rng(n_sh + 2 * exact).normal(size=fwd.shape[:2] + (8,))
    return payload, rays, start, count, active, fwd, cot


@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_bwd_plain_matches_pallas(n_sh, exact):
    args = _bwd_case(n_sh, exact)
    payload, rays, start, count, active, fwd, cot = args
    jp, jr = pk.trace_bundles_bwd(*(jnp.asarray(a) for a in args), n_sh=n_sh, tmin=1e-3, interpret=True,
                                  exact_order=exact)
    jp, jr = np.asarray(jp), np.asarray(jr)
    targs = [_t(a) for a in args]
    work = {}
    tp, tr = trace_bwd.trace_bundles_bwd_plain(*targs, n_sh=n_sh, exact_order=exact, work=work)
    tp, tr = tp.numpy(), tr.numpy()
    # The wrapper takes the plain version for CPU tensors and counts no launch.
    before = trace_bwd.trace_bundles_bwd.launches
    wp, wr = trace_bwd.trace_bundles_bwd(*targs, n_sh=n_sh, exact_order=exact)
    assert trace_bwd.trace_bundles_bwd.launches == before
    np.testing.assert_array_equal(wp.numpy(), tp)
    np.testing.assert_array_equal(wr.numpy(), tr)

    # The columns of the segments' chunks: the JAX kernel writes them all
    # (zeros past the walk); the port leaves every other column zero.
    walked = np.zeros(payload.shape[1], bool)
    for s, c in zip(start[:-1], count):
        walked[s : s + -(-c // 128) * 128] = True
    assert np.all(tp[:, ~walked] == 0.0)
    nrow = 13 + 3 * n_sh
    assert np.all(tp[nrow:] == 0.0)
    groups = dict(GROUPS, sh=(13, nrow))
    for name, (lo, hi) in groups.items():
        a, b = tp[lo:hi, walked], jp[lo:hi, walked]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6, err_msg=name)
    for name, (lo, hi) in (("origin", (0, 3)), ("direction", (3, 6))):
        a, b = tr[..., lo:hi], jr[..., lo:hi]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6, err_msg=name)
    assert np.all(tr[..., 6:] == 0.0)
    # What the walk covered: every segment with pairs, hits and composited
    # hits; in exact order the sort and hits past the rays' T-stop (in list
    # order the walk stops at each ray's n_contrib).
    assert work["hit_tests"] >= 256 * 400 and work["hits"] >= work["contribs"] > 0
    assert (work["sort_compares"] > 0) == exact == (work["hits"] > work["contribs"])


def _multichunk_scene(seed=17, P=512):
    """tests/test_tracer.py:198-226's multi-chunk case: 512 dense surfels,
    one bundle whose pair list spans several chunks and whose rays saturate."""
    rng = np.random.default_rng(seed)
    o, d, *_ = _trace_scene(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-1.2, 1.2, P), rng.uniform(-1.0, 2.0, P)], 1)
    scales = np.exp(rng.normal(size=(P, 2)) * 0.3 - 1.6)
    rots = rng.normal(size=(P, 4))
    opac = rng.uniform(0.6, 0.95, size=P)
    shs = np.zeros((P, 16, 3))
    shs[:, 0] = rng.uniform(-0.7, 0.7, size=(P, 3))
    shs[:, 1:] = 0.15 * rng.standard_normal((P, 15, 3))
    return [a.astype(np.float32) for a in (o, d, means, scales, rots, opac, shs)]


@pytest.mark.parametrize("case", ["list", "exact", "exact_multichunk"])
def test_trace_gradients_match_jax(case):
    """The autograd Function's gradients (port) against jax.grad of the JAX
    trace (Pallas in interpret mode) for every input the training path
    differentiates, under a cotangent from a numpy seed."""
    exact = case != "list"
    arrays = _multichunk_scene() if case == "exact_multichunk" else list(_trace_scene(3))
    N = arrays[0].shape[0]
    wts = np.random.default_rng(5).normal(size=(N, 8)).astype(np.float32)
    cfg = dict(pair_capacity=1 << 13, cluster_pair_capacity=1 << 10, exact_order=exact)

    def terms(out, w, lib):
        return (lib.sum(out["rgb"] * w[:, 0:3]) + lib.sum(out["depth"] * w[:, 3])
                + lib.sum(out["normal"] * w[:, 4:7]) + lib.sum(out["final_T"] * w[:, 7]))

    def jloss(o, d, means, scales, rots, opac, shs):
        out = japi.trace(o, d, means, scales, rots, opac, shs,
                         japi.TracerConfig(interpret=True, **cfg), sh_degree=3)
        return terms(out, jnp.asarray(wts), jnp)

    jin = [jnp.asarray(a) for a in arrays]
    jg = jax.grad(jloss, argnums=tuple(range(7)))(*jin)
    tin = [_t(a).requires_grad_(True) for a in arrays]
    before = (trace_fwd.trace_bundles_fwd.launches, trace_bwd.trace_bundles_bwd.launches)
    out = tapi.trace(*tin, tapi.TracerConfig(**cfg), sh_degree=3)
    assert out["overflow"] == 0
    if case == "exact_multichunk":
        assert out["pair_slots"] > 3 * 128 and float(out["final_T"].min()) < 1e-3
    tg = torch.autograd.grad(terms(out, _t(wts), torch), tin)
    assert (trace_fwd.trace_bundles_fwd.launches, trace_bwd.trace_bundles_bwd.launches) == before
    names = ["rays_o", "rays_d", "means", "scales", "rotations", "opacities", "shs"]
    for name, a, b in zip(names, tg, jg):
        a, b = a.numpy(), np.asarray(b)
        assert np.all(np.isfinite(a)), name
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * scale + 1e-4, err_msg=name)
        assert np.abs(b).max() > 0, name


def test_trace_backward_masks_pairs_past_the_budget():
    """A budget that truncates the pair list: the dropped pairs get no
    gradient, and no NaN from an unwalked column reaches the table."""
    arrays = list(_trace_scene(3))
    tin = [_t(a).requires_grad_(True) for a in arrays]
    cfg = tapi.TracerConfig(pair_capacity=256, cluster_pair_capacity=1, exact_order=True)
    out = tapi.trace(*tin, cfg, sh_degree=3)
    assert out["overflow"] > 0
    grads = torch.autograd.grad(out["rgb"].sum() + out["final_T"].sum(), tin)
    for g in grads:
        assert torch.isfinite(g).all()
    assert float(grads[2].abs().sum()) > 0


def test_trace_without_grad_builds_no_graph():
    arrays = [_t(a) for a in _trace_scene(3)]
    out = tapi.trace(*arrays, dataclasses.replace(tapi.TracerConfig(), pair_capacity=1 << 13))
    assert out["rgb"].grad_fn is None
