"""PyTorch port vs the JAX package: the bundle tracer's forward kernel (its
plain version against the Pallas kernel in interpret mode), the segment
layout, the whole forward `trace`, the dense reference, the mesh tracer and
the ray <-> bundle layouts.

Tolerance: float channels rtol 1e-4, atol 1e-5; integer outputs (n_contrib,
NPROC, segment layouts, overflow, pair counts, triangle ids) exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.ops import mesh_tracer as jmt  # noqa: E402
from materialrefgs_tpu.ops import segments as jseg  # noqa: E402
from materialrefgs_tpu.ops.tracer import api as japi  # noqa: E402
from materialrefgs_tpu.ops.tracer import pallas_kernels as pk  # noqa: E402
from materialrefgs_tpu.ops.tracer.reference import trace_reference as jax_reference  # noqa: E402
from materialrefgs_tpu.render import envgs as jenvgs  # noqa: E402
from materialrefgs_tpu.utils.transforms import quat_to_rotmat as jax_rotmat  # noqa: E402

from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops import segments as tseg  # noqa: E402
from materialrefgs_torch.ops.tracer import api as tapi  # noqa: E402
from materialrefgs_torch.ops.tracer import layout  # noqa: E402
from materialrefgs_torch.ops.tracer.reference import trace_reference as torch_reference  # noqa: E402
from materialrefgs_torch.ops.tracer.trace_fwd import trace_bundles_fwd, trace_bundles_fwd_plain  # noqa: E402
from materialrefgs_torch.render import envgs as tenvgs  # noqa: E402
from materialrefgs_torch.train.mesh_extract import extract_mesh  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
INT_CHANNELS = (layout.OUT_NCONTRIB, layout.OUT_NPROC)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _splats(rng, P, n_sh, spread=1.0, opac=(0.3, 0.9)):
    """Random surfels in front of rays that start near z = -3 and look down +z."""
    means = np.stack([rng.uniform(-spread, spread, P), rng.uniform(-spread, spread, P),
                      rng.uniform(-1.0, 2.0, P)], 1).astype(np.float32)
    scales = np.exp(rng.normal(size=(P, 2)) * 0.3 - 1.6).astype(np.float32)
    rots = rng.normal(size=(P, 4)).astype(np.float32)
    opa = rng.uniform(*opac, size=P).astype(np.float32)
    shs = np.zeros((P, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.0, 1.0, size=(P, 3))
    shs[:, 1:n_sh] = 0.3 * rng.standard_normal((P, n_sh - 1, 3))
    return means, scales, rots, opa, shs


def _payload_columns(means, scales, rots, opa, shs, n_sh):
    """(pay_rows, P) payload columns, as api.trace lays them out."""
    R = np.asarray(jax_rotmat(jnp.asarray(rots)))
    sh_flat = shs[:, :n_sh, :].transpose(0, 2, 1).reshape(len(means), 3 * n_sh)
    g = np.concatenate([means, R[:, :, 0] / scales[:, :1], R[:, :, 1] / scales[:, 1:2], R[:, :, 2],
                        opa[:, None], sh_flat], 1)
    out = np.zeros((layout.pay_rows(n_sh), len(means)), np.float32)
    out[: g.shape[1]] = g.T
    return out


def _rays(rng, NB, spread=0.4):
    o = np.zeros((NB, 256, 8), np.float32)
    o[..., 0:2] = rng.uniform(-spread, spread, size=(NB, 256, 2))
    o[..., 2] = -3.0
    o[..., 3:5] = rng.uniform(-0.1, 0.1, size=(NB, 256, 2))
    o[..., 5] = 1.0
    return o


def _kernel_case(n_sh, seed=0):
    """Four bundles: a 300-pair segment (3 chunks), an empty segment, a
    segment whose opaque pairs stop every ray in its first chunk (the
    bundle exits early) and a 90-pair segment; segments start at multiples
    of 128 and the payload has 128 spare columns."""
    rng = np.random.default_rng(seed)
    counts = [300, 0, 384, 90]
    parts = [_splats(rng, 300, n_sh), None,
             _splats(rng, 384, n_sh, spread=0.6, opac=(0.9, 0.99)), _splats(rng, 90, n_sh)]
    starts, cols, at = [], [], 0
    for c, s in zip(counts, parts):
        starts.append(at)
        pad = -(-c // 128) * 128
        block = np.zeros((layout.pay_rows(n_sh), pad), np.float32)
        if c:
            block[:, :c] = _payload_columns(*s, n_sh)[:, np.argsort(s[0][:, 2], kind="stable")]
        cols.append(block)
        at += pad
    starts.append(at)
    payload = np.concatenate(cols + [np.zeros((layout.pay_rows(n_sh), 128), np.float32)], 1)
    rays = _rays(rng, 4)
    rays[2, :, 0:2] *= 0.3  # the early-exit bundle looks into its dense core
    return payload, rays, np.array(starts, np.int32), np.array(counts, np.int32)


@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_fwd_plain_matches_pallas(n_sh, exact):
    payload, rays, start, count = _kernel_case(n_sh)
    ref = np.asarray(pk.trace_bundles_fwd(
        jnp.asarray(payload), jnp.asarray(rays), jnp.asarray(start), jnp.asarray(count),
        n_sh=n_sh, tmin=1e-3, interpret=True, exact_order=exact,
    ))
    args = (_t(payload), _t(rays), _t(start), _t(count))
    out = trace_bundles_fwd_plain(*args, n_sh=n_sh, exact_order=exact).numpy()
    # The wrapper takes the plain version for CPU tensors and counts no launch.
    before = trace_bundles_fwd.launches
    np.testing.assert_array_equal(trace_bundles_fwd(*args, n_sh=n_sh, exact_order=exact).numpy(), out)
    assert trace_bundles_fwd.launches == before

    # The case covers what it claims: 3 chunks processed by bundle 0, none by
    # the empty bundle, an early exit, rays that hit and rays that stopped.
    nproc = ref[:, 0, layout.OUT_NPROC]
    assert nproc[0] == 3 and nproc[1] == 0 and nproc[2] < 3, nproc
    assert (ref[..., layout.OUT_NCONTRIB] > 0).mean() > 0.5
    assert (ref[2, :, layout.OUT_SUMLG] < layout.LOG_T_STOP).all()  # every ray stopped
    for c in INT_CHANNELS:
        np.testing.assert_array_equal(out[..., c], ref[..., c], err_msg=f"channel {c}")
    for c in range(layout.C_OUT):
        if c not in INT_CHANNELS:
            np.testing.assert_allclose(out[..., c], ref[..., c], rtol=RTOL, atol=ATOL, err_msg=f"channel {c}")


@pytest.mark.parametrize("capacity", [1 << 13, 1 << 11, 1 << 8], ids=["roomy", "truncating", "legacy"])
def test_build_aligned_segments_matches_jax(capacity):
    rng = np.random.default_rng(5)
    N, S = 6000, 7
    seg_id = rng.integers(0, S, N).astype(np.int32)
    seg_id[seg_id == 3] = 2  # an empty segment
    key = np.round(rng.uniform(0, 4, N), 2).astype(np.float32)  # ties keep input order
    valid = rng.uniform(size=N) < 0.8
    ref = jseg.build_aligned_segments(jnp.asarray(seg_id), jnp.asarray(key), jnp.asarray(valid), S, capacity)
    out = tseg.build_aligned_segments(_t(seg_id), _t(key), _t(valid), S, capacity)
    for name in ("perm_pos", "seg_start", "seg_count", "num_kept", "overflow"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    if capacity < (1 << 13):
        assert int(out.overflow) > 0
    vals = rng.normal(size=(N, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.scatter_pairs(_t(vals), out.perm_pos, capacity).numpy(),
        np.asarray(jseg.scatter_pairs(jnp.asarray(vals), ref.perm_pos, capacity)),
    )


def _trace_scene(seed=0, P=64):
    """The scene of tests/test_tracer.py: 64 surfels with per-ray SH color
    (degree 3), two coherent bundles."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, size=(P, 3)).astype(np.float32)
    scales = np.exp(rng.normal(size=(P, 2)).astype(np.float32) * 0.3 - 2.2)
    rots = rng.normal(size=(P, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, size=(P,)).astype(np.float32)
    shs = np.zeros((P, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-0.7, 0.7, size=(P, 3))
    shs[:, 1:] = 0.15 * rng.standard_normal((P, 15, 3))
    N = 512
    o = np.zeros((N, 3), np.float32)
    o[:, :2] = rng.uniform(-0.3, 0.3, (N, 2))
    o[:, 2] = -6.0
    d = np.zeros((N, 3), np.float32)
    d[:, :2] = rng.uniform(-0.05, 0.05, (N, 2))
    d[:, 2] = 1.0
    d[256:, 0] += 0.15
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, means, scales, rots, opac, shs


def _pad_dead(means, scales, rots, opac, shs, cap=8192):
    """Capacity padding as a fixed-capacity model has it: dead slots at the
    origin (tests/test_tracer.py:242)."""
    pad = cap - len(means)
    return (np.concatenate([means, np.zeros((pad, 3), np.float32)]),
            np.concatenate([scales, np.full((pad, 2), 1e-3, np.float32)]),
            np.concatenate([rots, np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (pad, 1))]),
            np.concatenate([opac, np.zeros(pad, np.float32)]),
            np.concatenate([shs, np.zeros((pad, 16, 3), np.float32)]))


@pytest.mark.parametrize("case", ["list", "exact", "bundle_mask", "dead_capacity", "tight_capacity"])
def test_trace_matches_jax(case):
    o, d, *scene = _trace_scene()
    cfg = dict(pair_capacity=1 << 13, cluster_pair_capacity=1 << 10, exact_order=case != "list")
    mask = None
    if case == "bundle_mask":
        mask = np.array([False, True])
    elif case == "dead_capacity":
        # A cluster budget that fits the alive clusters but not the 31 dead
        # ones: they must not pass stage 1.
        scene = list(_pad_dead(*scene))
        cfg["cluster_pair_capacity"] = 8
    elif case == "tight_capacity":
        # Too few pair slots and cluster pairs: proportional truncation and
        # the CLUSTER-scaled stage-1 overflow.
        cfg.update(pair_capacity=512, cluster_pair_capacity=1)
    ref = japi.trace(jnp.asarray(o), jnp.asarray(d), *map(jnp.asarray, scene),
                     japi.TracerConfig(interpret=True, **cfg),
                     bundle_mask=None if mask is None else jnp.asarray(mask))
    out = tapi.trace(_t(o), _t(d), *map(_t, scene), tapi.TracerConfig(**cfg),
                     bundle_mask=None if mask is None else _t(mask))
    assert out["pairs"] == int(ref["pairs"]) > 0
    assert out["overflow"] == int(ref["overflow"])
    assert (out["overflow"] > 0) == (case == "tight_capacity")
    for k in ("rgb", "depth", "normal", "acc", "final_T"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(out["acc"].max()) > 0.5
    if mask is not None:
        assert torch.all(out["final_T"][:256] == 1.0) and torch.all(out["rgb"][:256] == 0.0)


def test_trace_reports_budgets_that_fit():
    """`cluster_pairs` and `pair_slots` are the least budgets that keep every
    pair: traced with them the outputs equal a roomy trace's, and one cluster
    pair or one 128-pair chunk fewer truncates."""
    o, d, *scene = _trace_scene()
    args = (_t(o), _t(d), *map(_t, scene))
    roomy = tapi.trace(*args, tapi.TracerConfig(pair_capacity=1 << 13, cluster_pair_capacity=1 << 10))
    tight = tapi.trace(*args, tapi.TracerConfig(pair_capacity=512, cluster_pair_capacity=1))
    assert roomy["overflow"] == 0 and tight["overflow"] > 0
    assert tight["cluster_pairs"] == roomy["cluster_pairs"] > 1
    assert tight["pair_slots"] < roomy["pair_slots"]
    cfg = tapi.TracerConfig(pair_capacity=roomy["pair_slots"], cluster_pair_capacity=roomy["cluster_pairs"])
    fit = tapi.trace(*args, cfg)
    assert fit["overflow"] == 0 and fit["pairs"] == roomy["pairs"]
    for k in ("rgb", "depth", "normal", "final_T"):
        assert torch.equal(fit[k], roomy[k]), k
    less = (dataclasses.replace(cfg, cluster_pair_capacity=cfg.cluster_pair_capacity - 1),
            dataclasses.replace(cfg, pair_capacity=cfg.pair_capacity - 128))
    assert all(tapi.trace(*args, c)["overflow"] > 0 for c in less)


def test_trace_demand_and_reference_match_jax():
    o, d, means, scales, rots, opac, shs = _trace_scene(seed=3)
    cfg = dict(pair_capacity=1 << 13, cluster_pair_capacity=1 << 10)
    demand = japi.trace_demand(jnp.asarray(o), jnp.asarray(d), jnp.asarray(means), jnp.asarray(scales),
                               jnp.asarray(opac), japi.TracerConfig(**cfg))
    assert tapi.trace_demand(_t(o), _t(d), _t(means), _t(scales), _t(opac), tapi.TracerConfig(**cfg)) == int(demand)
    args = [o, d, means, scales, rots, opac]
    ref = jax_reference(*map(jnp.asarray, args), None, shs=jnp.asarray(shs), sh_degree=3)
    out = torch_reference(*map(_t, args), None, shs=_t(shs), sh_degree=3)
    for k in ("rgb", "acc", "depth", "normal", "final_T"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def test_trace_refuses_autograd():
    """What the serving slice refused now runs (the surfel2 training slice):
    trace under autograd gives finite gradients (their parity with the JAX
    package is tests/test_torch_tracer_bwd.py's), the demand the trainer's
    probe counts is the trace's pair count, and mesh extraction of views that
    observed nothing returns an empty mesh."""
    o, d, means, scales, rots, opac, shs = _trace_scene()
    m = _t(means).requires_grad_(True)
    out = tapi.trace(_t(o), _t(d), m, _t(scales), _t(rots), _t(opac), _t(shs))
    (g,) = torch.autograd.grad(out["rgb"].sum(), m)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    assert tapi.trace_demand(_t(o), _t(d), _t(means), _t(scales), _t(opac)) == out["pairs"] > 0
    assert callable(tenvgs.tracer_demand_probe)
    from materialrefgs_torch.cameras import look_at_camera

    cam = look_at_camera(np.array([0.0, 0.0, -3.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.8, 0.8, 16, 16,
                         device="cpu")
    verts, faces = extract_mesh([cam], [np.zeros((16, 16), np.float32)], [np.zeros((16, 16), np.float32)],
                                resolution=8)
    assert len(faces) == 0
    with torch.no_grad():
        assert tapi.trace(_t(o), _t(d), m, _t(scales), _t(rots), _t(opac), _t(shs))["pairs"] > 0


def _icosphere(sub=2, radius=1.0):
    """Icosphere (vertices, triangles), as tests/test_mesh_tracer.py builds it."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
        [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1])]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
             [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
             [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(sub):
        mid, new = {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                verts.append((verts[a] + verts[b]) / 2.0)
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new
    v = np.array(verts)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) * radius
    return v.astype(np.float32), np.array(faces, np.int32)


@pytest.mark.parametrize("case", ["culled", "unculled", "dropping", "block_mask"])
def test_mesh_trace_matches_jax(case):
    verts, faces = _icosphere(sub=3)
    rng = np.random.default_rng(1)
    # Rays from inside the sphere outward (all hit) and from outside across
    # it (some miss), 4 blocks of 256.
    o = np.concatenate([rng.normal(size=(512, 3)) * 0.2, rng.normal(size=(512, 3)) * 0.3 + [0, 0, -3]])
    d = np.concatenate([rng.normal(size=(512, 3)), rng.normal(size=(512, 3)) * 0.2 + [0, 0, 1]])
    o, d = o.astype(np.float32), d.astype(np.float32)
    kw = {"culled": {}, "unculled": dict(use_cull=False), "dropping": dict(cull_cap=8),
          "block_mask": dict(block_mask=np.array([True, False, False, True]))}[case]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = jmt.trace(jmt.build_mesh(verts, faces), jnp.asarray(o), jnp.asarray(d), **jkw)
    out = tmt.trace(tmt.build_mesh(verts, faces, device="cpu"), _t(o), _t(d), **tkw)
    assert out["cull_dropped"] == int(ref["cull_dropped"])
    assert (out["cull_dropped"] > 0) == (case == "dropping")
    np.testing.assert_array_equal(out["tri"].numpy(), np.asarray(ref["tri"]))
    # XLA's CPU code fuses some multiply-adds of Moller-Trumbore, so t and
    # the barycentrics differ from the port's by a float32 ulp or so.
    for k in ("depth", "bary", "pos", "normal"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    hit = out["tri"].numpy() >= 0
    assert 0.3 < hit.mean() < 1.0
    if case == "block_mask":
        assert not hit.reshape(4, 256)[1:3].any()


def test_rays_to_bundles_matches_jax():
    H, W = 37, 21  # not multiples of 16: edge pads replicate the border
    x = np.random.default_rng(2).normal(size=(H, W, 3)).astype(np.float32)
    b = tenvgs.rays_to_bundles(_t(x), H, W)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jenvgs.rays_to_bundles(jnp.asarray(x), H, W)))
    np.testing.assert_array_equal(tenvgs.bundles_to_image(b, H, W).numpy(), x)
    alpha = np.zeros((H, W, 1), np.float32)
    alpha[20, 3] = 0.5
    np.testing.assert_array_equal(
        tenvgs.bundle_alpha_mask(_t(alpha), H, W).numpy(),
        np.asarray(jenvgs.bundle_alpha_mask(jnp.asarray(alpha), H, W)),
    )
