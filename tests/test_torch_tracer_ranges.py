"""PyTorch port vs the JAX package: the bundle tracer's range split. The
plain forward and backward walk each bundle's chunks in ranges of R chunks
(ops/tracer/ranges.py), as the CUDA kernels do; at every R they must agree
with the Pallas kernels in interpret mode, on bundles of 1 to 9 chunks, an
empty bundle and bundles that stop mid-walk, for n_sh 1 and 16 in list and
exact order.

Tolerances (those of tests/test_torch_tracer.py and test_torch_tracer_bwd.py):
forward float channels rtol 1e-4, atol 1e-5, n_contrib and NPROC exact;
backward values within 1e-4 x the largest magnitude of their group + 1e-6."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.ops.tracer import pallas_kernels as pk  # noqa: E402

from materialrefgs_torch.ops.tracer import layout, ranges  # noqa: E402
from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd  # noqa: E402
from test_torch_tracer import _payload_columns, _rays, _splats  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
INT_CHANNELS = (layout.OUT_NCONTRIB, layout.OUT_NPROC)
# Pairs per bundle: 9, 0 (empty), 2, 1, 5 (opaque: stops mid-walk), 8 (opaque
# behind a sparse front: stops mid-walk), 3 chunks.
COUNTS = (1100, 0, 130, 1, 600, 980, 380)
OPAQUE = (4, 5)
R_VALUES = (1, 2, 3, 9)


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def _case(n_sh):
    """Segments of COUNTS pairs (depth-sorted, 128-aligned starts) and one
    ray bundle each."""
    rng = np.random.default_rng(11 + n_sh)
    starts, cols, at = [], [], 0
    for b, c in enumerate(COUNTS):
        starts.append(at)
        pad = -(-c // 128) * 128
        block = np.zeros((layout.pay_rows(n_sh), pad), np.float32)
        if c:
            if b in OPAQUE:
                s = _splats(rng, c, n_sh, spread=0.5, opac=(0.9, 0.99))
                if b == 5:  # a sparse front of faint splats before the opaque ones
                    s[3][:300] = rng.uniform(0.05, 0.2, 300).astype(np.float32)
                    s[0][:300, 2] = rng.uniform(-1.5, -1.0, 300).astype(np.float32)
            else:  # bundle 0 faint, so that its rays walk all 9 chunks
                s = _splats(rng, c, n_sh, opac=(0.02, 0.08) if b == 0 else (0.3, 0.9))
            block[:, :c] = _payload_columns(*s, n_sh)[:, np.argsort(s[0][:, 2], kind="stable")]
        cols.append(block)
        at += pad
    starts.append(at)
    payload = np.concatenate(cols + [np.zeros((layout.pay_rows(n_sh), 128), np.float32)], 1)
    rays = _rays(rng, len(COUNTS))
    rays[list(OPAQUE), :, 0:2] *= 0.3  # the opaque bundles look into their dense cores
    return payload, rays, np.array(starts, np.int32), np.array(COUNTS, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fwd(n_sh, exact):
    payload, rays, start, count = _case(n_sh)
    return np.asarray(pk.trace_bundles_fwd(
        jnp.asarray(payload), jnp.asarray(rays), jnp.asarray(start), jnp.asarray(count),
        n_sh=n_sh, tmin=1e-3, interpret=True, exact_order=exact))


@functools.lru_cache(maxsize=None)
def _bwd_inputs(n_sh, exact):
    """The walk bound as the autograd Functions compute it, a cotangent from
    a numpy seed, and the JAX backward's (dpayload, drays)."""
    payload, rays, start, count = _case(n_sh)
    fwd = _jax_fwd(n_sh, exact)
    if exact:
        active = fwd[..., layout.OUT_NPROC].max(1).astype(np.int32) * layout.K_CHUNK
    else:
        active = fwd[..., layout.OUT_NCONTRIB].max(1).astype(np.int32)
    cot = np.zeros(fwd.shape, np.float32)
    cot[..., :8] = np.random.default_rng(3 * n_sh + exact).normal(size=fwd.shape[:2] + (8,))
    args = (payload, rays, start, count, active, fwd, cot)
    jp, jr = pk.trace_bundles_bwd(*(jnp.asarray(a) for a in args), n_sh=n_sh, tmin=1e-3, interpret=True,
                                  exact_order=exact)
    return args, np.asarray(jp), np.asarray(jr)


def test_case_covers_the_walks():
    """The inputs hold what the tests below claim: walks of 1 to 9 chunks,
    an empty bundle, and bundles that stop before their segment's end."""
    for n_sh in (1, 16):
        for exact in (False, True):
            nproc = _jax_fwd(n_sh, exact)[:, 0, layout.OUT_NPROC]
            n_chunks = -(-np.array(COUNTS) // 128)
            assert nproc[1] == 0 and n_chunks.max() == 9 and nproc.max() >= 3
            assert all(nproc[b] < n_chunks[b] for b in OPAQUE), nproc
            assert (nproc[[0, 2, 3, 6]] == n_chunks[[0, 2, 3, 6]]).all(), nproc


@pytest.mark.parametrize("R", R_VALUES)
@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_fwd_ranges_match_pallas(n_sh, exact, R):
    payload, rays, start, count = _case(n_sh)
    ref = _jax_fwd(n_sh, exact)
    out = trace_fwd.trace_bundles_fwd_plain(_t(payload), _t(rays), _t(start), _t(count), n_sh=n_sh,
                                            exact_order=exact, range_chunks=R).numpy()
    for c in INT_CHANNELS:
        np.testing.assert_array_equal(out[..., c], ref[..., c], err_msg=f"channel {c}")
    for c in range(layout.C_OUT):
        if c not in INT_CHANNELS:
            np.testing.assert_allclose(out[..., c], ref[..., c], rtol=RTOL, atol=ATOL, err_msg=f"channel {c}")


@pytest.mark.parametrize("R", R_VALUES)
@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_bwd_ranges_match_pallas(n_sh, exact, R):
    args, jp, jr = _bwd_inputs(n_sh, exact)
    tp, tr = trace_bwd.trace_bundles_bwd_plain(*(_t(a) for a in args), n_sh=n_sh, exact_order=exact,
                                               range_chunks=R)
    tp, tr = tp.numpy(), tr.numpy()
    payload, _, start, count = args[:4]
    walked = np.zeros(payload.shape[1], bool)
    for s, c in zip(start[:-1], count):
        walked[s : s + -(-c // 128) * 128] = True
    assert np.all(tp[:, ~walked] == 0.0)
    nrow = 13 + 3 * n_sh
    assert np.all(tp[nrow:] == 0.0) and np.all(tr[..., 6:] == 0.0)
    groups = {"center": (0, 3), "tu": (3, 6), "tv": (6, 9), "normal": (9, 12), "opacity": (12, 13),
              "sh": (13, nrow)}
    for name, (lo, hi) in groups.items():
        a, b = tp[lo:hi, walked], jp[lo:hi, walked]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6, err_msg=name)
    for name, (lo, hi) in (("origin", (0, 3)), ("direction", (3, 6))):
        a, b = tr[..., lo:hi], jr[..., lo:hi]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-6, err_msg=name)


@pytest.mark.parametrize("exact", [False, True], ids=["list", "exact"])
@pytest.mark.parametrize("n_sh", [1, 16])
def test_trace_bwd_same_with_and_without_the_residual(n_sh, exact):
    """The forward's residual (each processed chunk's end log T and hit
    masks) and the backward's own recomputation of it give the same
    gradients, bit for bit, through the plain version and through the
    wrapper on CPU tensors; the residual's masks are the hit test's."""
    args, _, _ = _bwd_inputs(n_sh, exact)
    targs = [_t(a) for a in args]
    payload, rays, start, count = targs[:4]
    residual = trace_fwd.new_residual(payload).fill_(-1)
    out = trace_fwd.trace_bundles_fwd(payload, rays, start, count, n_sh=n_sh, exact_order=exact,
                                      range_chunks=3, residual=residual)
    nproc = out[:, 0, layout.OUT_NPROC].long()
    for b in range(len(COUNTS)):  # every processed chunk's rows are written
        g0 = int(start[b]) // layout.K_CHUNK
        n = int(nproc[b])
        if n:
            assert torch.equal(residual[g0 + n - 1, 0].view(torch.float32), out[b, :, layout.OUT_SUMLG])
        for c in range(n):
            lanes = torch.arange(128)
            bits = (residual[g0 + c, 1:].long() & 0xFFFFFFFF)  # (4, 256)
            mask = ((bits[lanes // 32] >> (lanes % 32)[:, None]) & 1).bool().T  # (256, 128)
            cols = payload[:, (g0 + c) * 128 : (g0 + c + 1) * 128][:, None, None, :]
            o = tuple(rays[b, :, i : i + 1][None] for i in range(3))
            d = tuple(rays[b, :, 3 + i : 4 + i][None] for i in range(3))
            hit = trace_fwd._geometry(cols, o, d, 1e-3)[0][0] & (c * 128 + lanes < count[b])
            assert torch.equal(mask, hit), (b, c)
    for fn in (trace_bwd.trace_bundles_bwd_plain, trace_bwd.trace_bundles_bwd):
        kw = dict(n_sh=n_sh, exact_order=exact, range_chunks=3)
        with_res = fn(*targs, **kw, residual=residual)
        without = fn(*targs, **kw)
        for a, b in zip(with_res, without):
            assert torch.equal(a, b)


@pytest.mark.parametrize("R", [1, 2, 3, 8, 64])
def test_chunk_ranges_cover_every_chunk_once(R):
    """Each bundle's chunks 0..n-1 fall in its own ranges, exactly once, each
    range at most R chunks and a bundle of at most R chunks one range; the
    bound on the list's length holds for the columns the segments use."""
    rng = np.random.default_rng(R)
    count = rng.integers(0, 128 * 40, 300)
    count[rng.uniform(size=300) < 0.2] = 0
    count[:3] = (1, 128, 129)
    padded = -(-count // 128) * 128
    cols = int(padded.sum()) + 128
    n_max = ranges.max_ranges(cols, len(count), R)
    rl = ranges.chunk_ranges(torch.tensor(count, dtype=torch.int32), R, n_max)
    bundle, chunk0, off = rl.bundle.numpy(), rl.chunk0.numpy(), rl.range_off.numpy()
    n_real = int(off[-1])
    assert n_real <= n_max and (bundle[n_real:] == len(count)).all()
    n_chunks = padded // 128
    seen = np.zeros(int(n_chunks.sum()), int)
    first = np.concatenate([[0], np.cumsum(n_chunks)])
    for i in range(n_real):
        b, c0 = int(bundle[i]), int(chunk0[i])
        assert off[b] <= i < off[b + 1]
        assert 0 <= c0 < n_chunks[b] and c0 % R == 0
        seen[first[b] + c0 : first[b] + min(c0 + R, n_chunks[b])] += 1
    assert (seen == 1).all()
    assert ((off[1:] - off[:-1]) == -(-n_chunks // R)).all()
    assert ((off[1:] - off[:-1])[(n_chunks > 0) & (n_chunks <= R)] == 1).all()
