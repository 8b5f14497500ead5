"""Bundle tracer forward: the CUDA kernel's wrapper and its plain version.

`trace_bundles_fwd` replaces materialrefgs_tpu/ops/tracer/pallas_kernels.py:
trace_bundles_fwd. On a CUDA tensor it launches the hand-written kernels in
`csrc/trace_fwd.cu` (built with nvcc for sm_90a at first use) or raises; on a
CPU tensor it runs `trace_bundles_fwd_plain`, the same computation in plain
torch. The kernels' design and their bound are described in the source.

Inputs (the JAX kernel's): payload (pay_rows(n_sh), cols) float32, one
column per (bundle, gaussian) pair in layout.ROW_* rows; rays (NB, 256, 8)
float32 [origin(3), direction(3), pad(2)]; seg_start (NB+1,) int32 offsets,
multiples of 128; seg_count (NB,) int32. Output: (NB, 256, 16) float32 in
the OUT_* layout, padding channels zero.

Per (ray, pair): the ray-plane hit t = <p - o, n> / <d, n> (|<d, n>| > 1e-9,
t >= tmin), splat coordinates u = <q, tu/su>, v = <q, tv/sv> with q the hit
minus p, rho = u^2 + v^2 <= 9, alpha = min(0.99, opacity exp(-rho/2)) >=
1/255, color max(Y(d/|d|) . sh + 0.5, 0) at the ray's own direction, normal
flipped against the ray. Each bundle composites its pair list in 128-pair
chunks: in list order, or (exact_order) in each ray's own hit-t order within
every chunk, ties by list position. Transmittance is carried as a sum of
log1p(-alpha); a pair counts while log T after it stays >= log(1e-4). Each
chunk starts from logT[c] = logT[c-1] + tot[c-1], tot the chunk's sum of
log1p(-alpha) over its hits in lane order. The bundle stops at its segment's
end or before the first chunk where every ray has logT < log(1e-4). SUMLG is
logT after the last processed chunk, NPROC the number of processed chunks.

The walk is cut into ranges of at most `range_chunks` chunks
(ops/tracer/ranges.py): rgb, depth and normal are summed per range from 0
and the ranges' sums added in range order. `residual`, if given, a
(cols // 128, 5, 256) int32 tensor, receives for every processed chunk (row
seg_start // 128 + chunk) logT at its end (row 0, float32 bits) and each
ray's 128-bit mask of the lanes that pass the hit test (rows 1-4, lane j in
word j // 32, bit j % 32), which the backward takes in place of
recomputing them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from materialrefgs_torch.ops import nvcc
from materialrefgs_torch.ops.tracer.layout import (
    ALPHA_MAX,
    ALPHA_MIN,
    C_OUT,
    K_CHUNK,
    LOG_T_STOP,
    NRAY,
    OUT_DEPTH,
    OUT_FINAL_T,
    OUT_NCONTRIB,
    OUT_NORMAL,
    OUT_NPROC,
    OUT_RGB,
    OUT_SUMLG,
    RHO_CUTOFF,
    ROW_N,
    ROW_OPA,
    ROW_P,
    ROW_SH,
    ROW_TU,
    ROW_TV,
    pay_rows,
)
from materialrefgs_torch.ops.tracer.ranges import RANGE_CHUNKS, chunk_ranges, max_ranges
from materialrefgs_torch.utils.sh import sh_basis

SOURCE = nvcc.CSRC / "trace_fwd.cu"
N_SH = (1, 4, 9, 16)  # SH basis sizes the kernel is instantiated for
BUNDLE_BLOCK = 4096  # bundles per step of the plain version (bounds its memory)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    fn = lib.trace_bundles_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        p, ctypes.c_longlong,  # payload, its row stride (columns)
        p, p, p,  # rays, seg_start, seg_count
        p, p, p, i,  # range_bundle, range_chunk0, range_off, n_ranges
        p, p, p, p,  # clogT, nproc, part, out
        i, i, i, ctypes.c_float, i, i,  # NB, n_sh, R, tmin, exact_order, full
        p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


NRES = 5  # residual rows per chunk: end log T (float32 bits), 4 hit-mask words


def _launch(payload, rays, seg_start, seg_count, n_sh, tmin, exact_order, R, res, out, full):
    """Launches (a)-(d) of csrc/trace_fwd.cu ((a)-(b) when not `full`) on
    contiguous CUDA inputs; res (cols // 128, 5, 256) and out are written."""
    NB = rays.shape[0]
    n_max = max_ranges(payload.shape[1], NB, R)
    rl = chunk_ranges(seg_count, R, n_max)
    dev = payload.device
    nproc = torch.empty(NB, dtype=torch.int32, device=dev)
    part = torch.empty((n_max if full else 0, 9, NRAY), dtype=torch.float32, device=dev)
    err = _library().trace_bundles_fwd(
        payload.data_ptr(), payload.shape[1], rays.data_ptr(), seg_start.data_ptr(), seg_count.data_ptr(),
        rl.bundle.data_ptr(), rl.chunk0.data_ptr(), rl.range_off.data_ptr(), n_max,
        res.data_ptr(), nproc.data_ptr(), part.data_ptr(), out.data_ptr(),
        NB, n_sh, R, float(tmin), int(bool(exact_order)), int(full),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"trace_bundles_fwd kernel launch failed with CUDA error {err}")


def _check_inputs(payload, rays, seg_start, seg_count, n_sh):
    if n_sh not in N_SH:
        raise ValueError(f"n_sh must be one of {N_SH}, got {n_sh}")
    if payload.dtype != torch.float32 or payload.dim() != 2 or payload.shape[0] != pay_rows(n_sh):
        raise ValueError(
            f"payload must be ({pay_rows(n_sh)}, cols) float32, got {payload.dtype} {tuple(payload.shape)}"
        )
    if rays.dtype != torch.float32 or rays.dim() != 3 or rays.shape[1:] != (NRAY, 8):
        raise ValueError(f"rays must be (NB, {NRAY}, 8) float32, got {rays.dtype} {tuple(rays.shape)}")
    NB = rays.shape[0]
    if seg_start.dtype != torch.int32 or seg_count.dtype != torch.int32:
        raise ValueError("seg_start and seg_count must be int32")
    if seg_start.shape != (NB + 1,) or seg_count.shape != (NB,):
        raise ValueError(
            f"seg_start/seg_count shapes {tuple(seg_start.shape)}/{tuple(seg_count.shape)} "
            f"do not match {NB} bundles"
        )
    if not (payload.device == rays.device == seg_start.device == seg_count.device):
        raise ValueError("payload, rays, seg_start and seg_count must be on one device")


def new_residual(payload: torch.Tensor) -> torch.Tensor:
    """An (uninitialized) residual buffer for this payload."""
    return torch.empty((payload.shape[1] // K_CHUNK, NRES, NRAY), dtype=torch.int32, device=payload.device)


def _check_residual(payload, residual):
    shape = (payload.shape[1] // K_CHUNK, NRES, NRAY)
    if residual is not None and (
        residual.dtype != torch.int32 or residual.shape != shape
        or residual.device != payload.device or not residual.is_contiguous()
    ):
        raise ValueError(f"residual must be a contiguous {shape} int32 tensor on the payload's device, "
                         f"got {residual.dtype} {tuple(residual.shape)}")


def _check_cuda(payload, seg_start, seg_count, tmin):
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    if not tmin > 0.0:
        # The kernel's exact-order sort keys hit distances by their bits,
        # which orders them like floats only for t > 0.
        raise ValueError(f"the CUDA kernel needs tmin > 0, got {tmin}")
    if seg_count.shape[0]:
        # Every chunk the kernel stages must lie inside the payload's columns.
        ends = seg_start[:-1].long() + (seg_count.long() + K_CHUNK - 1) // K_CHUNK * K_CHUNK
        if int(ends.max()) > payload.shape[1] or int(seg_count.min()) < 0:
            raise ValueError("segments reach past the payload's columns")


def trace_bundles_fwd(
    payload: torch.Tensor,
    rays: torch.Tensor,
    seg_start: torch.Tensor,
    seg_count: torch.Tensor,
    *,
    n_sh: int,
    tmin: float = 1e-3,
    exact_order: bool = False,
    range_chunks: int = RANGE_CHUNKS,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-ray forward outputs (NB, 256, 16). Launches the CUDA kernels for
    CUDA tensors and counts the call in `trace_bundles_fwd.launches`; runs
    the plain version for CPU tensors."""
    _check_inputs(payload, rays, seg_start, seg_count, n_sh)
    _check_residual(payload, residual)
    if payload.device.type == "cpu":
        return trace_bundles_fwd_plain(payload, rays, seg_start, seg_count, n_sh=n_sh, tmin=tmin,
                                       exact_order=exact_order, range_chunks=range_chunks, residual=residual)
    _check_cuda(payload, seg_start, seg_count, tmin)
    payload, rays, seg_start, seg_count = (x.contiguous() for x in (payload, rays, seg_start, seg_count))
    NB = rays.shape[0]
    out = torch.empty((NB, NRAY, C_OUT), dtype=torch.float32, device=payload.device)
    res = residual if residual is not None else new_residual(payload)
    _launch(payload, rays, seg_start, seg_count, n_sh, tmin, exact_order, range_chunks, res, out, True)
    trace_bundles_fwd.launches += 1
    return out


trace_bundles_fwd.launches = 0


def chunk_residual(payload, rays, seg_start, seg_count, *, n_sh, tmin=1e-3, range_chunks=RANGE_CHUNKS):
    """The forward's `residual` alone: on a CUDA tensor launches (a) and
    (b) only (the backward's recomputation; counted in no launch count), on
    a CPU tensor the plain version's (rows of unprocessed chunks zero)."""
    _check_inputs(payload, rays, seg_start, seg_count, n_sh)
    if payload.device.type == "cpu":
        res = torch.zeros((payload.shape[1] // K_CHUNK, NRES, NRAY), dtype=torch.int32)
        trace_bundles_fwd_plain(payload, rays, seg_start, seg_count, n_sh=n_sh, tmin=tmin,
                                range_chunks=range_chunks, residual=res)
        return res
    _check_cuda(payload, seg_start, seg_count, tmin)
    payload, rays, seg_start, seg_count = (x.contiguous() for x in (payload, rays, seg_start, seg_count))
    res = new_residual(payload)
    out = torch.empty((rays.shape[0], NRAY, C_OUT), dtype=torch.float32, device=payload.device)
    _launch(payload, rays, seg_start, seg_count, n_sh, tmin, False, range_chunks, res, out, False)
    return res


def trace_bundles_fwd_plain(
    payload: torch.Tensor,
    rays: torch.Tensor,
    seg_start: torch.Tensor,
    seg_count: torch.Tensor,
    *,
    n_sh: int,
    tmin: float = 1e-3,
    exact_order: bool = False,
    range_chunks: int = RANGE_CHUNKS,
    residual: torch.Tensor | None = None,
    work: dict | None = None,
) -> torch.Tensor:
    """The kernels' computation in plain torch on any device: vectorized over
    bundles, rays and a chunk's 128 lanes, one step per chunk, and inside a
    chunk one step per lane (the chunk total) and per composite position,
    with the kernels' arithmetic in their order: each chunk from the carry's
    logT, the sums per range of `range_chunks` chunks, the ranges added in
    order. Bundles are taken BUNDLE_BLOCK at a time to bound memory. `work`,
    if given, receives the counts the kernel's bound is made of:
    `hit_tests` (ray, pair) evaluated in processed chunks, `hits` (those
    passing the hit test), `contribs` (hits composited before the ray's
    T-stop) and `sort_compares` (sum over rays and chunks of k log2 k for k
    hits: the least a comparison sort of them needs)."""
    _check_inputs(payload, rays, seg_start, seg_count, n_sh)
    _check_residual(payload, residual)
    if range_chunks < 1:
        raise ValueError(f"ranges need at least one chunk, got {range_chunks}")
    NB = rays.shape[0]
    out = torch.zeros((NB, NRAY, C_OUT), dtype=torch.float32, device=payload.device)
    # The counts accumulate on the tensors' device and are read once at the
    # end, so counting adds no host synchronization per chunk.
    counts = None if work is None else _work_counters(payload.device)
    for b0 in range(0, NB, BUNDLE_BLOCK):
        b1 = min(NB, b0 + BUNDLE_BLOCK)
        out[b0:b1] = _plain_bundles(payload, rays[b0:b1], seg_start[b0:b1], seg_count[b0:b1], n_sh, tmin,
                                    exact_order, range_chunks, residual, counts)
    if work is not None:
        work.update(_read_work(counts))
    return out


def _work_counters(device) -> dict:
    z = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa: E731
    return dict(hit_tests=z(torch.int64), hits=z(torch.int64), contribs=z(torch.int64),
                sort_compares=z(torch.float64))


def _read_work(counts: dict) -> dict:
    return {k: (float(v) if v.is_floating_point() else int(v)) for k, v in counts.items()}


def _pack_bits(ok):
    """(n, 256, 128) bool -> (n, 4, 256) int32: lane j in word j // 32, bit
    j % 32 (the kernels' hit masks)."""
    n = ok.shape[0]
    shifts = torch.arange(32, device=ok.device, dtype=torch.int64)
    words = (ok.reshape(n, NRAY, 4, 32).to(torch.int64) << shifts).sum(-1)  # (n, 256, 4)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).transpose(1, 2)


def _geometry(pay, o, d, tmin):
    """Per-(bundle, ray, lane) hit test of _geom (pallas_kernels.py:184-215).
    pay: (rows, nb, 1, K); o, d: 3-tuples of (nb, 256, 1)."""
    px, py, pz = pay[ROW_P], pay[ROW_P + 1], pay[ROW_P + 2]
    tux, tuy, tuz = pay[ROW_TU], pay[ROW_TU + 1], pay[ROW_TU + 2]
    tvx, tvy, tvz = pay[ROW_TV], pay[ROW_TV + 1], pay[ROW_TV + 2]
    nx, ny, nz = pay[ROW_N], pay[ROW_N + 1], pay[ROW_N + 2]
    ox, oy, oz = o
    dx, dy, dz = d
    denom = dx * nx + dy * ny + dz * nz
    den_ok = torch.abs(denom) > 1e-9
    den_s = torch.where(den_ok, denom, torch.ones_like(denom))
    t = ((px - ox) * nx + (py - oy) * ny + (pz - oz) * nz) / den_s
    qx = ox + t * dx - px
    qy = oy + t * dy - py
    qz = oz + t * dz - pz
    u = qx * tux + qy * tuy + qz * tuz
    v = qx * tvx + qy * tvy + qz * tvz
    rho = u * u + v * v
    alpha = torch.clamp(pay[ROW_OPA] * torch.exp(-0.5 * rho), max=ALPHA_MAX)
    ok = den_ok & (t >= tmin) & (rho <= RHO_CUTOFF) & (alpha >= ALPHA_MIN)
    return ok, t, alpha, denom, (nx, ny, nz)


def _plain_bundles(payload, rays, seg_start, seg_count, n_sh, tmin, exact_order, R, residual, work):
    dev = payload.device
    nb = rays.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    o = tuple(rays[:, :, i : i + 1] for i in range(3))  # (nb, 256, 1)
    d = tuple(rays[:, :, 3 + i : 4 + i] for i in range(3))
    dx, dy, dz = d
    inv = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    Y = sh_basis(dx * inv, dy * inv, dz * inv, n_sh)  # n_sh x (nb, 256, 1)

    start = seg_start.long()
    count = seg_count.long()
    n_chunks = (count + K_CHUNK - 1) // K_CHUNK
    shape = (nb, NRAY)
    logT = torch.zeros(shape, **f32)
    # The sums of the ranges before the current one (launch (d)'s order),
    # and the current range's own (launch (c)'s partials).
    tot_rgb, tot_dep, tot_nrm = torch.zeros(shape + (3,), **f32), torch.zeros(shape, **f32), torch.zeros(shape + (3,), **f32)
    rgb, dep, nrm = torch.zeros(shape + (3,), **f32), torch.zeros(shape, **f32), torch.zeros(shape + (3,), **f32)
    final_logT = torch.zeros(shape, **f32)
    n_contrib = torch.zeros(shape, **f32)
    nproc = torch.zeros(nb, **f32)
    lane = torch.arange(K_CHUNK, device=dev)
    last_col = payload.shape[1] - 1
    zero = torch.zeros((), **f32)

    chunk = 0
    while True:
        # The bundle's loop condition (pallas_kernels.py:328-329).
        live = (chunk < n_chunks) & torch.any(logT >= LOG_T_STOP, dim=1)
        idx = torch.nonzero(live).squeeze(1)
        if idx.numel() == 0:
            break
        if chunk % R == 0:
            # A new range: the finished ones' sums join the total (bundles
            # that stopped add zeros, which changes no sum).
            tot_rgb, tot_dep, tot_nrm = tot_rgb + rgb, tot_dep + dep, tot_nrm + nrm
            rgb, dep, nrm = torch.zeros_like(rgb), torch.zeros_like(dep), torch.zeros_like(nrm)
        off = start[idx] + chunk * K_CHUNK  # (na,)
        cols = torch.clamp(off[:, None] + lane[None, :], max=last_col)  # (na, K)
        pay = payload[:, cols][:, :, None, :]  # (rows, na, 1, K)
        oi = tuple(c[idx] for c in o)
        di = tuple(c[idx] for c in d)
        ok, t, alpha, denom, n = _geometry(pay, oi, di, tmin)
        lane_ok = (off[:, None] + lane[None, :]) < (start[idx] + count[idx])[:, None]
        ok = ok & lane_ok[:, None, :]  # (na, 256, K)
        ok_lanes = ok
        if work is not None:
            work["hit_tests"] += lane_ok.sum() * NRAY
            hits = ok.sum(-1).to(torch.float32)  # (na, 256) hits per ray in this chunk
            work["hits"] += hits.sum().to(torch.int64)
            work["sort_compares"] += (hits * torch.log2(torch.clamp(hits, min=1.0))).sum().to(torch.float64)
        a = torch.where(ok, alpha, zero)
        lg = torch.log1p(-a)
        # Launch (a): the chunk's total in lane order, over its hits. Lanes
        # no ray hits change nothing, here and in the composite below (the
        # kernels visit only the hits), so the loops skip them.
        hit_lanes = torch.nonzero(ok.any(dim=1).any(dim=0)).flatten().tolist()
        tot = torch.zeros((idx.numel(), NRAY), **f32)
        for j in hit_lanes:
            tot = torch.where(ok[..., j], tot + lg[..., j], tot)
        flip = torch.where(denom > 0, -1.0, 1.0)
        Yi = [y[idx] for y in Y]
        colors = []
        for c in range(3):
            sh = pay[ROW_SH + c * n_sh : ROW_SH + (c + 1) * n_sh]
            raw = Yi[0] * sh[0]
            for k in range(1, n_sh):
                raw = raw + Yi[k] * sh[k]
            colors.append(torch.clamp(raw + 0.5, min=0.0))
        pos = (chunk * K_CHUNK + lane + 1).to(torch.float32).expand_as(t)
        col = torch.stack(colors, -1)  # (na, 256, K, 3)
        nrm_l = torch.stack(n, -1).expand(col.shape)
        if exact_order:
            # Each ray's own hit-t order within the chunk, ties by lane
            # (a stable sort); lanes that miss go last and add nothing.
            key = torch.where(ok, t, torch.full_like(t, float("inf")))
            perm = torch.sort(key, dim=-1, stable=True).indices
            ok, a, lg, t, flip, pos = (torch.gather(x, -1, perm) for x in (ok, a, lg, t, flip, pos))
            col, nrm_l = (torch.gather(x, -2, perm[..., None].expand(x.shape)) for x in (col, nrm_l))
            hit_lanes = range(int(ok.sum(-1).max()))  # the hits come first

        # Launch (c): the chunk from its starting logT.
        p = logT[idx]
        c_rgb, c_dep, c_nrm = rgb[idx], dep[idx], nrm[idx]
        c_fin, c_nc = final_logT[idx], n_contrib[idx]
        if work is not None:
            n_inc = torch.zeros((), dtype=torch.int64, device=dev)
        for j in hit_lanes:
            okj = ok[..., j]
            incl = p + lg[..., j]
            inc = okj & (incl >= LOG_T_STOP)
            w = torch.where(inc, a[..., j] * torch.exp(p), zero)
            c_rgb = c_rgb + w[..., None] * col[..., j, :]
            c_dep = c_dep + w * t[..., j]
            wf = w * flip[..., j]
            c_nrm = c_nrm + wf[..., None] * nrm_l[..., j, :]
            c_fin = torch.where(inc, torch.minimum(c_fin, incl), c_fin)
            c_nc = torch.where(inc, torch.maximum(c_nc, pos[..., j]), c_nc)
            p = torch.where(okj, incl, p)
            if work is not None:
                n_inc += inc.sum()
        if work is not None:
            work["contribs"] += n_inc
        # Launch (b): the carry is the chunk total, not the running sum.
        logT[idx] = logT[idx] + tot
        if residual is not None:
            rows = torch.div(off, K_CHUNK, rounding_mode="floor")
            residual[rows, 0] = logT[idx].view(torch.int32)
            residual[rows, 1:] = _pack_bits(ok_lanes)
        rgb[idx], dep[idx], nrm[idx] = c_rgb, c_dep, c_nrm
        final_logT[idx], n_contrib[idx] = c_fin, c_nc
        nproc[idx] += 1.0
        chunk += 1

    out = torch.zeros((nb, NRAY, C_OUT), **f32)
    out[..., OUT_RGB : OUT_RGB + 3] = tot_rgb + rgb
    out[..., OUT_DEPTH] = tot_dep + dep
    out[..., OUT_NORMAL : OUT_NORMAL + 3] = tot_nrm + nrm
    out[..., OUT_FINAL_T] = torch.exp(final_logT)
    out[..., OUT_NCONTRIB] = n_contrib
    out[..., OUT_SUMLG] = logT
    out[..., OUT_NPROC] = nproc[:, None]
    return out
