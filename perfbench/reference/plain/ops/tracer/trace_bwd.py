"""Bundle tracer backward: the plain version only (a frozen copy of the port's plain
torch version, which the benchmark's reference runs on every device; the
CUDA kernel and its wrapper are left out)."""
from __future__ import annotations


import torch

from perfbench.reference.plain.ops.tracer.layout import (
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
    ROW_N,
    ROW_OPA,
    ROW_P,
    ROW_SH,
    ROW_TU,
    ROW_TV,
)
from perfbench.reference.plain.ops.tracer.ranges import RANGE_CHUNKS, chunk_ranges, max_ranges
from perfbench.reference.plain.ops.tracer.trace_fwd import (
    _check_inputs,
    _check_residual,
    _read_work,
    _work_counters,
    NRES,
    chunk_residual,
    trace_bundles_fwd_plain,
)
from perfbench.reference.plain.utils.sh import sh_basis, sh_basis_grad

RANGE_BLOCK = 512  # ranges per step of the plain version (bounds its memory)


def _check_bwd_inputs(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent, n_sh):
    _check_inputs(payload, rays, seg_start, seg_count, n_sh)
    NB = rays.shape[0]
    if seg_active.dtype != torch.int32 or seg_active.shape != (NB,):
        raise ValueError(f"seg_active must be ({NB},) int32, got {seg_active.dtype} {tuple(seg_active.shape)}")
    for name, x in (("fwd_out", fwd_out), ("cotangent", cotangent)):
        if x.dtype != torch.float32 or x.shape != (NB, NRAY, C_OUT):
            raise ValueError(f"{name} must be ({NB}, {NRAY}, {C_OUT}) float32, got {x.dtype} {tuple(x.shape)}")
    if not (payload.device == seg_active.device == fwd_out.device == cotangent.device):
        raise ValueError("the backward's inputs must be on one device")


def trace_bundles_bwd(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent, *, n_sh,
                      tmin=1e-3, exact_order=False, range_chunks=RANGE_CHUNKS, residual=None):
    """(dpayload, drays): the plain version."""
    _check_bwd_inputs(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent, n_sh)
    _check_residual(payload, residual)
    return trace_bundles_bwd_plain(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent,
                                   n_sh=n_sh, tmin=tmin, exact_order=exact_order, range_chunks=range_chunks,
                                   residual=residual)


def trace_bundles_bwd_plain(
    payload: torch.Tensor,
    rays: torch.Tensor,
    seg_start: torch.Tensor,
    seg_count: torch.Tensor,
    seg_active: torch.Tensor,
    fwd_out: torch.Tensor,
    cotangent: torch.Tensor,
    *,
    n_sh: int,
    tmin: float = 1e-3,
    exact_order: bool = False,
    range_chunks: int = RANGE_CHUNKS,
    residual: torch.Tensor | None = None,
    work: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' computation in plain torch on any device: vectorized over
    ranges, rays and a chunk's 128 lanes, one step per chunk of a range in
    reverse, and inside a chunk the order-dependent walk one position at a
    time in the kernels' order; the ranges' sums of G w, their carries from
    the last range back and the ranges' ray partials added in range order as
    the kernels take them. `work`, if given, receives the counts the kernels'
    bound is made of: `hit_tests` (ray, pair) of walked chunks, `hits` (those
    passing the hit test and, in list order, inside the ray's n_contrib),
    `contribs` (hits that carry a gradient: composited before the T-stop) and
    `sort_compares` (exact order: sum over rays and chunks of k log2 k for k
    hits)."""
    _check_bwd_inputs(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent, n_sh)
    _check_residual(payload, residual)
    if range_chunks < 1:
        raise ValueError(f"ranges need at least one chunk, got {range_chunks}")
    dev = payload.device
    f32 = dict(dtype=torch.float32, device=dev)
    if residual is None:
        residual = torch.zeros((payload.shape[1] // K_CHUNK, NRES, NRAY), dtype=torch.int32, device=dev)
        trace_bundles_fwd_plain(payload, rays, seg_start, seg_count, n_sh=n_sh, tmin=tmin,
                                range_chunks=range_chunks, residual=residual)
    chunk_logT = residual[:, 0].contiguous().view(torch.float32)  # (cols // 128, 256) each chunk's end log T
    NB, R = rays.shape[0], range_chunks
    dpayload = torch.zeros_like(payload)
    drays = torch.zeros((NB, NRAY, 8), **f32)
    if NB == 0:
        return dpayload, drays
    counts = None if work is None else _work_counters(dev)

    # The work list and each range's walked chunks [c0, c1).
    rl = chunk_ranges(seg_count, R, max_ranges(payload.shape[1], NB, R))
    n_ranges = int(rl.range_off[-1])
    rb = rl.bundle[:n_ranges].long()
    c0 = rl.chunk0[:n_ranges].long()
    k_in = torch.arange(n_ranges, device=dev) - rl.range_off[rb].long()
    n_chunks = (seg_count.long() + K_CHUNK - 1) // K_CHUNK
    nproc = fwd_out[:, 0, OUT_NPROC].long()
    active = torch.minimum(torch.minimum((seg_active.long() + K_CHUNK - 1) // K_CHUNK, n_chunks), nproc)
    nra = (active + R - 1) // R
    c1 = torch.minimum(c0 + R, active[rb])
    walked = c0 < c1
    ctx = (payload, rays, seg_start, seg_count, fwd_out, cotangent, chunk_logT, n_sh, tmin, exact_order, R)

    # (b') each range's own sum of G w (a bundle's first range needs none).
    gwsum = torch.zeros((n_ranges, NRAY), **f32)
    sel = torch.nonzero(walked & (k_in > 0)).squeeze(1)
    for i0 in range(0, sel.numel(), RANGE_BLOCK):
        blk = sel[i0 : i0 + RANGE_BLOCK]
        gwsum[blk] = _range_walks(ctx, rb[blk], c0[blk], c1[blk], torch.zeros((blk.numel(), NRAY), **f32))
    # carry_gw: the later ranges' sums, added from the last range back.
    carry = torch.zeros((n_ranges, NRAY), **f32)
    acc = torch.zeros((NB, NRAY), **f32)
    max_nra = int(nra.max())
    for k in range(max_nra - 1, -1, -1):
        idx = torch.nonzero(walked & (k_in == k)).squeeze(1)
        carry[idx] = acc[rb[idx]]
        acc[rb[idx]] = acc[rb[idx]] + gwsum[idx]
    # (c') the ranges' gradients; (d') their ray partials in range order.
    part = torch.zeros((n_ranges, NRAY, 6), **f32)
    sel = torch.nonzero(walked).squeeze(1)
    for i0 in range(0, sel.numel(), RANGE_BLOCK):
        blk = sel[i0 : i0 + RANGE_BLOCK]
        part[blk] = _range_walks(ctx, rb[blk], c0[blk], c1[blk], carry[blk], dpayload, counts)
    for k in range(max_nra):
        idx = torch.nonzero(walked & (k_in == k)).squeeze(1)
        drays[rb[idx], :, 0:6] = drays[rb[idx], :, 0:6] + part[idx]
    if work is not None:
        work.update(_read_work(counts))
    return dpayload, drays


def _range_walks(ctx, rb, c0, c1, sg0, dpayload=None, work=None):
    """Ranges (bundle rb, chunks [c0, c1)) walked in reverse from the
    carried sum of G w sg0 (n, 256). Without dpayload: the ranges' own sums
    of G w (launch (b')); with it: each walked chunk's payload gradient
    written into dpayload and the ranges' ray partials (n, 256, 6) returned
    (launch (c'))."""
    payload, rays, seg_start, seg_count, fwd, cot, chunk_logT, n_sh, tmin, exact_order, R = ctx
    dev = payload.device
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros((), **f32)
    one = torch.ones((), **f32)
    grad = dpayload is not None
    ray = rays[rb]
    o = tuple(ray[:, :, i : i + 1] for i in range(3))  # (n, 256, 1)
    d = tuple(ray[:, :, 3 + i : 4 + i] for i in range(3))
    dx, dy, dz = d
    inv = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    xu, yu, zu = dx * inv, dy * inv, dz * inv
    Y = sh_basis(xu, yu, zu, n_sh)  # n_sh x (n, 256, 1)
    f, g_ = fwd[rb], cot[rb]
    final_T = f[..., OUT_FINAL_T : OUT_FINAL_T + 1]
    n_contrib = f[..., OUT_NCONTRIB : OUT_NCONTRIB + 1]
    dRGB = [g_[..., OUT_RGB + c : OUT_RGB + c + 1] for c in range(3)]
    dDep = g_[..., OUT_DEPTH : OUT_DEPTH + 1]
    dN = [g_[..., OUT_NORMAL + c : OUT_NORMAL + c + 1] for c in range(3)]
    dTfin = g_[..., OUT_FINAL_T : OUT_FINAL_T + 1]
    start = seg_start.long()[rb]
    count = seg_count.long()[rb]
    lane = torch.arange(K_CHUNK, device=dev)
    last_col = payload.shape[1] - 1
    nrow = ROW_SH + 3 * n_sh
    sg_all = sg0.clone()
    do_r = torch.zeros(sg0.shape + (3,), **f32)
    dd_r = torch.zeros(sg0.shape + (3,), **f32)

    for kk in range(R - 1, -1, -1):
        idx = torch.nonzero(c0 + kk < c1).squeeze(1)
        if idx.numel() == 0:
            continue
        sel = lambda x: x[idx]  # noqa: E731
        c = c0[idx] + kk  # (na,)
        off = start[idx] + c * K_CHUNK
        cols = torch.clamp(off[:, None] + lane[None, :], max=last_col)  # (na, K)
        pay = payload[:, cols][:, :, None, :]  # (rows, na, 1, K)
        ox, oy, oz = (sel(x) for x in o)
        dxi, dyi, dzi = (sel(x) for x in d)
        px, py, pz = pay[ROW_P], pay[ROW_P + 1], pay[ROW_P + 2]
        tux, tuy, tuz = pay[ROW_TU], pay[ROW_TU + 1], pay[ROW_TU + 2]
        tvx, tvy, tvz = pay[ROW_TV], pay[ROW_TV + 1], pay[ROW_TV + 2]
        nx, ny, nz = pay[ROW_N], pay[ROW_N + 1], pay[ROW_N + 2]
        opa = pay[ROW_OPA]
        # The hit test (trace_fwd._geometry, pallas_kernels.py:_geom).
        denom = dxi * nx + dyi * ny + dzi * nz
        den_ok = torch.abs(denom) > 1e-9
        den_s = torch.where(den_ok, denom, one)
        pox, poy, poz = px - ox, py - oy, pz - oz
        t = (pox * nx + poy * ny + poz * nz) / den_s
        qx = ox + t * dxi - px
        qy = oy + t * dyi - py
        qz = oz + t * dzi - pz
        u = qx * tux + qy * tuy + qz * tuz
        v = qx * tvx + qy * tvy + qz * tvz
        rho = u * u + v * v
        G = torch.exp(-0.5 * rho)
        alpha = torch.clamp(opa * G, max=0.99)
        ok = den_ok & (t >= tmin) & (rho <= 9.0) & (alpha >= 1.0 / 255.0)
        lane_ok = (off[:, None] + lane[None, :]) < (start[idx] + count[idx])[:, None]
        ok = ok & lane_ok[:, None, :]
        pos = (c[:, None] * K_CHUNK + lane[None, :] + 1).to(torch.float32)[:, None, :]  # (na, 1, K)
        within = torch.ones_like(ok) if exact_order else ok & (pos <= sel(n_contrib))
        flip = torch.where(denom > 0, -one, one)
        Yi = [sel(y) for y in Y]
        raws, cols_ = [], []
        for ch in range(3):
            sh = pay[ROW_SH + ch * n_sh : ROW_SH + (ch + 1) * n_sh]
            raw = Yi[0] * sh[0]
            for k in range(1, n_sh):
                raw = raw + Yi[k] * sh[k]
            raw = raw + 0.5
            raws.append(raw)
            cols_.append(torch.clamp(raw, min=0.0))
        dR, dG, dB = (sel(x) for x in dRGB)
        dN0, dN1, dN2 = (sel(x) for x in dN)
        dDepi, dTfini, fTi = sel(dDep), sel(dTfin), sel(final_T)
        Gw = dR * cols_[0] + dG * cols_[1] + dB * cols_[2]
        Gw = Gw + t * dDepi
        Gw = Gw + flip * (nx * dN0 + ny * dN1 + nz * dN2)
        a = torch.where(ok, alpha, zero)
        lg = torch.log1p(-a)
        if work is not None:
            work["hit_tests"] += lane_ok.sum() * NRAY
            hits = (ok & within).sum(-1).to(torch.float32)
            work["hits"] += hits.sum().to(torch.int64)
            if exact_order:
                work["sort_compares"] += (hits * torch.log2(torch.clamp(hits, min=1.0))).sum().to(torch.float64)

        # The order-dependent walk, one position at a time from the back:
        # lane order, or each ray's hit-t order (ties by lane; misses last,
        # where they add nothing).
        # Positions no ray hits change nothing (the kernels visit only the
        # hits), so the walk skips them.
        if exact_order:
            key = torch.where(ok, t, torch.full_like(t, float("inf")))
            perm = torch.sort(key, dim=-1, stable=True).indices
            positions = range(int(ok.sum(-1).max()) - 1, -1, -1)  # the hits come first
        else:
            perm = lane.expand_as(t)
            positions = torch.nonzero(ok.any(dim=1).any(dim=0)).flatten().flip(0).tolist()
        okp, wip, ap, lgp, Gwp = (torch.gather(x, -1, perm) for x in (ok, within.expand_as(ok), a, lg, Gw))
        Lend = chunk_logT[torch.div(off, K_CHUNK, rounding_mode="floor")]  # (na, 256)
        s = torch.zeros_like(Lend)
        sg = sg_all[idx]
        fT, dTf = fTi[..., 0], dTfini[..., 0]
        w_p = torch.zeros_like(ap)
        da_p = torch.zeros_like(ap)
        inc_p = torch.zeros_like(okp)
        for j in positions:
            okj, aj, lgj, Gwj = okp[..., j], ap[..., j], lgp[..., j], Gwp[..., j]
            prefix_excl = Lend - s - lgj
            if exact_order:
                inc = okj & (prefix_excl + lgj >= LOG_T_STOP)
            else:
                inc = okj & wip[..., j]
            T_i = torch.exp(torch.clamp(prefix_excl, max=0.0))
            w = torch.where(inc, aj * T_i, zero)
            one_m = torch.where(okj, 1.0 - aj, one)
            da = torch.where(inc, T_i * Gwj - sg / one_m - (fT / one_m) * dTf, zero)
            w_p[..., j], da_p[..., j], inc_p[..., j] = w, da, inc
            s = torch.where(okj, s + lgj, s)
            sg = torch.where(inc, sg + Gwj * w, sg)
        sg_all[idx] = sg
        if not grad:
            continue
        # Back to lane order. Only the composited hits carry a gradient.
        w_l = torch.zeros_like(w_p).scatter_(-1, perm, w_p)
        dalpha = torch.zeros_like(da_p).scatter_(-1, perm, da_p)
        contrib = torch.zeros_like(inc_p).scatter_(-1, perm, inc_p)
        if work is not None:
            work["contribs"] += contrib.sum()

        # The chain rule per (ray, lane); rows summed over the range's rays.
        dG_g = opa * dalpha
        dopa = G * dalpha
        drho = -0.5 * G * dG_g
        du = 2.0 * u * drho
        dv = 2.0 * v * drho
        dqx = du * tux + dv * tvx
        dqy = du * tuy + dv * tvy
        dqz = du * tuz + dv * tvz
        dt = w_l * dDepi + dqx * dxi + dqy * dyi + dqz * dzi
        inv_den = 1.0 / den_s
        dden = -t * inv_den * dt
        wf = w_l * flip
        rows = [
            -dqx + dt * nx * inv_den, -dqy + dt * ny * inv_den, -dqz + dt * nz * inv_den,
            du * qx, du * qy, du * qz, dv * qx, dv * qy, dv * qz,
            dt * pox * inv_den + dden * dxi + wf * dN0,
            dt * poy * inv_den + dden * dyi + wf * dN1,
            dt * poz * inv_den + dden * dzi + wf * dN2,
            dopa,
        ]
        dY = [torch.zeros_like(sel(xu)) for _ in range(n_sh)]
        for ch, dc in enumerate((dR, dG, dB)):
            Xc = torch.where(raws[ch] > 0.0, dc * w_l, zero)
            sh = pay[ROW_SH + ch * n_sh : ROW_SH + (ch + 1) * n_sh]
            for k in range(n_sh):
                rows.append(Yi[k] * Xc)
                dY[k] = dY[k] + torch.sum(Xc * sh[k], dim=-1, keepdim=True)
        grad_rows = torch.stack([torch.where(contrib, r, zero).sum(dim=1) for r in rows])  # (nrow, na, K)
        dpayload[:nrow, cols] = torch.where(lane_ok[None], grad_rows, zero)

        m = lambda x: torch.where(contrib, x, zero).sum(dim=-1, keepdim=True)  # noqa: E731
        do_c = torch.cat([m(dqx - dt * nx * inv_den), m(dqy - dt * ny * inv_den),
                          m(dqz - dt * nz * inv_den)], dim=-1)
        dd_c = [m(t * dqx + dden * nx), m(t * dqy + dden * ny), m(t * dqz + dden * nz)]
        if n_sh > 1:
            gb = sh_basis_grad(sel(xu), sel(yu), sel(zu), n_sh)
            du_ = [sum(dY[k] * gb[k][i] for k in range(n_sh)) for i in range(3)]
            proj = sel(xu) * du_[0] + sel(yu) * du_[1] + sel(zu) * du_[2]
            unit = (sel(xu), sel(yu), sel(zu))
            dd_c = [dd_c[i] + sel(inv) * (du_[i] - unit[i] * proj) for i in range(3)]
        do_r[idx] = do_r[idx] + do_c
        dd_r[idx] = dd_r[idx] + torch.cat(dd_c, dim=-1)

    if not grad:
        return sg_all  # sg0 is zero: the ranges' own sums
    return torch.cat([do_r, dd_r], dim=-1)
