"""Bundle tracer backward: the CUDA kernel's wrapper and its plain version.

`trace_bundles_bwd` replaces materialrefgs_tpu/ops/tracer/pallas_kernels.py:
trace_bundles_bwd. On a CUDA tensor it launches the hand-written kernel in
`csrc/trace_bwd.cu` (built with nvcc for sm_90a at first use) or raises; on a
CPU tensor it runs `trace_bundles_bwd_plain`, the same arithmetic in plain
torch. The kernel's design and its bound are described in the source.

Inputs: the forward's payload, rays, seg_start and seg_count
(trace_fwd.trace_bundles_fwd), seg_active (NB,) int32 (the positions of each
segment the backward walks: in exact order NPROC x 128, in list order the
largest n_contrib of the bundle, as ops/tracer/api.py computes it), the
forward's output (NB, 256, 16) and its cotangent (NB, 256, 16) (rgb, depth,
normal and final_T channels are read). Outputs: dpayload, the payload's
shape, zero outside the walked chunks and in the padding rows; drays
(NB, 256, 8) [d origin(3), d direction(3), 0, 0].

Each bundle walks its chunks in reverse from its active end. Per chunk, each
ray rebuilds its weights: in list order T_i = exp(log final_T - the inclusive
suffix of log1p(-alpha)) over the pairs up to its n_contrib; in exact order,
in its own hit-t order (ties by lane), prefix = SUMLG - suffix - lg, with the
T-stop inclusion re-derived. Then dL/dalpha = (T_i G_i - (sum of G w after
i) / (1 - alpha_i) - final_T / (1 - alpha_i) dL/dfinal_T), with G_i = dL/dw_i
from the color, depth and flipped-normal outputs, and the chain rule through
rho, the splat coordinates, the hit distance and the plane to every payload
row (the alpha clamp passes its gradient; the color clamp gates the SH rows)
and to the ray origin and direction (through sh_basis_grad when n_sh > 1).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from materialrefgs_torch.ops import nvcc
from materialrefgs_torch.ops.tracer.layout import (
    C_OUT,
    K_CHUNK,
    LOG_T_STOP,
    NRAY,
    OUT_DEPTH,
    OUT_FINAL_T,
    OUT_NCONTRIB,
    OUT_NORMAL,
    OUT_RGB,
    OUT_SUMLG,
    ROW_N,
    ROW_OPA,
    ROW_P,
    ROW_SH,
    ROW_TU,
    ROW_TV,
)
from materialrefgs_torch.ops.tracer.trace_fwd import _check_inputs, _read_work, _work_counters
from materialrefgs_torch.utils.sh import sh_basis, sh_basis_grad

SOURCE = nvcc.CSRC / "trace_bwd.cu"
BUNDLE_BLOCK = 512  # bundles per step of the plain version (bounds its memory)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    fn = lib.trace_bundles_bwd
    fn.argtypes = [
        ctypes.c_void_p,  # payload
        ctypes.c_longlong,  # payload row stride (columns)
        ctypes.c_void_p,  # rays
        ctypes.c_void_p,  # seg_start
        ctypes.c_void_p,  # seg_count
        ctypes.c_void_p,  # seg_active
        ctypes.c_void_p,  # fwd_out
        ctypes.c_void_p,  # cotangent
        ctypes.c_void_p,  # dpayload
        ctypes.c_void_p,  # drays
        ctypes.c_int,  # NB
        ctypes.c_int,  # n_sh
        ctypes.c_float,  # tmin
        ctypes.c_int,  # exact_order
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


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


def trace_bundles_bwd(
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpayload, drays). Launches the CUDA kernel for CUDA tensors and counts
    the launch in `trace_bundles_bwd.launches`; runs the plain version for
    CPU tensors."""
    _check_bwd_inputs(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent, n_sh)
    if payload.device.type == "cpu":
        return trace_bundles_bwd_plain(
            payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent,
            n_sh=n_sh, tmin=tmin, exact_order=exact_order,
        )
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    if not tmin > 0.0:
        # The exact-order walk keys hit distances by their bits, which orders
        # them like floats only for t > 0 (as the forward kernel's sort).
        raise ValueError(f"the CUDA kernel needs tmin > 0, got {tmin}")
    payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent = (
        x.contiguous() for x in (payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent)
    )
    NB = rays.shape[0]
    if NB:
        ends = seg_start[:-1].long() + (seg_count.long() + K_CHUNK - 1) // K_CHUNK * K_CHUNK
        if int(ends.max()) > payload.shape[1] or int(seg_count.min()) < 0:
            raise ValueError("segments reach past the payload's columns")
    # Columns no chunk walks keep their zeros (the kernel writes only the
    # walked chunks, as the JAX kernel's gather-VJP masks the rest).
    dpayload = torch.zeros_like(payload)
    drays = torch.empty((NB, NRAY, 8), dtype=torch.float32, device=payload.device)
    stream = torch.cuda.current_stream(payload.device).cuda_stream
    err = _library().trace_bundles_bwd(
        payload.data_ptr(), payload.shape[1], rays.data_ptr(), seg_start.data_ptr(),
        seg_count.data_ptr(), seg_active.data_ptr(), fwd_out.data_ptr(), cotangent.data_ptr(),
        dpayload.data_ptr(), drays.data_ptr(), NB, n_sh, float(tmin), int(bool(exact_order)), stream,
    )
    if err != 0:
        raise RuntimeError(f"trace_bundles_bwd kernel launch failed with CUDA error {err}")
    trace_bundles_bwd.launches += 1
    return dpayload, drays


trace_bundles_bwd.launches = 0


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
    work: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's computation in plain torch on any device: vectorized over
    bundles, rays and a chunk's 128 lanes, one step per chunk in reverse, and
    inside a chunk the order-dependent suffix walk one position at a time in
    the kernel's order. `work`, if given, receives the counts the kernel's
    bound is made of: `hit_tests` (ray, pair) of walked chunks, `hits` (those
    passing the hit test and, in list order, inside the ray's n_contrib),
    `contribs` (hits that carry a gradient: composited before the T-stop) and
    `sort_compares` (exact order: sum over rays and chunks of k log2 k for k
    hits)."""
    _check_bwd_inputs(payload, rays, seg_start, seg_count, seg_active, fwd_out, cotangent, n_sh)
    NB = rays.shape[0]
    dpayload = torch.zeros_like(payload)
    drays = torch.zeros((NB, NRAY, 8), dtype=torch.float32, device=payload.device)
    counts = None if work is None else _work_counters(payload.device)
    # Blocks of bundles with like walks: a block takes as many chunk steps
    # as its longest walk, and the long (silhouette) walks are few.
    order = torch.argsort(seg_active, descending=True, stable=True)
    for b0 in range(0, NB, BUNDLE_BLOCK):
        blk = order[b0 : b0 + BUNDLE_BLOCK]
        drays[blk] = _plain_bundles(
            payload, dpayload, rays[blk], seg_start[blk], seg_count[blk], seg_active[blk],
            fwd_out[blk], cotangent[blk], n_sh, tmin, exact_order, counts,
        )
    if work is not None:
        work.update(_read_work(counts))
    return dpayload, drays


def _plain_bundles(payload, dpayload, rays, seg_start, seg_count, seg_active, fwd, cot, n_sh, tmin,
                   exact_order, work):
    dev = payload.device
    nb = rays.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros((), **f32)
    one = torch.ones((), **f32)
    o = tuple(rays[:, :, i : i + 1] for i in range(3))  # (nb, 256, 1)
    d = tuple(rays[:, :, 3 + i : 4 + i] for i in range(3))
    dx, dy, dz = d
    inv = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    xu, yu, zu = dx * inv, dy * inv, dz * inv
    Y = sh_basis(xu, yu, zu, n_sh)  # n_sh x (nb, 256, 1)
    final_T = fwd[..., OUT_FINAL_T : OUT_FINAL_T + 1]
    n_contrib = fwd[..., OUT_NCONTRIB : OUT_NCONTRIB + 1]
    total_lg = fwd[..., OUT_SUMLG : OUT_SUMLG + 1]
    logT_fin = torch.log(torch.clamp(final_T, min=1e-30))
    dRGB = [cot[..., OUT_RGB + c : OUT_RGB + c + 1] for c in range(3)]
    dDep = cot[..., OUT_DEPTH : OUT_DEPTH + 1]
    dN = [cot[..., OUT_NORMAL + c : OUT_NORMAL + c + 1] for c in range(3)]
    dTfin = cot[..., OUT_FINAL_T : OUT_FINAL_T + 1]

    start = seg_start.long()
    count = seg_count.long()
    n_chunks = (count + K_CHUNK - 1) // K_CHUNK
    active_chunks = torch.minimum((seg_active.long() + K_CHUNK - 1) // K_CHUNK, n_chunks)
    carry_lg = torch.zeros((nb, NRAY, 1), **f32)
    carry_gw = torch.zeros((nb, NRAY, 1), **f32)
    do_acc = torch.zeros((nb, NRAY, 3), **f32)
    dd_acc = torch.zeros((nb, NRAY, 3), **f32)
    lane = torch.arange(K_CHUNK, device=dev)
    last_col = payload.shape[1] - 1
    nrow = ROW_SH + 3 * n_sh
    max_chunks = int(active_chunks.max()) if nb else 0

    for chunk in range(max_chunks - 1, -1, -1):
        idx = torch.nonzero(chunk < active_chunks).squeeze(1)
        off = start[idx] + chunk * K_CHUNK  # (na,)
        cols = torch.clamp(off[:, None] + lane[None, :], max=last_col)  # (na, K)
        pay = payload[:, cols][:, :, None, :]  # (rows, na, 1, K)
        sel = lambda x: x[idx]  # noqa: E731
        ox, oy, oz = (sel(c) for c in o)
        dxi, dyi, dzi = (sel(c) for c in d)
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
        if not exact_order:
            pos = (chunk * K_CHUNK + lane + 1).to(torch.float32)
            ok = ok & (pos <= sel(n_contrib))
        flip = torch.where(denom > 0, -one, one)
        Yi = [sel(y) for y in Y]
        raws, cols_ = [], []
        for c in range(3):
            sh = pay[ROW_SH + c * n_sh : ROW_SH + (c + 1) * n_sh]
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
            hits = ok.sum(-1).to(torch.float32)
            work["hits"] += hits.sum().to(torch.int64)
            if exact_order:
                work["sort_compares"] += (hits * torch.log2(torch.clamp(hits, min=1.0))).sum().to(torch.float64)

        # The order-dependent walk, one position at a time from the back:
        # lane order, or each ray's hit-t order (ties by lane; misses last,
        # where they add nothing).
        if exact_order:
            key = torch.where(ok, t, torch.full_like(t, float("inf")))
            perm = torch.sort(key, dim=-1, stable=True).indices
        else:
            perm = lane.expand_as(t)
        okp, ap, lgp, Gwp = (torch.gather(x, -1, perm) for x in (ok, a, lg, Gw))
        s, sg = sel(carry_lg)[..., 0], sel(carry_gw)[..., 0]
        lT, tl = sel(logT_fin)[..., 0], sel(total_lg)[..., 0]
        fT, dTf = fTi[..., 0], dTfini[..., 0]
        w_p = torch.zeros_like(ap)
        da_p = torch.zeros_like(ap)
        inc_p = torch.zeros_like(okp)
        for j in range(K_CHUNK - 1, -1, -1):
            okj, aj, lgj, Gwj = okp[..., j], ap[..., j], lgp[..., j], Gwp[..., j]
            if exact_order:
                prefix_excl = tl - s - lgj
                inc = okj & (prefix_excl + lgj >= LOG_T_STOP)
                T_i = torch.exp(torch.clamp(prefix_excl, max=0.0))
            else:
                inc = okj
                T_i = torch.exp(lT - (s + lgj))
            w = torch.where(inc, aj * T_i, zero)
            one_m = torch.where(okj, 1.0 - aj, one)
            da = torch.where(inc, T_i * Gwj - sg / one_m - (fT / one_m) * dTf, zero)
            w_p[..., j], da_p[..., j], inc_p[..., j] = w, da, inc
            s = torch.where(okj, s + lgj, s)
            sg = torch.where(inc, sg + Gwj * w, sg)
        carry_lg[idx], carry_gw[idx] = s[..., None], sg[..., None]
        # Back to lane order. Only the composited hits carry a gradient.
        w_l = torch.zeros_like(w_p).scatter_(-1, perm, w_p)
        dalpha = torch.zeros_like(da_p).scatter_(-1, perm, da_p)
        contrib = torch.zeros_like(inc_p).scatter_(-1, perm, inc_p)
        if work is not None:
            work["contribs"] += contrib.sum()

        # The chain rule per (ray, lane); rows summed over the bundle's rays.
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
        dY = [torch.zeros_like(xu[idx]) for _ in range(n_sh)]
        for c, dc in enumerate((dR, dG, dB)):
            Xc = torch.where(raws[c] > 0.0, dc * w_l, zero)
            sh = pay[ROW_SH + c * n_sh : ROW_SH + (c + 1) * n_sh]
            for k in range(n_sh):
                rows.append(Yi[k] * Xc)
                dY[k] = dY[k] + torch.sum(Xc * sh[k], dim=-1, keepdim=True)
        grad = torch.stack([torch.where(contrib, r, zero).sum(dim=1) for r in rows])  # (nrow, na, K)
        dpayload[:nrow, cols] = torch.where(lane_ok[None], grad, zero)

        m = lambda x: torch.where(contrib, x, zero).sum(dim=-1, keepdim=True)  # noqa: E731
        do_c = torch.cat([m(dqx - dt * nx * inv_den), m(dqy - dt * ny * inv_den),
                          m(dqz - dt * nz * inv_den)], dim=-1)
        dd_c = [m(t * dqx + dden * nx), m(t * dqy + dden * ny), m(t * dqz + dden * nz)]
        if n_sh > 1:
            gb = sh_basis_grad(xu[idx], yu[idx], zu[idx], n_sh)
            du_ = [sum(dY[k] * gb[k][i] for k in range(n_sh)) for i in range(3)]
            proj = xu[idx] * du_[0] + yu[idx] * du_[1] + zu[idx] * du_[2]
            unit = (xu[idx], yu[idx], zu[idx])
            dd_c = [dd_c[i] + inv[idx] * (du_[i] - unit[i] * proj) for i in range(3)]
        do_acc[idx] = do_acc[idx] + do_c
        dd_acc[idx] = dd_acc[idx] + torch.cat(dd_c, dim=-1)

    out = torch.zeros((nb, NRAY, 8), **f32)
    out[..., 0:3] = do_acc
    out[..., 3:6] = dd_acc
    return out
