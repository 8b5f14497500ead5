"""Bundle splat tracer API: clustering, cone culling, pair binning, tracing
(materialrefgs_tpu/ops/tracer/api.py).

Rays are grouped into bundles of 256 (16x16 pixel tiles of the reflected-ray
map), gaussians into Morton clusters of 256. Stage 1 cone-culls (bundle,
cluster) pairs, stage 2 runs the exact per-gaussian cone test, and the
surviving pairs, sorted by depth along each bundle's axis in 128-aligned
segments, go through the forward kernel (`trace_fwd.trace_bundles_fwd`).

Gradients flow through `_TraceCore`, an autograd Function over the payload
gather and both kernels (the JAX package's `_trace_core` custom VJP): its
backward launches `trace_bwd.trace_bundles_bwd` and scatter-adds the payload
gradient into the per-gaussian table. The cull and the segment layout take no
gradient (their outputs are indices and masks).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from materialrefgs_torch.ops.knn import _morton3d
from materialrefgs_torch.ops.segments import build_aligned_segments, scatter_pairs
from materialrefgs_torch.ops.tracer.layout import (
    K_CHUNK,
    NRAY,
    OUT_DEPTH,
    OUT_FINAL_T,
    OUT_NCONTRIB,
    OUT_NORMAL,
    OUT_NPROC,
    OUT_RGB,
    pay_rows,
)
from materialrefgs_torch.ops.tracer.trace_bwd import trace_bundles_bwd
from materialrefgs_torch.ops.tracer.trace_fwd import new_residual, trace_bundles_fwd
from materialrefgs_torch.utils.logging_utils import span, spanned
from materialrefgs_torch.utils.transforms import normalize, quat_to_rotmat

CLUSTER = 256


@dataclass(frozen=True)
class TracerConfig:
    pair_capacity: int = 1 << 19
    cluster_pair_capacity: int = 1 << 14
    tmin: float = 1e-3
    # Mesh-tracer cluster pre-cull survivor budget per 256-ray block
    # (ops.mesh_tracer.trace cull_cap); exact while cull_dropped == 0.
    mesh_cull_cap: int = 64
    # Each ray composites in its own hit-t order within every 128-pair chunk
    # (chunks stay in the bundle's depth order); False: list order.
    exact_order: bool = False


class _TraceCore(torch.autograd.Function):
    """The payload gather and the tracer kernels (api.py:122-160 of the JAX
    package). Forward: gather the (rows, P) per-gaussian table's columns of
    the binned pairs straight into the one payload buffer (invalid pairs
    zero), then `trace_bundles_fwd`, which also fills the backward's
    residual (each processed chunk's end log T and hit masks). Backward: the walk bound `seg_active`
    as `_trace_core_bwd` computes it, `trace_bundles_bwd`, and the valid
    pairs' payload gradients `index_add_`ed into a (rows, P) table. The
    payload and its gradient span only the columns the segments use
    (seg_start[-1], + 128): every valid pair lies there."""

    @staticmethod
    def forward(ctx, table, rays8, pair_gauss, pair_valid, seg_start, seg_count, n_sh, tmin, exact_order):
        nrow = table.shape[0]
        used = int(seg_start[-1])
        # The kernels never stage past the segments' 128-aligned ends, so the
        # payload spans only the columns they use (+128 spare), not the
        # budget's B: a budget raised for the largest view leaves most of B
        # unused on the others.
        payload = torch.empty((pay_rows(n_sh), used + K_CHUNK), dtype=torch.float32, device=table.device)
        payload[nrow:].zero_()
        payload[:nrow, used:].zero_()
        torch.index_select(table, 1, pair_gauss[:used], out=payload[:nrow, :used])
        payload[:nrow, :used].masked_fill_(~pair_valid[:used], 0.0)
        # Each processed chunk's end log T and hit masks, which the backward reads.
        residual = new_residual(payload) if any(ctx.needs_input_grad[:2]) else None
        out = trace_bundles_fwd(payload, rays8, seg_start, seg_count, n_sh=n_sh, tmin=tmin,
                                exact_order=exact_order, residual=residual)
        ctx.save_for_backward(payload, rays8, seg_start, seg_count, out, pair_gauss[:used], pair_valid[:used],
                              residual)
        ctx.cfg = (n_sh, tmin, exact_order, nrow, table.shape[1])
        return out

    @staticmethod
    def backward(ctx, g):
        payload, rays8, seg_start, seg_count, out, pair_gauss, pair_valid, residual = ctx.saved_tensors
        n_sh, tmin, exact_order, nrow, P = ctx.cfg
        if exact_order:
            # The exact-order backward walks every chunk the forward processed.
            seg_active = torch.amax(out[..., OUT_NPROC], dim=1).to(torch.int32) * K_CHUNK
        else:
            seg_active = torch.amax(out[..., OUT_NCONTRIB], dim=1).to(torch.int32)
        dpay, drays = trace_bundles_bwd(payload, rays8, seg_start, seg_count, seg_active, out, g.contiguous(),
                                        n_sh=n_sh, tmin=tmin, exact_order=exact_order, residual=residual)
        dtable = None
        if ctx.needs_input_grad[0]:
            src = dpay[:nrow, : pair_gauss.shape[0]]  # the columns the segments span
            src.masked_fill_(~pair_valid, 0.0)
            dtable = torch.zeros((nrow, P), dtype=torch.float32, device=dpay.device)
            dtable.index_add_(1, pair_gauss, src)
        return dtable, drays, None, None, None, None, None, None, None


def _cluster_gaussians(means3d, scales, alive):
    """Morton-sort alive gaussians into clusters of 256. Returns (order
    (Pc,), centers (G, 3), radii (G,), cluster_alive (G,))."""
    P = means3d.shape[0]
    G = (P + CLUSTER - 1) // CLUSTER
    Pc = G * CLUSTER
    inf = torch.full_like(means3d, float("inf"))
    lo = torch.amin(torch.where(alive[:, None], means3d, inf), dim=0)
    hi = torch.amax(torch.where(alive[:, None], means3d, -inf), dim=0)
    q = ((means3d - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).to(torch.int32)
    code = _morton3d(torch.clamp(q, 0, 1023))
    # Dead gaussians sort last.
    code = torch.where(alive, code, torch.full_like(code, 0x3FFFFFFF))
    order = torch.argsort(code, stable=True)
    if Pc > P:
        order = torch.cat([order, torch.full((Pc - P,), P - 1, dtype=order.dtype, device=order.device)])

    pts = means3d[order].reshape(G, CLUSTER, 3)
    r3 = torch.where(alive, 3.0 * torch.amax(scales, dim=-1), torch.zeros((), device=means3d.device))
    r3 = r3[order].reshape(G, CLUSTER)
    w = alive[order].reshape(G, CLUSTER)
    wsum = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1)
    centers = torch.sum(pts * w[..., None], dim=1) / wsum
    dist = torch.linalg.vector_norm(pts - centers[:, None], dim=-1)
    radii = torch.amax(torch.where(w, dist + r3, torch.zeros((), device=means3d.device)), dim=1)
    # All-dead clusters (center 0, radius 0) must not pass the stage-1 test:
    # they would flood the cluster-pair budget.
    return order, centers, radii, torch.sum(w, dim=1) > 0


def _bundle_stats(rays_o, rays_d):
    """(NB,256,3) x2 -> per-bundle centroid, mean dir, origin radius, tan(theta)."""
    o_c = torch.mean(rays_o, dim=1)
    d_n = normalize(rays_d)
    d_c = normalize(torch.mean(d_n, dim=1))
    r0 = torch.amax(torch.linalg.vector_norm(rays_o - o_c[:, None], dim=-1), dim=1)
    cosm = torch.amin(torch.sum(d_n * d_c[:, None], dim=-1), dim=1)
    cosm = torch.clamp(cosm, 1e-3, 1.0)
    tant = torch.sqrt(torch.clamp(1.0 - cosm**2, min=0.0)) / cosm
    return o_c, d_c, r0, tant


def _cone_test(p, r_obj, o_c, d_c, r0, tant, tmin):
    """Conservative sphere-vs-cone: p (..., 3) against a bundle cone."""
    v = p - o_c
    t = torch.sum(v * d_c, dim=-1)
    perp2 = torch.clamp(torch.sum(v * v, dim=-1) - t * t, min=0.0)
    lim = r0 + r_obj + torch.clamp(t, min=0.0) * tant
    return (t >= tmin - r0 - r_obj) & (perp2 <= lim * lim), t


def _cull(ro, rd, means3d, scales, opacities, config: TracerConfig, bundle_mask):
    """Stages 1+2: (bundle, cluster) cone cull, then exact per-gaussian cone
    tests. Returns (gauss ids (CP, 256), bundle of each pair, t_proj, okg
    validity, cluster_overflow). CP is the number of cluster pairs kept (at
    most cluster_pair_capacity): the JAX package pads to the capacity with
    invalid pairs, which no output depends on."""
    NB = ro.shape[0]
    P = means3d.shape[0]
    dev = means3d.device
    o_c, d_c, r0, tant = _bundle_stats(ro, rd)

    alive = opacities >= (1.0 / 255.0)
    order, centers, radii, cluster_alive = _cluster_gaussians(means3d, scales, alive)
    G = centers.shape[0]

    # Stage 1: (bundle, cluster) cone culling.
    ok_bc, _ = _cone_test(
        centers[None, :, :], radii[None, :], o_c[:, None, :], d_c[:, None, :],
        r0[:, None], tant[:, None], config.tmin,
    )  # (NB, G)
    ok_bc = ok_bc & cluster_alive[None, :]
    if bundle_mask is not None:
        ok_bc = ok_bc & bundle_mask.reshape(NB, 1)
    # nonzero(size=cap) keeps the lowest flat indices: pairs beyond the cap
    # belong to the highest-index bundles. Scaled by CLUSTER so the total
    # overflow is in gaussian-pair units (a truncated cluster pair loses up to
    # CLUSTER gaussians).
    flat_idx = torch.nonzero(ok_bc.reshape(-1)).squeeze(1)
    n_bc = flat_idx.numel()
    cluster_overflow = CLUSTER * max(n_bc - config.cluster_pair_capacity, 0)
    flat_idx = flat_idx[: config.cluster_pair_capacity]
    cp_b = flat_idx // G
    cp_c = flat_idx % G

    # Stage 2: expand clusters to gaussians, exact per-gaussian cone test.
    lanes = torch.arange(CLUSTER, device=dev)[None, :]
    gidx_sorted = cp_c[:, None] * CLUSTER + lanes  # index into morton order
    gauss = order[gidx_sorted]  # (CP, 256) original gaussian ids
    b_of = cp_b[:, None].expand(gauss.shape)
    px, py, pz = (means3d[:, i][gauss] for i in range(3))
    r_g = (3.0 * torch.amax(scales, dim=-1))[gauss]
    vx = px - o_c[cp_b, 0][:, None]
    vy = py - o_c[cp_b, 1][:, None]
    vz = pz - o_c[cp_b, 2][:, None]
    t_proj = vx * d_c[cp_b, 0][:, None] + vy * d_c[cp_b, 1][:, None] + vz * d_c[cp_b, 2][:, None]
    perp2 = torch.clamp(vx * vx + vy * vy + vz * vz - t_proj * t_proj, min=0.0)
    r0_b = r0[cp_b][:, None]
    lim = r0_b + r_g + torch.clamp(t_proj, min=0.0) * tant[cp_b][:, None]
    okg = (t_proj >= config.tmin - r0_b - r_g) & (perp2 <= lim * lim)
    # Mask morton-order padding lanes (duplicated last gaussian) and dead ones.
    okg = okg & alive[gauss] & (gidx_sorted < P)
    return gauss, b_of, t_proj, okg, cluster_overflow


def trace_demand(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    means3d: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    config: TracerConfig = TracerConfig(),
    bundle_mask: torch.Tensor | None = None,
) -> int:
    """Pair demand of a would-be trace: the cull stages only, no binning or
    kernel (cluster-truncated pairs count in CLUSTER units)."""
    N = rays_o.shape[0]
    if N % NRAY:
        raise ValueError(f"ray count {N} is not a multiple of {NRAY}")
    NB = N // NRAY
    _, _, _, okg, cluster_overflow = _cull(
        rays_o.reshape(NB, NRAY, 3), rays_d.reshape(NB, NRAY, 3), means3d, scales, opacities,
        config, bundle_mask,
    )
    return int(okg.sum()) + cluster_overflow


@spanned("tracer.trace")
def trace(
    rays_o: torch.Tensor,  # (N, 3); N must be a multiple of 256
    rays_d: torch.Tensor,  # (N, 3)
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,  # (P,)
    shs: torch.Tensor,  # (P, K_sh, 3) SH coefficients (degree via sh_degree)
    config: TracerConfig = TracerConfig(),
    sh_degree: int = 3,
    bundle_mask: torch.Tensor | None = None,  # (N/256,) bool: trace this bundle?
) -> dict:
    """Trace rays against a surfel cloud. Returns per-ray rgb/acc/depth/normal/
    final_T, the pairs dropped for capacity (`overflow`, stage-1 cluster
    pairs counted in CLUSTER units), the pair demand before truncation
    (`pairs`), and the budgets that would have kept them all:
    `cluster_pairs` (stage 1) and `pair_slots` (the segment layout's
    capacity; exact once the cluster budget fits).

    `bundle_mask=False` bundles produce zero output (final_T = 1): their
    (bundle, cluster) pairs are culled in stage 1, so they bin no pairs and
    the kernel's loop for them exits at once."""
    N = rays_o.shape[0]
    if N % NRAY:
        raise ValueError(f"ray count {N} is not a multiple of {NRAY}")
    NB = N // NRAY
    P = means3d.shape[0]
    n_sh = (sh_degree + 1) ** 2
    if shs.shape[1] < n_sh:
        raise ValueError(f"shs has {shs.shape[1]} coefficients, degree {sh_degree} needs {n_sh}")

    ro = rays_o.reshape(NB, NRAY, 3)
    rd = rays_d.reshape(NB, NRAY, 3)
    B = config.pair_capacity
    with torch.no_grad():
        with span("tracer.cull"):
            gauss, b_of, t_proj, okg, cluster_overflow = _cull(
                ro.detach(), rd.detach(), means3d.detach(), scales.detach(), opacities.detach(), config,
                bundle_mask,
            )
        with span("tracer.segments"):
            okg_f = okg.reshape(-1)
            seg = build_aligned_segments(b_of.reshape(-1), t_proj.reshape(-1), okg_f, NB, B)
            gauss_f = gauss.reshape(-1)
            pair_gauss = scatter_pairs(torch.where(okg_f, gauss_f, torch.zeros_like(gauss_f)), seg.perm_pos, B)
            pair_valid = scatter_pairs(okg_f, seg.perm_pos, B, fill=False)

    # Per-pair payload (pay_rows(n_sh), B + 128): geometry rows + raw SH rows
    # (channel-major), gathered in one gather from a (13 + 3*n_sh, P)
    # per-gaussian table; color is evaluated per ray inside the kernel. The
    # gather writes straight into the channel-major payload, the only (rows,
    # B) buffer alive: at tens of millions of pairs a second one would not
    # fit beside it (_TraceCore).
    R = quat_to_rotmat(rotations)
    tu_s = R[:, :, 0] / torch.clamp(scales[:, 0:1], min=1e-12)
    tv_s = R[:, :, 1] / torch.clamp(scales[:, 1:2], min=1e-12)
    sh_flat = shs[:, :n_sh, :].transpose(1, 2).reshape(P, 3 * n_sh)
    g_all = torch.cat([means3d, tu_s, tv_s, R[:, :, 2], opacities[:, None], sh_flat], dim=1)
    rays8 = torch.cat([ro, rd, torch.zeros((NB, NRAY, 2), dtype=ro.dtype, device=ro.device)], dim=-1)
    out = _TraceCore.apply(
        g_all.T.contiguous(), rays8.contiguous(), pair_gauss.long(), pair_valid, seg.seg_start,
        seg.seg_count, n_sh, config.tmin, config.exact_order,
    )
    final_T = out[..., OUT_FINAL_T].reshape(N)
    # Budgets that would have kept every pair of this trace: the stage-1
    # cluster pairs, and the 128-aligned segment slots of the pairs that
    # passed under this config's cluster budget.
    cluster_pairs = gauss.shape[0] + cluster_overflow // CLUSTER
    per_bundle = torch.zeros(NB, dtype=torch.int64, device=okg.device)
    per_bundle.index_add_(0, b_of[:, 0], okg.sum(dim=1))
    pair_slots = int(torch.sum((per_bundle + K_CHUNK - 1) // K_CHUNK * K_CHUNK))
    return {
        "rgb": out[..., OUT_RGB : OUT_RGB + 3].reshape(N, 3),
        "depth": out[..., OUT_DEPTH].reshape(N),
        "normal": out[..., OUT_NORMAL : OUT_NORMAL + 3].reshape(N, 3),
        "acc": 1.0 - final_T,
        "final_T": final_T,
        "overflow": int(seg.overflow) + cluster_overflow,
        # Pair demand before truncation: overflow == 0 alone cannot tell a
        # fitting budget from nothing to trace.
        "pairs": int(okg.sum()),
        "cluster_pairs": cluster_pairs,
        "pair_slots": pair_slots,
    }
