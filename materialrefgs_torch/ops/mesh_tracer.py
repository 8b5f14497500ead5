"""Mesh ray tracer and one-bounce shading (materialrefgs_tpu/ops/mesh_tracer.py).

Nearest hit of rays against a triangle soup, as a dense Moller-Trumbore
reduction: no BVH. Triangles are Morton-ordered so consecutive CLUSTER rows
are spatially tight; the culled path slab-tests every cluster's AABB against
each 256-ray block, keeps the clusters any ray of the block may hit (at most
`cull_cap`, in ascending cluster order; `cull_dropped` counts the rest) and
intersects only their triangles. The first hit is the first minimum of t in
that order, which is the JAX package's tie-break.

The JAX package maps a `lax.cond` over every ray block; here the active
blocks (block_mask) are gathered and intersected in batches sized to a
memory budget. Plain torch: the hot-spot question for a hand kernel is in
ROADMAP.md. On top of the trace: per-vertex attributes (`MeshData.attrs`,
`interpolate_attr`), the split-sum colour seen along secondary rays
(`secondary_color`), the one-bounce indirect light of the
`raytracing_residual` flavor (`shade_one_bounce`), and the bake of the
gaussians' materials onto mesh vertices (`bake_vertex_attrs`, the material
mesh). Gradients flow through the shading (to the env light and the vertex
attributes), not through the hit search.

Divergences of the JAX package from the reference, kept here:
- raytracer.py:264-266 samples the FG LUT for the first secondary hit only;
  the LUT is evaluated per ray.
- Barycentric weights are the Moller-Trumbore (u, v) themselves.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from materialrefgs_torch import resolve_device
from materialrefgs_torch.ops.brdf_lut import sample_fg_lut
from materialrefgs_torch.utils.logging_utils import span, spanned
from materialrefgs_torch.utils.transforms import normalize, reflect

TRI_CHUNK = 512
RAY_BLOCK = 2048
T_FAR = 10.0  # reference miss sentinel (raytracer.py:220 hit_depth == 10)
CLUSTER = 64  # triangles per Morton cluster (pre-cull granularity)
# Bytes of (ray, triangle) intermediates one batch of blocks may hold. At the
# training CLI's mesh_cull_cap of 512 clusters a block's worst case is 400 MB,
# so this admits 21 blocks per batch (1 GB admitted 2, and dispatching ~45
# small ops per batch then held the host for seconds per 800x800 view).
BATCH_BYTES = 1 << 33


@dataclass
class MeshData:
    """Static-shape triangle soup with precomputed intersection terms
    (the JAX package's flax dataclass, as tensors on one device)."""

    v0: torch.Tensor  # (T, 3) first vertex of each triangle
    e1: torch.Tensor  # (T, 3) v1 - v0
    e2: torch.Tensor  # (T, 3) v2 - v0
    normal: torch.Tensor  # (T, 3) unit geometric normal
    valid: torch.Tensor  # (T,) bool, False on padding rows
    vertices: torch.Tensor  # (V, 3)
    triangles: torch.Tensor  # (T, 3) int32 vertex ids (clamped on padding)
    cluster_lo: torch.Tensor  # (NC, 3) cluster AABB mins (padding: +inf)
    cluster_hi: torch.Tensor  # (NC, 3) cluster AABB maxs (padding: -inf)
    attrs: dict = field(default_factory=dict)  # name -> (V, C) per-vertex attributes

    @property
    def n_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.cluster_lo.shape[0]


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Sort order of points along a 30-bit 3D Morton curve."""
    lo = centroids.min(0)
    span = np.maximum(centroids.max(0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def build_mesh(
    vertices: np.ndarray,
    triangles: np.ndarray,
    attrs: dict | None = None,
    device: str | torch.device | None = None,
) -> MeshData:
    """Pack (V,3) vertices + (T,3) int triangles into a MeshData on `device`
    (default: the card), padded to whole TRI_CHUNK and CLUSTER blocks.

    attrs maps name -> (V, C) per-vertex arrays (the reference's
    load_from_ply_file prefixes: diffuse/roughness/albedo/metallic/normal,
    normal in [0, 1]). The JAX package's pad_to / pad_verts_to (a capacity
    that keeps its jitted step's shapes) have no use in the eager port:
    padding rows never hit."""
    dev = resolve_device(device)
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int32)
    T = triangles.shape[0]
    if vertices.shape[0] == 0:
        vertices = np.zeros((1, 3), np.float32)  # padding rows index vertex 0
    if T > 0:
        cent = vertices[triangles].mean(axis=1)
        triangles = triangles[_morton_order(cent)]
    T_pad = max(TRI_CHUNK, ((T + TRI_CHUNK - 1) // TRI_CHUNK) * TRI_CHUNK)
    T_pad = ((T_pad + CLUSTER - 1) // CLUSTER) * CLUSTER
    tri_pad = np.zeros((T_pad, 3), np.int32)
    tri_pad[:T] = triangles
    valid = np.zeros((T_pad,), bool)
    valid[:T] = True

    tv = vertices[tri_pad]  # (T_pad, 3, 3)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - v0
    e2 = tv[:, 2] - v0
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    NC = T_pad // CLUSTER
    tvc = tv.reshape(NC, CLUSTER, 3, 3)
    vmask = valid.reshape(NC, CLUSTER, 1, 1)
    lo = np.where(vmask, tvc, np.inf).min(axis=(1, 2))
    hi = np.where(vmask, tvc, -np.inf).max(axis=(1, 2))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return MeshData(
        v0=t(v0), e1=t(e1), e2=t(e2), normal=t(n), valid=t(valid, torch.bool),
        vertices=t(vertices), triangles=t(tri_pad, torch.int32),
        cluster_lo=t(lo), cluster_hi=t(hi),
        attrs={k: t(np.asarray(v, np.float32)) for k, v in (attrs or {}).items()},
    )


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _intersect(v0, e1, e2, o, d):
    """Moller-Trumbore (jnp.cross's component formulas) of (nb, R, 3) rays
    against (nb, 1, C, 3) triangles. Returns a, u, v, t (nb, R, C)."""
    ox, oy, oz = (o[..., i : i + 1] for i in range(3))  # (nb, R, 1)
    dx, dy, dz = (d[..., i : i + 1] for i in range(3))
    ax, ay, az = (v0[..., i] for i in range(3))  # (nb, 1, C)
    e1x, e1y, e1z = (e1[..., i] for i in range(3))
    e2x, e2y, e2z = (e2[..., i] for i in range(3))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = _dot3(e1x, e1y, e1z, hx, hy, hz)
    zero = torch.zeros((), device=a.device)
    f = torch.where(torch.abs(a) > 1e-9, 1.0 / torch.where(a == 0, torch.ones_like(a), a), zero)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * _dot3(sx, sy, sz, hx, hy, hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * _dot3(dx, dy, dz, qx, qy, qz)
    t = f * _dot3(e2x, e2y, e2z, qx, qy, qz)
    return a, u, v, t


def _keep_nearest(best, hits, ok, gid, t_min, t_far):
    """The carry of _nearest_hit: each ray's first minimum among a chunk's
    hits replaces best (t, tri, u, v; None before the first chunk) where its
    t is strictly smaller."""
    a, u, v, t = hits
    if best is None:
        nb, R = t.shape[:2]
        best = (torch.full((nb, R), float("inf"), device=t.device),
                torch.full((nb, R), -1, dtype=torch.int32, device=t.device),
                torch.zeros((nb, R), device=t.device), torch.zeros((nb, R), device=t.device))
    best_t, best_tri, best_u, best_v = best
    hit = ok & (torch.abs(a) > 1e-9) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t < t_far)
    t = torch.where(hit, t, torch.full((), float("inf"), device=t.device))
    j = torch.argmin(t, dim=-1, keepdim=True)  # first minimum
    tc = torch.gather(t, -1, j)[..., 0]
    better = tc < best_t
    gids = torch.gather(gid, 1, j[..., 0])
    best_tri = torch.where(better, gids.to(torch.int32), best_tri)
    best_u = torch.where(better, torch.gather(u, -1, j)[..., 0], best_u)
    best_v = torch.where(better, torch.gather(v, -1, j)[..., 0], best_v)
    return torch.minimum(best_t, tc), best_tri, best_u, best_v


def _nearest_hit(v0, e1, e2, ok, gid, o, d, t_min, t_far, chunk, out, rows):
    """Nearest hit of (nb, R, 3) rays against per-block triangle lists
    v0/e1/e2 (nb, Tn, 3), ok (nb, Tn), gid (nb, Tn) global ids, walked in
    chunks of `chunk` triangles with the JAX package's carry: a later chunk
    wins only with a strictly smaller t. Writes t, tri, u, v (nb, R) into
    the blocks `rows` of the four arrays `out`."""
    best = None
    last = range(0, v0.shape[1], chunk)[-1]
    for c0 in range(0, v0.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        with span("mesh_tracer.hit"):
            hits = _intersect(v0[:, None, sl], e1[:, None, sl], e2[:, None, sl], o, d)
            with span("mesh_tracer.nearest"):
                best = _keep_nearest(best, hits, ok[:, None, sl], gid[:, sl], t_min, t_far)
                del hits  # the chunk's (nb, R, C) intersections, freed inside the span
                if c0 == last:
                    for dst, src in zip(out, best):
                        dst[rows] = src


def _cluster_hits(mesh: MeshData, o, d, t_min, t_far):
    """Cluster AABB pre-cull for (nb, R, 3) ray blocks: (nb, NC) whether
    any ray of the block meets the cluster's box."""
    # Ray-AABB slab test. Axis-parallel directions use a large finite
    # reciprocal (1e12): inf would make 0*inf NaN on boundary origins.
    d_safe = torch.where(
        torch.abs(d) > 1e-12, d,
        torch.where(d >= 0, torch.full_like(d, 1e-12), torch.full_like(d, -1e-12)),
    )
    inv = 1.0 / d_safe
    t1 = (mesh.cluster_lo[None, None] - o[:, :, None]) * inv[:, :, None]  # (nb, R, NC, 3)
    t2 = (mesh.cluster_hi[None, None] - o[:, :, None]) * inv[:, :, None]
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit_c = (tf >= torch.clamp(tn, min=t_min)) & (tn <= t_far)
    # Padding clusters (lo=+inf, hi=-inf) pass the slab test for every ray.
    cluster_ok = torch.all(mesh.cluster_lo <= mesh.cluster_hi, dim=-1)
    return torch.any(hit_c, dim=1) & cluster_ok[None]


def _survivors(mesh: MeshData, any_hit, cap):
    """The triangles of each block's surviving clusters, as _nearest_hit
    takes them (v0, e1, e2, ok, gid), the chunk that walks them at once, and
    the clusters dropped beyond `cap` per block (nb,)."""
    nb, NC = any_hit.shape
    dev = any_hit.device
    ids = torch.arange(NC, dtype=torch.int32, device=dev)
    idx = torch.where(any_hit, ids[None], torch.full_like(ids, NC)[None])
    n_surv = torch.sum(any_hit.to(torch.int32), dim=1)
    n_dropped = torch.clamp(n_surv - cap, min=0)
    # The JAX package intersects all `cap` slots; the slots past a block's
    # survivors are dead and never hit, so the batch keeps only as many as
    # its fullest block fills (the same first hit, less work).
    keep = max(1, min(cap, int(n_surv.max())))
    if keep > NC:
        idx = torch.cat([idx, torch.full((nb, keep - NC), NC, dtype=torch.int32, device=dev)], 1)
    sel = torch.sort(idx, dim=1).values[:, :keep]  # (nb, keep) ascending
    live = sel < NC
    safe = torch.clamp(sel, max=NC - 1).long()

    def gather(arr):  # (NC*CLUSTER, ...) -> (nb, keep*CLUSTER, ...)
        a = arr.reshape(NC, CLUSTER, *arr.shape[1:])[safe]
        return a.reshape(nb, keep * CLUSTER, *arr.shape[1:])

    oks = gather(mesh.valid) & live.repeat_interleave(CLUSTER, dim=1)
    gids = (safe[..., None] * CLUSTER + torch.arange(CLUSTER, device=dev)).reshape(nb, -1)
    return (gather(mesh.v0), gather(mesh.e1), gather(mesh.e2), oks, gids), keep * CLUSTER, n_dropped


@spanned("mesh_tracer.trace")
def trace(
    mesh: MeshData,
    rays_o: torch.Tensor,  # (..., 3)
    rays_d: torch.Tensor,  # (..., 3) need not be unit; t is in units of |d|
    t_min: float = 1e-3,
    t_far: float = T_FAR,
    use_cull: bool = True,
    cull_cap: int | None = None,
    block_mask: torch.Tensor | None = None,  # (R/per_block,) bool
) -> dict:
    """Nearest-hit trace. Returns dict with pos (..., 3), normal (..., 3),
    depth (...,), tri (...,), bary (..., 2) and cull_dropped (int, clusters
    beyond cull_cap; 0 = exact). Miss: depth = t_far, tri = -1,
    pos = o + t_far * d, normal = 0.

    use_cull enables the Morton-cluster AABB pre-cull, exact while
    cull_dropped == 0; cull_cap (default 64 clusters = 4096 triangles per
    256-ray block) bounds each block's survivor list. block_mask=False blocks
    report a miss for every ray and are not intersected; it requires the ray
    count to be a multiple of the block size."""
    shape = rays_o.shape[:-1]
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    R = o.shape[0]
    dev = o.device
    NC = mesh.n_clusters
    per_block = 256 if use_cull else RAY_BLOCK
    R_pad = max(per_block, ((R + per_block - 1) // per_block) * per_block)
    o = torch.cat([o, torch.zeros((R_pad - R, 3), dtype=o.dtype, device=dev)])
    d = torch.cat([d, torch.ones((R_pad - R, 3), dtype=d.dtype, device=dev)])
    n_blk = R_pad // per_block
    if block_mask is None:
        mask = torch.ones((n_blk,), dtype=torch.bool, device=dev)
    else:
        if R != R_pad or block_mask.shape != (n_blk,):
            raise ValueError(f"block_mask {tuple(block_mask.shape)} needs {n_blk} full blocks of {per_block} rays")
        mask = block_mask
    ob = o.reshape(n_blk, per_block, 3)
    db = d.reshape(n_blk, per_block, 3)
    t = torch.full((n_blk, per_block), float("inf"), device=dev)
    tri = torch.full((n_blk, per_block), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n_blk, per_block), device=dev)
    v = torch.zeros((n_blk, per_block), device=dev)
    active = torch.nonzero(mask).squeeze(1)

    if use_cull:
        gran = TRI_CHUNK // CLUSTER
        cap = cull_cap or min(NC, 64)
        cap = min(max(((cap + gran - 1) // gran) * gran, gran), ((NC + gran - 1) // gran) * gran)
        per_blk_bytes = 4 * per_block * max(cap * CLUSTER, NC * 3) * 12
    else:
        per_blk_bytes = 4 * per_block * TRI_CHUNK * 12
    step = max(1, BATCH_BYTES // per_blk_bytes)
    # Each batch of blocks is spans of a few dozen ops (cull, select, hit
    # with nearest inside it), each freeing its temporaries and storing its
    # results before it ends, so that a trace names the owner of the host's
    # time between the ops. The dropped clusters are summed on the device.
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, active.numel(), step):
        with span("mesh_tracer.cull"):
            blk = active[i : i + step]
            o_b, d_b = ob[blk], db[blk]
            any_hit = _cluster_hits(mesh, o_b, d_b, t_min, t_far) if use_cull else None
        with span("mesh_tracer.select"):
            if use_cull:
                tris, chunk, n_dropped = _survivors(mesh, any_hit, cap)
                dropped = dropped + n_dropped.sum()
            else:
                nb = blk.numel()
                gid = torch.arange(mesh.n_tris, dtype=torch.int32, device=dev)
                tris = (mesh.v0.expand(nb, -1, -1), mesh.e1.expand(nb, -1, -1), mesh.e2.expand(nb, -1, -1),
                        mesh.valid.expand(nb, -1), gid.expand(nb, -1))
                chunk = TRI_CHUNK
            del any_hit
        _nearest_hit(*tris, o_b, d_b, t_min, t_far, chunk, (t, tri, u, v), blk)
        del tris
    with span("mesh_tracer.output"):
        t, tri, u, v = (x.reshape(-1)[:R] for x in (t, tri, u, v))

        hit = tri >= 0
        t_out = torch.where(hit, t, torch.full_like(t, t_far))
        o, d = o[:R], d[:R]
        pos = o + t_out[:, None] * d
        nrm = torch.where(hit[:, None], mesh.normal[torch.clamp(tri, min=0).long()], torch.zeros((), device=dev))
        return {
            "pos": pos.reshape(*shape, 3),
            "normal": nrm.reshape(*shape, 3),
            "depth": t_out.reshape(shape),
            "tri": torch.where(hit, tri, torch.full_like(tri, -1)).reshape(shape),
            "bary": torch.stack([u, v], -1).reshape(*shape, 2),
            "cull_dropped": int(dropped),
        }


def interpolate_attr(mesh: MeshData, name: str, tri: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Barycentric vertex-attribute interpolation at hit points: tri (...,),
    bary (..., 2) = (u, v), the weight of v0 is 1 - u - v (raytracer.py:176-199)."""
    vals = mesh.attrs[name]  # (V, C)
    ids = mesh.triangles[torch.clamp(tri, min=0).long()].long()  # (..., 3)
    tv = vals[ids]  # (..., 3, C)
    u, v = bary[..., 0:1], bary[..., 1:2]
    w = torch.cat([1.0 - u - v, u, v], dim=-1)
    return torch.sum(tv * w[..., None], dim=-2)


def secondary_color(mesh: MeshData, envmap, hit: dict, rays_d: torch.Tensor) -> torch.Tensor:
    """Colour seen along secondary rays (raytracer.py:208-273
    secondary_indirect_color): a miss fetches the env map along the ray, a
    hit shades the vertex materials there with the split sum. A mesh without
    attributes shades with diffuse 0, metallic 0, roughness 1, albedo 0.5 and
    the geometric normal."""
    miss_color = envmap(normalize(rays_d), mode="pure_env")
    tri, bary = hit["tri"], hit["bary"]

    def attr_or(name, default):
        if name in mesh.attrs:
            return interpolate_attr(mesh, name, tri, bary)
        return torch.tensor(default, dtype=torch.float32, device=tri.device).expand(*tri.shape, len(default))

    diffuse = attr_or("diffuse", (0.0, 0.0, 0.0))
    metallic = attr_or("metallic", (0.0,))
    rough = attr_or("roughness", (1.0,))
    albedo = attr_or("albedo", (0.5, 0.5, 0.5))
    if "normal" in mesh.attrs:
        nrm = interpolate_attr(mesh, "normal", tri, bary) * 2.0 - 1.0
    else:
        nrm = hit["normal"]

    w_o = -normalize(rays_d)
    rays_l = normalize(reflect(w_o, nrm))
    NoV = torch.sum(w_o * nrm, dim=-1, keepdim=True)
    fg = sample_fg_lut(NoV[..., 0], rough[..., 0])  # per ray (module doc)
    direct = envmap(rays_l, roughness=rough)
    spec_w = (0.04 * (1 - metallic) + albedo * metallic) * fg[..., 0:1] + fg[..., 1:2]
    hit_color = (1 - metallic) * diffuse + spec_w * direct
    return torch.where((tri >= 0)[..., None], hit_color, miss_color)


def shade_one_bounce(
    mesh: MeshData,
    envmap,
    surface_pos: torch.Tensor,  # (..., 3)
    rays_n: torch.Tensor,  # (..., 3) surface normal
    rays_v: torch.Tensor,  # (..., 3) unit view direction, pointing off the surface
    cull_cap: int | None = None,
    block_mask: torch.Tensor | None = None,  # see trace()
) -> dict:
    """One-bounce indirect light at surface points (raytracer.py:274-300
    shade, refl_utils.py:120-150): reflect the view ray, nearest-hit the
    mesh, and return the colour seen along the bounce with the visibility:
    {indirect (..., 3), visibility (..., 1), depth (...,), cull_dropped}."""
    incident = normalize(reflect(rays_v, rays_n))
    hit = trace(mesh, surface_pos, incident, cull_cap=cull_cap, block_mask=block_mask)
    indirect = secondary_color(mesh, envmap, hit, incident)
    vis = (hit["depth"] >= T_FAR).to(torch.float32)[..., None]
    return {"indirect": indirect, "visibility": vis, "depth": hit["depth"], "cull_dropped": hit["cull_dropped"]}


def bake_vertex_attrs(model, vertices: np.ndarray, k: int = 4) -> dict:
    """Bake the gaussians' materials onto mesh vertices by inverse-distance
    weighting over the k nearest alive gaussians (the JAX package's stand-in
    for the reference's attribute-baked PLY, raytracer.py:60-81). Returns the
    build_mesh attrs (diffuse/roughness/albedo/metallic/normal, normal in
    [0, 1]) as float32 numpy; the neighbour search is scipy's cKDTree on
    float32 inputs, as in the JAX package, so ties resolve alike."""
    from scipy.spatial import cKDTree

    with torch.no_grad():
        xyz = model.xyz.detach().cpu().numpy()
        alive = model.alive.cpu().numpy()
        sel = alive if alive.any() else np.ones_like(alive)
        dist, idx = cKDTree(xyz[sel]).query(np.asarray(vertices, np.float32), k=k)
        w = 1.0 / np.maximum(dist, 1e-8)
        w = w / w.sum(-1, keepdims=True)  # (V, k)

        def gather(t):
            a = t.detach().cpu().numpy()[sel]
            return np.einsum("vk,vkc->vc", w, a[idx]).astype(np.float32)

        albedo = gather(torch.sigmoid(model.ori_color))
        metallic = gather(torch.sigmoid(model.refl_strength))
        rough = gather(torch.sigmoid(model.roughness))
        normals = gather(model.get_world_normal())
    nn = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-8)
    return {
        "diffuse": (1.0 - metallic) * albedo,
        "albedo": albedo,
        "metallic": metallic,
        "roughness": rough,
        "normal": nn * 0.5 + 0.5,
    }
