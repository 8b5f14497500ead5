"""Cubemap ops in plain torch: sampling, mips, diffuse/GGX prefilter.

Replaces the reference's nvdiffrast `dr.texture(..., boundary_mode='cube')`
queries (scene/light.py:99-129) and the renderutils cubemap prefilters.

Face/uv conventions follow scene/light_utils.py cube_to_dir (OpenGL cubemap):
  face 0 (+x): dir = ( 1, -y, -x)      face 1 (-x): dir = (-1, -y,  x)
  face 2 (+y): dir = ( x,  1,  y)      face 3 (-y): dir = ( x, -1, -y)
  face 4 (+z): dir = ( x, -y,  1)      face 5 (-z): dir = (-x, -y, -1)
with texel centers at x,y in linspace(-1+1/R, 1-1/R, R).

Documented divergences from the reference, shared with the JAX package:
bilinear filtering clamps at face edges instead of blending across faces, and
the GGX prefilter uses filtered importance sampling with a fixed Hammersley
pattern.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def cube_to_dir(face: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(x)
    table = {
        0: (one, -y, -x),
        1: (-one, -y, x),
        2: (x, one, y),
        3: (x, -one, -y),
        4: (x, -y, one),
        5: (-x, -y, -one),
    }
    return torch.stack(table[face], dim=-1)


def face_dirs(res: int, device=None) -> torch.Tensor:
    """(6, R, R, 3) unit direction of each texel center."""
    g = torch.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res, device=device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    dirs = torch.stack([cube_to_dir(s, gx, gy) for s in range(6)], dim=0)
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


def dir_to_cube_uv(d: torch.Tensor):
    """Direction (..., 3) -> (face (...,), u (...,), v (...,)) with u,v in [-1,1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    eps = 1e-12
    face = torch.where(
        is_x,
        torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    ).to(torch.int64)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)) + eps
    u = torch.where(
        is_x,
        torch.where(x >= 0, -z, z),
        torch.where(is_y, x, torch.where(z >= 0, x, -x)),
    )
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    return face, u / ma, v / ma


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap fetch, clamped at face edges. cubemap (6, R, R, C);
    dirs (..., 3) -> (..., C). Indices are clipped to [0, R-1] before the
    gather (torch raises on out-of-range gathers)."""
    R = cubemap.shape[1]
    face, u, v = dir_to_cube_uv(dirs)
    tu = (u + 1.0) * (R / 2.0) - 0.5
    tv = (v + 1.0) * (R / 2.0) - 0.5
    u0 = torch.clamp(torch.floor(tu), 0, R - 1)
    v0 = torch.clamp(torch.floor(tv), 0, R - 1)
    u1 = torch.clamp(u0 + 1, 0, R - 1)
    v1 = torch.clamp(v0 + 1, 0, R - 1)
    fu = torch.clamp(tu - u0, 0.0, 1.0)[..., None]
    fv = torch.clamp(tv - v0, 0.0, 1.0)[..., None]
    u0i, u1i, v0i, v1i = (a.to(torch.int64) for a in (u0, u1, v0, v1))

    c00 = cubemap[face, v0i, u0i]  # rows indexed by v (gy), cols by u
    c01 = cubemap[face, v0i, u1i]
    c10 = cubemap[face, v1i, u0i]
    c11 = cubemap[face, v1i, u1i]
    return (
        c00 * (1 - fu) * (1 - fv)
        + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv
        + c11 * fu * fv
    )


def cubemap_avg_pool(cubemap: torch.Tensor) -> torch.Tensor:
    """2x2 average pool per face (scene/light_utils.py cubemap_mip)."""
    six, R, _, C = cubemap.shape
    x = cubemap.reshape(six, R // 2, 2, R // 2, 2, C)
    return x.mean(dim=(2, 4))


def texel_solid_angles(res: int, device=None) -> torch.Tensor:
    """(6, R, R) solid angle of each texel: (2/R)^2 / (x^2+y^2+1)^(3/2)."""
    g = np.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    w = (2.0 / res) ** 2 / np.power(gx**2 + gy**2 + 1.0, 1.5)
    w = np.ascontiguousarray(np.broadcast_to(w, (6, res, res)), np.float32)
    return torch.as_tensor(w, device=device)


def diffuse_convolve(cubemap: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere convolution (renderutils diffuse_cubemap):
    out[n] = sum_t L_t max(n.d_t, 0) w_t / sum_t max(n.d_t, 0) w_t."""
    six, R, _, C = cubemap.shape
    dirs = face_dirs(R, cubemap.device).reshape(-1, 3)
    w = texel_solid_angles(R, cubemap.device).reshape(-1)
    L = cubemap.reshape(-1, C)
    cos = torch.clamp(dirs @ dirs.T, min=0.0)
    wc = cos * w[None, :]
    out = (wc @ L) / torch.sum(wc, dim=1, keepdim=True)
    return out.reshape(six, R, R, C)


def _hammersley(n: int) -> np.ndarray:
    pts = np.zeros((n, 2), np.float64)
    pts[:, 0] = (np.arange(n) + 0.5) / n
    # radical inverse base 2
    b = np.arange(n, dtype=np.uint32)
    b = (b << 16) | (b >> 16)
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    pts[:, 1] = b.astype(np.float64) * 2.3283064365386963e-10
    return pts


@functools.lru_cache(maxsize=16)
def _ggx_sample_dirs(roughness: float, n_samples: int):
    """Tangent-space GGX sample dirs (reflected L for V=N) + NoL weights."""
    uv = _hammersley(n_samples)
    a = roughness * roughness
    cos_h = np.sqrt((1.0 - uv[:, 0]) / (1.0 + (a * a - 1.0) * uv[:, 0]))
    sin_h = np.sqrt(np.maximum(0.0, 1.0 - cos_h**2))
    phi = 2.0 * np.pi * uv[:, 1]
    h = np.stack([sin_h * np.cos(phi), sin_h * np.sin(phi), cos_h], axis=-1)
    # V = N = +z; L = reflect(V, H) = 2(V.H)H - V
    l = 2.0 * h[:, 2:3] * h - np.array([0.0, 0.0, 1.0])
    nol = np.maximum(l[:, 2], 0.0)
    keep = nol > 1e-6
    return l[keep].astype(np.float32), nol[keep].astype(np.float32)


def ggx_prefilter(
    cubemap: torch.Tensor, roughness: float, n_samples: int = 64
) -> torch.Tensor:
    """Split-sum GGX prefilter: out[n] = sum_s L(rot_n(l_s)) NoL_s / sum NoL_s,
    filtered importance sampling around each texel's direction."""
    if roughness < 1e-3:
        return cubemap
    six, R, _, C = cubemap.shape
    dev = cubemap.device
    n = face_dirs(R, dev)  # (6,R,R,3)
    l_np, nol_np = _ggx_sample_dirs(float(roughness), n_samples)
    l_tan = torch.as_tensor(l_np, device=dev)
    nol = torch.as_tensor(nol_np, device=dev)
    # Per-texel tangent frames (branchless: pick a helper axis).
    helper = torch.where(
        torch.abs(n[..., 2:3]) < 0.999,
        torch.tensor([0.0, 0.0, 1.0], device=dev),
        torch.tensor([1.0, 0.0, 0.0], device=dev),
    )
    t = torch.linalg.cross(helper, n, dim=-1)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    b = torch.linalg.cross(n, t, dim=-1)

    world = (
        l_tan[:, None, None, None, 0:1] * t[None]
        + l_tan[:, None, None, None, 1:2] * b[None]
        + l_tan[:, None, None, None, 2:3] * n[None]
    )  # (M, 6, R, R, 3)
    samples = sample_cubemap(cubemap, world)  # (M, 6, R, R, C)
    acc = torch.tensordot(nol, samples, dims=([0], [0]))  # (6, R, R, C)
    return acc / torch.sum(nol)


def build_mip_chain(
    base: torch.Tensor,
    min_res: int = 16,
    min_roughness: float = 0.08,
    max_roughness: float = 0.5,
    n_samples: int = 64,
):
    """EnvLight.build_mips (scene/light.py:72-90): avg-pool chain, GGX-filter
    each level with linearly mapped roughness, diffuse-convolve the smallest.

    Returns (specular_levels: list[(6,r,r,C)], diffuse: (6,min_res,min_res,C))."""
    pooled = [base]
    while pooled[-1].shape[1] > min_res:
        pooled.append(cubemap_avg_pool(pooled[-1]))
    L = len(pooled)
    diffuse = diffuse_convolve(pooled[-1])
    specular = []
    for idx in range(L - 1):
        rough = (idx / max(L - 2, 1)) * (max_roughness - min_roughness) + min_roughness
        specular.append(ggx_prefilter(pooled[idx], rough, n_samples))
    specular.append(ggx_prefilter(pooled[-1], 1.0, n_samples))
    return specular, diffuse


def get_mip(
    roughness: torch.Tensor,
    num_levels: int,
    min_roughness: float = 0.08,
    max_roughness: float = 0.5,
) -> torch.Tensor:
    """scene/light.py:88-96 roughness -> fractional mip level."""
    lo = (
        (torch.clamp(roughness, min_roughness, max_roughness) - min_roughness)
        / (max_roughness - min_roughness)
        * (num_levels - 2)
    )
    hi = (torch.clamp(roughness, max_roughness, 1.0) - max_roughness) / (
        1.0 - max_roughness
    ) + num_levels - 2
    return torch.where(roughness < max_roughness, lo, hi)


def sample_mip_chain(levels: list, dirs: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """Trilinear: bilinear per level + linear between adjacent mip levels."""
    L = len(levels)
    mip = torch.clamp(mip, 0.0, L - 1.0)
    lo = torch.clamp(torch.floor(mip).to(torch.int64), 0, L - 1)
    frac = (mip - lo.to(mip.dtype))[..., None]
    samples = torch.stack([sample_cubemap(lv, dirs) for lv in levels], dim=0)
    C = samples.shape[-1]
    idx_lo = lo[None, ..., None].expand((1,) + lo.shape + (C,))
    take_lo = torch.gather(samples, 0, idx_lo)[0]
    hi = torch.clamp(lo + 1, max=L - 1)
    idx_hi = hi[None, ..., None].expand((1,) + hi.shape + (C,))
    take_hi = torch.gather(samples, 0, idx_hi)[0]
    return take_lo * (1 - frac) + take_hi * frac


def cubemap_to_latlong(cubemap: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(6, R, R, C) -> (H, W, C) equirectangular (scene/light_utils.py:50-64)."""
    dev = cubemap.device
    gy = torch.linspace(0.0 + 1.0 / H, 1.0 - 1.0 / H, H, device=dev)[:, None]
    gx = torch.linspace(-1.0 + 1.0 / W, 1.0 - 1.0 / W, W, device=dev)[None, :]
    sintheta, costheta = torch.sin(gy * np.pi), torch.cos(gy * np.pi)
    sinphi, cosphi = torch.sin(gx * np.pi), torch.cos(gx * np.pi)
    refl = torch.stack(
        [
            (sintheta * sinphi).expand(H, W),
            costheta.expand(H, W),
            (-sintheta * cosphi).expand(H, W),
        ],
        dim=-1,
    )
    return sample_cubemap(cubemap, refl)


def latlong_to_cubemap(latlong: torch.Tensor, res: int) -> torch.Tensor:
    """(H, W, C) equirectangular -> (6, res, res, C) cubemap
    (scene/light_utils.py:34-47), bilinear: the longitude wraps (dr.texture's
    default boundary; a clamp would leave a seam at the +-pi meridian) and
    the latitude clamps."""
    H, W, _ = latlong.shape
    v = face_dirs(res, device=latlong.device)  # (6, res, res, 3), unit
    tu = torch.atan2(v[..., 0], -v[..., 2]) / (2 * np.pi) + 0.5
    tv = torch.arccos(torch.clamp(v[..., 1], -1, 1)) / np.pi
    x = tu * W - 0.5
    y = tv * H - 0.5
    x0f = torch.floor(x)
    x0 = torch.remainder(x0f, W)
    x1 = torch.remainder(x0f + 1, W)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    fx = torch.clamp(x - x0f, 0, 1)[..., None]
    fy = torch.clamp(y - y0, 0, 1)[..., None]
    x0, x1, y0, y1 = (a.long() for a in (x0, x1, y0, y1))
    return (
        latlong[y0, x0] * (1 - fx) * (1 - fy)
        + latlong[y0, x1] * fx * (1 - fy)
        + latlong[y1, x0] * (1 - fx) * fy
        + latlong[y1, x1] * fx * fy
    )
