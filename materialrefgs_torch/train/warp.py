"""Multi-view consistency losses (the JAX package's train/warp.py; reference
train_refnerf.py:414-745 calc_warp_loss and scene/gaussian_model.py:1081-1116
depth helpers), as plain torch.

The variable-size set of valid pixels becomes a fixed `sample_num` random
choice with zero weights on invalid samples (masked means), as in the JAX
package. The random scores are an argument (`uniforms`, one per pixel, drawn
by the caller from its own generator), so both packages can pick the same
pixels. The edge mask is a Sobel-magnitude threshold + max-pool dilation of
the rendered normals, not the reference's cv2.Canny (a documented divergence
of the JAX package).

Gradient contract, as in the JAX package: `grid_sample`'s bilinear weights
use jnp.clip's tie gradient (half at a bound) so coordinate gradients match;
`abs_` takes jnp.abs's gradient (+1 at 0, where a masked-out or
max/min-picked sample meets its target exactly); every masked reduction
keeps a `torch.where` (0 * NaN is NaN); each
stop_gradient is a `.detach()` in the same place; each structural gate is a
Python `if`, so a term that is off is not evaluated at all.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.config import OptimizationParams
from materialrefgs_torch.train.losses import lncc, spatial_gradient
from materialrefgs_torch.utils.transforms import abs_, clip, normalize


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample. img (H, W, C); coords (..., 2) in [-1, 1] (x, y).
    Matches F.grid_sample(align_corners=True) in value, with zero padding
    (out-of-bounds taps vanish: the warp's foreground min-mask relies on it),
    but at an integer coordinate its weight takes jnp.clip's gradient, half
    of F.grid_sample's."""
    H, W = img.shape[:2]
    x, y = coords[..., 0], coords[..., 1]
    fx = (x + 1) * (W - 1) / 2
    fy = (y + 1) * (H - 1) / 2
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    wx = clip(fx - x0f, 0.0, 1.0)[..., None]
    wy = clip(fy - y0f, 0.0, 1.0)[..., None]

    def tap(yf, xf):
        ok = (xf >= 0) & (xf < W) & (yf >= 0) & (yf < H)
        # A non-finite coordinate reads any texel: ok is False there, and the
        # JAX package's float -> int conversion differs from torch's.
        xi = torch.clamp(torch.nan_to_num(xf, nan=0.0), 0, W - 1).long()
        yi = torch.clamp(torch.nan_to_num(yf, nan=0.0), 0, H - 1).long()
        return img[yi, xi] * ok[..., None]

    c00 = tap(y0f, x0f)
    c01 = tap(y0f, x0f + 1)
    c10 = tap(y0f + 1, x0f)
    c11 = tap(y0f + 1, x0f + 1)
    return c00 * (1 - wx) * (1 - wy) + c01 * wx * (1 - wy) + c10 * (1 - wx) * wy + c11 * wx * wy


def patch_offsets(h_patch_size: int, device=None) -> torch.Tensor:
    """(1, (2p+1)^2, 2) pixel offsets (utils/graphics_utils.py:230)."""
    r = torch.arange(-h_patch_size, h_patch_size + 1, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(r, r, indexing="xy")
    return torch.stack([gx, gy], dim=-1).reshape(1, -1, 2)


def patch_warp(Hmat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Apply homographies: Hmat (B, 3, 3), uv (B, P, 2) pixel coords
    (utils/graphics_utils.py:234-244)."""
    homo = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    out = torch.einsum("bik,bpk->bpi", Hmat, homo)
    return out[..., :2] / (out[..., 2:3] + 1e-10)


def edges_mask_from_normal(normal_map: torch.Tensor, dilate_size: int = 7,
                           thresh: float = 80.0 / 255.0) -> torch.Tensor:
    """(H, W, 3) -> (H, W) bool: True where NOT near a normal edge."""
    gray = torch.mean(normal_map.detach(), dim=-1, keepdim=True)
    grad = spatial_gradient(gray)  # (H, W, 1, 2)
    mag = torch.sqrt(torch.sum(grad**2, dim=-1))[..., 0] * 8.0  # unnormalize sobel
    edges = (mag > thresh).to(torch.float32)
    k = dilate_size
    # lax.reduce_window(max, 2k+1, SAME, init -inf): max_pool2d pads with -inf.
    dil = F.max_pool2d(edges[None, None], 2 * k + 1, stride=1, padding=k)[0, 0]
    return dil < 0.5


def points_from_depth(camera: Camera, depth: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H*W, 3) world points (gaussian_model.py:1104-1116)."""
    rays_d = camera.get_rays()  # camera-space, z=1
    pts_cam = (rays_d * depth[..., None]).reshape(-1, 3)
    # world_view[:3,:3] = R_w2c^T (row-vector); world = (cam - T) @ R^T.
    R = camera.world_view[:3, :3]
    T = camera.world_view[3, :3]
    return (pts_cam - T) @ R.T


def points_depth_in_depth_map(camera: Camera, depth_map: torch.Tensor, pts_cam: torch.Tensor):
    """Bilinear-sample `depth_map` at the projections of pts_cam
    (gaussian_model.py:1081-1103). Returns (map_z (N,), in_bounds (N,))."""
    W, H = camera.width, camera.height
    px = pts_cam[:, 0] * camera.fx / pts_cam[:, 2] + camera.cx
    py = pts_cam[:, 1] * camera.fy / pts_cam[:, 2] + camera.cy
    mask = (px > 0) & (px < W) & (py > 0) & (py < H) & (pts_cam[:, 2] > 0.1)
    gx = px / ((W - 1) / 2) - 1
    gy = py / ((H - 1) / 2) - 1
    z = grid_sample(depth_map[..., None], torch.stack([gx, gy], -1))[:, 0]
    return z, mask


class WarpLosses(NamedTuple):
    geo_loss: torch.Tensor
    ncc_loss: torch.Tensor
    base_color_loss: torch.Tensor
    metallic_warp_loss: torch.Tensor
    roughness_warp_loss: torch.Tensor
    weights_map: torch.Tensor  # (H, W) geometry-consistency weights


def robust_L(d: torch.Tensor, gamma: float = 0.2, delta: float = 5.0) -> torch.Tensor:
    """train_refnerf.py:641-645 robust penalty."""
    lo = (d / gamma) ** 3 * gamma
    hi = d + 1.0 / delta * (torch.exp(delta * (d - gamma)) - 1.0)
    return torch.where(d < gamma, lo, hi)


def _project(camera: Camera, pts_view: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [pts_view[:, 0] * camera.fx / pts_view[:, 2] + camera.cx,
         pts_view[:, 1] * camera.fy / pts_view[:, 2] + camera.cy],
        dim=-1,
    )


def pixel_grid(H: int, W: int, device) -> torch.Tensor:
    """(H*W, 2) integer pixel coordinates (x, y), row-major."""
    iy, ix = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([ix, iy], dim=-1).reshape(-1, 2)


def norm_coords(p: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Pixel coordinates (..., 2) -> grid_sample's [-1, 1] (align_corners)."""
    return torch.stack([2 * p[..., 0] / (W - 1) - 1, 2 * p[..., 1] / (H - 1) - 1], dim=-1)


def plane_homography(camera: Camera, nearest_camera: Camera, normal: torch.Tensor, distance: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """(B, 3, 3) plane-induced homographies ref -> nearest from world normals
    (B, 3) and plane distances (B,) (train_refnerf.py:570-584)."""
    Rv, Tv = camera.world_view[:3, :3], camera.world_view[3, :3]
    Rn, Tn = nearest_camera.world_view[:3, :3], nearest_camera.world_view[3, :3]
    R_rel = Rn.T @ Rv
    t_rel = -R_rel @ Tv + Tn
    local_n = normal @ Rv
    Hrel = R_rel[None] - torch.einsum("i,bj->bij", t_rel, local_n) / torch.maximum(
        distance, distance.new_tensor(1e-8))[:, None, None]
    Hrel = torch.einsum("ij,bjk->bik", nearest_camera.get_K(scale), Hrel)
    return torch.einsum("bij,jk->bik", Hrel, camera.get_inv_K(scale))


def reprojection(camera: Camera, nearest_camera: Camera, depth: torch.Tensor, nearest_depth: torch.Tensor,
                 pixels: torch.Tensor, eps: float = 1e-12):
    """Depth reprojection round trip ref -> nearest -> ref
    (train_refnerf.py:483-516). Returns (pixel_noise (H*W,), in_bounds
    (H*W,)); pixel_noise is sqrt(|proj - pixel|^2 + eps)."""
    pts = points_from_depth(camera, depth)
    Rn, Tn = nearest_camera.world_view[:3, :3], nearest_camera.world_view[3, :3]
    pts_near = pts @ Rn + Tn
    map_z, d_mask = points_depth_in_depth_map(nearest_camera, nearest_depth, pts_near)
    pts_near2 = pts_near / (pts_near[:, 2:3] + 1e-12) * map_z[:, None]
    pts_world2 = (pts_near2 - Tn) @ Rn.T
    pts_view = pts_world2 @ camera.world_view[:3, :3] + camera.world_view[3, :3]
    # NOT torch.linalg.norm: its backward is 0/0 = NaN at an exactly
    # consistent pixel (proj == pixels), and one NaN there poisons the
    # gradients of every splat the pixel touches (the JAX package's warp
    # onset once gave 18k non-finite gradient entries in its first step).
    dproj = _project(camera, pts_view) - pixels
    return torch.sqrt(torch.sum(dproj * dproj, dim=-1) + eps), d_mask


def calc_warp_loss(
    camera: Camera,
    nearest_camera: Camera,
    render_pkg: dict,
    nearest_pkg: dict,
    gt_gray: torch.Tensor,  # (H, W)
    nearest_gray: torch.Tensor,  # (H, W)
    image_mask: torch.Tensor,  # (H, W) foreground mask
    opt: OptimizationParams,
    iteration: float,
    uniforms: torch.Tensor,  # (H*W,) in [0, 1): the random pixel scores
    use_ncc: bool = False,
) -> WarpLosses:
    """Geometry + homography-patch material warp losses
    (train_refnerf.py:414-745); invalid samples carry zero weight."""
    H, W = camera.height, camera.width
    dev = render_pkg["surf_depth"].device
    patch_size = opt.multi_view_patch_size
    total_patch = (2 * patch_size + 1) ** 2
    sample_num = min(opt.multi_view_sample_num, H * W)
    it = float(iteration)

    pixels_all = pixel_grid(H, W, dev)
    pixel_noise, d_mask = reprojection(camera, nearest_camera, render_pkg["surf_depth"],
                                       nearest_pkg["surf_depth"], pixels_all)
    if not opt.wo_use_geo_occ_aware:
        d_mask = d_mask & (pixel_noise < opt.multi_view_pixel_noise_th)
        weights = (1.0 / torch.exp(pixel_noise)).detach()
    else:
        weights = torch.ones_like(pixel_noise)
    weights = torch.where(d_mask, weights, torch.zeros_like(weights))

    n_valid = torch.clamp(torch.sum(d_mask), min=1)
    zero = pixel_noise.new_zeros(())
    # geo_loss is computed by every reference trainer but applied only by
    # refreal; the gate is structural, so that an unapplied term's backward
    # cannot leak a NaN through 0 * NaN.
    geo_loss = zero
    if opt.use_warp_geo_loss:
        geo_loss = opt.multi_view_geo_weight * torch.sum(weights * pixel_noise) / n_valid

    # Random subset of valid pixels: lax.top_k of the uniforms, -1 where
    # invalid. A stable descending sort breaks ties by the lower index, as
    # top_k does; ties among the -1 of invalid pixels could not change the
    # result anyway, since every invalid sample has weight 0.
    score = torch.where(d_mask, uniforms, uniforms.new_tensor(-1.0))
    idx = torch.sort(score, descending=True, stable=True).indices[:sample_num]
    sel_valid = d_mask[idx]
    w_sel = weights[idx].detach() * sel_valid

    pixels = pixels_all[idx]  # (N, 2)
    ori_patch = pixels[:, None, :] + patch_offsets(patch_size, dev)  # (N, P, 2)

    patch_ref = norm_coords(ori_patch, H, W)
    Hrel = plane_homography(camera, nearest_camera, render_pkg["rend_normal"].reshape(-1, 3)[idx],
                       render_pkg["rend_distance"].reshape(-1)[idx])
    patch_near = norm_coords(patch_warp(Hrel, ori_patch), H, W)  # (N, P, 2)

    def sample_map(mp, coords):
        return grid_sample(mp, coords.reshape(-1, 2)).reshape(sample_num, total_patch, -1)

    # NCC photometric patch loss (the refreal path, get_consistency_loss2,
    # train_refreal.py:358-396): its gradient flows through the warp
    # coordinates (homography <- normals/distance); a no-grad reflectivity
    # gate skips pixels whose mean metallic across the two views is >= 0.2.
    ncc_loss = zero
    if use_ncc:
        ref_gray = sample_map(gt_gray[..., None], patch_ref)[..., 0]
        near_gray = sample_map(nearest_gray[..., None], patch_near)[..., 0]
        refl_ref = sample_map(render_pkg["refl_strength_map"].detach(), patch_ref)[..., 0].mean(dim=-1)
        refl_nst = sample_map(nearest_pkg["refl_strength_map"].detach(), patch_near.detach())[..., 0].mean(dim=-1)
        not_reflective = (refl_ref + refl_nst) < 0.4
        ncc, ncc_mask = lncc(ref_gray, near_gray)
        m = ncc_mask[:, 0] & sel_valid & not_reflective
        ncc_loss = opt.multi_view_ncc_weight * torch.sum(
            torch.where(m, ncc[:, 0] * w_sel, torch.zeros_like(w_sel))) / torch.clamp(torch.sum(m), min=1)

    # Base-color warp (train_refnerf.py:535-548, 639, 696): the current
    # view's samples are constant (the reference's no_grad block) and the
    # nearest view's are taken at detached coordinates, so the warp pulls the
    # nearest view's rendered map toward the current view's through map
    # values only.
    gate_bc = float(it > opt.basecolor_warp_from_iter)
    bc_ref = sample_map(render_pkg["diffuse_map"].detach(), patch_ref)
    bc_near = sample_map(nearest_pkg["diffuse_map"], patch_near.detach())
    bc_diff = torch.mean(torch.sum(abs_(bc_ref - bc_near), dim=-1), dim=-1)
    base_color_loss = (
        gate_bc * 0.1 * opt.multi_view_ncc_weight  # 0.1: get_current_basecolor_warp_weight
        * torch.sum(bc_diff * w_sel) / torch.clamp(torch.sum(sel_valid), min=1)
    )

    metallic_warp_loss = zero
    roughness_warp_loss = zero
    if opt.use_metallic_warp_loss or opt.use_roughness_warp_loss:
        # Edge mask + background mask (train_refnerf.py:446-452, 620-636).
        if opt.edge_aware_in_warp:
            edges_ok = edges_mask_from_normal(render_pkg["rend_normal"], dilate_size=opt.dilate_size).reshape(-1)[idx]
        else:
            edges_ok = torch.ones((sample_num,), dtype=torch.bool, device=dev)
        mask_val = sample_map(image_mask[..., None], patch_ref)[..., 0]
        fg_ok = torch.min(mask_val, dim=-1).values > 0.99
        m = fg_ok & edges_ok & sel_valid
        denom = torch.clamp(torch.sum(m), min=1)

        def directional_warp(name, direction):
            """Directional metallic / roughness alignment
            (train_refnerf.py:650-676); plain symmetric differences when
            directional_rghmtl_warp_alignment is off (:661-662, :675-676).
            The same gradient contract as the base color."""
            a = sample_map(render_pkg[name].detach(), patch_ref)[..., 0]
            b = sample_map(nearest_pkg[name], patch_near.detach())[..., 0]
            if not opt.directional_rghmtl_warp_alignment:
                loss = torch.mean(abs_(a - b), dim=-1) * w_sel
                return torch.sum(torch.where(m, loss, torch.zeros_like(loss))) / denom
            tgt = (torch.maximum(a, b) if direction == "max" else torch.minimum(a, b)).detach()
            vw = torch.mean(tgt, dim=-1) if direction == "max" else 1.0
            loss = vw * torch.mean(abs_(a - tgt), dim=-1) * w_sel
            loss = loss + vw * torch.mean(abs_(b - tgt), dim=-1) * w_sel
            rl = robust_L(loss)
            return torch.sum(torch.where(m, rl, torch.zeros_like(rl))) / denom

        # Their own start gate (train_refnerf.py:1274-1277).
        gate_rm = gate_bc * float(it > opt.rghmtl_warp_loss_start_iter)
        if opt.use_metallic_warp_loss:
            metallic_warp_loss = gate_rm * 0.5 * opt.metallic_warp_weight * directional_warp("refl_strength_map", "max")
        if opt.use_roughness_warp_loss:
            roughness_warp_loss = gate_rm * 0.5 * opt.roughness_warp_weight * directional_warp("roughness_map", "min")

    return WarpLosses(
        geo_loss=geo_loss,
        ncc_loss=ncc_loss,
        base_color_loss=base_color_loss,
        metallic_warp_loss=metallic_warp_loss,
        roughness_warp_loss=roughness_warp_loss,
        weights_map=weights.reshape(H, W),
    )


def mono_normal_loss(
    camera: Camera,
    surf_normal: torch.Tensor,  # (H, W, 3) world
    rend_normal: torch.Tensor,  # (H, W, 3) world
    normal_prior: torch.Tensor,  # (H, W, 3) camera-space prior (Metric3D)
    mask: torch.Tensor | None,  # (H, W)
):
    """Monocular normal prior loss (train_refnerf.py:202-251): rotate world
    normals into the camera frame, L1 + cosine against the prior. Returns
    (l1_surf, cos_surf, l1_rend, cos_rend)."""
    R = camera.world_view[:3, :3]  # world -> camera for row vectors
    gt = normalize(normal_prior.reshape(-1, 3))

    def one(normal):
        n_cam = normalize(normal.reshape(-1, 3) @ R)
        l1 = torch.sum(abs_(n_cam - gt), dim=-1)
        cos = 1.0 - torch.sum(n_cam * gt, dim=-1)
        if mask is None:
            return torch.mean(l1), torch.mean(cos)
        m = mask.reshape(-1)
        denom = torch.clamp(torch.sum(m), min=1)
        return torch.sum(l1 * m) / denom, torch.sum(cos * m) / denom

    l1_s, cos_s = one(surf_normal)
    l1_r, cos_r = one(rend_normal)
    return l1_s, cos_s, l1_r, cos_r
