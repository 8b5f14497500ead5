"""Forward render paths (reference gaussian_renderer/__init__.py).

  render_initial (ref :94)  — plain 2DGS RGB from SH, no materials.
  render_surfel  (ref :225) — deferred: rasterize base color + feature vector
      [refl, rough, ori_color(3), indirect(3), distance], then per-pixel
      split-sum shading; final = (1-refl)*base + specular, bg composited last.

All outputs channel-last (H, W, C). The PGSR-flavor unbiased depth is
reconstructed from the composited plane-distance and normal maps:
depth = dist / <n_view, K^-1 (u,v,1)>.

Not in this slice: ASG indirect light (raises NotImplementedError), traced
visibility / indirect light (surfel2 and the mesh-traced residual) and
render_volume, which come with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.models.env_light import EnvLightMips
from materialrefgs_torch.models.gaussian_model import GaussianModel
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig, rasterize
from materialrefgs_torch.render import shading
from materialrefgs_torch.utils import sh as sh_utils
from materialrefgs_torch.utils.point import depth_to_normal
from materialrefgs_torch.utils.transforms import (
    flip_align_view,
    linear_to_srgb,
    normalize,
    reflect,
)


@dataclass(frozen=True)
class RenderOptions:
    depth_ratio: float = 0.0  # 2DGS expected/median blend (pipe.depth_ratio)
    use_asg: bool = False  # ASG vs SH indirect (pipe.use_asg)
    unbiased_depth: bool = True  # PGSR flavor
    srgb: bool = False
    raster: RasterizeConfig = RasterizeConfig()


def _gaussian_normals(pc: GaussianModel, camera: Camera):
    """World normals flipped toward the viewer (gaussian_model.py:268-284)."""
    dir_pp = normalize(pc.xyz - camera.camera_center[None, :])
    n, _ = flip_align_view(pc.get_world_normal(), dir_pp)
    return normalize(n), dir_pp


def _local_distance(pc: GaussianModel, camera: Camera, normals: torch.Tensor):
    """Per-gaussian |<n_view, p_view>| plane distance (get_distance,
    gaussian_renderer/__init__.py:32-40)."""
    Rv = camera.world_view[:3, :3]
    local_n = normals @ Rv
    p_cam = pc.xyz @ Rv + camera.world_view[3, :3]
    return torch.abs(torch.sum(local_n * p_cam, dim=-1, keepdim=True))


def _indirect_light(pc: GaussianModel, camera: Camera, opts: RenderOptions):
    if opts.use_asg:
        raise NotImplementedError(
            "ASG indirect light (use_asg) is not ported yet; it comes with the "
            "surfel2 slice of the port"
        )
    normals, dir_pp = _gaussian_normals(pc, camera)
    refl = reflect(-dir_pp, normals)
    shs = pc.get_indirect().transpose(1, 2)  # (P, 3, K)
    indirect = torch.clamp(sh_utils.eval_sh(pc.max_sh_degree, shs, normalize(refl)), min=0.0)
    return indirect, normals


def _unpack_regularizations(out: dict, camera: Camera, opts: RenderOptions, rend_distance=None):
    """compute_2dgs_normal_and_regularizations (gaussian_renderer/__init__.py:42-90)."""
    render_alpha = out["alpha"][..., None]  # (H, W, 1)
    Rv = camera.world_view[:3, :3]
    render_normal = out["normal"] @ Rv.T  # kernel composites view-space normals

    depth_median = torch.nan_to_num(out["median_depth"], nan=0.0)
    depth_expected = torch.nan_to_num(
        out["depth"] / torch.clamp(render_alpha[..., 0], min=1e-12), nan=0.0
    )
    depth_expected = torch.where(
        render_alpha[..., 0] > 0, depth_expected, torch.zeros_like(depth_expected)
    )

    if opts.unbiased_depth and rend_distance is not None:
        # PGSR: per-pixel plane distance / <n_view, ray_cam>.
        rays_cam = camera.get_rays()  # (H, W, 3), z=1
        denom = torch.abs(torch.sum(out["normal"] * rays_cam, dim=-1))
        surf_depth = torch.where(
            denom > 1e-6,
            rend_distance[..., 0] / torch.clamp(denom, min=1e-6),
            torch.zeros_like(denom),
        )
        surf_depth = torch.nan_to_num(surf_depth, nan=0.0)
    else:
        surf_depth = depth_expected * (1 - opts.depth_ratio) + opts.depth_ratio * depth_median

    surf_normal = depth_to_normal(camera, surf_depth) * render_alpha

    return {
        "rend_alpha": render_alpha,
        "rend_normal": render_normal,
        "render_depth_median": depth_median,
        "render_depth_expected": depth_expected,
        "rend_dist": out["distortion"],
        "surf_depth": surf_depth,
        "surf_normal": surf_normal,
    }


def _zeros3(device) -> torch.Tensor:
    return torch.zeros(3, dtype=torch.float32, device=device)


def render_initial(
    pc: GaussianModel,
    camera: Camera,
    bg_color: torch.Tensor,
    opts: RenderOptions = RenderOptions(),
) -> dict:
    """Plain 2DGS render (gaussian_renderer/__init__.py:94-222)."""
    colors = pc.get_colors(camera.camera_center)
    feats = torch.zeros((pc.capacity, 1), dtype=torch.float32, device=pc.device)
    out = rasterize(
        pc.xyz, pc.get_scaling, pc.get_rotation, pc.get_opacity[:, 0], colors, feats,
        camera, _zeros3(pc.device), config=opts.raster,
    )
    regs = _unpack_regularizations(out, camera, opts, None)
    image = out["render"]
    if opts.srgb:
        image = linear_to_srgb(image)
    image = image + bg_color[None, None, :] * (1 - regs["rend_alpha"])
    return {
        "render": image,
        "radii": out["radii"],
        "visibility_filter": out["radii"] > 0,
        "overflow": out["overflow"],
        **regs,
    }


def render_surfel(
    pc: GaussianModel,
    camera: Camera,
    bg_color: torch.Tensor,
    envmap: EnvLightMips,
    opts: RenderOptions = RenderOptions(),
) -> dict:
    """Deferred-shading render (gaussian_renderer/__init__.py:225-520),
    without traced visibility or indirect light (the surfel2 slice)."""
    colors = pc.get_colors(camera.camera_center)
    refl = pc.get_refl
    rough = pc.get_rough
    ori_color = pc.get_ori_color
    indirect, normals = _indirect_light(pc, camera, opts)
    distance = _local_distance(pc, camera, normals)

    feats = torch.cat([refl, rough, ori_color, indirect, distance], dim=-1)
    out = rasterize(
        pc.xyz, pc.get_scaling, pc.get_rotation, pc.get_opacity[:, 0], colors, feats,
        camera, _zeros3(pc.device), config=opts.raster,
    )

    f = out["feature"]
    refl_map = f[..., 0:1]
    rough_map = f[..., 1:2]
    albedo_map = f[..., 2:5]
    indirect_map = f[..., 5:8]
    dist_map = f[..., 8:9]
    base_color = out["render"]  # bg=0 inside

    regs = _unpack_regularizations(out, camera, opts, dist_map)
    render_alpha = regs["rend_alpha"]

    results = {
        "refl_strength_map": refl_map,
        "base_color_map": albedo_map,
        "roughness_map": rough_map,
        "rend_distance": dist_map,
        "radii": out["radii"],
        "visibility_filter": out["radii"] > 0,
        "overflow": out["overflow"],
        **regs,
    }

    # Deferred shading with the world-space normal map divided by alpha
    # (render_surfel:424-427).
    normal_map = regs["rend_normal"] / torch.clamp(render_alpha, min=1e-6)
    specular, extra = shading.specular_color_surfel(
        envmap, albedo_map, camera, normal_map, render_alpha, refl_map, rough_map,
    )

    final = (1 - refl_map) * base_color + specular
    albedo_out = albedo_map
    if opts.srgb:
        final = linear_to_srgb(final)
        albedo_out = linear_to_srgb(albedo_map)
        specular = linear_to_srgb(specular)
    final = final + bg_color[None, None, :] * (1 - render_alpha)

    results.update(
        {
            "render": final,
            "diffuse_map": (1 - refl_map) * base_color,
            "diffuse_map_ori": base_color,
            "specular_map": specular,
            "base_color_map": albedo_out,
            "indirect_map": indirect_map,
            **extra,
        }
    )
    return results
