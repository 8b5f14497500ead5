"""Forward render paths (reference gaussian_renderer/__init__.py).

  render_initial (ref :94)  — plain 2DGS RGB from SH, no materials.
  render_surfel  (ref :225) — deferred: rasterize base color + feature vector
      [refl, rough, ori_color(3), indirect(3), distance], then per-pixel
      split-sum shading; final = (1-refl)*base + specular, bg composited last.

All outputs channel-last (H, W, C). The PGSR-flavor unbiased depth is
reconstructed from the composited plane-distance and normal maps:
depth = dist / <n_view, K^-1 (u,v,1)>.

The env-GS composite (`render_surfel2`) lives in render/envgs.py; its
mesh-traced visibility is `mesh_visibility_map` below. The indirect light
rasterized per gaussian is SH or, with use_asg, ASG lobes (utils/asg.py).
Given a mesh (the raytracing_residual flavor), `render_surfel` takes its
visibility and indirect light from `mesh_indirect_maps`, the mesh-traced
one-bounce shading. Not ported yet: render_volume (the volume stage).
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
from materialrefgs_torch.utils.asg import eval_asg_indirect
from materialrefgs_torch.utils.point import depth_to_normal
from materialrefgs_torch.utils.transforms import (
    flip_align_view,
    linear_to_srgb,
    normalize,
    reflect,
    relu0,
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
    normals, dir_pp = _gaussian_normals(pc, camera)
    refl = reflect(-dir_pp, normals)
    if opts.use_asg:
        return eval_asg_indirect(pc.indirect_asg, normals, refl), normals
    shs = pc.get_indirect().transpose(1, 2)  # (P, 3, K)
    indirect = relu0(sh_utils.eval_sh(pc.max_sh_degree, shs, normalize(refl)))
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

    surf_normal = depth_to_normal(camera, surf_depth) * render_alpha.detach()

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
    mean2d_offset: torch.Tensor | None = None,
) -> dict:
    """Plain 2DGS render (gaussian_renderer/__init__.py:94-222).
    mean2d_offset: see ops/rasterize/api.rasterize (densification stats)."""
    colors = pc.get_colors(camera.camera_center)
    feats = torch.zeros((pc.capacity, 1), dtype=torch.float32, device=pc.device)
    out = rasterize(
        pc.xyz, pc.get_scaling, pc.get_rotation, pc.get_opacity[:, 0], colors, feats,
        camera, _zeros3(pc.device), config=opts.raster, mean2d_offset=mean2d_offset,
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
    envmap: EnvLightMips | None,
    opts: RenderOptions = RenderOptions(),
    mean2d_offset: torch.Tensor | None = None,
    wo_render_img: bool = False,
    mesh=None,  # ops.mesh_tracer.MeshData: the raytracing_residual branch
    mesh_cull_cap: int | None = None,
) -> dict:
    """Deferred-shading render (gaussian_renderer/__init__.py:225-520).
    mean2d_offset: see ops/rasterize/api.rasterize (densification stats).
    Without `mesh` the env light is unoccluded. With `mesh` (the
    raytracing_residual flavor) visibility and indirect light come from
    mesh_indirect_maps (refl_utils.py:101-190) and the pre-cull's drops are
    returned as "mesh_cull_dropped".
    wo_render_img: the geometry and material pass alone (envmap may be
    None): the regularization maps, the material maps, rend_distance and
    diffuse_map, without shading; what the warp losses read."""
    colors = pc.get_colors(camera.camera_center)
    refl = pc.get_refl
    rough = pc.get_rough
    ori_color = pc.get_ori_color
    indirect, normals = _indirect_light(pc, camera, opts)
    distance = _local_distance(pc, camera, normals)

    feats = torch.cat([refl, rough, ori_color, indirect, distance], dim=-1)
    out = rasterize(
        pc.xyz, pc.get_scaling, pc.get_rotation, pc.get_opacity[:, 0], colors, feats,
        camera, _zeros3(pc.device), config=opts.raster, mean2d_offset=mean2d_offset,
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
    if wo_render_img:
        # diffuse_map is shading-free ((1-m) * SH base color, render_surfel:446).
        results["diffuse_map"] = (1 - refl_map) * base_color
        return results

    # Deferred shading with the world-space normal map divided by alpha
    # (render_surfel:424-427).
    normal_map = regs["rend_normal"] / torch.clamp(render_alpha, min=1e-6)
    visibility = indirect_light = None
    if mesh is not None:
        maps = mesh_indirect_maps(mesh, camera, normal_map, regs["surf_depth"], envmap, render_alpha,
                                  cull_cap=mesh_cull_cap)
        visibility, indirect_light = maps["visibility"], maps["indirect"]
        results["mesh_cull_dropped"] = maps["cull_dropped"]
    specular, extra = shading.specular_color_surfel(
        envmap, albedo_map, camera, normal_map, render_alpha, refl_map, rough_map,
        visibility=visibility, indirect_light=indirect_light,
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


def _surface_bundles(camera: Camera, normal_map, surf_depth, render_alpha):
    """What a mesh trace from the rasterized surface starts from, in 16x16
    tile bundles and detached (the reference's tracer passes no gradient):
    the unbiased-depth surface points, the normals and the view directions
    w_o, and the mask of bundles with a pixel of render_alpha > 0 (None
    without render_alpha: every bundle)."""
    from materialrefgs_torch.render.envgs import bundle_alpha_mask, rays_to_bundles

    if surf_depth.dim() == 2:
        surf_depth = surf_depth[..., None]
    H, W = camera.height, camera.width
    rays_d, rays_o = shading.camera_rays_world(camera, unnormalized=True)
    surf_points = rays_o[None, None, :] + surf_depth * rays_d
    w_o = -normalize(rays_d)
    mask_b = bundle_alpha_mask(render_alpha, H, W) if render_alpha is not None else None
    return [rays_to_bundles(t.detach(), H, W) for t in (surf_points, normal_map, w_o)], mask_b


def _surface_image(bundles, camera: Camera, render_alpha, empty_value: float):
    """Bundled per-ray values back to an (H, W, C) image; pixels with
    render_alpha <= 0 take empty_value (refl_utils.py:118-125 traces only
    where render_alpha > 0)."""
    from materialrefgs_torch.render.envgs import bundles_to_image

    img = bundles_to_image(bundles, camera.height, camera.width)
    if render_alpha is None:
        return img
    return torch.where(render_alpha <= 0.0, torch.full_like(img, empty_value), img)


def mesh_visibility_map(
    mesh,  # ops.mesh_tracer.MeshData
    camera: Camera,
    normal_map: torch.Tensor,  # (H, W, 3) alpha-divided world normal
    surf_depth: torch.Tensor,  # (H, W) or (H, W, 1)
    render_alpha: torch.Tensor | None = None,
    cull_cap: int | None = None,
    with_dropped: bool = False,
):
    """Mesh-traced specular visibility (refl_utils.py:319-330, :381-392):
    reflect camera rays at the unbiased-depth surface, nearest-hit the
    extracted mesh, vis = miss (depth >= 10). No gradient flows through it.

    Rays are traced in 16x16 tile bundles, and tiles with no pixel of
    render_alpha > 0 are skipped (their visibility is 1). with_dropped=True
    also returns the trace's cull_dropped count (occluder clusters beyond
    cull_cap that were ignored; 0 = exact)."""
    from materialrefgs_torch.ops import mesh_tracer as mt

    (ro_b, n_b, wo_b), mask_b = _surface_bundles(camera, normal_map, surf_depth, render_alpha)
    hit = mt.trace(mesh, ro_b, normalize(reflect(wo_b, n_b)), cull_cap=cull_cap, block_mask=mask_b)
    vis = _surface_image((hit["depth"] >= mt.T_FAR).to(torch.float32)[:, None], camera, render_alpha, 1.0)
    if with_dropped:
        return vis, hit["cull_dropped"]
    return vis


def mesh_indirect_maps(
    mesh,  # ops.mesh_tracer.MeshData (the extracted TSDF mesh)
    camera: Camera,
    normal_map: torch.Tensor,  # (H, W, 3) world-space, alpha-divided
    surf_depth: torch.Tensor,  # (H, W) or (H, W, 1) unbiased surface depth
    envmap: EnvLightMips,
    render_alpha: torch.Tensor | None = None,  # (H, W, 1) gate for empty pixels
    cull_cap: int | None = None,
) -> dict:
    """Per-pixel mesh-traced visibility and one-bounce indirect light, the
    reference's raytracing_residual shading (utils/refl_utils.py:101-190):
    surface points from the rasterized unbiased depth, reflected rays traced
    against the mesh, and the colour along each bounce
    (ops/mesh_tracer.shade_one_bounce). No gradient reaches the surface
    points, normals or view directions (the reference's tracer has none);
    the env light's does, through the two env fetches.

    Rays are traced in 16x16 tile bundles and bundles without a pixel of
    render_alpha > 0 are skipped, as in mesh_visibility_map: every ray hits
    what the JAX package's row-major blocks hit (the first minimum in
    ascending triangle order either way); only the pre-cull's survivor
    lists, and so cull_dropped, differ. Empty pixels are fully visible and
    take no indirect light. Returns {"visibility" (H, W, 1), "indirect"
    (H, W, 3), "cull_dropped"}."""
    from materialrefgs_torch.ops import mesh_tracer as mt

    (ro_b, n_b, wo_b), mask_b = _surface_bundles(camera, normal_map, surf_depth, render_alpha)
    out = mt.shade_one_bounce(mesh, envmap, ro_b, n_b, wo_b, cull_cap=cull_cap, block_mask=mask_b)
    return {
        "visibility": _surface_image(out["visibility"], camera, render_alpha, 1.0),
        "indirect": _surface_image(out["indirect"], camera, render_alpha, 0.0),
        "cull_dropped": out["cull_dropped"],
    }
