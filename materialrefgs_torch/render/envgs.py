"""EnvGS composite rendering (materialrefgs_tpu/render/envgs.py; reference
gaussian_renderer/envgs_renderer.py).

render_surfel2 (ref :461): deferred surfel render with an extra blend_weight
feature channel (S = 10), reflected-ray tracing into the environment
gaussians (render_indirect, ref :716) and split-sum shading where the traced
indirect light replaces the env light in occluded directions.

Visibility: with an extracted mesh, the mesh-traced hard occlusion of the
reflected rays (render/renderers.mesh_visibility_map), and the env trace runs
only on bundles with an occluded pixel; without one, the main cloud traced
with the same bundle tracer, vis = 1 - acc (the JAX package's documented
substitute).

The env trace's rays keep their gradient (to the normal map and the
surface depth, as in the JAX package); the visibility trace takes none.
`tracer_demand_probe` sizes the tracer's budget at the surfel2 onset.
"""
from __future__ import annotations

import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.models.env_light import EnvLightMips
from materialrefgs_torch.models.gaussian_model import GaussianModel
from materialrefgs_torch.ops.rasterize.api import rasterize
from materialrefgs_torch.ops.tracer.api import TracerConfig, trace, trace_demand
from materialrefgs_torch.render import shading
from materialrefgs_torch.render.renderers import (
    RenderOptions,
    _indirect_light,
    _local_distance,
    _unpack_regularizations,
    _zeros3,
    mesh_visibility_map,
)
from materialrefgs_torch.utils.transforms import linear_to_srgb, normalize, reflect

TILE = 16
# The scalar counts of ops.tracer.api.trace that a render passes on.
_TRACE_COUNTS = ("overflow", "pairs", "cluster_pairs", "pair_slots")


def rays_to_bundles(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H, W, C) -> (NB*256, C) in 16x16 tile bundle order. The edge pads
    replicate the border (zero padding would give edge bundles degenerate
    cone stats that defeat cone culling)."""
    gy, gx = (H + TILE - 1) // TILE, (W + TILE - 1) // TILE
    rows = torch.clamp(torch.arange(gy * TILE, device=x.device), max=H - 1)
    cols = torch.clamp(torch.arange(gx * TILE, device=x.device), max=W - 1)
    xp = x[rows][:, cols]
    xb = xp.reshape(gy, TILE, gx, TILE, -1).permute(0, 2, 1, 3, 4)
    return xb.reshape(gy * gx * TILE * TILE, x.shape[-1])


def bundles_to_image(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    gy, gx = (H + TILE - 1) // TILE, (W + TILE - 1) // TILE
    C = x.shape[-1] if x.dim() > 1 else 1
    xb = x.reshape(gy, gx, TILE, TILE, C).permute(0, 2, 1, 3, 4)
    return xb.reshape(gy * TILE, gx * TILE, C)[:H, :W]


def bundle_alpha_mask(render_alpha: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H, W, 1) render alpha -> (NB,) bool: any pixel of the 16x16 tile hit
    geometry. Reflected rays are shaded only where render_alpha > 0, so
    background bundles skip the trace."""
    ab = rays_to_bundles(render_alpha.detach(), H, W)
    return torch.amax(ab.reshape(-1, TILE * TILE), dim=1) > 0.0


def _reflected_rays(camera: Camera, normal_map, surf_depth, offset):
    """Bundled origins (surface point pushed `offset` along the reflected
    direction) and unit reflected directions."""
    H, W = camera.height, camera.width
    rays_cam, rays_o = shading.camera_rays_world(camera, unnormalized=True)
    inter = rays_o[None, None, :] + surf_depth[..., None] * rays_cam
    w_o = normalize(-rays_cam)
    rays_refl = normalize(reflect(w_o, normal_map))
    inter = inter + offset * rays_refl
    return rays_to_bundles(inter, H, W), rays_to_bundles(rays_refl, H, W)


def render_indirect(
    env_model: GaussianModel,
    camera: Camera,
    normal_map: torch.Tensor,  # (H, W, 3)
    surf_depth: torch.Tensor,  # (H, W)
    tracer_cfg: TracerConfig,
    bundle_mask: torch.Tensor | None = None,  # (NB,) bool, see bundle_alpha_mask
) -> dict:
    """Reflect camera rays at the surface, trace env gaussians (ref :716)."""
    H, W = camera.height, camera.width
    ro, rd = _reflected_rays(camera, normal_map, surf_depth, 1e-3)
    shs = torch.cat([env_model.features_dc, env_model.features_rest], dim=1)
    out = trace(
        ro, rd, env_model.xyz, env_model.get_scaling, env_model.get_rotation,
        env_model.get_opacity[:, 0], shs, tracer_cfg, sh_degree=env_model.max_sh_degree,
        bundle_mask=bundle_mask,
    )
    return {
        "render": bundles_to_image(out["rgb"], H, W),
        "acc": bundles_to_image(out["acc"][:, None], H, W),
        "depth": bundles_to_image(out["depth"][:, None], H, W),
        "normal": bundles_to_image(out["normal"], H, W),
        **{k: out[k] for k in _TRACE_COUNTS},
    }


def trace_visibility(
    pc: GaussianModel,
    camera: Camera,
    normal_map: torch.Tensor,
    surf_depth: torch.Tensor,
    tracer_cfg: TracerConfig,
    bundle_mask: torch.Tensor | None = None,
    offset: float = 3e-2,
) -> tuple[torch.Tensor, dict]:
    """Returns ((H, W, 1) soft visibility, the trace's counts: overflow,
    pairs, cluster_pairs, pair_slots): trace the main cloud along reflected
    rays, vis = 1 - acc. Masked bundles come back vis = 1. The origin is
    pushed 3e-2 along the reflected direction so the ray escapes the surfel
    it starts on. No gradient flows through it."""
    H, W = camera.height, camera.width
    ro, rd = _reflected_rays(camera, normal_map, surf_depth, offset)
    shs = torch.zeros((pc.capacity, 1, 3), dtype=torch.float32, device=pc.device)
    out = trace(
        ro.detach(), rd.detach(), pc.xyz.detach(), pc.get_scaling.detach(),
        pc.get_rotation.detach(), pc.get_opacity[:, 0].detach(), shs, tracer_cfg,
        sh_degree=0, bundle_mask=bundle_mask,
    )
    vis = 1.0 - out["acc"][:, None]
    return bundles_to_image(vis, H, W), {k: out[k] for k in _TRACE_COUNTS}


@torch.no_grad()
def tracer_demand_probe(
    env_model: GaussianModel,
    camera: Camera,
    normal_map: torch.Tensor,  # (H, W, 3) alpha-divided
    surf_depth: torch.Tensor,  # (H, W) or (H, W, 1)
    render_alpha: torch.Tensor,  # (H, W, 1)
    tracer_cfg: TracerConfig,
    mesh=None,
) -> int:
    """Pair demand of the indirect trace render_surfel2 would issue from this
    view (envgs.py:161-203 of the JAX package): the cull stages only, no
    binning, kernel or gradient. With a mesh, only the bundles it occludes."""
    H, W = camera.height, camera.width
    if surf_depth.dim() == 3:
        surf_depth = surf_depth[..., 0]
    mask = bundle_alpha_mask(render_alpha, H, W)
    if mesh is not None:
        vis = mesh_visibility_map(mesh, camera, normal_map, surf_depth, render_alpha,
                                  cull_cap=tracer_cfg.mesh_cull_cap)
        vb = rays_to_bundles(vis, H, W)
        mask = mask & (torch.amin(vb.reshape(-1, TILE * TILE), dim=1) < 0.5)
    ro, rd = _reflected_rays(camera, normal_map, surf_depth, 1e-3)
    return trace_demand(ro, rd, env_model.xyz, env_model.get_scaling, env_model.get_opacity[:, 0],
                        tracer_cfg, bundle_mask=mask)


def render_surfel2(
    pc: GaussianModel,
    env_model: GaussianModel,
    camera: Camera,
    bg_color: torch.Tensor,
    envmap: EnvLightMips,
    opts: RenderOptions = RenderOptions(),
    tracer_cfg: TracerConfig = TracerConfig(),
    mean2d_offset: torch.Tensor | None = None,
    with_visibility: bool = True,
    mesh=None,  # ops.mesh_tracer.MeshData: mesh-traced hard visibility
) -> dict:
    """EnvGS composite forward (ref envgs_renderer.py:461-711).

    With `mesh`, specular visibility is the mesh-traced occlusion of the
    reflected rays (vis = depth >= 10) and the env trace skips every tile
    whose pixels are all unoccluded; without one, the splat-traced soft
    visibility stands in for it."""
    colors = pc.get_colors(camera.camera_center)
    indirect, normals = _indirect_light(pc, camera, opts)
    distance = _local_distance(pc, camera, normals)
    feats = torch.cat(
        [pc.get_refl, pc.get_rough, pc.get_ori_color, indirect, pc.get_specular, distance], dim=-1
    )
    out = rasterize(
        pc.xyz, pc.get_scaling, pc.get_rotation, pc.get_opacity[:, 0], colors, feats,
        camera, _zeros3(pc.device), config=opts.raster, mean2d_offset=mean2d_offset,
    )
    f = out["feature"]
    refl_map = f[..., 0:1]
    rough_map = f[..., 1:2]
    albedo_map = f[..., 2:5]
    indirect_residual = f[..., 5:8]
    blend_map = f[..., 8:9]
    dist_map = f[..., 9:10]
    base_color = out["render"]

    regs = _unpack_regularizations(out, camera, opts, dist_map)
    render_alpha = regs["rend_alpha"]
    normal_map = regs["rend_normal"] / torch.clamp(render_alpha, min=1e-6)
    H, W = camera.height, camera.width
    active = bundle_alpha_mask(render_alpha, H, W)

    # Visibility first: the traced indirect light reaches the output only as
    # (1 - visibility) * indirect, so with the mesh's hard {0,1} visibility
    # the env trace can skip every tile whose pixels are all unoccluded.
    visibility = None
    mesh_cull_dropped = 0
    indirect_mask = active
    if mesh is not None:
        visibility, mesh_cull_dropped = mesh_visibility_map(
            mesh, camera, normal_map, regs["surf_depth"], render_alpha,
            cull_cap=tracer_cfg.mesh_cull_cap, with_dropped=True,
        )
        vb = rays_to_bundles(visibility.detach(), H, W)
        occluded = torch.amin(vb.reshape(-1, TILE * TILE), dim=1) < 0.5
        indirect_mask = active & occluded

    indirect_results = render_indirect(
        env_model, camera, normal_map, regs["surf_depth"], tracer_cfg, bundle_mask=indirect_mask,
    )
    indirect_light = indirect_results["render"]
    traces = [indirect_results]

    if mesh is None and with_visibility:
        visibility, vis_counts = trace_visibility(
            pc, camera, normal_map, regs["surf_depth"], tracer_cfg, bundle_mask=active,
        )
        traces.append(vis_counts)

    specular, extra = shading.specular_color_surfel(
        envmap, albedo_map, camera, normal_map, render_alpha, refl_map, rough_map,
        visibility=visibility if visibility is not None else torch.ones_like(render_alpha),
        indirect_light=indirect_light,
    )

    final = (1 - refl_map) * base_color + specular
    albedo_out = albedo_map
    if opts.srgb:
        final = linear_to_srgb(final)
        albedo_out = linear_to_srgb(albedo_map)
        specular = linear_to_srgb(specular)
    final = final + bg_color[None, None, :] * (1 - render_alpha)

    return {
        "render": final,
        "refl_strength_map": refl_map,
        "diffuse_map": (1 - refl_map) * base_color,
        "diffuse_map_ori": base_color,
        "specular_map": specular,
        "base_color_map": albedo_out,
        "roughness_map": rough_map,
        "blend_weight": blend_map,
        "rend_distance": dist_map,
        "indirect_out": indirect_results,
        "indirect_map": indirect_residual,
        "radii": out["radii"],
        "visibility_filter": out["radii"] > 0,
        "overflow": out["overflow"],
        # Splat-tracer truncation (env-GS indirect + soft-visibility traces),
        # apart from the rasterizer's.
        "tracer_overflow": sum(t["overflow"] for t in traces),
        # Pair demand of the indirect trace before truncation.
        "tracer_pairs": indirect_results["pairs"],
        # The TracerConfig budgets that would have kept every pair of both
        # traces (evaluate.render_set redoes an overflowed view with them).
        "tracer_cluster_pairs": max(t["cluster_pairs"] for t in traces),
        "tracer_pair_slots": max(t["pair_slots"] for t in traces),
        "mesh_cull_dropped": mesh_cull_dropped,
        **regs,
        **extra,
    }
