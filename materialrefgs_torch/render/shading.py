"""Deferred split-sum shading (reference utils/refl_utils.py).

All maps are channel-last (H, W, C). Shading contract
(refl_utils.py:188-245 and :461+):

  w_o        = -normalize(camera ray)
  refl, NoV  = reflect(w_o, normal)
  fg         = FG_LUT(NoV, roughness)                       (2,)
  direct     = envmap(refl, roughness)                      sigmoid'd RGB
  spec_w     = (0.04 * (1 - m) + albedo * m) * fg.x + fg.y
  spec_light = direct * vis + (1 - vis) * indirect          (if vis given)
  specular   = spec_light * alpha * spec_w
  final      = (1 - m) * base + specular                    (in render paths)
"""
from __future__ import annotations

import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.ops.brdf_lut import sample_fg_lut
from materialrefgs_torch.utils.transforms import normalize, reflect


def camera_rays_world(camera: Camera, unnormalized: bool = False):
    """Per-pixel world-space ray dirs (H, W, 3) + origin (3,)
    (refl_utils.py:54-93): integer pixel grid, K^-1 backprojection, rotated
    to world."""
    d_cam = camera.get_rays()  # (H, W, 3) camera-space, z=1
    R = camera.world_view[:3, :3]  # world->view rotation (row-vector form)
    d_world = torch.einsum("hwc,cd->hwd", d_cam, R.T)
    if not unnormalized:
        d_world = normalize(d_world)
    return d_world, camera.camera_center


def specular_color_surfel(
    envmap,  # EnvLightMips
    albedo: torch.Tensor,  # (H, W, 3)
    camera: Camera,
    normal_map: torch.Tensor,  # (H, W, 3) world-space
    render_alpha: torch.Tensor,  # (H, W, 1)
    refl_strength: torch.Tensor,  # (H, W, 1) metallic
    roughness: torch.Tensor,  # (H, W, 1)
    visibility: torch.Tensor | None = None,  # (H, W, 1) or None
    indirect_light: torch.Tensor | None = None,  # (H, W, 3) or None
    blend_weight: torch.Tensor | None = None,  # (H, W, 1) EnvGS blend (surfel4)
    indirect_light_residual: torch.Tensor | None = None,  # (H, W, 3)
) -> tuple[torch.Tensor, dict]:
    """Deferred specular shading; returns (specular (H,W,3), extras). With
    visibility and indirect light (the env-GS trace), occluded directions
    take the traced light instead of the env map's."""
    rays_d, _ = camera_rays_world(camera)
    w_o = -rays_d
    NoV = torch.sum(w_o * normal_map, dim=-1, keepdim=True)
    rays_refl = normalize(reflect(w_o, normal_map))

    fg = sample_fg_lut(NoV[..., 0], roughness[..., 0])  # (H, W, 2)
    direct_light = envmap(rays_refl, roughness=roughness)
    specular_weight = (
        0.04 * (1 - refl_strength) + albedo * refl_strength
    ) * fg[..., 0:1] + fg[..., 1:2]

    extras = {"direct_light": direct_light, "specular_weight": specular_weight}
    if visibility is not None and indirect_light is not None:
        if blend_weight is not None and indirect_light_residual is not None:
            indirect_light = (1 - blend_weight) * indirect_light + blend_weight * indirect_light_residual
        specular_light = direct_light * visibility + (1 - visibility) * indirect_light
        extras["visibility"] = visibility
        extras["indirect_light"] = indirect_light
        extras["indirect_color"] = (1 - visibility) * indirect_light * render_alpha * specular_weight
    elif visibility is not None:
        # surfel2 flavor: direct light masked by visibility only.
        specular_light = direct_light * visibility
        extras["visibility"] = visibility
    else:
        specular_light = direct_light

    specular = specular_light * render_alpha * specular_weight
    return specular, extras
