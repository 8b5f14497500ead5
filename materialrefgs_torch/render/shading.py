"""Deferred split-sum shading (reference utils/refl_utils.py).

All maps are channel-last (H, W, C). Shading contract
(refl_utils.py:188-245 and :461+):

  w_o        = -normalize(camera ray)
  refl, NoV  = reflect(w_o, normal)
  fg         = FG_LUT(NoV, roughness)                       (2,)
  direct     = envmap(refl, roughness)                      sigmoid'd RGB
  spec_w     = (0.04 * (1 - m) + albedo * m) * fg.x + fg.y
  specular   = direct * alpha * spec_w
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
) -> tuple[torch.Tensor, dict]:
    """Deferred specular shading with direct light only (traced visibility
    and indirect light come with the surfel2 slice); returns
    (specular (H,W,3), extras)."""
    rays_d, _ = camera_rays_world(camera)
    w_o = -rays_d
    NoV = torch.sum(w_o * normal_map, dim=-1, keepdim=True)
    rays_refl = normalize(reflect(w_o, normal_map))

    fg = sample_fg_lut(NoV[..., 0], roughness[..., 0])  # (H, W, 2)
    direct_light = envmap(rays_refl, roughness=roughness)
    specular_weight = (
        0.04 * (1 - refl_strength) + albedo * refl_strength
    ) * fg[..., 0:1] + fg[..., 1:2]

    specular = direct_light * render_alpha * specular_weight
    return specular, {"direct_light": direct_light, "specular_weight": specular_weight}
