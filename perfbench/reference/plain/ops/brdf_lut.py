"""Split-sum environment BRDF LUT (Karis 2013).

The (256, 256, 2) table, LUT[rough_row, nov_col] = (A, B), ships with the
package as `_fg_lut_256.npy` (GGX importance sampling + height-correlated
Smith visibility, 512 Hammersley samples per texel).

Lookup convention matches dr.texture(filter_mode='linear',
boundary_mode='clamp'): texel (i, j) center at uv = ((j+0.5)/256, (i+0.5)/256).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

_LUT_PATH = os.path.join(os.path.dirname(__file__), "_fg_lut_256.npy")


@functools.lru_cache(maxsize=4)
def get_fg_lut(device: torch.device) -> torch.Tensor:
    """The LUT on `device`, loaded once per device."""
    return torch.as_tensor(np.load(_LUT_PATH), dtype=torch.float32, device=device)


def sample_fg_lut(nov: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear clamped lookup; nov/roughness (...,) -> (..., 2).

    Matches dr.texture(FG_LUT, cat([NdotV, roughness]).clamp(0,1), 'linear',
    'clamp') in utils/refl_utils.py:112."""
    lut = get_fg_lut(nov.device)
    R = lut.shape[0]
    u = torch.clamp(nov, 0.0, 1.0) * R - 0.5
    v = torch.clamp(roughness, 0.0, 1.0) * R - 0.5
    u0 = torch.clamp(torch.floor(u), 0, R - 1)
    v0 = torch.clamp(torch.floor(v), 0, R - 1)
    u1 = torch.clamp(u0 + 1, 0, R - 1)
    v1 = torch.clamp(v0 + 1, 0, R - 1)
    fu = torch.clamp(u - u0, 0, 1)[..., None]
    fv = torch.clamp(v - v0, 0, 1)[..., None]
    u0, u1, v0, v1 = (x.to(torch.int64) for x in (u0, u1, v0, v1))
    c00 = lut[v0, u0]
    c01 = lut[v0, u1]
    c10 = lut[v1, u0]
    c11 = lut[v1, u1]
    return (
        c00 * (1 - fu) * (1 - fv)
        + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv
        + c11 * fu * fv
    )
