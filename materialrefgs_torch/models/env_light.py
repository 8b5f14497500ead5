"""Trainable cubemap environment light (reference scene/light.py EnvLight).

State = logits cubemap (6, R, R, 3); every sample passes through sigmoid
(scene/light.py:129). `EnvLightMips.build` rebuilds the avg-pool + GGX
prefilter chain from the logits, eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from materialrefgs_torch import resolve_device
from materialrefgs_torch.ops import cubemap as cm
from materialrefgs_torch.utils.hdr import read_hdr
from materialrefgs_torch.utils.transforms import inverse_sigmoid, linear_to_srgb


class EnvLightParams(nn.Module):
    """Cubemap logits (6, R, R, 3) as one parameter."""

    def __init__(self, base: torch.Tensor):
        super().__init__()
        self.base = nn.Parameter(base)

    @staticmethod
    def create(
        res: int = 128, init: float = 0.0, device: str | torch.device | None = None
    ) -> "EnvLightParams":
        dev = resolve_device(device)
        return EnvLightParams(torch.full((6, res, res, 3), init, dtype=torch.float32, device=dev))


@dataclass(frozen=True)
class EnvLightMips:
    specular: tuple  # (6, r, r, 3) per level, r: R..min_res
    diffuse: torch.Tensor  # (6, min_res, min_res, 3)
    min_roughness: float = 0.08
    max_roughness: float = 0.5

    @staticmethod
    def build(
        params: EnvLightParams,
        min_res: int = 16,
        min_roughness: float = 0.08,
        max_roughness: float = 0.5,
        n_samples: int = 64,
    ) -> "EnvLightMips":
        spec, diff = cm.build_mip_chain(
            params.base,
            min_res=min_res,
            min_roughness=min_roughness,
            max_roughness=max_roughness,
            n_samples=n_samples,
        )
        return EnvLightMips(
            specular=tuple(spec),
            diffuse=diff,
            min_roughness=min_roughness,
            max_roughness=max_roughness,
        )

    def __call__(
        self,
        dirs: torch.Tensor,
        mode: str | None = None,
        roughness: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Query light; returns sigmoid-activated RGB (..., 3)."""
        if mode == "diffuse":
            light = cm.sample_cubemap(self.diffuse, dirs)
        elif mode == "pure_env":
            light = cm.sample_cubemap(self.specular[0], dirs)
        else:
            if roughness is None:
                raise ValueError("specular queries need a roughness")
            r = roughness[..., 0] if roughness.ndim == dirs.ndim else roughness
            mip = cm.get_mip(r, len(self.specular), self.min_roughness, self.max_roughness)
            light = cm.sample_mip_chain(list(self.specular), dirs, mip)
        return torch.sigmoid(light)


def load_envlight_from_hdr(
    path: str, res: int = 128, scale: float = 1.0, device: str | torch.device | None = None
) -> EnvLightParams:
    """EnvLight.load (scene/light.py:46-70): an HDR latlong (Radiance RGBE,
    utils/hdr.py) -> sRGB -> clipped -> logits -> a (6, res, res, 3)
    cubemap on `device` (default: the card)."""
    hdr = torch.as_tensor(read_hdr(path).clip(1e-4, 255.0), device=resolve_device(device))
    img = torch.clamp(linear_to_srgb(hdr) * scale, 0.001, 1 - 0.001)
    return EnvLightParams(cm.latlong_to_cubemap(inverse_sigmoid(img), res))
