"""LPIPS perceptual distance (reference lpipsPyTorch/modules/lpips.py:1-55,
networks.py; the JAX package's train/lpips.py) in torch: VGG16 features,
channel-unit-normalized, squared difference, learned non-negative
per-channel weights, spatial mean, summed over the five tap layers (relu1_2,
relu2_2, relu3_3, relu4_3, relu5_3).

Weights policy (no pretrained VGG16 ships with the repository): every entry
point demands a weight file and raises LpipsWeightsMissing with instructions
when it is missing; the Trainer turns that into a loud degradation
(train/trainer.py). `scripts/convert_lpips_weights.py` converts torchvision's
VGG16 checkpoint and the lpips package's 'vgg.pth' heads into the file.

Weight file format (.npz), the JAX package's:
  conv{i}_w  (kh, kw, Cin, Cout) f32   i in 0..12   VGG16 conv stack (HWIO)
  conv{i}_b  (Cout,)
  lin{j}     (C_j,) f32                j in 0..4    LPIPS heads (>= 0 used)

The convolutions are cuDNN's (as the JAX package's are XLA's
conv_general_dilated, outside any Pallas kernel), in full float32: the
package turns TF32 off at import.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.plain.utils.transforms import relu0

DEFAULT_WEIGHTS_ENV = "MATERIALREFGS_LPIPS_WEIGHTS"
# VGG16 conv plan: channels per conv layer and pool positions.
_VGG_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
_POOL_AFTER = {1, 3, 6, 9}  # maxpool after these conv indices (0-based)
_TAPS = {1: 0, 3: 1, 6: 2, 9: 3, 12: 4}  # conv idx -> lpips head idx

# ImageNet normalization in the lpips 'scaling layer' convention
# (lpipsPyTorch networks.py ScalingLayer: inputs in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def default_weights_path() -> str:
    return os.environ.get(
        DEFAULT_WEIGHTS_ENV,
        os.path.join(os.path.dirname(__file__), "..", "..", "assets", "lpips_vgg.npz"),
    )


def weights_available(path: str | None = None) -> bool:
    return os.path.exists(path or default_weights_path())


class LpipsWeightsMissing(FileNotFoundError):
    pass


def load_weights(path: str | None = None, device=None) -> dict[str, torch.Tensor]:
    """The .npz's arrays as float32 tensors on `device`, the convolutions
    moved HWIO -> OIHW; raises LpipsWeightsMissing or, on a malformed file,
    ValueError."""
    path = path or default_weights_path()
    if not os.path.exists(path):
        raise LpipsWeightsMissing(
            f"LPIPS weights not found at {path}. This environment cannot "
            "download pretrained VGG16; obtain torchvision's vgg16 checkpoint "
            "and the lpips package's 'vgg.pth' linear heads, then run "
            "scripts/convert_lpips_weights.py to produce the .npz (or set "
            f"${DEFAULT_WEIGHTS_ENV}). Refusing to compute LPIPS from "
            "uninitialized weights."
        )
    raw = np.load(path)
    for i, c in enumerate(_VGG_CHANNELS):
        if f"conv{i}_w" not in raw.files or raw[f"conv{i}_w"].shape[-1] != c:
            raise ValueError(f"LPIPS weight file malformed at conv{i} ({path})")
    out = {}
    for k in raw.files:
        a = np.asarray(raw[k], np.float32)
        if k.endswith("_w"):
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out[k] = torch.as_tensor(a, device=device)
    return out


def _vgg_features(x: torch.Tensor, w: dict) -> list[torch.Tensor]:
    """x (H, W, 3) in [0, 1] -> the 5 tap feature maps, each (1, C_i, H_i, W_i)."""
    shift = x.new_tensor(_SHIFT)
    scale = x.new_tensor(_SCALE)
    x = (x * 2.0 - 1.0 - shift) / scale
    x = x.permute(2, 0, 1)[None]
    taps = [None] * 5
    for i in range(len(_VGG_CHANNELS)):
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], padding=1))
        if i in _TAPS:
            taps[_TAPS[i]] = x
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)  # floor: JAX's VALID window
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """f / sqrt(max(sum f^2, eps^2)) over channels, with jnp.maximum's
    gradient at the tie."""
    n2 = torch.sum(f * f, dim=1, keepdim=True)
    return f / torch.sqrt(torch.maximum(n2, n2.new_tensor(eps * eps)))


def lpips(img1: torch.Tensor, img2: torch.Tensor, weights: dict) -> torch.Tensor:
    """Perceptual distance between (H, W, 3) images in [0, 1]."""
    f1 = _vgg_features(img1, weights)
    f2 = _vgg_features(img2, weights)
    total = img1.new_zeros(())
    for j, (a, b) in enumerate(zip(f1, f2)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        lin = relu0(weights[f"lin{j}"])  # lpips constrains the heads >= 0
        total = total + torch.mean(torch.sum(d * lin[None, :, None, None], dim=1))
    return total


class LPIPS(torch.nn.Module):
    """The distance with its weights held on a device: LPIPS(path,
    device)(img1, img2) -> scalar. Raises LpipsWeightsMissing."""

    def __init__(self, path: str | None = None, device=None):
        super().__init__()
        for k, v in load_weights(path, device).items():
            self.register_buffer(k, v)

    def weights(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return lpips(img1, img2, self.weights())
