"""Image metrics of the loss library (reference utils/loss_utils.py).

All image args are channel-last (H, W, C), as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return g[:, None] @ g[None, :]  # (size, size)


def _depthwise_conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img (H, W, C), kernel (k, k), zero 'same' padding -> (H, W, C).
    Full float32: the package disables cuDNN's TF32 at import, since the SSIM
    moment differences E[x^2]-E[x]^2 cancel badly at lower precision."""
    C = img.shape[-1]
    k = kernel[None, None].expand(C, 1, *kernel.shape)
    out = F.conv2d(img.permute(2, 0, 1)[None], k, padding=kernel.shape[-1] // 2, groups=C)
    return out[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM, zero padding (loss_utils.py:96-124)."""
    w = _gaussian_window(window_size, 1.5, img1.device)
    mu1 = _depthwise_conv2d(img1, w)
    mu2 = _depthwise_conv2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # Clamp variances at 0: rounding can make the moment difference
    # slightly negative, and a negative denominator flips the SSIM sign.
    s1 = torch.clamp(_depthwise_conv2d(img1 * img1, w) - mu1_sq, min=0.0)
    s2 = torch.clamp(_depthwise_conv2d(img2 * img2, w) - mu2_sq, min=0.0)
    s12 = _depthwise_conv2d(img1 * img2, w) - mu12
    C1, C2 = 0.01**2, 0.03**2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(m)
