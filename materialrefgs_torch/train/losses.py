"""Loss library (reference utils/loss_utils.py), channel-last torch.

All image args are (H, W, C), as in the JAX package. Iteration gates are
multiplied in as 0/1 weights, as the JAX package's traced gates are, so a
gated-off term still costs its evaluation and contributes exact zeros; the
LPIPS term alone is skipped before its gate (train/lpips.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from materialrefgs_torch.config import OptimizationParams
from materialrefgs_torch.utils.transforms import abs_, clip, relu0


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return g[:, None] @ g[None, :]  # (size, size)


def _depthwise_conv2d(img: torch.Tensor, kernel: torch.Tensor, same: bool = True) -> torch.Tensor:
    """img (H, W, C), kernel (kh, kw), cross-correlation with zero 'same'
    padding (or none) -> (H', W', C). Full float32: the package disables
    cuDNN's TF32 at import, since the SSIM moment differences E[x^2]-E[x]^2
    cancel badly at lower precision."""
    C = img.shape[-1]
    k = kernel[None, None].expand(C, 1, *kernel.shape)
    pad = kernel.shape[-1] // 2 if same else 0
    out = F.conv2d(img.permute(2, 0, 1)[None], k, padding=pad, groups=C)
    return out[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM, zero padding (loss_utils.py:96-124)."""
    w = _gaussian_window(window_size, 1.5, img1.device)
    mu1 = _depthwise_conv2d(img1, w)
    mu2 = _depthwise_conv2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # Clamp variances at 0: rounding can make the moment difference
    # slightly negative, and a negative denominator flips the SSIM sign.
    s1 = relu0(_depthwise_conv2d(img1 * img1, w) - mu1_sq)
    s2 = relu0(_depthwise_conv2d(img2 * img2, w) - mu2_sq)
    s12 = _depthwise_conv2d(img1 * img2, w) - mu12
    C1, C2 = 0.01**2, 0.03**2
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(m)


def _edge_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad an (H, W, C) image by p on both spatial sides."""
    return F.pad(img.permute(2, 0, 1)[None], (p, p, p, p), mode="replicate")[0].permute(1, 2, 0)


def spatial_gradient(img: torch.Tensor) -> torch.Tensor:
    """Normalized Sobel gradients with replicate padding (kornia
    spatial_gradient): img (H, W, C) -> (H, W, C, 2) [dx, dy]."""
    sx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32, device=img.device) / 8.0
    pad = _edge_pad(img, 1)
    gx = _depthwise_conv2d(pad, sx, same=False)
    gy = _depthwise_conv2d(pad, sx.T.contiguous(), same=False)
    return torch.stack([gx, gy], dim=-1)


def first_order_edge_aware_loss(data: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """(|grad data| * exp(-|grad img|)) (loss_utils.py:121)."""
    gd = torch.abs(spatial_gradient(data))
    gi = torch.abs(spatial_gradient(img))
    return torch.mean(torch.sum(gd * torch.exp(-gi), dim=-1))


def get_img_grad_weight(img: torch.Tensor) -> torch.Tensor:
    """Inverse-gradient pixel weights (loss_utils.py:127-141). img (H, W, C)."""
    H, W = img.shape[:2]
    right = img[1 : H - 1, 2:W]
    left = img[1 : H - 1, 0 : W - 2]
    top = img[0 : H - 2, 1 : W - 1]
    bottom = img[2:H, 1 : W - 1]
    gx = torch.mean(torch.abs(right - left), dim=-1)
    gy = torch.mean(torch.abs(top - bottom), dim=-1)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / torch.clamp(g.max() - g.min(), min=1e-12)
    return F.pad(g, (1, 1, 1, 1), value=1.0)  # (H, W)


def smooth_loss_simple(data: torch.Tensor) -> torch.Tensor:
    """Mean L1 of the Sobel gradients, with jnp.abs's gradient at 0 (the
    ref-score loss smooths a masked map, flat where the mask is 0)."""
    return torch.mean(torch.sum(abs_(spatial_gradient(data)), dim=-1))


def _lap_kernel(size: int = 5, sigma: float = 2.0) -> np.ndarray:
    """Reference build_gauss_kernel (utils/lap_loss.py:10-24), quirks intact:
    a cross-shaped kernel (the per-axis gaussians are summed), not a
    separable 2D gaussian."""
    grid = np.float32(np.mgrid[0:size, 0:size].T)  # (size, size, 2)
    g = np.exp((grid - size // 2) ** 2 / (-2.0 * sigma**2)) ** 2
    k = np.sum(g, axis=2)
    return (k / k.sum()).astype(np.float32)


def lap_loss(x, y, max_levels: int = 5, k_size: int = 5, sigma: float = 2.0) -> torch.Tensor:
    """Laplacian-pyramid L1 (utils/lap_loss.py LapLoss; the loss_utils.py:44
    wrapper feeds 2*img-1). x, y: (H, W, C) in [0, 1]. Sum-reduced L1 over
    all pyramid levels plus the final low-pass residual. Library surface
    only, as in the reference: calculate_loss does not call it."""
    x = 2.0 * x - 1.0
    y = 2.0 * y - 1.0
    k = torch.as_tensor(_lap_kernel(k_size, sigma), device=x.device)
    p = k_size // 2

    def blur(img):
        return _depthwise_conv2d(_edge_pad(img, p), k, same=False)

    def avgpool2(img):
        return F.avg_pool2d(img.permute(2, 0, 1)[None], 2)[0].permute(1, 2, 0)

    total = x.new_zeros(())
    cx, cy = x, y
    for _ in range(max_levels):
        bx, by = blur(cx), blur(cy)
        total = total + torch.sum(torch.abs((cx - bx) - (cy - by)))
        cx, cy = avgpool2(bx), avgpool2(by)
    return total + torch.sum(torch.abs(cx - cy))


def lncc(ref: torch.Tensor, nea: torch.Tensor):
    """Patch NCC (loss_utils.py:230-263). ref/nea (B, ps*ps) grayscale
    patches. Returns (ncc (B, 1), mask (B, 1))."""
    tps = nea.shape[1]
    r, n = ref, nea
    ref_sum, nea_sum, ref2_sum, nea2_sum, rn_sum = torch.sum(torch.stack([r, n, r * r, n * n, r * n]), dim=-1)
    ref_avg = ref_sum / tps
    nea_avg = nea_sum / tps
    cross = rn_sum - nea_avg * ref_sum
    ref_var = ref2_sum - ref_avg * ref_sum
    nea_var = nea2_sum - nea_avg * nea_sum
    cc = cross * cross / (ref_var * nea_var + 1e-8)
    ncc = clip(1.0 - cc, 0.0, 2.0)[:, None]
    return ncc, ncc < 0.9


def calculate_loss(
    gt_image: torch.Tensor,  # (H, W, 3)
    render_pkg: dict,
    opt: OptimizationParams,
    iteration: float,
    image_weight: torch.Tensor | None = None,  # (H, W)
    lpips_weights: dict | None = None,
):
    """Core photometric + geometric losses (loss_utils.py:142-228).
    Returns (loss, tb_dict)."""
    it = float(iteration)
    img = render_pkg["render"]
    tb = {}

    Ll1 = l1_loss(img, gt_image)
    ssim_val = ssim(img, gt_image)
    loss = (1.0 - opt.lambda_dssim) * Ll1 + opt.lambda_dssim * (1.0 - ssim_val)
    tb["loss_l1"] = Ll1
    tb["ssim"] = ssim_val
    tb["psnr"] = psnr(img, gt_image)

    if opt.lambda_normal_render_depth > 0:
        gate = float(it > opt.normal_loss_start)
        rn = render_pkg["rend_normal"]
        sn = render_pkg["surf_normal"]
        if image_weight is not None and not opt.wo_image_weight:
            ln = torch.mean(image_weight * torch.sum(abs_(sn - rn), dim=-1))
        else:
            ln = torch.mean(1.0 - torch.sum(rn * sn, dim=-1))
        tb["loss_normal_render_depth"] = ln
        loss = loss + gate * opt.lambda_normal_render_depth * ln

    if opt.lambda_dist > 0:
        gate = float(it > opt.dist_loss_start)
        dl = torch.mean(render_pkg["rend_dist"])
        tb["loss_dist"] = dl
        loss = loss + gate * opt.lambda_dist * dl

    if opt.lambda_normal_smooth > 0:
        gate = float(opt.normal_smooth_from_iter < it < opt.normal_smooth_until_iter)
        ns = first_order_edge_aware_loss(render_pkg["rend_normal"], gt_image)
        tb["loss_normal_smooth"] = ns
        loss = loss + gate * opt.lambda_normal_smooth * ns

    if opt.lambda_depth_smooth > 0:
        # Reference literal `iteration > 3000` (loss_utils.py:193), routed
        # through dist_loss_start as the JAX package does.
        gate = float(it > opt.dist_loss_start)
        ds = first_order_edge_aware_loss(render_pkg["surf_depth"][..., None], gt_image)
        tb["loss_depth_smooth"] = ds
        loss = loss + gate * opt.lambda_depth_smooth * ds

    if opt.use_perceptual_loss and lpips_weights is not None and it > opt.perceptual_loss_start_iter:
        # LPIPS perceptual term (loss_utils.py:209-212). Unlike the other
        # gated terms it is evaluated only past its gate: a VGG16 forward
        # and backward over the frame is the costliest loss, and a gated-off
        # term contributes exact zeros either way.
        from materialrefgs_torch.train import lpips as lpips_mod

        pl = lpips_mod.lpips(img, gt_image, lpips_weights)
        tb["perceptual_loss"] = pl
        loss = loss + opt.lambda_perceptual_loss * pl

    tb["loss"] = loss
    return loss, tb
