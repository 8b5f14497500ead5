"""Evaluation (reference eval.py): render a camera set, compute PSNR/SSIM
(+FPS), dump per-map PNGs and metric.txt.

LPIPS is reported as None: the reference's pretrained VGG weights are not
available offline, and the JAX package reports the same in their absence.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.models.env_light import EnvLightMips
from materialrefgs_torch.models.gaussian_model import GaussianModel
from materialrefgs_torch.render.renderers import RenderOptions, render_initial, render_surfel
from materialrefgs_torch.train.losses import psnr, ssim
from materialrefgs_torch.utils.png import write_png


def _numpy(img) -> np.ndarray:
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def save_png(path: str, img):
    arr = np.clip(_numpy(img), 0, 1)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    # Round like torchvision save_image (mul(255).add_(0.5)).
    write_png(path, (arr * 255 + 0.5).astype(np.uint8))


def depth_vis(depth) -> np.ndarray:
    d = _numpy(depth)
    lo, hi = np.percentile(d[d > 0], 2) if (d > 0).any() else 0, d.max() + 1e-8
    return np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)


@torch.no_grad()
def render_set(
    out_dir: str,
    name: str,
    cameras: list[Camera],
    images: list[np.ndarray],
    model: GaussianModel,
    envmap: EnvLightMips,
    env_model: GaussianModel | None = None,
    opts: RenderOptions = RenderOptions(),
    dump_maps: bool = True,
    bg_color=(0.0, 0.0, 0.0),
    stage: str = "surfel",
    gt_normals: list | None = None,  # (H, W, 3) world normals in [-1, 1]
    gt_normal_masks: list | None = None,  # (H, W) foreground masks
) -> dict:
    """reference eval.py:23-106 render_set: per-view metrics + map dumps.

    bg_color must match the dataset's composite background (white for the
    Shiny Blender synthetic presets). stage="initial" evaluates the SH-color
    path of the pre-deferred curriculum phase."""
    if stage not in ("initial", "surfel"):
        raise NotImplementedError(
            f"stage {stage!r} is not ported yet: the volume stage comes with "
            "the multi-view/volume slice, surfel2 with the surfel2 slice"
        )
    if env_model is not None:
        raise NotImplementedError(
            "env-GS checkpoints (env_point_cloud.ply) render through the splat "
            "tracer, which comes with the surfel2 slice of the port"
        )
    dev = model.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    psnrs, ssims, times, normal_maes, overflows = [], [], [], [], []

    def run(cam):
        if stage == "initial":
            return render_initial(model, cam, bg, opts)
        return render_surfel(model, cam, bg, envmap, opts)

    for idx, (cam, gt) in enumerate(zip(cameras, images)):
        t0 = time.perf_counter()
        pkg = run(cam)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        overflows.append(int(pkg["overflow"]))
        gt_t = torch.clamp(torch.as_tensor(gt, dtype=torch.float32, device=dev), 0.0, 1.0)
        # Reference protocol clamps to [0,1] before every metric
        # (eval.py:44-50); deferred specular can overshoot 1.
        render_c = torch.clamp(pkg["render"], 0.0, 1.0)
        psnrs.append(float(psnr(render_c, gt_t)))
        ssims.append(float(ssim(render_c, gt_t)))
        if gt_normals is not None:
            # GT-normal mean angular error in degrees over the foreground.
            ng = np.asarray(gt_normals[idx], np.float32)
            ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-8)
            npred = _numpy(pkg["rend_normal"]).astype(np.float32)
            npred = npred / np.maximum(np.linalg.norm(npred, axis=-1, keepdims=True), 1e-8)
            m = (
                np.asarray(gt_normal_masks[idx], np.float32)
                if gt_normal_masks is not None
                else _numpy(pkg["rend_alpha"])[..., 0] > 0.5
            )
            cosang = np.clip(np.sum(ng * npred, axis=-1), -1.0, 1.0)
            ang = np.degrees(np.arccos(cosang))
            normal_maes.append(float(np.sum(ang * m) / max(float(np.sum(m)), 1.0)))
        if dump_maps:
            base = os.path.join(out_dir, name)
            save_png(f"{base}/renders/{idx:05d}.png", pkg["render"])
            save_png(f"{base}/gt/{idx:05d}.png", gt_t)
            save_png(f"{base}/normal/{idx:05d}.png", _numpy(pkg["rend_normal"]) * 0.5 + 0.5)
            save_png(f"{base}/depth/{idx:05d}.png", depth_vis(pkg["surf_depth"]))
            for key, fname in [
                ("diffuse_map", "diffuse"),
                ("specular_map", "specular"),
                ("base_color_map", "albedo"),
            ]:
                if key in pkg:
                    save_png(f"{base}/{fname}/{idx:05d}.png", pkg[key])
            for key, fname in [
                ("roughness_map", "roughness"),
                ("refl_strength_map", "metallic"),
            ]:
                if key in pkg:
                    save_png(f"{base}/{fname}/{idx:05d}.png", _numpy(pkg[key])[..., 0])

    # Skip the first frame's wall time (kernel build and warm-up).
    fps = 1.0 / np.mean(times[1:]) if len(times) > 1 else 1.0 / max(times[0], 1e-9)
    return {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": None,
        "fps": float(fps),
        "per_view_psnr": psnrs,
        "normal_mae": float(np.mean(normal_maes)) if normal_maes else None,
        # Pairs dropped for capacity, worst view; nonzero means truncated
        # renders (raise the run's pair_capacity).
        "overflow": max(overflows),
    }


def write_metrics(out_dir: str, metrics: dict):
    """metric.txt (eval.py:72-74); normal_mae when GT normals were given."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metric.txt"), "w") as f:
        f.write(f"psnr: {metrics['psnr']}\n")
        f.write(f"ssim: {metrics['ssim']}\n")
        f.write(f"lpips: {metrics['lpips']}\n")
        f.write(f"fps: {metrics['fps']}\n")
        if metrics.get("normal_mae") is not None:
            f.write(f"normal_mae: {metrics['normal_mae']}\n")
