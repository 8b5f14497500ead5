"""Evaluation (reference eval.py): render a camera set, compute PSNR/SSIM
(+FPS), dump per-map PNGs and metric.txt.

LPIPS(vgg) is reported when converted weights exist (train/lpips.py), and as
None without them, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.models.env_light import EnvLightMips
from materialrefgs_torch.models.gaussian_model import GaussianModel
from materialrefgs_torch.ops.tracer.api import TracerConfig
from materialrefgs_torch.render.envgs import render_surfel2
from materialrefgs_torch.render.renderers import RenderOptions, render_initial, render_surfel, render_volume
from materialrefgs_torch.train.losses import psnr, ssim
from materialrefgs_torch.utils.logging_utils import count, span
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
    tracer_cfg: TracerConfig = TracerConfig(),
    dump_maps: bool = True,
    bg_color=(0.0, 0.0, 0.0),
    stage: str = "surfel",
    mesh=None,  # ops.mesh_tracer.MeshData: mesh-traced specular visibility
    gt_normals: list | None = None,  # (H, W, 3) world normals in [-1, 1]
    gt_normal_masks: list | None = None,  # (H, W) foreground masks
) -> dict:
    """reference eval.py:23-106 render_set: per-view metrics + map dumps.

    bg_color must match the dataset's composite background (white for the
    Shiny Blender synthetic presets). stage="initial" evaluates the SH-color
    path of the pre-deferred curriculum phase, stage="volume" the
    per-gaussian shading of the volume stage with the caller's envmap (env2
    for a volume-stage checkpoint); with `env_model` (an env-GS
    checkpoint) the deferred stage renders through render_surfel2, and a view
    whose traces overflow `tracer_cfg` is redone with budgets that fit it
    (fit_tracer_budgets), kept for the views after it; its time counts the
    redo."""
    if stage not in ("initial", "volume", "surfel"):
        raise ValueError(f"stage {stage!r} is not one of initial, volume, surfel")
    dev = model.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    psnrs, ssims, times, normal_maes, overflows, tracer_overflows = [], [], [], [], [], []
    # LPIPS(vgg) when converted weights exist (reference eval.py:52); absent
    # weights are reported as lpips=None, never as a silent zero.
    from materialrefgs_torch.train import lpips as lpips_mod

    lpips_net = lpips_mod.LPIPS(device=dev) if lpips_mod.weights_available() else None
    lpipses = []

    def run(cam, tcfg):
        if stage == "initial":
            return render_initial(model, cam, bg, opts)
        if stage == "volume":
            return render_volume(model, cam, bg, envmap, opts)
        if env_model is not None:
            return render_surfel2(model, env_model, cam, bg, envmap, opts, tcfg, mesh=mesh)
        return render_surfel(model, cam, bg, envmap, opts)

    cull_warned = False
    redos = 0

    for idx, (cam, gt) in enumerate(zip(cameras, images)):
        with span("serve.view"):
            t0 = time.perf_counter()
            pkg = run(cam, tracer_cfg)
            # The JAX package serves a view whose traces overflow their budgets
            # truncated; the port redoes it with budgets that fit. Two redos
            # suffice: after the first the cluster budget fits, so the pair
            # slots the second render reports are exact.
            for _ in range(2):
                if int(pkg.get("tracer_overflow", 0)) == 0:
                    break
                tracer_cfg = fit_tracer_budgets(tracer_cfg, pkg)
                print(
                    f"[info] eval view {idx}: tracer overflow {int(pkg['tracer_overflow'])}; "
                    f"redone at cluster_pair_capacity {tracer_cfg.cluster_pair_capacity}, "
                    f"pair_capacity {tracer_cfg.pair_capacity}"
                )
                redos += 1
                pkg = run(cam, tracer_cfg)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            overflows.append(int(pkg["overflow"]))
            tracer_overflows.append(int(pkg.get("tracer_overflow", 0)))
            if not cull_warned and int(pkg.get("mesh_cull_dropped", 0)) > 0:
                print(
                    f"[warn] eval view {idx}: mesh pre-cull dropped "
                    f"{int(pkg['mesh_cull_dropped'])} occluder clusters — "
                    f"visibility maps are truncated; raise TracerConfig.mesh_cull_cap"
                )
                cull_warned = True
        with span("serve.metrics"):
            gt_t = torch.clamp(torch.as_tensor(gt, dtype=torch.float32, device=dev), 0.0, 1.0)
            # Reference protocol clamps to [0,1] before every metric
            # (eval.py:44-50); deferred specular can overshoot 1.
            render_c = torch.clamp(pkg["render"], 0.0, 1.0)
            psnrs.append(float(psnr(render_c, gt_t)))
            ssims.append(float(ssim(render_c, gt_t)))
            if lpips_net is not None:
                with torch.no_grad():
                    lpipses.append(float(lpips_net(render_c, gt_t)))
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
            with span("serve.png"):
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
                    ("visibility", "visibility"),
                ]:
                    if key in pkg:
                        save_png(f"{base}/{fname}/{idx:05d}.png", _numpy(pkg[key])[..., 0])

    # Skip the first frame's wall time (kernel build and warm-up).
    fps = 1.0 / np.mean(times[1:]) if len(times) > 1 else 1.0 / max(times[0], 1e-9)
    return {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": float(np.mean(lpipses)) if lpipses else None,
        "fps": float(fps),
        "per_view_psnr": psnrs,
        "normal_mae": float(np.mean(normal_maes)) if normal_maes else None,
        # Rasterizer pairs dropped for capacity, worst view; nonzero means
        # truncated renders (raise the run's pair_capacity).
        "overflow": max(overflows),
        # Splat-tracer pairs dropped in the served renders, worst view, the
        # renders redone at raised budgets, and the budgets the set ended at.
        "tracer_overflow": max(tracer_overflows),
        "tracer_redos": redos,
        "tracer_budgets": (tracer_cfg.cluster_pair_capacity, tracer_cfg.pair_capacity),
    }


def fit_tracer_budgets(cfg: TracerConfig, pkg: dict) -> TracerConfig:
    """`cfg` with budgets that keep every pair `pkg` (a render_surfel2
    result) asked for, a quarter above it; pair_capacity in whole steps of
    1<<16 (the segment layout needs a multiple of 128). Never lowered."""
    count("tracer.refit")
    step = 1 << 16
    pairs = -(-int(1.25 * pkg["tracer_pair_slots"]) // step) * step
    return dataclasses.replace(
        cfg,
        cluster_pair_capacity=max(cfg.cluster_pair_capacity, int(1.25 * pkg["tracer_cluster_pairs"])),
        pair_capacity=max(cfg.pair_capacity, pairs),
    )


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
