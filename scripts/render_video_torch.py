"""Fly-through frames of a trained model through the PyTorch/CUDA port (the
counterpart of scripts/render_video.py; reference utils/render_utils.py
generate_path + utils/video_utils.py). The reference encodes with mediapy;
this writes a PNG sequence to <model>/video/frame_XXXXX.png, rendered with
render_surfel over a white background. Runs on the CUDA card unless
--device cpu is given.

Usage:
  python scripts/render_video_torch.py -m output/helmet -s /data/refnerf/helmet \
      [--n_frames 120] [--path ellipse|interp] [--iteration N] [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--n_frames", type=int, default=120)
    ap.add_argument("--path", default="ellipse", choices=["ellipse", "interp"])
    ap.add_argument("--pair_capacity", type=int, default=1 << 21)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to render (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from materialrefgs_torch import config as cfg
    from materialrefgs_torch import resolve_device
    from materialrefgs_torch.evaluate import save_png
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models.env_light import EnvLightMips
    from materialrefgs_torch.models.scene import Scene
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
    from materialrefgs_torch.utils.video import generate_ellipse_path, interpolate_cameras

    device = resolve_device(args.device)
    loaded = cfg.load_config(args.model_path)
    model_params, pipe, opt = loaded[:3] if loaded is not None else cfg.preset_refnerf()
    model_params = dataclasses.replace(model_params, source_path=args.source_path)
    scene = Scene.load(model_params, device=device)

    pc_dir = os.path.join(args.model_path, "point_cloud")
    it = args.iteration
    if it < 0:
        it = max(int(d.split("_")[-1]) for d in os.listdir(pc_dir) if d.startswith("iteration_"))
    # Capacity: the next power of two over the PLY's splats (scripts/render_video.py
    # fixes 1 << 18, which refuses larger models and pads small ones).
    model, e1, _ = gaussian_io.load_ply(os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply"), device=device)
    with torch.no_grad():
        mips = EnvLightMips.build(e1)

    if args.path == "ellipse":
        cams = generate_ellipse_path(scene.train_cameras, args.n_frames)
    else:
        per = max(args.n_frames // max(len(scene.train_cameras) - 1, 1), 2)
        cams = interpolate_cameras(scene.train_cameras, per)

    ropts = RenderOptions(unbiased_depth=pipe.unbiased_depth, srgb=opt.srgb,
                          raster=RasterizeConfig(pair_capacity=args.pair_capacity))
    out_dir = os.path.join(args.model_path, "video")
    os.makedirs(out_dir, exist_ok=True)
    bg = torch.ones(3, device=device)
    for i, cam in enumerate(cams):
        with torch.no_grad():
            pkg = render_surfel(model, cam, bg, mips, ropts)
        save_png(os.path.join(out_dir, f"frame_{i:05d}.png"), pkg["render"])
        if i % 20 == 0:
            print(f"frame {i}/{len(cams)}", flush=True)
    print(f"wrote {len(cams)} frames to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
