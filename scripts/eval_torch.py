"""Evaluation CLI of the PyTorch/CUDA port (the counterpart of scripts/eval.py):
load a trained model, render the train/test sets, write metrics + per-map
PNGs. Runs on the CUDA card unless --device cpu is given.

An env-GS checkpoint (`env_point_cloud.ply` beside `point_cloud.ply`, as the
`surfel2` stage writes) renders through render_surfel2, with mesh-traced
visibility when the run dumped `meshes/*.ply` (the newest is used). The
tracer's budgets start as scripts/eval.py sets them (`pair_capacity` from the
run's cfg_args.json, 1<<14 stage-1 cluster pairs); where a view's traces need
more, evaluate.render_set redoes it with budgets that fit instead of serving
it truncated.

A COLMAP scene (refreal) is served at the run's resolution, read from its
cfg_args.json (`-r` at training). LPIPS is reported when the weights exist
($MATERIALREFGS_LPIPS_WEIGHTS, train/lpips.py), else None.

--relight HDR serves the model under a new environment: a Radiance RGBE
latlong (utils/hdr.py) turned into the cubemap in place of the trained env1
(models/env_light.load_envlight_from_hdr). --export_material_mesh bakes the
gaussians' materials onto the newest meshes/*.ply (ops/mesh_tracer.
bake_vertex_attrs) and writes fuse_post_material.ply beside the run
(train/mesh_material.py), also for a run without an env-GS cloud (the
raytracing_residual flavor).

Usage: python scripts/eval_torch.py -m output/helmet -s /data/refnerf/helmet
       python scripts/eval_torch.py -m output/helmet -s /data/refnerf/helmet --relight sky.hdr
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_gt_normals(source_path, image_names, hw, device=None):
    """GT normal maps for the test split, when the dataset ships them
    (Glossy Synthetic via nero2blender: `normal/{name}.png`; Shiny Blender:
    `test/{name}_normal.png`). Returns (normals, masks) or (None, None).
    The files decode by content, as Pillow opens them (PNG, or JPEG partly
    on `device`), as n = 2*rgb - 1; the alpha channel (if any) is the
    foreground mask. A map of another size than the renders is resized
    first, as Pillow's BILINEAR does (scripts/eval.py:36; RGBA premultiplied)."""
    from materialrefgs_torch.data.readers import read_image
    from materialrefgs_torch.utils import resample

    layouts = [
        lambda n: os.path.join(source_path, "normal", n + ".png"),
        lambda n: os.path.join(source_path, "test", n + "_normal.png"),
        lambda n: os.path.join(source_path, n + "_normal.png"),
    ]
    for layout in layouts:
        if not all(os.path.exists(layout(n)) for n in image_names):
            continue
        normals, masks = [], []
        for n in image_names:
            arr = read_image(layout(n), device)
            if arr.shape[:2] != tuple(hw):
                arr = resample.resize(arr, (hw[1], hw[0]), resample.BILINEAR)
            arr = arr.astype(np.float32) / 255.0
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            normals.append(arr[..., :3] * 2.0 - 1.0)
            masks.append(
                (arr[..., 3] > 0.5).astype(np.float32)
                if arr.shape[-1] == 4
                else np.ones(arr.shape[:2], np.float32)
            )
        return normals, masks
    return None, None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--preset", default="refnerf", choices=["refnerf", "refreal", "glossy"])
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_test", action="store_true")
    ap.add_argument("--relight", default=None, metavar="HDR",
                    help="render under a new environment: a Radiance .hdr latlong")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to render (default: the CUDA card)")
    ap.add_argument("--export_material_mesh", action="store_true",
                    help="write fuse_post_material.ply: the newest extracted mesh with per-vertex "
                         "rgb/normal/diffuse/albedo/metallic/roughness (mesh_utils.py:255)")
    args = ap.parse_args(argv)

    import torch

    from materialrefgs_torch import config as cfg
    from materialrefgs_torch import resolve_device
    from materialrefgs_torch.evaluate import render_set, save_png, write_metrics
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models.env_light import EnvLightMips, EnvLightParams, load_envlight_from_hdr
    from materialrefgs_torch.models.scene import Scene
    from materialrefgs_torch.ops.cubemap import cubemap_to_latlong
    from materialrefgs_torch.ops import mesh_tracer
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.ops.tracer.api import TracerConfig
    from materialrefgs_torch.render.renderers import RenderOptions
    from materialrefgs_torch.train.mesh_extract import read_mesh_ply
    from materialrefgs_torch.train.stages import select_stage

    device = resolve_device(args.device)

    # Prefer the training run's dumped config; --preset is the fallback.
    extra_cfg = {}
    loaded = cfg.load_config(args.model_path)
    if loaded is not None:
        model_params, pipe, opt, extra_cfg = loaded
        print(f"Using {os.path.join(args.model_path, 'cfg_args.json')}")
    else:
        preset = {
            "refnerf": cfg.preset_refnerf,
            "refreal": cfg.preset_refreal,
            "glossy": cfg.preset_glossy,
        }[args.preset]
        model_params, pipe, opt = preset()
    model_params = dataclasses.replace(
        model_params, source_path=args.source_path, model_path=args.model_path
    )

    pc_dir = os.path.join(args.model_path, "point_cloud")
    it = args.iteration
    if it < 0:
        iters = [int(d.split("_")[-1]) for d in os.listdir(pc_dir) if d.startswith("iteration_")]
        it = max(iters)
    # Mid-curriculum checkpoints evaluate on the path they trained with
    # (select_render_method): initial / volume (env2) / deferred.
    eval_stage = select_stage(it, opt)
    if eval_stage not in ("initial", "volume"):
        eval_stage = "surfel"

    scene = Scene.load(model_params, device=device)
    ply = os.path.join(pc_dir, f"iteration_{it}", "point_cloud.ply")
    print(f"Loading {ply}")
    model, env1, env2 = gaussian_io.load_ply(
        ply, max_sh_degree=model_params.sh_degree, device=device
    )
    if args.relight:
        env1 = load_envlight_from_hdr(args.relight, res=model_params.envmap_max_res, device=device)
        print(f"Relighting with {args.relight}")
    env1 = env1 or EnvLightParams.create(model_params.envmap_max_res, device=device)
    # A volume-stage checkpoint shades with env2 when the run saved it, else
    # with env1 (scripts/eval.py:186-195).
    shade_env = env2 if eval_stage == "volume" and env2 is not None else env1
    with torch.no_grad():
        mips = EnvLightMips.build(
            shade_env,
            min_roughness=model_params.envmap_min_roughness,
            max_roughness=model_params.envmap_max_roughness,
        )
        # Trained environment map dumps (reference eval.py:129-139).
        for name, env in (("env1", env1), ("env2", env2)):
            if env is not None:
                img = torch.sigmoid(cubemap_to_latlong(env.base, 512, 1024))
                save_png(os.path.join(args.model_path, f"{name}.png"), torch.clamp(img, 0, 1))

    env_ply = os.path.join(pc_dir, f"iteration_{it}", "env_point_cloud.ply")
    env_model = None
    if os.path.exists(env_ply):
        env_model, _, _ = gaussian_io.load_ply(env_ply, max_sh_degree=model_params.sh_degree, device=device)

    # Mesh-traced specular visibility from the newest mesh the run dumped.
    mesh = None
    mesh_dir = os.path.join(args.model_path, "meshes")
    plys = sorted(p for p in os.listdir(mesh_dir) if p.endswith(".ply")) if os.path.isdir(mesh_dir) else []
    if args.export_material_mesh and not plys:
        raise FileNotFoundError(f"--export_material_mesh: no extracted mesh under {mesh_dir}")
    if plys and (env_model is not None or args.export_material_mesh):
        verts, faces = read_mesh_ply(os.path.join(mesh_dir, plys[-1]))
    if env_model is not None and plys:
        mesh = mesh_tracer.build_mesh(verts, faces, device=device)
        print(f"Mesh visibility: {plys[-1]} ({len(faces)} tris)")
    results = {}
    if args.export_material_mesh:
        from materialrefgs_torch.train.mesh_material import write_material_mesh_ply

        attrs = mesh_tracer.bake_vertex_attrs(model, verts)
        out = os.path.join(args.model_path, "fuse_post_material.ply")
        write_material_mesh_ply(out, verts, faces, attrs)
        print(f"Material mesh: {out} ({len(verts)} verts, baked from {plys[-1]})")
        results["material_mesh"] = out

    opts = RenderOptions(
        srgb=opt.srgb,
        unbiased_depth=pipe.unbiased_depth,
        use_asg=pipe.use_asg,
        depth_ratio=pipe.depth_ratio,
        raster=RasterizeConfig(pair_capacity=int(extra_cfg.get("pair_capacity", 1 << 20))),
    )
    # Final renders composite the traced indirect light in each ray's exact
    # order within every chunk.
    tr_cfg = TracerConfig(exact_order=True, pair_capacity=int(extra_cfg.get("pair_capacity", 1 << 19)))
    bg = (1.0, 1.0, 1.0) if model_params.white_background else (0.0, 0.0, 0.0)
    out_dir = os.path.join(args.model_path, f"eval_{it}")
    if not args.skip_test and scene.test_cameras:
        images = [scene.test_image(i) for i in range(len(scene.test_cameras))]
        test_names = [ci.image_name for ci in scene.info.test_cameras]
        gt_normals, gt_nmasks = load_gt_normals(
            args.source_path, test_names, images[0].shape[:2], device
        )
        if gt_normals is not None:
            print(f"GT normals found for {len(gt_normals)} test views (normal MAE on)")
        m = render_set(
            out_dir, "test", scene.test_cameras, images, model, mips, env_model, opts,
            tracer_cfg=tr_cfg, bg_color=bg, mesh=mesh, stage=eval_stage,
            gt_normals=gt_normals, gt_normal_masks=gt_nmasks,
        )
        write_metrics(out_dir, m)
        print("test:", {k: v for k, v in m.items() if k != "per_view_psnr"})
        results["test"] = m
    if not args.skip_train:
        images = [scene.train_image(i) for i in range(len(scene.train_cameras))]
        m = render_set(
            out_dir, "train", scene.train_cameras, images, model, mips, env_model, opts,
            tracer_cfg=tr_cfg, bg_color=bg, mesh=mesh, stage=eval_stage,
        )
        print("train:", {k: v for k, v in m.items() if k != "per_view_psnr"})
        results["train"] = m
    return results


if __name__ == "__main__":
    main()
