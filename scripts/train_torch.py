"""Training CLI of the PyTorch/CUDA port (the counterpart of scripts/train.py)
for the three presets' curricula, stages `initial`, `volume` (per-gaussian
shading against env2, asked for with --volume_render_until_iter N), `surfel`
and `surfel2` (env-GS traced indirect light, mesh visibility, exact-order
tracing), on Blender-layout scenes (refnerf, glossy) and COLMAP scenes
(refreal: a `sparse/0` model beside `images/`, PNG photos, `-r 4` by the
preset). Runs on the CUDA card unless --device cpu is given.

Usage:
  python scripts/train_torch.py -s /data/refnerf/helmet -m output/helmet
  python scripts/train_torch.py -s /data/refreal/gardenspheres -m output/gs --preset refreal
  python scripts/train_torch.py -s <scene> -m <out> --schedule_scale 0.01 \
      --iterations 240 --device cpu

-r/--resolution N trains at 1/N of the photos' size (refreal's preset sets
4), resized as Pillow's LANCZOS does; foreground masks of another size take
Pillow's NEAREST (refreal reads them from the scene's mask/ dir). With
use_perceptual_loss (refreal's preset) the LPIPS weights are read from
$MATERIALREFGS_LPIPS_WEIGHTS (default assets/lpips_vgg.npz, made by
scripts/convert_lpips_weights.py); without them the run goes on without the
perceptual term, says so in a banner and records `lpips_disabled` in
cfg_args.json.

Writes point_cloud/iteration_N/point_cloud.ply (+ the env maps, and past the
surfel2 onset env_point_cloud.ply) and meshes/test_XXXXXX.ply that
scripts/eval_torch.py loads, cfg_args.json, train_log.json, and checkpoints
(chkpnt{N}.pt). When multi_view_ncc_weight > 0 (refnerf: 0.15) the multi-view
warp losses run past multi_view_weight_from_iter (refnerf 25000 x
schedule_scale) against each view's neighbours (the scene's nearest-view
graph) or virtual cameras (--use_virtul_cam). --metric3d_path reads
camera-space normal priors (PNG, v/255*2-1) for the mono-normal loss;
--ref_score_path reads reflection-score masks (PNG, last channel > 128) or,
given `auto`, mines them at ref_score_start_iter. The flags of
PipelineParams pick the flavor: --use_asg (ASG indirect lobes) and
--indirect_type raytracing_residual (mesh-traced one-bounce indirect light,
no env-GS model). --detect_anomaly checks the loss and every gradient group
for nonfinite values each step and stops with the groups named;
--deadline_min N saves a checkpoint and the PLYs at the first save, test or
checkpoint mark past N minutes and stops there.

--dp N trains with camera-batch data parallelism over N ranks, one view and
one device each (parallel/dp_trainer.py), the gradients averaged in an
all_reduce: over NCCL on N cards (rank r on cuda:r), or over gloo with
--device cpu. Outside a launcher it starts the N ranks itself
(torch.multiprocessing, start method spawn); under torchrun (RANK and
WORLD_SIZE set) each process is one rank of the launcher's group, whose size
must be N. Fewer than N cards on the host raise. Only rank 0 writes
(checkpoints, PLYs, meshes, visualisations, train_log.json, psnr.json, the
test renders); every rank loads a --start_checkpoint. Rank 0 logs the test
PSNR to psnr.json (continued across resumes) and TensorBoard scalars when
torch.utils.tensorboard imports.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_masks(mask_dir, train_infos, hw, device=None):
    """Foreground masks from `{image_name}.png` files (last channel > 128;
    decoded by content, as Pillow opens them: PNG or JPEG, a JPEG partly on
    `device`), one per train view, or None when any is missing (reference
    get_mask_dir, train_glossy.py:101-134). A mask of another size than the
    images is resized first, as Pillow's NEAREST does (scripts/train.py:194-195)."""
    from materialrefgs_torch.data.readers import read_image
    from materialrefgs_torch.utils import resample

    masks = []
    for ci in train_infos:
        p = os.path.join(mask_dir, ci.image_name + ".png")
        if not os.path.exists(p):
            return None
        arr = read_image(p, device)
        if arr.shape[:2] != tuple(hw):
            arr = resample.resize(arr, (hw[1], hw[0]), resample.NEAREST)
        masks.append((arr[..., -1] > 128).astype(np.float32))
    return masks


def load_normal_priors(metric3d_path, source_path, preset, train_infos, device=None):
    """Metric3D mono-normal priors, (H, W, 3) camera-space normals v/255*2-1,
    one per train view, or None when any is missing. The layout differs per
    preset (train_glossy.py:62 `{scan}/normal`, train_refnerf.py:60
    `{scan}_train/normal`); a flat dir of `{image_name}.png` also works.
    Files decode by content, as load_masks's do."""
    from materialrefgs_torch.data.readers import read_image

    scan = os.path.basename(os.path.normpath(source_path))
    suffix = "" if preset == "glossy" else "_train"
    prior_dirs = [os.path.join(metric3d_path, scan + suffix, "normal"),
                  os.path.join(metric3d_path, scan, "normal"), metric3d_path]
    prior_rt = next((d for d in prior_dirs if os.path.isdir(d)), None)
    priors = []
    for ci in train_infos:
        p = os.path.join(prior_rt, ci.image_name + ".png") if prior_rt else ""
        if not (p and os.path.exists(p)):
            return None
        priors.append((read_image(p, device).astype(np.float32) / 255.0 * 2 - 1)[..., :3])
    return priors


def load_ref_score_masks(ref_score_path, train_infos, device=None):
    """Precomputed reflection-score masks (train_refreal.py:177-185): last
    channel > 128, one per train view, decoded by content as load_masks's;
    a missing file raises."""
    from materialrefgs_torch.data.readers import read_image

    masks = []
    for ci in train_infos:
        p = os.path.join(ref_score_path, ci.image_name + ".png")
        if not os.path.exists(p):
            raise FileNotFoundError(f"--ref_score_path given but {p} is missing")
        masks.append((read_image(p, device)[..., -1] > 128).astype(np.float32))
    return masks


def main(argv=None) -> dict:
    """Parse the flags and train; with --dp, as one rank of a torchrun group,
    in this process at --dp 1, or by spawning the N ranks (the returned dict
    is then {"dp": N})."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if not args.dp:
        return _train(args)
    import torch

    from materialrefgs_torch import resolve_device
    from materialrefgs_torch.parallel import multihost

    resolve_device(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != args.dp:
            raise SystemExit(f"--dp {args.dp} but the launcher's group has WORLD_SIZE {world}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if args.device == "cuda" and torch.cuda.device_count() < local:
            raise SystemExit(f"--dp {args.dp}: {local} ranks on this host but only "
                             f"{torch.cuda.device_count()} CUDA cards visible")
        return _train(args, int(os.environ["RANK"]), world)
    if args.device == "cuda" and torch.cuda.device_count() < args.dp:
        raise SystemExit(f"--dp {args.dp} but only {torch.cuda.device_count()} CUDA cards visible "
                         "(on the CPU: --device cpu)")
    if args.dp == 1:
        return _train(args, 0, 1, f"localhost:{multihost.free_port()}")
    multihost.spawn(os.path.abspath(__file__), "_train_rank", argv, args.dp)
    return {"dp": args.dp}


def _train_rank(argv, rank: int, world: int, coordinator: str):
    """One spawned rank of --dp N."""
    _train(_parse(argv), rank, world, coordinator)


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--preset", default="refnerf", choices=["refnerf", "refreal", "glossy"])
    ap.add_argument("-r", "--resolution", type=int, default=None,
                    help="image downscale factor (reference -r; refreal's preset: 4)")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--schedule_scale", type=float, default=1.0,
                    help="uniformly compress/stretch the whole curriculum by this "
                         "factor; applied before --iterations and explicit flags")
    ap.add_argument("--capacity", type=int, default=1 << 19)
    ap.add_argument("--pair_capacity", type=int, default=1 << 20)
    ap.add_argument("--tracer_pair_capacity", type=int, default=None,
                    help="splat-tracer pair budget (default: --pair_capacity); also the "
                         "ceiling of its escalation when given")
    ap.add_argument("--approx_tracer_order", action="store_true",
                    help="train the env-GS trace in the shared list order instead of each "
                         "ray's exact hit order (eval is always exact)")
    ap.add_argument("--no_mesh_visibility", action="store_true",
                    help="splat-traced soft visibility past indirect_from_iter instead of "
                         "the extracted mesh's")
    ap.add_argument("--mesh_every", type=int, default=None,
                    help="TSDF mesh re-extraction interval past indirect_from_iter "
                         "(default 2000 x schedule_scale)")
    ap.add_argument("--save_iterations", type=int, nargs="+", default=None)
    ap.add_argument("--test_iterations", type=int, nargs="+", default=None)
    ap.add_argument("--test_every", type=int, default=0,
                    help="evaluate test-set PSNR every N iterations")
    ap.add_argument("--checkpoint_iterations", type=int, nargs="+", default=None)
    ap.add_argument("--checkpoint_every", type=int, default=0)
    ap.add_argument("--start_checkpoint", default=None,
                    help="run directory holding chkpnt{N}.pt to resume from")
    ap.add_argument("--start_ply", default=None,
                    help="point_cloud/iteration_N dir to initialize model + env maps "
                         "from (fresh optimizer state), continuing at --start_iter")
    ap.add_argument("--start_iter", type=int, default=0)
    ap.add_argument("--mask_dir", default=None,
                    help="dir of foreground-mask PNGs (last channel > 128); "
                         "default: the scene's train/ dir for refnerf")
    ap.add_argument("--metric3d_path", default=None,
                    help="dir of Metric3D normal PNGs ({scan}_train/normal, {scan}/normal or flat)")
    ap.add_argument("--ref_score_path", default=None,
                    help="dir of reflection-score PNGs (last channel > 128), or 'auto' to mine "
                         "them in-process at ref_score_start_iter")
    ap.add_argument("--dp", type=int, default=0,
                    help="camera-batch data parallelism over N ranks (NCCL on N cards, gloo with --device cpu)")
    ap.add_argument("--deadline_min", type=float, default=0,
                    help="wall-clock budget in minutes: at the first mark past it, save a checkpoint, "
                         "the PLYs and the log, and stop cleanly at that iteration boundary")
    ap.add_argument("--detect_anomaly", action="store_true",
                    help="check the loss and every gradient group for nonfinite values each step and "
                         "stop with the offending groups named (reference train_refnerf.py:1832)")
    ap.add_argument("--seed", type=int, default=3407)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default: the CUDA card)")

    from materialrefgs_torch import config as cfg

    cfg.add_param_flags(ap)
    args = ap.parse_args(argv)
    if args.mesh_every is None:
        # The mesh cadence is a curriculum literal (train_refnerf.py:1459):
        # it compresses with the schedule.
        args.mesh_every = max(1, round(2000 * args.schedule_scale))
    return args


def _train(args, rank: int = 0, world: int = 1, coordinator: str | None = None) -> dict:
    """The run; with --dp, rank `rank` of `world` (joining the group at
    `coordinator`, or the launcher's from the environment)."""
    from materialrefgs_torch import config as cfg

    import torch

    from materialrefgs_torch import resolve_device
    from materialrefgs_torch.evaluate import render_set
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models import gaussian_model as gm
    from materialrefgs_torch.models.env_light import EnvLightMips
    from materialrefgs_torch.models.scene import Scene
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.ops.tracer.api import TracerConfig
    from materialrefgs_torch.render.renderers import RenderOptions
    from materialrefgs_torch.train.optim import Adam
    from materialrefgs_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from materialrefgs_torch.train.stages import select_stage
    from materialrefgs_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    writer = rank == 0  # only rank 0 writes files
    if args.dp:
        from materialrefgs_torch.parallel import multihost

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
            torch.cuda.set_device(device)
        else:
            # The ranks share the host's cores; more threads than that spin
            # against each other.
            torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world)))
        multihost.initialize(coordinator, world, rank, device=device)
        print(f"[dp] rank {rank}/{world} on {device} over {torch.distributed.get_backend()}", flush=True)
    preset = {"refnerf": cfg.preset_refnerf, "refreal": cfg.preset_refreal,
              "glossy": cfg.preset_glossy}[args.preset]
    model_params, pipe, opt = preset()
    if args.schedule_scale != 1.0:
        opt = cfg.scale_schedule(opt, args.schedule_scale)
        print(f"[schedule] curriculum scaled x{args.schedule_scale}: iterations={opt.iterations}, "
              f"init_until={opt.init_until_iter}, indirect_from={opt.indirect_from_iter}")
    model_params, pipe, opt = cfg.apply_param_flags(args, model_params, pipe, opt)
    model_params = dataclasses.replace(model_params, source_path=args.source_path,
                                       model_path=args.model_path)
    if args.iterations:
        opt = dataclasses.replace(opt, iterations=args.iterations)

    def dump_config(opt, extra):
        if writer:
            cfg.dump_config(args.model_path, model_params, pipe, opt, extra=extra)

    dump_config(opt, {"preset": args.preset, "capacity": args.capacity, "pair_capacity": args.pair_capacity,
                      "seed": args.seed})

    print(f"Loading scene from {args.source_path} ...")
    scene = Scene.load(model_params, device=device)
    n_train = len(scene.train_cameras)
    images = [scene.train_image(i) for i in range(n_train)]
    H, W = images[0].shape[:2]
    print(f"{n_train} train cameras ({W}x{H}), extent {scene.cameras_extent:.2f}")

    mask_dir = args.mask_dir
    if mask_dir is None:
        auto = {"glossy": "rgb", "refnerf": "train", "refreal": "mask"}[args.preset]
        cand = os.path.join(args.source_path, auto)
        mask_dir = cand if os.path.isdir(cand) else None
    masks = load_masks(mask_dir, scene.info.train_cameras, (H, W), device) if mask_dir else None
    if masks is not None:
        print(f"Loaded {len(masks)} foreground masks from {mask_dir}")
    priors = None
    if args.metric3d_path and os.path.isdir(args.metric3d_path):
        priors = load_normal_priors(args.metric3d_path, args.source_path, args.preset, scene.info.train_cameras,
                                    device)
        print(f"Loaded {len(priors)} normal priors from {args.metric3d_path}" if priors is not None
              else f"[warn] --metric3d_path {args.metric3d_path}: a train view has no prior; mono-normal off")
    ref_score_masks = None
    if args.ref_score_path and args.ref_score_path != "auto":
        ref_score_masks = load_ref_score_masks(args.ref_score_path, scene.info.train_cameras, device)

    pcd = scene.info.point_cloud
    if len(pcd.points) > args.capacity:
        # Keep room for densification: subsample the seed cloud to half cap.
        sel = np.random.default_rng(args.seed).choice(len(pcd.points), args.capacity // 2, replace=False)
        pcd = pcd._replace(points=pcd.points[sel], colors=pcd.colors[sel])
    start_env = (None, None)
    if args.start_ply:
        model, *start_env = gaussian_io.load_ply(
            os.path.join(args.start_ply, "point_cloud.ply"), capacity=args.capacity,
            max_sh_degree=model_params.sh_degree, device=device,
        )
        print(f"Warm-started {int(model.n_alive)} gaussians from {args.start_ply}")
    else:
        model = gm.create_from_points(
            pcd.points, pcd.colors, capacity=args.capacity, max_sh_degree=model_params.sh_degree,
            rng=np.random.default_rng(args.seed), init_refl=opt.init_refl_value,
            init_roughness=opt.init_roughness_value, device=device,
        )
        print(f"Initialized {len(pcd.points)} gaussians (capacity {args.capacity})")

    bg = (1.0, 1.0, 1.0) if model_params.white_background else (0.0, 0.0, 0.0)
    tracer_pairs = args.tracer_pair_capacity or args.pair_capacity
    trainer_kw = {}
    trainer_cls = Trainer
    if args.dp:
        from materialrefgs_torch.parallel.dp_trainer import DPTrainer

        trainer_cls = DPTrainer
        trainer_kw["group"] = None
    trainer = trainer_cls(
        model, scene.train_cameras, images, opt, pipe,
        cameras_extent=scene.cameras_extent, bg_color=bg,
        raster_cfg=RasterizeConfig(pair_capacity=args.pair_capacity),
        seed=args.seed, envmap_res=model_params.envmap_max_res, masks=masks,
        normal_priors=priors, ref_score_masks=ref_score_masks, nearest_ids=scene.nearest_ids,
        with_warp=opt.multi_view_ncc_weight > 0,
        envmap_min_roughness=model_params.envmap_min_roughness,
        envmap_max_roughness=model_params.envmap_max_roughness,
        tracer_cfg=TracerConfig(pair_capacity=tracer_pairs, cluster_pair_capacity=tracer_pairs >> 7,
                                mesh_cull_cap=512, exact_order=not args.approx_tracer_order),
        mesh_dir=os.path.join(args.model_path, "meshes"),
        mesh_every=args.mesh_every,
        use_mesh_visibility=not args.no_mesh_visibility,
        virtual_cam_trans_noise=model_params.multi_view_max_dis,
        virtual_cam_deg_noise=model_params.multi_view_max_angle,
        detect_anomaly=args.detect_anomaly,
        **trainer_kw,
    )
    extra_cfg = {"preset": args.preset, "capacity": args.capacity, "seed": args.seed}
    if trainer.lpips_disabled:
        # The durable record of the degradation (scripts/train.py:334-342):
        # the persisted config says the perceptual loss did not run.
        opt = trainer.opt
        extra_cfg["lpips_disabled"] = True
        dump_config(opt, {**extra_cfg, "pair_capacity": args.pair_capacity})
    if args.tracer_pair_capacity:
        # An explicit tracer budget is also its escalation's ceiling.
        trainer.MAX_TRACER_PAIR_CAPACITY = args.tracer_pair_capacity

    save_iters = set(args.save_iterations or [opt.iterations])
    ckpt_iters = set(args.checkpoint_iterations or [])
    if args.checkpoint_every:
        ckpt_iters |= set(range(args.checkpoint_every, opt.iterations + 1, args.checkpoint_every))
    test_marks = set(args.test_iterations or [])
    if args.test_every:
        test_marks |= set(range(args.test_every, opt.iterations + 1, args.test_every))
    marks = {m for m in save_iters | ckpt_iters | test_marks | {opt.iterations} if m <= opt.iterations}
    done = 0
    if args.start_checkpoint:
        trainer.state, done = load_checkpoint(args.start_checkpoint, device=device)
        print(f"Resumed from {args.start_checkpoint} at iteration {done}")
    elif args.start_ply:
        e1, e2 = start_env
        if e1 is not None:
            trainer.state.env1.base.data.copy_(e1.base)
        if e2 is not None:
            trainer.state.env2.base.data.copy_(e2.base)
        trainer.state.step = args.start_iter
        env_ply = os.path.join(args.start_ply, "env_point_cloud.ply")
        if os.path.exists(env_ply):
            env_gs, _, _ = gaussian_io.load_ply(env_ply, capacity=args.capacity,
                                                max_sh_degree=model_params.sh_degree, device=device)
            trainer.state.env_gs = env_gs
            trainer.state.env_adam = Adam({k: v.detach() for k, v in trainer.state.env_params().items()})
            print(f"Warm-started {int(env_gs.n_alive)} env gaussians from {env_ply}")
        done = args.start_iter
    marks = {m for m in marks if m > done}
    if args.ref_score_path == "auto":
        rs_iter = opt.ref_score_start_iter
        if done < rs_iter <= opt.iterations:
            marks.add(rs_iter)
        elif done >= rs_iter:
            # Resumed past the mining point: masks are not checkpointed, so
            # mine now, or the resumed run would train without the ref-score
            # supervision an uninterrupted run has.
            print(f"[resume] mining reflection scores (past {rs_iter}) ...")
            trainer.mine_ref_scores()

    def save_ply(iteration):
        out = os.path.join(args.model_path, f"point_cloud/iteration_{iteration}/point_cloud.ply")
        results["ply"] = out
        if not writer:
            return out
        gaussian_io.save_ply(trainer.state.model, out, env1=trainer.state.env1, env2=trainer.state.env2)
        if trainer.state.env_gs is not None:
            gaussian_io.save_ply(trainer.state.env_gs, os.path.join(os.path.dirname(out), "env_point_cloud.ply"))
        return out

    def write_log():
        if writer:
            with open(os.path.join(args.model_path, "train_log.json"), "w") as f:
                json.dump(trainer.metrics_log, f)

    def deadline_passed() -> bool:
        over = bool(args.deadline_min) and (time.time() - t0) / 60 > args.deadline_min
        if args.dp:
            # The ranks' clocks differ: they stop together if any is over.
            flag = torch.tensor([int(over)], device=device)
            torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
            over = bool(flag.item())
        return over

    logger = None
    if writer:
        from materialrefgs_torch.utils.logging_utils import TrainLogger

        logger = TrainLogger(args.model_path)
    results = {"trainer": trainer, "test": {}, "ply": None, "deadline_hit": False}
    t0 = time.time()
    for target in sorted(marks):
        if deadline_passed():
            # A clean stop at an iteration boundary (scripts/train.py:414-435):
            # checkpoint, PLYs and the log of the iteration reached.
            print(f"[deadline] {args.deadline_min:g} min budget exhausted at iteration {done}/{opt.iterations}; "
                  "saving and exiting")
            results["deadline_hit"] = True
            if writer:
                save_checkpoint(trainer.state, done, args.model_path)
            dump_config(opt, {**extra_cfg, "pair_capacity": trainer.raster_cfg.pair_capacity})
            save_ply(done)
            write_log()
            break
        trainer.train(target - done, start_iter=done + 1, log_every=args.log_every)
        done = target
        if args.ref_score_path == "auto" and target == opt.ref_score_start_iter:
            print(f"[{target}] mining reflection scores ...")
            trainer.mine_ref_scores()
        if logger is not None and trainer.metrics_log:
            logger.scalars(target, trainer.metrics_log[-1])
        write_log()
        if writer and target in test_marks and scene.test_cameras:
            st = trainer.state
            with torch.no_grad():
                mips = EnvLightMips.build(st.env1, min_roughness=model_params.envmap_min_roughness,
                                          max_roughness=model_params.envmap_max_roughness)
            # As scripts/train.py does, a volume-stage mark is evaluated
            # through the deferred `surfel` path with env1's mips.
            stage = select_stage(target, opt)
            surfel2 = stage == "surfel2"
            m = render_set(
                os.path.join(args.model_path, f"test_{target}"), "test", scene.test_cameras,
                [scene.test_image(i) for i in range(len(scene.test_cameras))], st.model, mips,
                env_model=st.env_gs if surfel2 else None,
                opts=RenderOptions(unbiased_depth=pipe.unbiased_depth, srgb=opt.srgb,
                                   depth_ratio=pipe.depth_ratio,
                                   raster=RasterizeConfig(pair_capacity=trainer.raster_cfg.pair_capacity)),
                # Test renders trace in exact order, whatever the training order.
                tracer_cfg=dataclasses.replace(trainer.tracer_cfg, exact_order=True),
                dump_maps=False, bg_color=bg, stage="initial" if stage == "initial" else "surfel",
                mesh=trainer.mesh if surfel2 else None,
            )
            results["test"][target] = m
            logger.test_psnr(target, m["psnr"])
            print(f"[{target}] test psnr {m['psnr']:.2f}")
        if writer and target in ckpt_iters:
            save_checkpoint(trainer.state, target, args.model_path)
        if target in save_iters or target == opt.iterations:
            # Record the escalated pair capacity, so eval renders the model
            # without dropping pairs.
            dump_config(opt, {**extra_cfg, "pair_capacity": trainer.raster_cfg.pair_capacity})
            save_ply(target)
            last = trainer.metrics_log[-1] if trainer.metrics_log else {}
            if writer:
                print(f"[{target}] saved; psnr={last.get('psnr', float('nan')):.2f} "
                      f"n_alive={last.get('n_alive', 0)} wall={time.time() - t0:.0f}s")
    if logger is not None:
        logger.close()
    if args.dp:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
