"""Camera-batch data parallelism over torch.distributed (the JAX package's
parallel/data_parallel.py).

The parameters are replicated on every rank, each rank renders its own
camera through the unchanged tile kernels (and, in `surfel2`, the tracer
kernels), and the gradients are averaged over the group's ranks in one
all_reduce inside the step, where the JAX package's shard_map step calls
jax.lax.pmean over its mesh axis. The Adam update then runs on every rank
on the same averaged gradients, so the parameters stay replicated without a
broadcast. Where the JAX step takes stacked per-device camera batches, each
rank here passes its own camera, so no stacking is needed.
"""
from __future__ import annotations

import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.config import OptimizationParams, PipelineParams
from materialrefgs_torch.models.env_light import EnvLightMips
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
from materialrefgs_torch.train import losses
from materialrefgs_torch.train.trainer import TrainState, TrainStep, make_train_step, param_lrs


def make_dp_production_step(group, stage: str, opt: OptimizationParams, pipe: PipelineParams,
                            spatial_lr_scale: float, raster_cfg: RasterizeConfig, envmap_n_samples: int = 32,
                            **step_kwargs) -> TrainStep:
    """The real curriculum step (train/trainer.TrainStep: env-GS tracing in
    surfel2, the warp losses, densification statistics, mask entropy, Adam)
    with its collectives over `group`: step(state, camera, gt, extra,
    mesh=None) -> metrics, with this rank's camera, ground truth and extra.
    Gradients, loss and metrics come back averaged and the overflow counts
    summed; the densification statistics sum each rank's per-view norms.
    step_kwargs go to make_train_step (with_warp, tracer_cfg, lpips_weights,
    env_{min,max}_roughness, detect_anomaly). `group` None is the default
    group."""
    import torch.distributed as dist

    group = dist.group.WORLD if group is None else group
    return make_train_step(stage, opt, pipe, spatial_lr_scale, raster_cfg, envmap_n_samples, group=group,
                           **step_kwargs)


def make_dp_train_step(group, opt: OptimizationParams, pipe: PipelineParams, spatial_lr_scale: float,
                       raster_cfg: RasterizeConfig, envmap_n_samples: int = 8):
    """The reduced data-parallel step of the JAX package's make_dp_train_step:
    render_surfel over a black background, calculate_loss, gradients of the
    model and env1 averaged over `group`, and Adam (env2 updated with a zero
    gradient). Returns step(state, camera, gt, iteration) -> {"loss",
    "psnr"}, both averaged over the ranks. `group` None is the default
    group."""
    import torch.distributed as dist

    group = dist.group.WORLD if group is None else group
    ropts = RenderOptions(depth_ratio=pipe.depth_ratio, use_asg=pipe.use_asg,
                          unbiased_depth=pipe.unbiased_depth, srgb=opt.srgb, raster=raster_cfg)

    def step(state: TrainState, camera: Camera, gt: torch.Tensor, iteration: float) -> dict:
        mips = EnvLightMips.build(state.env1, n_samples=envmap_n_samples)
        pkg = render_surfel(state.model, camera, torch.zeros(3, device=gt.device), mips, ropts)
        loss, tb = losses.calculate_loss(gt, pkg, opt, float(iteration))
        params = state.params()
        names = [k for k in params if k != "env2"]
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        flat = torch.cat([(g if g is not None else torch.zeros_like(params[k])).reshape(-1)
                          for k, g in zip(names, grads)]
                         + [loss.detach().reshape(1), torch.as_tensor(tb["psnr"], device=gt.device).reshape(1)])
        dist.all_reduce(flat, group=group)
        flat.div_(dist.get_world_size(group))
        avg, pos = {}, 0
        for k in names:
            avg[k] = flat[pos : pos + params[k].numel()].view_as(params[k])
            pos += params[k].numel()
        state.adam.step(params, avg, param_lrs(opt, spatial_lr_scale, state.step))
        state.step += 1
        return {"loss": flat[pos], "psnr": flat[pos + 1]}

    return step
