"""Training loop for the curriculum's `initial`, `volume`, `surfel` and
`surfel2` stages (the JAX package's train/trainer.py, reference
train_refnerf.py:1012-1533), from iteration 1 to the end of the schedule.

`make_train_step(stage, ...)` returns one optimization step of that stage
(a `TrainStep`, whose render and update halves can be called apart):
render through the rasterizer (both tile kernels; in `volume` the
gaussians are shaded first, against env2's mips) and, in `surfel2`, the
env-GS trace (both tracer kernels) with mesh-traced visibility, the loss terms
(calculate_loss with the image-gradient weight, the normal-consistency
ladder, mask entropy when masks exist, the env-scope penalty when
configured), one backward, the Adam update with the per-group learning rates,
the densification statistics from the screen-offset gradient, and in
`surfel2` the env-GS model's own Adam update and statistics. Past the warp
gate (multi_view_weight_from_iter) a step also renders its nearest view
geometry-only and adds the multi-view warp losses (train/warp.py); with
normal priors it adds the mono-normal loss, and with ref-score masks (given,
or mined by `Trainer.mine_ref_scores`) the ref-score material supervision.
`Trainer` runs
the JAX Trainer's schedule of SH oneups, pair-capacity escalation on binning
overflow, densify/prune with prune grace, the white-background kick, opacity
resets, the normal-propagation resets with the opacity-LR toggle (past a
volume stage with `dist_color`), the volume -> surfel material re-init, and
from the surfel2 onset the env-GS init, TSDF mesh extraction, the
tracer-budget probe, env densify/prune/reset with the signal-counted grace,
the env SH ladder and the extinction re-seed.

With PipelineParams.indirect_type "raytracing_residual" (the reference's
other INDIRECT_TYPE flavor) `surfel2` spawns no env-GS model: its step shades
the indirect light by tracing every pixel's reflected ray through the
extracted mesh (render_surfel(mesh=...), render/renderers.mesh_indirect_maps),
and the mesh is extracted at the onset even without mesh visibility. With
use_asg the per-gaussian indirect light is ASG lobes (utils/asg.py) instead of
SH. With detect_anomaly each step counts the nonfinite values of the loss and
of every gradient group, and the Trainer raises a FloatingPointError naming
the groups.

The port runs eagerly, so a step mutates the state in place where the JAX
step returns a new one. With use_perceptual_loss the `surfel` and `surfel2`
steps add the LPIPS term (train/lpips.py) past perceptual_loss_start_iter;
without weights the Trainer degrades loudly, as the JAX Trainer does.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from materialrefgs_torch.cameras import Camera, gen_virtual_cam
from materialrefgs_torch.config import OptimizationParams, PipelineParams
from materialrefgs_torch.evaluate import fit_tracer_budgets
from materialrefgs_torch.models import gaussian_model as gm
from materialrefgs_torch.models.env_light import EnvLightMips, EnvLightParams
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
from materialrefgs_torch.ops.tracer.api import TracerConfig
from materialrefgs_torch.render.envgs import render_surfel2, tracer_demand_probe
from materialrefgs_torch.render.renderers import RenderOptions, render_initial, render_surfel, render_volume
from materialrefgs_torch.train import losses, warp
from materialrefgs_torch.train.optim import Adam
from materialrefgs_torch.train.stages import select_stage
from materialrefgs_torch.utils.logging_utils import backward_spans, count, span, spanned
from materialrefgs_torch.utils.transforms import abs_, expon_lr

STAGES = ("initial", "volume", "surfel", "surfel2")
INDIRECT_TYPES = ("origin", "raytracing_residual")
# Parameters the volume -> surfel transition re-initialises, moments zeroed.
VOLUME_REINIT = ("ori_color", "refl_strength", "roughness")


@dataclass
class TrainState:
    model: gm.GaussianModel
    env1: EnvLightParams  # gaussians.env_map
    env2: EnvLightParams  # gaussians.env_map_2 (volume stage)
    adam: Adam
    step: int = 0  # optimizer steps taken (the xyz LR schedule's clock)
    opacity_lr_scale: float = 1.0  # set_opacity_lr toggle, 0 or 1
    env_gs: gm.GaussianModel | None = None  # environment gaussians (surfel2)
    env_adam: Adam | None = None  # their own Adam, counted from the onset

    def params(self) -> dict[str, torch.Tensor]:
        """Every optimized tensor by name: the model's raw parameters, then
        the two cubemaps (the JAX optimizer's (params, env1, env2) tree)."""
        out = {name: getattr(self.model, name) for name in gm.PARAM_SHAPES}
        out["env1"] = self.env1.base
        out["env2"] = self.env2.base
        return out

    def env_params(self) -> dict[str, torch.Tensor]:
        """The env-GS model's raw parameters by name."""
        return {name: getattr(self.env_gs, name) for name in gm.PARAM_SHAPES}

    def init_env_gs(self) -> None:
        """Env-GS from the main model with a fresh Adam (_init_env_gs)."""
        self.env_gs = gm.env_gs_from(self.model)
        self.env_adam = Adam({k: v.detach() for k, v in self.env_params().items()})


def init_train_state(model: gm.GaussianModel, envmap_res: int = 128) -> TrainState:
    env1 = EnvLightParams.create(envmap_res, device=model.device)
    env2 = EnvLightParams.create(envmap_res, device=model.device)
    state = TrainState(model=model, env1=env1, env2=env2, adam=None)
    state.adam = Adam({k: v.detach() for k, v in state.params().items()})
    return state


def param_lrs(opt: OptimizationParams, spatial_lr_scale: float, step: int,
              opacity_lr_scale: float = 1.0) -> dict[str, float]:
    """Per-parameter learning rates (_param_lrs, trainer.py:54-84; reference
    training_setup gaussian_model.py:440-466)."""
    return {
        "xyz": expon_lr(
            step,
            opt.position_lr_init * spatial_lr_scale,
            opt.position_lr_final * spatial_lr_scale,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps,
        ),
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "opacity": opt.opacity_lr * opacity_lr_scale,
        "refl_strength": opt.refl_strength_lr,
        "metalness": opt.metalness_lr,
        "roughness": opt.roughness_lr,
        "ori_color": opt.ori_color_lr,
        "diffuse_color": opt.ori_color_lr,
        "features_dc": opt.features_lr,
        "features_rest": opt.features_lr / 20.0,
        "indirect_dc": opt.indirect_lr,
        "indirect_rest": opt.indirect_lr / 20.0,
        "indirect_asg": opt.asg_lr,
        "normal1": 0.0,  # frozen (training_setup:434)
        "normal2": 0.0,
        "env1": opt.envmap_cubemap_lr,
        "env2": opt.envmap_cubemap_lr,
    }


def _ladder(iteration: int, steps) -> float:
    """Value of the last (threshold, value) step with threshold < iteration."""
    v = steps[0][1]
    for thr, val in steps:
        if iteration > thr:
            v = val
    return v


def normal_gamma_schedule(iteration: int, opt: OptimizationParams) -> float:
    """Mono-normal prior weight ladder (train_refnerf.py:1138-1149; the
    ladder is preset config, glossy's differs)."""
    g = 0.0
    if iteration > opt.init_until_iter:
        g = _ladder(iteration, opt.normal_gamma_ladder)
    if iteration > opt.normal_prop_until_iter or iteration > opt.densify_until_iter:
        g = 0.0
    if opt.indirect_from_iter < iteration < opt.indirect_from_iter + 10000:
        g = 0.0
    return g


def normal_loss_weight_schedule(iteration: int, opt: OptimizationParams) -> float:
    """get_current_normal_loss_weight (train_refnerf.py:1183-1196): the
    reference's chain of `current < thr` tests makes thresholds inclusive."""
    v = opt.normal_weight_ladder[0][1]
    for thr, val in opt.normal_weight_ladder:
        if iteration >= thr:
            v = val
    return v


class TrainStep:
    """One optimization step of `initial`, `volume`, `surfel` or `surfel2`, in two
    halves so that the caller can look at the render before anything is
    updated: `render(state, camera, extra, mesh)` draws the view (with the
    screen-offset leaf of the densification statistics; `surfel2` traces the
    env-GS model with the mesh's visibility, or the splat visibility without
    one) and `update(state, camera, gt, extra, rendered)` takes the loss, its
    backward and the Adam updates and returns the metrics. Calling the step
    does both. The step updates `state` in place.

    extra: {"iteration", "lambda_normal_render_depth", "bg"}, in `surfel2`
    "env_geo_lr_scale" (0 past env_update_until_iter: freeze_geo), and, when
    the scene has foreground masks, "image_mask" (H, W). With the warp
    (with_warp, `surfel` and `surfel2`): "nearest_camera", "nearest_gt"
    (H, W, 3), "warp_photo_weight" (0 for a virtual camera) and
    "warp_uniforms" (H*W,), the random pixel scores; the render then holds
    the nearest view's geometry-only render under "nearest_pkg". With normal
    priors: "normal_prior" (H, W, 3) and "normal_gamma". With ref-score
    masks: "ref_score_mask" (H, W). Each of these two terms is on exactly
    when its key is in `extra`."""

    def __init__(
        self,
        stage: str,
        opt: OptimizationParams,
        pipe: PipelineParams,
        spatial_lr_scale: float,
        raster_cfg: RasterizeConfig,
        envmap_n_samples: int = 32,
        env_min_roughness: float = 0.08,
        env_max_roughness: float = 0.5,
        tracer_cfg: TracerConfig = TracerConfig(),
        with_warp: bool = False,
        lpips_weights: dict | None = None,
        detect_anomaly: bool = False,
        group=None,
    ):
        if stage not in STAGES:
            raise ValueError(f"stage {stage!r} is not one of {STAGES}")
        if pipe.indirect_type not in INDIRECT_TYPES:
            raise ValueError(f"indirect_type {pipe.indirect_type!r} is not one of {INDIRECT_TYPES}")
        self.stage = stage
        # raytracing_residual: no env-GS model; the mesh-traced one-bounce
        # shading is the indirect term (trainer.py:215-222).
        self.residual = stage == "surfel2" and pipe.indirect_type == "raytracing_residual"
        self.detect_anomaly = detect_anomaly
        # Camera-batch data parallelism (parallel/data_parallel.py): the
        # torch.distributed group whose ranks each render their own view.
        self.group = group
        self.with_warp = with_warp and stage in ("surfel", "surfel2")
        self.tracer_cfg = tracer_cfg
        # The perceptual loss applies to the deferred stages (trainer.py:252).
        self.lpips_weights = lpips_weights if stage in ("surfel", "surfel2") else None
        self.opt = opt
        self.spatial_lr_scale = spatial_lr_scale
        self.envmap_n_samples = envmap_n_samples
        self.env_min_roughness = env_min_roughness
        self.env_max_roughness = env_max_roughness
        self.ropts = RenderOptions(
            depth_ratio=pipe.depth_ratio,
            use_asg=pipe.use_asg,
            unbiased_depth=pipe.unbiased_depth,
            srgb=opt.srgb,
            raster=raster_cfg,
        )
        self.lopt = dataclasses.replace(opt, lambda_normal_render_depth=0.0)  # applied in update

    def __call__(self, state: TrainState, camera: Camera, gt: torch.Tensor, extra: dict,
                 mesh=None) -> dict:
        return self.update(state, camera, gt, extra, self.render(state, camera, extra, mesh))

    @spanned("TrainStep.render")
    def render(self, state: TrainState, camera: Camera, extra: dict, mesh=None) -> tuple[dict, torch.Tensor]:
        """(the render package, the screen-offset leaf it was drawn with)."""
        pkg, offset = self._render_main(state, camera, extra, mesh)
        if self.with_warp:
            # The warp reads only geometry and material maps, none of which
            # depends on shading, the env-GS trace or the mesh: the nearest
            # view is rendered geometry-only (trainer.py:259-269).
            with span("warp.nearest_render"):
                pkg["nearest_pkg"] = render_surfel(state.model, extra["nearest_camera"], extra["bg"], None,
                                                   self.ropts, wo_render_img=True)
        return pkg, offset

    def _render_main(self, state: TrainState, camera: Camera, extra: dict, mesh) -> tuple[dict, torch.Tensor]:
        model = state.model
        offset = torch.zeros((model.capacity, 2), device=model.device, requires_grad=True)
        if self.stage == "initial":
            return render_initial(model, camera, extra["bg"], self.ropts, offset), offset
        if self.stage == "volume":
            # The volume stage shades each gaussian against env2's mips,
            # rebuilt every step, differentiably (trainer.py:204-209).
            with span("envlight.mips"):
                mips = EnvLightMips.build(
                    state.env2, n_samples=self.envmap_n_samples,
                    min_roughness=self.env_min_roughness, max_roughness=self.env_max_roughness,
                )
            return render_volume(model, camera, extra["bg"], mips, self.ropts, offset), offset
        # The mips are rebuilt from env1 every step, differentiably
        # (trainer.py:210-213).
        with span("envlight.mips"):
            mips = EnvLightMips.build(
                state.env1, n_samples=self.envmap_n_samples,
                min_roughness=self.env_min_roughness, max_roughness=self.env_max_roughness,
            )
        if self.residual:
            pkg = render_surfel(model, camera, extra["bg"], mips, self.ropts, offset, mesh=mesh,
                                mesh_cull_cap=self.tracer_cfg.mesh_cull_cap)
            return pkg, offset
        if self.stage == "surfel2":
            if state.env_gs is None:
                raise ValueError("the surfel2 step needs the env-GS model (TrainState.init_env_gs)")
            pkg = render_surfel2(model, state.env_gs, camera, extra["bg"], mips, self.ropts,
                                 self.tracer_cfg, offset, mesh=mesh)
            return pkg, offset
        return render_surfel(model, camera, extra["bg"], mips, self.ropts, offset), offset

    @spanned("TrainStep.update")
    def update(self, state: TrainState, camera: Camera, gt: torch.Tensor, extra: dict,
               rendered: tuple[dict, torch.Tensor]) -> dict:
        pkg, offset = rendered
        opt, model = self.opt, state.model
        it = float(extra["iteration"])
        with span("losses"):
            image_weight = None
            if not opt.wo_image_weight:
                image_weight = torch.clamp(1.0 - losses.get_img_grad_weight(gt), 0, 1) ** 2
            loss, tb = losses.calculate_loss(gt, pkg, self.lopt, it, image_weight, self.lpips_weights)

        if self.with_warp:
            # Multi-view warp losses (calc_warp_loss, train_refnerf.py:414).
            near = pkg["nearest_pkg"]
            near_gt = extra["nearest_gt"]
            gt_gray = 0.299 * gt[..., 0] + 0.587 * gt[..., 1] + 0.114 * gt[..., 2]
            ngray = 0.299 * near_gt[..., 0] + 0.587 * near_gt[..., 1] + 0.114 * near_gt[..., 2]
            msk = extra.get("image_mask")
            if msk is None:
                msk = torch.ones(gt.shape[:2], device=gt.device)
            wl = warp.calc_warp_loss(
                camera, extra["nearest_camera"], pkg, near, gt_gray, ngray, msk, opt, it, extra["warp_uniforms"],
                use_ncc=opt.use_warp_ncc_loss and opt.multi_view_ncc_weight > 0 and opt.use_multi_view_trim,
            )
            gate_w = float(it > opt.multi_view_weight_from_iter)
            # A virtual camera has no ground truth: only the geometric term
            # applies (train_refnerf.py:511).
            photo_w = float(extra.get("warp_photo_weight", 1.0))
            loss = loss + gate_w * (wl.geo_loss + photo_w * (
                wl.ncc_loss + wl.base_color_loss + wl.metallic_warp_loss + wl.roughness_warp_loss))
            tb["loss_warp_geo"] = wl.geo_loss
            tb["loss_warp_ncc"] = wl.ncc_loss
            tb["loss_warp_bc"] = wl.base_color_loss
            tb["loss_warp_mtl"] = wl.metallic_warp_loss
            tb["loss_warp_rgh"] = wl.roughness_warp_loss

        with span("losses"):
            if self.stage in ("surfel", "surfel2") and "ref_score_mask" in extra:
                # Reflection-score material supervision (train_refreal.py:1237-1263):
                # inside the mask metallic -> 0.9 and roughness -> 0.05, the
                # inverse outside, plus albedo smoothness in the mask.
                gate_rs = float(it > opt.ref_score_start_iter)
                rs = extra["ref_score_mask"][..., None]  # (H, W, 1)
                refl_m, rough_m = pkg["refl_strength_map"], pkg["roughness_map"]

                def masked_mean(x, m):
                    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)

                lrs = masked_mean(abs_(refl_m - 0.9), rs)
                lrs = lrs + masked_mean(abs_(rough_m - 0.05), rs)
                lrs = lrs + masked_mean(abs_(refl_m - 0.05), 1.0 - rs)
                lrs = lrs * opt.ref_score_loss_weight
                lrs = lrs + 0.5 * opt.ref_score_loss_weight * masked_mean(abs_(0.9 - rough_m), 1.0 - rs)
                lrs = lrs + losses.smooth_loss_simple(pkg["base_color_map"] * rs)
                loss = loss + gate_rs * lrs
                tb["loss_ref_score"] = lrs

            if "normal_prior" in extra:
                # Monocular normal prior (mono_normal_loss, train_refnerf.py:202).
                l1s, coss, l1r, cosr = warp.mono_normal_loss(
                    camera, pkg["surf_normal"], pkg["rend_normal"], extra["normal_prior"], extra.get("image_mask"))
                loss = loss + float(extra["normal_gamma"]) * opt.mono_normal_coef * (l1s + l1r + coss + cosr)
                tb["loss_mono_normal"] = l1s + l1r

            # Iteration-dependent normal-consistency weight (ladder).
            gate = float(it > opt.normal_loss_start)
            rn, sn = pkg["rend_normal"], pkg["surf_normal"]
            if image_weight is not None:
                ln = torch.mean(image_weight * torch.sum(abs_(sn - rn), dim=-1))
            else:
                ln = torch.mean(1.0 - torch.sum(rn * sn, dim=-1))
            loss = loss + gate * float(extra["lambda_normal_render_depth"]) * ln
            tb["loss_normal_render_depth"] = ln

            if opt.use_env_scope and self.stage in ("surfel", "surfel2", "volume"):
                # Penalize refl_strength outside the scene sphere
                # (train_refnerf.py:1022-1027, 1335-1338; weight 0.4).
                center = torch.tensor(opt.env_scope_center, dtype=torch.float32, device=model.device)
                outside = (torch.sum((model.xyz - center) ** 2, dim=-1) > opt.env_scope_radius**2) & model.alive
                denom = torch.clamp(torch.sum(outside), min=1).to(torch.float32)
                refl_msk_loss = torch.sum(model.get_refl[:, 0] * outside) / denom
                loss = loss + 0.4 * refl_msk_loss
                tb["loss_refl_msk"] = refl_msk_loss

            if self.stage in ("surfel", "surfel2") and "image_mask" in extra:
                # Mask entropy after the volume stage (train_refnerf.py:1211-1220).
                o = torch.clamp(pkg["rend_alpha"][..., 0], 1e-6, 1 - 1e-6)
                msk = extra["image_mask"]
                ent = -torch.mean(msk * torch.log(o) + (1 - msk) * torch.log(1 - o))
                loss = loss + 0.01 * ent
                tb["loss_mask_entropy"] = ent

        # One backward over the main model, both cubemaps, in surfel2 the
        # env-GS model, and the screen offset.
        params = state.params()
        names = list(params)
        leaves = [params[k] for k in names]
        env_params = state.env_params() if self.stage == "surfel2" and not self.residual else {}
        env_names = list(env_params)
        leaves += [env_params[k] for k in env_names]
        with span("update.backward"):
            backward_spans(loss)
            grads = torch.autograd.grad(loss, leaves + [offset], allow_unused=True)
        # The screen-offset gradient stays this view's own: the densification
        # statistics sum each view's norm (add_densification_stats).
        goff = grads[-1] if grads[-1] is not None else torch.zeros_like(offset)
        anomaly = self._nonfinite_counts(loss, names, env_names, grads) if self.detect_anomaly else {}
        metrics = {k: v.detach() for k, v in tb.items()}
        metrics["loss"] = loss.detach()
        metrics["overflow"] = pkg["overflow"]
        metrics.update(anomaly)
        if self.with_warp:
            metrics["nearest_overflow"] = pkg["nearest_pkg"]["overflow"]
        if self.residual:
            metrics["tracer_overflow"] = 0
            metrics["tracer_pairs"] = 0
            metrics["mesh_cull_dropped"] = int(pkg.get("mesh_cull_dropped", 0))
        elif self.stage == "surfel2":
            metrics["tracer_overflow"] = int(pkg["tracer_overflow"])
            metrics["tracer_pairs"] = int(pkg["tracer_pairs"])
            metrics["mesh_cull_dropped"] = int(pkg["mesh_cull_dropped"])
        if self.group is not None:
            grads = self._all_reduce(grads[:-1], leaves, metrics) + (goff,)
        with span("update.adam"):
            lrs = param_lrs(opt, self.spatial_lr_scale, state.step, state.opacity_lr_scale)
            state.adam.step(params, dict(zip(names, grads[: len(names)])), lrs)
            gm.add_densification_stats(
                model, goff, pkg["radii"].detach(),
                ndc_scale=(0.5 * camera.width, 0.5 * camera.height), group=self.group,
            )
            state.step += 1

            if self.stage == "surfel2" and not self.residual:
                # The env-GS model's own Adam. Its learning rates read the step
                # after the increment (trainer.py:461), without the opacity-LR
                # toggle; freeze_geo scales xyz and scaling, not rotation
                # (trainer.py:465-468).
                egrads = dict(zip(env_names, grads[len(names) : len(names) + len(env_names)]))
                elrs = param_lrs(opt, self.spatial_lr_scale, state.step)
                fz = float(extra.get("env_geo_lr_scale", 1.0))
                elrs["xyz"] *= fz
                elrs["scaling"] *= fz
                state.env_adam.step(env_params, egrads, elrs)
                # Under data parallelism gx is the averaged gradient (trainer.py:471-475).
                gx = egrads["xyz"] if egrads["xyz"] is not None else torch.zeros_like(env_params["xyz"])
                gm.add_env_stats(state.env_gs, gx)
                # The largest env-GS gradients this step (zero: the trace gave
                # the env cloud no learning signal), kept on the device: the
                # Trainer reads them at its log steps.
                zero = torch.zeros((), device=model.device)
                for name, keys in (("xyz", ("xyz",)), ("opacity", ("opacity",)),
                                   ("sh", ("features_dc", "features_rest"))):
                    metrics[f"env_grad_{name}"] = torch.stack(
                        [egrads[k].abs().max() if egrads[k] is not None else zero for k in keys]).max()
        return metrics

    # Metrics summed over the ranks; every other metric is averaged.
    SUMMED = ("overflow", "nearest_overflow", "tracer_overflow", "tracer_pairs", "mesh_cull_dropped")

    def _all_reduce(self, grads, leaves, metrics: dict) -> tuple:
        """Average the gradients (None: zeros, so that every rank reduces the
        same layout), the loss and every float metric over the group in one
        all_reduce, as jax.lax.pmean does (trainer.py:406-420); sum the
        counts (and --detect_anomaly's nonfinite counts) in a second one.
        Rewrites `metrics` in place, adds the first all_reduce's bytes and
        milliseconds (dp_allreduce_bytes, dp_allreduce_ms) and returns the
        averaged gradients."""
        world = dist.get_world_size(self.group)
        counts = [k for k in metrics if k in self.SUMMED or k.startswith("nonfinite/")]
        means = [k for k in metrics if k not in counts and not k.startswith("gradmax/")]
        flat = torch.cat([(g if g is not None else torch.zeros_like(a)).reshape(-1) for g, a in zip(grads, leaves)]
                         + [torch.as_tensor(metrics[k], dtype=torch.float32, device=leaves[0].device).reshape(1)
                            for k in means])
        ints = torch.tensor([int(metrics[k]) for k in counts], dtype=torch.int64, device=flat.device)
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=self.group)
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        reduce_ms = (time.perf_counter() - t0) * 1e3
        flat.div_(world)
        dist.all_reduce(ints, group=self.group)
        out, pos = [], 0
        for a in leaves:
            out.append(flat[pos : pos + a.numel()].view_as(a))
            pos += a.numel()
        for k, v in zip(means, flat[pos:]):
            metrics[k] = v
        for k, v in zip(counts, ints.tolist()):
            metrics[k] = v
        # The gradient all_reduce's size and host-clock time (synchronised).
        metrics["dp_allreduce_bytes"] = flat.numel() * flat.element_size()
        metrics["dp_allreduce_ms"] = reduce_ms
        return tuple(out)

    @staticmethod
    def _nonfinite_counts(loss, names, env_names, grads) -> dict:
        """The --detect_anomaly record (trainer.py:486-500): per group, the
        count of nonfinite entries and the largest magnitude, named as the
        JAX package names them (loss, grad.screen_offset, grad.env1,
        grad.env2, grad.env_gs, grad.param.<name>). A gradient the loss does
        not reach counts as zeros."""
        n = len(names)
        groups = {"loss": [loss.detach()], "grad.screen_offset": [grads[-1]]}
        for k, g in zip(names, grads[:n]):
            groups[f"grad.{k}" if k in ("env1", "env2") else f"grad.param.{k}"] = [g]
        if env_names:
            groups["grad.env_gs"] = list(grads[n : n + len(env_names)])
        zero = torch.zeros((), device=loss.device)
        counts, maxes = [], []
        for leaves in groups.values():
            leaves = [g.detach() for g in leaves if g is not None] or [zero]
            counts.append(sum((~torch.isfinite(g)).sum() for g in leaves))
            maxes.append(torch.stack([g.abs().max() for g in leaves]).max())
        counts, maxes = torch.stack(counts).tolist(), torch.stack(maxes).tolist()
        out = {}
        for name, c, m in zip(groups, counts, maxes):
            out[f"nonfinite/{name}"] = int(c)
            out[f"gradmax/{name}"] = float(m)
        return out


def make_train_step(
    stage: str,
    opt: OptimizationParams,
    pipe: PipelineParams,
    spatial_lr_scale: float,
    raster_cfg: RasterizeConfig,
    envmap_n_samples: int = 32,
    env_min_roughness: float = 0.08,
    env_max_roughness: float = 0.5,
    tracer_cfg: TracerConfig = TracerConfig(),
    with_warp: bool = False,
    lpips_weights: dict | None = None,
    detect_anomaly: bool = False,
    group=None,
) -> TrainStep:
    """The step of `initial`, `surfel` or `surfel2`: step(state, camera, gt,
    extra, mesh=None) -> metrics (see TrainStep). lpips_weights
    (train/lpips.load_weights) turns the perceptual term on; detect_anomaly
    adds the nonfinite/ and gradmax/ counts of each gradient group; `group`
    (a torch.distributed group) averages the gradients and metrics over its
    ranks (parallel/data_parallel.py)."""
    return TrainStep(stage, opt, pipe, spatial_lr_scale, raster_cfg, envmap_n_samples,
                     env_min_roughness, env_max_roughness, tracer_cfg, with_warp, lpips_weights,
                     detect_anomaly, group)


class Trainer:
    """Python orchestration of the curriculum (train_refnerf.py:1093-1495).

    Budget overflows: the JAX Trainer polls the rasterizer's and the
    tracer's overflow and the mesh pre-cull's drops every 10 iterations
    (reading them syncs its asynchronous dispatch) and escalates the
    budgets, so up to 10 truncated steps are applied. The port's eager step
    synchronizes with the host anyway, so the Trainer reads every render's
    counts between the step's render and update halves and redoes a render
    that dropped anything: at the escalated pair capacity (binning, of the
    view or of its nearest view's warp render), at budgets that fit (the
    tracer: evaluate.fit_tracer_budgets), or at a doubled mesh_cull_cap. No truncated step is applied unless a budget is at
    its ceiling, where the step is applied truncated with a warning, as in the
    JAX package. The rasterizer's ceiling is 4x the JAX package's 1<<23 pair
    slots (a compressed curriculum's resets ask for over 10M pairs at
    800x800). The tracer's is 1<<26 pairs, 16x the JAX package's 1<<22: a
    traced pair costs its payload column and the column's gradient, 2 x 64
    rows x 4 B at n_sh = 16, and an int64 gather index (520 B in all), so
    1<<26 pairs take 35 GB of the card's 80 GB beside the rest of a step. The
    env-GS prune grace counts the steps with traced pairs one by one, where
    the JAX Trainer adds 10 per poll."""

    MAX_PAIR_CAPACITY = 1 << 25
    MAX_TRACER_PAIR_CAPACITY = 1 << 26
    MAX_TRACER_CLUSTER_PAIRS = 1 << 20  # the cull's (cluster pair, 256) candidates: ~16 GB
    MAX_MESH_CULL_CAP = 1 << 11  # 2048 clusters = 131k triangles per block
    # TSDF grid over the observed content's bounds (~ the reference's
    # mesh_res 1024 over the camera ring, trainer.py:544-546), and the traced
    # copy's triangle budget (the full mesh is the meshes/*.ply artifact).
    MESH_RESOLUTION = 256
    MESH_TRI_CAPACITY = 1 << 16

    def __init__(
        self,
        model: gm.GaussianModel,
        cameras: list[Camera],
        images: list[np.ndarray],  # (H, W, 3) f32 in [0,1]
        opt: OptimizationParams,
        pipe: PipelineParams,
        cameras_extent: float = 3.0,
        bg_color=(0.0, 0.0, 0.0),
        raster_cfg: RasterizeConfig = RasterizeConfig(),
        seed: int = 3407,
        envmap_res: int = 128,
        masks: list[np.ndarray] | None = None,  # (H, W) fg masks
        normal_priors: list[np.ndarray] | None = None,  # (H, W, 3) camera-space (Metric3D)
        ref_score_masks: list[np.ndarray] | None = None,  # (H, W) 0/1 masks
        nearest_ids: list[list[int]] | None = None,  # Scene.nearest_ids
        with_warp: bool = False,
        envmap_min_roughness: float = 0.08,
        envmap_max_roughness: float = 0.5,
        tracer_cfg: TracerConfig = TracerConfig(),
        mesh_dir: str | None = None,  # periodic TSDF mesh artifacts
        mesh_every: int = 2000,
        vis_dir: str | None = None,  # save_training_vis output dir
        vis_every: int = 1000,
        use_mesh_visibility: bool = True,  # mesh-traced specular occlusion
        virtual_cam_trans_noise: float = 1.5,  # ModelParams.multi_view_max_dis
        virtual_cam_deg_noise: float = 30.0,  # ModelParams.multi_view_max_angle
        detect_anomaly: bool = False,  # reference --detect_anomaly
    ):
        self.pipe = pipe
        self.detect_anomaly = detect_anomaly
        self._last_cam_id = -1
        self.cameras = cameras
        dev = model.device
        # Load the LPIPS weights or degrade loudly (trainer.py:561-588): the
        # run starts, the banner says the perceptual loss is off, and
        # lpips_disabled records it (the CLI writes it to cfg_args.json).
        self.lpips_weights = None
        self.lpips_disabled = False
        if opt.use_perceptual_loss:
            from materialrefgs_torch.train import lpips as lpips_mod

            try:
                self.lpips_weights = lpips_mod.load_weights(device=dev)
            except lpips_mod.LpipsWeightsMissing as e:
                banner = "!" * 78
                print(
                    f"{banner}\n"
                    "!! PERCEPTUAL (LPIPS) LOSS DISABLED: pretrained VGG16 weights unavailable.\n"
                    f"!! {e}\n"
                    "!! Training continues WITHOUT lambda_perceptual_loss (reference "
                    f"train_refreal.py uses it from iter {opt.perceptual_loss_start_iter}).\n"
                    f"{banner}",
                    flush=True,
                )
                opt = dataclasses.replace(opt, use_perceptual_loss=False)
                self.lpips_disabled = True
        self.opt = opt
        self.images = [torch.as_tensor(np.asarray(im, np.float32), device=dev) for im in images]
        self.masks = (
            [torch.as_tensor(np.asarray(m, np.float32), device=dev) for m in masks] if masks else None
        )
        self.normal_priors = (
            [torch.as_tensor(np.asarray(n, np.float32), device=dev) for n in normal_priors]
            if normal_priors else None
        )
        self.ref_score_masks = (
            [torch.as_tensor(np.asarray(m, np.float32), device=dev) for m in ref_score_masks]
            if ref_score_masks else None
        )
        self.nearest_ids = nearest_ids
        self.with_warp = with_warp and nearest_ids is not None
        self.virtual_cam_trans_noise = virtual_cam_trans_noise
        self.virtual_cam_deg_noise = virtual_cam_deg_noise
        # (seconds, mask coverage) of each mine_ref_scores call.
        self.ref_score_log: list[tuple[float, float]] = []
        self.cameras_extent = cameras_extent
        self.spatial_lr_scale = cameras_extent
        self.bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
        self.raster_cfg = raster_cfg
        self.tracer_cfg = tracer_cfg
        self.envmap_min_roughness = envmap_min_roughness
        self.envmap_max_roughness = envmap_max_roughness
        self.state = init_train_state(model, envmap_res)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._steps: dict = {}
        self._reset0_at: int | None = None
        self._env_reset_at: int | None = None
        # Steps with traced env pairs since the last env reset (the
        # signal-counted prune grace).
        self._env_signal_steps = 0
        self._tracer_presized = False
        self.mesh_dir = mesh_dir
        self.mesh_every = mesh_every
        self.vis_dir = vis_dir
        self.vis_every = vis_every
        self.use_mesh_visibility = use_mesh_visibility
        self.mesh = None  # ops.mesh_tracer.MeshData for the traced visibility
        # (iteration, triangles, seconds) of each mesh extraction.
        self.mesh_log: list[tuple[int, int, float]] = []
        self.metrics_log: list[dict] = []
        self._order: list[int] = []

    def _step_fn(self, stage: str, warp_on: bool = False) -> TrainStep:
        key = (stage, warp_on)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                stage, self.opt, self.pipe, self.spatial_lr_scale, self.raster_cfg,
                env_min_roughness=self.envmap_min_roughness,
                env_max_roughness=self.envmap_max_roughness,
                tracer_cfg=self.tracer_cfg,
                with_warp=warp_on,
                lpips_weights=self.lpips_weights,
                detect_anomaly=self.detect_anomaly,
            )
        return self._steps[key]

    def _pick_view(self) -> int:
        """Next camera id from the epoch permutation (viewpoint_stack pop)."""
        if not self._order:
            self._order = list(self.rng.permutation(len(self.cameras)))
        return int(self._order.pop())

    def _build_extra(self, iteration: int, cam_id: int) -> dict:
        opt = self.opt
        extra = {
            "iteration": float(iteration),
            "lambda_normal_render_depth": (
                normal_loss_weight_schedule(iteration, opt)
                if opt.lambda_normal_render_depth > 0 else 0.0
            ),
            "bg": self.bg,
            # freeze_geo (env_gaussian_model3.py:200-213): past
            # env_update_until_iter the env model's xyz/scaling LRs drop to 0.
            "env_geo_lr_scale": 0.0 if iteration > opt.env_update_until_iter else 1.0,
            "normal_gamma": normal_gamma_schedule(iteration, opt),
        }
        if self.masks is not None:
            extra["image_mask"] = self.masks[cam_id]
        if self.normal_priors is not None:
            extra["normal_prior"] = self.normal_priors[cam_id]
        if self.ref_score_masks is not None:
            extra["ref_score_mask"] = self.ref_score_masks[cam_id]
        return extra

    def _warp_gate(self, iteration: int, stage: str) -> bool:
        """Whether the warp loss is live this iteration (trainer.py:777-784)."""
        return (
            self.with_warp
            and stage in ("surfel", "surfel2")
            and iteration > self.opt.multi_view_weight_from_iter
        )

    def _select_warp(self, iteration: int, stage: str, cam_id: int):
        """(warp_on, nearest_camera, nearest_gt, photo_weight, nearest_id):
        a neighbour from nearest_ids, or a virtual camera (nearest_id -1,
        photo weight 0) with probability virtul_cam_prob or when the view has
        no neighbour (train_refnerf.py:454-457). Draws from the Trainer's rng
        in the JAX Trainer's order (trainer.py:786-814)."""
        opt = self.opt
        camera, gt = self.cameras[cam_id], self.images[cam_id]
        warp_on = self._warp_gate(iteration, stage) and (len(self.nearest_ids[cam_id]) > 0 or opt.use_virtul_cam)
        if not warp_on:
            return False, camera, gt, 1.0, -1
        use_virtual = opt.use_virtul_cam and (
            self.rng.random() < opt.virtul_cam_prob or len(self.nearest_ids[cam_id]) == 0)
        if use_virtual:
            near = gen_virtual_cam(camera, self.rng, trans_noise=self.virtual_cam_trans_noise,
                                   deg_noise=self.virtual_cam_deg_noise)
            return True, near, gt, 0.0, -1
        nid = int(self.nearest_ids[cam_id][self.rng.integers(len(self.nearest_ids[cam_id]))])
        return True, self.cameras[nid], self.images[nid], 1.0, nid

    def _view_extra(self, iteration: int, stage: str, cam_id: int) -> tuple[dict, bool, int]:
        """(the step's extra for view cam_id, warp_on, nearest id): the
        warp's neighbour or virtual camera and its uniforms, drawn from the
        Trainer's rng and generator."""
        extra = self._build_extra(iteration, cam_id)
        cam = self.cameras[cam_id]
        warp_on, near_cam, near_gt, photo_w, near_id = self._select_warp(iteration, stage, cam_id)
        if warp_on:
            uniforms = torch.rand(cam.height * cam.width, generator=self.generator, device=cam.device)
            extra.update(nearest_camera=near_cam, nearest_gt=near_gt, warp_photo_weight=photo_w,
                         warp_uniforms=uniforms)
        return extra, warp_on, near_id

    def _agree(self, counts: dict) -> dict:
        """The render's drop counts as every rank of the step sees them (one
        process: its own)."""
        return counts

    def _run_step(self, iteration: int, stage: str) -> dict:
        with span("trainer.pick"):
            cam_id = self._pick_view()
            self._last_cam_id = cam_id
            extra, warp_on, near_id = self._view_extra(iteration, stage, cam_id)
        return self._render_and_update(iteration, stage, cam_id, extra, warp_on, near_id)

    def _render_and_update(self, iteration: int, stage: str, cam_id: int, extra: dict, warp_on: bool,
                           near_id: int) -> dict:
        cam = self.cameras[cam_id]
        mesh = self.mesh if stage == "surfel2" else None
        rendered = self._step_fn(stage, warp_on).render(self.state, cam, extra, mesh)
        dropped, tracer_dropped, renders = 0, 0, 0
        while True:
            pkg = rendered[0]
            # The nearest view's render is a second rasterization: its
            # overflow is redone with the view's.
            overflow = int(pkg["overflow"])
            if warp_on:
                overflow = max(overflow, int(pkg["nearest_pkg"]["overflow"]))
            counts = self._agree({
                "overflow": overflow,
                "tracer_overflow": int(pkg.get("tracer_overflow", 0)),
                "mesh_cull_dropped": int(pkg.get("mesh_cull_dropped", 0)),
                "tracer_pair_slots": int(pkg.get("tracer_pair_slots", 0)),
                "tracer_cluster_pairs": int(pkg.get("tracer_cluster_pairs", 0)),
            })
            overflow, tracer_overflow = counts["overflow"], counts["tracer_overflow"]
            raised = False
            if overflow:
                raised |= self._escalate_pair_capacity(overflow, iteration)
            if tracer_overflow:
                raised |= self._escalate_tracer_capacity(counts, iteration)
            if counts["mesh_cull_dropped"]:
                raised |= self._escalate_mesh_cull_cap(counts["mesh_cull_dropped"], iteration)
            if not raised:
                break
            dropped, tracer_dropped, renders = dropped + overflow, tracer_dropped + tracer_overflow, renders + 1
            del rendered, pkg  # free the truncated render's graph before redoing it
            count("trainer.redo")
            rendered = self._step_fn(stage, warp_on).render(self.state, cam, extra, mesh)
        metrics = self._step_fn(stage, warp_on).update(self.state, cam, self.images[cam_id], extra, rendered)
        # Renders that dropped pairs and were redone, and the pairs they
        # dropped (with the warp, the larger of the two views' overflows).
        metrics["renders_redone"] = renders
        metrics["overflow_redone"] = dropped
        metrics["warp_on"] = int(warp_on)
        metrics["warp_near"] = near_id
        if stage == "surfel2":
            metrics["tracer_overflow_redone"] = tracer_dropped
        return metrics

    def train(self, num_iters: int, start_iter: int = 1, log_every: int = 100):
        self._order = []
        for iteration in range(start_iter, start_iter + num_iters):
            with span("Trainer.train"):
                self._iteration(iteration, start_iter, log_every)
        return self.state

    def _iteration(self, iteration: int, start_iter: int, log_every: int):
        opt = self.opt
        with span("trainer.upkeep"):
            stage = select_stage(iteration, opt)
            if stage == "surfel2":
                self._surfel2_onset(iteration)
            if iteration == opt.volume_render_until_iter + 1 and opt.volume_render_until_iter > opt.init_until_iter:
                self._volume_to_surfel()

            # SH degree ladder (train_refnerf.py:1109-1111).
            if iteration > opt.feature_rest_from_iter and iteration % opt.sh_ladder_interval == 0:
                self.state.model.oneup_sh_degree()

        metrics = self._run_step(iteration, stage)
        st = self.state
        with span("trainer.upkeep"):
            if self.detect_anomaly:
                # Debug mode (trainer.py:896-911): a report naming each
                # nonfinite gradient group.
                bad = {k.removeprefix("nonfinite/"): int(v) for k, v in metrics.items()
                       if k.startswith("nonfinite/") and v > 0}
                if bad:
                    raise FloatingPointError(
                        f"anomaly at iteration {iteration} (stage {stage}, cam {self._last_cam_id}): nonfinite "
                        "values in " + ", ".join(f"{k} ({v} entries)" for k, v in sorted(bad.items())))
            if stage == "surfel2" and st.env_gs is not None:
                if metrics["tracer_pairs"] > 0:
                    self._env_signal_steps += 1
                if int(st.env_gs.n_alive) == 0:
                    # Extinction: an env cloud pruned to nothing never regrows
                    # (densify clones alive gaussians); re-seed it.
                    print(f"[warn] it={iteration}: env-GS cloud extinct (0 alive); re-seeding from the main model")
                    st.init_env_gs()
                    self._env_reset_at = None
                    self._env_signal_steps = 0

            # Mesh re-extraction before the densify/reset block: extracting
            # after a reset would snapshot a just-reset model (trainer.py:962-974).
            if (
                (self.mesh_dir or self.use_mesh_visibility)
                and iteration >= opt.indirect_from_iter
                and iteration % self.mesh_every == 0
            ):
                self._extract_mesh(iteration)
            self._densify_and_reset(iteration, stage)

        with span("trainer.log"):
            if self.vis_dir and iteration % self.vis_every == 0:
                self._save_vis(iteration, self._last_cam_id, stage)

            if iteration % log_every == 0 or iteration == start_iter:
                m = {k: float(v) for k, v in metrics.items()}
                m["iteration"] = iteration
                m["stage"] = stage
                m["n_alive"] = int(st.model.n_alive)
                if st.env_gs is not None:
                    m["env_n_alive"] = int(st.env_gs.n_alive)
                m["wall"] = time.time()
                self.metrics_log.append(m)

    def _surfel2_onset(self, iteration: int):
        """At the first surfel2 iteration: the env-GS model, the mesh, and the
        tracer budget sized from a demand probe (trainer.py:840-870)."""
        residual = self.pipe.indirect_type == "raytracing_residual"
        if self.state.env_gs is None and not residual:
            self.state.init_env_gs()
        if self.mesh is None and (self.use_mesh_visibility or residual):
            self._extract_mesh(iteration)
        if not self._tracer_presized:
            self._tracer_presized = True
            self._presize_tracer_capacity(iteration)

    def _volume_to_surfel(self):
        """The volume -> surfel transition (reset_gaussian_para,
        train_refnerf.py:1152-1153, :1508-1521; trainer.py:872-885): albedo
        re-drawn around 0.5, reflection strength 0.1, roughness the preset's
        init value, and their Adam moments zeroed."""
        model = self.state.model
        gm.reset_ori_color(model, self.generator)
        gm.reset_refl_strength(model, 0.1)
        gm.reset_roughness(model, self.opt.init_roughness_value)
        for name in VOLUME_REINIT:
            self.state.adam.zero_param(name)

    def _build_mips(self, env: EnvLightParams) -> EnvLightMips:
        with torch.no_grad():
            return EnvLightMips.build(env, n_samples=8, min_roughness=self.envmap_min_roughness,
                                      max_roughness=self.envmap_max_roughness)

    @torch.no_grad()
    def _render_view(self, cam_id: int, mips: EnvLightMips, stage: str = "surfel") -> dict:
        """A render without gradient: `surfel` for the probe and the mesh;
        the visualisation renders a `volume`-stage view with render_volume
        (mips from env2), as the JAX Trainer does (trainer.py:1300-1320)."""
        ropts = RenderOptions(unbiased_depth=self.pipe.unbiased_depth, raster=self.raster_cfg)
        if stage == "volume":
            return render_volume(self.state.model, self.cameras[cam_id], self.bg, mips, ropts)
        return render_surfel(self.state.model, self.cameras[cam_id], self.bg, mips, ropts)

    def _save_vis(self, iteration: int, cam_id: int, stage: str):
        """save_training_vis (train_refnerf.py:1533; JAX trainer.py:1321-1340):
        {vis_dir}/{iteration:06d}.png, a grid of the view's GT, render and
        normal over its depth, albedo and (roughness, reflection strength,
        0); nothing in `initial`."""
        import os

        from materialrefgs_torch.evaluate import _numpy, depth_vis, save_png

        if stage == "initial":
            return
        env = self.state.env2 if stage == "volume" else self.state.env1
        pkg = self._render_view(cam_id, self._build_mips(env), stage)
        gt = _numpy(self.images[cam_id])
        render = np.clip(_numpy(pkg["render"]), 0, 1)
        normal = _numpy(pkg["rend_normal"]) * 0.5 + 0.5
        depth = depth_vis(pkg["surf_depth"])[..., None].repeat(3, -1)
        albedo = np.clip(_numpy(pkg["base_color_map"]), 0, 1)
        rough = _numpy(pkg["roughness_map"])[..., :1]
        refl = _numpy(pkg["refl_strength_map"])[..., :1]
        top = np.concatenate([gt, render, normal], axis=1)
        bot = np.concatenate([depth, albedo, np.clip(np.concatenate([rough, refl, rough * 0], -1), 0, 1)], axis=1)
        os.makedirs(self.vis_dir, exist_ok=True)
        save_png(os.path.join(self.vis_dir, f"{iteration:06d}.png"), np.concatenate([top, bot], axis=0))

    @torch.no_grad()
    def mine_ref_scores(self, threshold: float = 0.5):
        """calc_ref_score (train_refnerf.py:790-1010; JAX trainer.py:1342-1373):
        render depth/normal/distance for every train view, mine multi-view
        colour-difference scores through occlusion-tested homography warps,
        and install thresholded masks for the ref-score supervision. Each
        score map is divided by its 98th percentile before the 0.5 threshold
        (the analog of the reference's PNG alpha > 128). The maps come from
        the geometry-only render, which draws them as the shaded one does;
        a render that overflows is redone at an escalated pair capacity."""
        from materialrefgs_torch.train import ref_score as rs

        t0 = time.perf_counter()
        ropts = RenderOptions(unbiased_depth=self.pipe.unbiased_depth, raster=self.raster_cfg)
        depths, normals, dists = [], [], []
        for i in range(len(self.cameras)):
            while True:
                pkg = render_surfel(self.state.model, self.cameras[i], self.bg, None, ropts, wo_render_img=True)
                ovf = int(pkg["overflow"])
                if not ovf or not self._escalate_pair_capacity(ovf, self.state.step):
                    break
                ropts = dataclasses.replace(ropts, raster=self.raster_cfg)
            depths.append(pkg["surf_depth"])
            normals.append(pkg["rend_normal"])
            dists.append(pkg["rend_distance"])
        # Viewing direction in world = world_view[:3,:3] @ e_z.
        R_list = [c.world_view[:3, :3].cpu().numpy() for c in self.cameras]
        neighbors = rs.neighbor_graph_wide(self.cameras, R_list)
        scores = rs.compute_ref_scores(self.cameras, self.images, depths, normals, dists, neighbors,
                                       pixel_noise_th=self.opt.multi_view_pixel_noise_th)
        masks = []
        for s in scores:
            hi = np.percentile(s, 98)
            masks.append((s / max(hi, 1e-6) > threshold).astype(np.float32))
        dev = self.state.model.device
        self.ref_score_masks = [torch.as_tensor(m, device=dev) for m in masks]
        seconds = time.perf_counter() - t0
        coverage = float(np.mean([m.mean() for m in masks]))
        self.ref_score_log.append((seconds, coverage))
        print(f"[ref-score] mined {len(masks)} views ({sum(map(len, neighbors))} neighbour warps) in "
              f"{seconds:.2f} s; the masks cover {100 * coverage:.2f} % of the pixels")
        return scores, masks

    def _presize_tracer_capacity(self, iteration: int):
        """Probe the indirect trace's pair demand over up to 4 views drawn
        from the Trainer's rng and size pair_capacity to fit it (x1.5,
        doubling from min(capacity, 1<<16) up to the ceiling), keeping the
        CLI's cluster:pair ratio (>> 7). The redo in _run_step stays the
        safety net (trainer.py:1003-1088). Without an env-GS model (the
        raytracing_residual flavor) nothing is traced and nothing is probed."""
        if self.state.env_gs is None:
            return
        cfg = self.tracer_cfg
        probe_cfg = dataclasses.replace(cfg, cluster_pair_capacity=max(cfg.cluster_pair_capacity, 1 << 16))
        mips = self._build_mips(self.state.env1)
        demand = 0
        n_probe = min(4, len(self.cameras))
        ids = self.rng.choice(len(self.cameras), size=n_probe, replace=False)
        for cam_id in ids:
            pkg = self._render_view(int(cam_id), mips)
            alpha = pkg["rend_alpha"]
            nmap = pkg["rend_normal"] / torch.clamp(alpha, min=1e-6)
            cam = self.cameras[int(cam_id)]
            demand = max(demand, tracer_demand_probe(self.state.env_gs, cam, nmap, pkg["surf_depth"], alpha,
                                                     probe_cfg, self.mesh))
            if self.mesh is None:
                # Without a mesh render_surfel2 also traces the main cloud for
                # visibility; each trace has its own pair buffer.
                demand = max(demand, tracer_demand_probe(self.state.model, cam, nmap, pkg["surf_depth"], alpha,
                                                         probe_cfg, None))
        ceiling = self.MAX_TRACER_PAIR_CAPACITY
        target = min(cfg.pair_capacity, 1 << 16)
        while target < int(demand * 1.5) and target < ceiling:
            target *= 2
        if target != cfg.pair_capacity:
            print(f"[it={iteration}] surfel2 onset: probed indirect-trace demand {demand} over {n_probe} "
                  f"views; tracer pair_capacity {cfg.pair_capacity} -> {target} (ceiling {ceiling})")
            self.tracer_cfg = dataclasses.replace(
                cfg, pair_capacity=target, cluster_pair_capacity=max(target >> 7, 1 << 9))
            self._steps.clear()
        else:
            print(f"[it={iteration}] surfel2 onset: probed indirect-trace demand {demand} fits "
                  f"pair_capacity {cfg.pair_capacity}")

    def _escalate_pair_capacity(self, overflow: int, iteration: int) -> bool:
        """Double pair_capacity until the binning fits (bounded, like the
        CUDA rasterizer's buffer growth). Returns False at the ceiling."""
        cap = self.raster_cfg.pair_capacity
        needed = cap + int(overflow)
        new_cap = cap
        while new_cap < needed and new_cap < self.MAX_PAIR_CAPACITY:
            new_cap *= 2
        if new_cap == cap:
            print(
                f"[warn] it={iteration}: binning overflow {int(overflow)} but "
                f"pair_capacity already at MAX ({cap}); the step renders truncated"
            )
            return False
        print(
            f"[it={iteration}] binning overflow {int(overflow)}; pair_capacity "
            f"{cap} -> {new_cap}, step redone"
        )
        self.raster_cfg = dataclasses.replace(self.raster_cfg, pair_capacity=new_cap)
        self._steps.clear()
        return True

    def _escalate_tracer_capacity(self, pkg: dict, iteration: int) -> bool:
        """Raise the tracer's budgets to what the render reported it needed
        (fit_tracer_budgets on its tracer_pair_slots, tracer_cluster_pairs
        and tracer_overflow), bounded by the ceiling. Returns False when
        nothing could be raised."""
        cfg = self.tracer_cfg
        new = fit_tracer_budgets(cfg, pkg)
        ceiling = self.MAX_TRACER_PAIR_CAPACITY
        new = dataclasses.replace(
            new, pair_capacity=min(new.pair_capacity, max(ceiling, cfg.pair_capacity)),
            cluster_pair_capacity=min(new.cluster_pair_capacity,
                                      max(self.MAX_TRACER_CLUSTER_PAIRS, cfg.cluster_pair_capacity)))
        overflow = int(pkg["tracer_overflow"])
        if new == cfg:
            print(f"[warn] it={iteration}: tracer overflow {overflow} but its budgets are at their ceiling "
                  f"({cfg.cluster_pair_capacity} cluster pairs, {cfg.pair_capacity} pairs); the step traces "
                  "truncated")
            return False
        print(f"[it={iteration}] tracer overflow {overflow}; cluster_pair_capacity {cfg.cluster_pair_capacity} "
              f"-> {new.cluster_pair_capacity}, pair_capacity {cfg.pair_capacity} -> {new.pair_capacity}, "
              "step redone")
        self.tracer_cfg = new
        self._steps.clear()
        return True

    def _escalate_mesh_cull_cap(self, dropped: int, iteration: int) -> bool:
        """Double the mesh tracer's per-block cluster budget (the cull is
        exact only while cull_dropped == 0). Returns False at the ceiling."""
        cap = self.tracer_cfg.mesh_cull_cap
        if cap >= self.MAX_MESH_CULL_CAP:
            print(f"[warn] it={iteration}: mesh cull dropped {dropped} clusters but mesh_cull_cap already "
                  f"at MAX ({cap})")
            return False
        print(f"[it={iteration}] mesh cull dropped {dropped} clusters; mesh_cull_cap {cap} -> {2 * cap}, "
              "step redone")
        self.tracer_cfg = dataclasses.replace(self.tracer_cfg, mesh_cull_cap=2 * cap)
        self._steps.clear()
        return True

    def _densify(self, max_screen_size, min_opacity):
        gm.densify_and_prune(
            self.state.model, self.state.adam, self.generator,
            max_grad=self.opt.densify_grad_threshold,
            min_opacity=min_opacity,
            extent=self.cameras_extent,
            max_screen_size=max_screen_size,
        )

    def _env_upkeep(self, iteration: int):
        """Env-GS maintenance on its own schedule (update_env_gs_,
        env_gaussian_model3.py:482-512; trainer.py:1175-1213): the SH ladder
        until env_update_until_iter, densify/prune every env_densify_interval
        (max_grad 1e-4; no prune while in the post-reset grace, counted in
        steps with traced pairs; screen-size prune past the first reset
        interval), and the opacity reset every env_reset_interval."""
        opt = self.opt
        st = self.state
        if iteration <= opt.env_update_until_iter and iteration % opt.sh_ladder_interval == 0:
            st.env_gs.oneup_sh_degree()
        if iteration < opt.env_update_until_iter and iteration % opt.env_densify_interval == 0:
            in_grace = self._env_reset_at is not None and self._env_signal_steps < opt.env_prune_grace
            if in_grace:
                min_opacity, max_screen = 0.0, None
            elif iteration > opt.env_reset_interval:
                min_opacity, max_screen = opt.prune_opacity_threshold, 20.0
            else:
                min_opacity, max_screen = opt.prune_opacity_threshold, None
            gm.densify_and_prune(st.env_gs, st.env_adam, self.generator, max_grad=1e-4,
                                 min_opacity=min_opacity, extent=self.cameras_extent,
                                 max_screen_size=max_screen)
            if iteration % opt.env_reset_interval == 0:
                gm.reset_opacity0(st.env_gs)
                st.env_adam.zero_param("opacity")
                self._env_reset_at = iteration
                self._env_signal_steps = 0

    def _densify_and_reset(self, iteration: int, stage: str):
        """Densification + reset block (train_refnerf.py:1414-1462); the env
        model's upkeep runs first, on its own schedule."""
        opt = self.opt
        st = self.state
        if st.env_gs is not None:
            self._env_upkeep(iteration)
        if iteration >= opt.densify_until_iter or iteration == opt.volume_render_until_iter:
            return
        if iteration <= opt.init_until_iter:
            dens_interval = opt.densification_interval
        elif iteration <= opt.normal_prop_until_iter:
            dens_interval = opt.densification_interval_when_prop
        else:
            dens_interval = opt.densification_interval

        if iteration > opt.densify_from_iter and iteration % dens_interval == 0:
            # Post-reset grace: densify without pruning until reset
            # opacities had prune_grace absolute steps to regrow.
            in_grace = self._reset0_at is not None and iteration - self._reset0_at < opt.prune_grace
            if in_grace:
                self._densify(None, 0.0)
            elif iteration > opt.opacity_reset_interval:
                self._densify(20.0, opt.prune_opacity_threshold)
            else:
                self._densify(None, opt.prune_opacity_threshold)

        has_reset0 = False
        # White-bg scenes get one extra reset right at densify_from
        # (train_refnerf.py:1436).
        white_bg_kick = bool(torch.all(self.bg == 1.0)) and iteration == opt.densify_from_iter
        if iteration % opt.opacity_reset_interval == 0 or white_bg_kick:
            has_reset0 = True
            self._reset0_at = iteration
            outside = self._outside_msk()
            gm.reset_opacity0(st.model)
            # Past indirect_from the reset value is pinned to 0.1
            # (train_refnerf.py:1440-1443).
            rv = 0.1 if iteration > opt.indirect_from_iter else None
            gm.reset_refl(st.model, exclusive_msk=outside, rst_value=rv)
            st.adam.zero_param("opacity")
            st.adam.zero_param("refl_strength")

        in_prop = opt.init_until_iter < iteration <= opt.normal_prop_until_iter
        if opt.opac_lr0_interval > 0 and in_prop and iteration % opt.opac_lr0_interval == 0:
            st.opacity_lr_scale = 1.0
        if in_prop and iteration % opt.normal_prop_interval == 0 and not has_reset0:
            outside = self._outside_msk()
            gm.reset_opacity1(st.model, exclusive_msk=outside)
            if iteration > opt.volume_render_until_iter > opt.init_until_iter:
                gm.dist_color(st.model, self.generator, exclusive_msk=outside)
            gm.reset_scale(st.model, exclusive_msk=outside)
            st.adam.zero_param("opacity")
            st.adam.zero_param("scaling")
            if opt.opac_lr0_interval > 0 and iteration != opt.normal_prop_until_iter:
                st.opacity_lr_scale = 0.0

    def _outside_msk(self):
        """get_outside_msk (train_refnerf.py:1332-1333): gaussians outside
        the env-scope sphere are excluded from material/scale resets."""
        if not self.opt.use_env_scope:
            return None
        model = self.state.model
        center = torch.tensor(self.opt.env_scope_center, dtype=torch.float32, device=model.device)
        return torch.sum((model.xyz - center) ** 2, dim=-1) > self.opt.env_scope_radius**2

    @torch.no_grad()
    def _extract_mesh(self, iteration: int):
        """TSDF mesh extraction over every train view (trainer.py:1375-1446):
        write meshes/test_{iteration:06d}.ply when mesh_dir is set, and with
        mesh visibility or the raytracing_residual flavor rebuild the traced
        mesh, decimated to MESH_TRI_CAPACITY triangles. The JAX Trainer pads
        it to a capacity for its jitted step's shapes; the eager step needs
        no padding, and padding rows never hit."""
        from materialrefgs_torch.ops import mesh_tracer as mt
        from materialrefgs_torch.train import mesh_extract as me

        t0 = time.perf_counter()
        mips = self._build_mips(self.state.env1)
        depths, alphas = [], []
        for i in range(len(self.cameras)):
            pkg = self._render_view(i, mips)
            depths.append(pkg["surf_depth"].cpu().numpy())
            alphas.append(pkg["rend_alpha"][..., 0].cpu().numpy())
        extract = me.extract_mesh_unbounded if self.opt.unbounded_mesh else me.extract_mesh
        verts, faces = extract(self.cameras, depths, alphas, resolution=self.MESH_RESOLUTION,
                               num_cluster=self.opt.num_cluster)
        if self.mesh_dir:
            me.write_mesh_ply(f"{self.mesh_dir}/test_{iteration:06d}.ply", verts, faces)
        n_full = len(faces)
        if self.use_mesh_visibility or self.pipe.indirect_type == "raytracing_residual":
            if len(faces) > self.MESH_TRI_CAPACITY:
                verts, faces = me.decimate_vertex_clustering(verts, faces, self.MESH_TRI_CAPACITY)
            self.mesh = mt.build_mesh(verts, faces, device=self.state.model.device)
        seconds = time.perf_counter() - t0
        self.mesh_log.append((iteration, n_full, seconds))
        print(f"[mesh] it={iteration}: {n_full} triangles ({len(faces)} traced) in {seconds:.1f} s")
