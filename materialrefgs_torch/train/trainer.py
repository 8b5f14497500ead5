"""Training loop for the refnerf curriculum's `initial` and `surfel` stages
(the JAX package's train/trainer.py, reference train_refnerf.py:1012-1533).

`make_train_step(stage, ...)` returns one optimization step of that stage
(a `TrainStep`, whose render and update halves can be called apart):
render through the rasterizer (both tile kernels), the loss terms that are
live before `surfel2` (calculate_loss with the image-gradient weight, the
normal-consistency ladder, mask entropy when masks exist, the env-scope
penalty when configured), one backward, the Adam update with the per-group
learning rates, and the densification statistics from the screen-offset
gradient. `Trainer` runs the JAX Trainer's schedule of SH oneups, pair-capacity
escalation on binning overflow, densify/prune with prune grace, the
white-background kick, opacity resets, and the normal-propagation resets
with the opacity-LR toggle.

The port runs eagerly, so a step mutates the state in place where the JAX
step returns a new one. What the later slices bring raises
NotImplementedError naming the slice: the `volume` and `surfel2` stages, the
multi-view warp loss, mono-normal priors, ref-score masks and the LPIPS loss
(the env-GS model belongs to `surfel2`).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.config import OptimizationParams, PipelineParams
from materialrefgs_torch.models import gaussian_model as gm
from materialrefgs_torch.models.env_light import EnvLightMips, EnvLightParams
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
from materialrefgs_torch.render.renderers import RenderOptions, render_initial, render_surfel
from materialrefgs_torch.train import losses
from materialrefgs_torch.train.optim import Adam
from materialrefgs_torch.train.stages import select_stage
from materialrefgs_torch.utils.transforms import expon_lr

STAGES = ("initial", "surfel")


def _later_slice(what: str) -> NotImplementedError:
    where = {
        "volume": "the multi-view/volume slice",
        "surfel2": "the surfel2 training slice",
        "warp": "the multi-view/volume slice",
        "mono-normal": "the multi-view/volume slice",
        "ref-score": "the multi-view/volume slice",
        "LPIPS": "the multi-view/volume slice",
    }[what]
    return NotImplementedError(f"{what} training is not ported yet; it comes with {where} of the port")


@dataclass
class TrainState:
    model: gm.GaussianModel
    env1: EnvLightParams  # gaussians.env_map
    env2: EnvLightParams  # gaussians.env_map_2 (volume stage)
    adam: Adam
    step: int = 0  # optimizer steps taken (the xyz LR schedule's clock)
    opacity_lr_scale: float = 1.0  # set_opacity_lr toggle, 0 or 1

    def params(self) -> dict[str, torch.Tensor]:
        """Every optimized tensor by name: the model's raw parameters, then
        the two cubemaps (the JAX optimizer's (params, env1, env2) tree)."""
        out = {name: getattr(self.model, name) for name in gm.PARAM_SHAPES}
        out["env1"] = self.env1.base
        out["env2"] = self.env2.base
        return out


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


def normal_loss_weight_schedule(iteration: int, opt: OptimizationParams) -> float:
    """get_current_normal_loss_weight (train_refnerf.py:1183-1196): the
    reference's chain of `current < thr` tests makes thresholds inclusive."""
    v = opt.normal_weight_ladder[0][1]
    for thr, val in opt.normal_weight_ladder:
        if iteration >= thr:
            v = val
    return v


class TrainStep:
    """One optimization step of `initial` or `surfel`, in two halves so that
    the caller can look at the render before anything is updated:
    `render(state, camera, extra)` draws the view (with the screen-offset
    leaf of the densification statistics) and `update(state, camera, gt,
    extra, rendered)` takes the loss, its backward and the Adam update and
    returns the metrics. Calling the step does both. The step updates
    `state` in place.

    extra: {"iteration", "lambda_normal_render_depth", "bg"} and, when the
    scene has foreground masks, "image_mask" (H, W)."""

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
    ):
        if stage not in STAGES:
            raise _later_slice("surfel2" if stage == "surfel2" else "volume")
        if pipe.use_asg:
            raise NotImplementedError(
                "ASG indirect light (use_asg, utils/asg.py) is not ported yet; "
                "refnerf has it off"
            )
        self.stage = stage
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

    def __call__(self, state: TrainState, camera: Camera, gt: torch.Tensor, extra: dict) -> dict:
        return self.update(state, camera, gt, extra, self.render(state, camera, extra))

    def render(self, state: TrainState, camera: Camera, extra: dict) -> tuple[dict, torch.Tensor]:
        """(the render package, the screen-offset leaf it was drawn with)."""
        model = state.model
        offset = torch.zeros((model.capacity, 2), device=model.device, requires_grad=True)
        if self.stage == "initial":
            return render_initial(model, camera, extra["bg"], self.ropts, offset), offset
        # The mips are rebuilt from env1 every step, differentiably
        # (trainer.py:210-213).
        mips = EnvLightMips.build(
            state.env1, n_samples=self.envmap_n_samples,
            min_roughness=self.env_min_roughness, max_roughness=self.env_max_roughness,
        )
        return render_surfel(model, camera, extra["bg"], mips, self.ropts, offset), offset

    def update(self, state: TrainState, camera: Camera, gt: torch.Tensor, extra: dict,
               rendered: tuple[dict, torch.Tensor]) -> dict:
        pkg, offset = rendered
        opt, model = self.opt, state.model
        it = float(extra["iteration"])
        image_weight = None
        if not opt.wo_image_weight:
            image_weight = torch.clamp(1.0 - losses.get_img_grad_weight(gt), 0, 1) ** 2
        loss, tb = losses.calculate_loss(gt, pkg, self.lopt, it, image_weight)

        # Iteration-dependent normal-consistency weight (ladder).
        gate = float(it > opt.normal_loss_start)
        rn, sn = pkg["rend_normal"], pkg["surf_normal"]
        if image_weight is not None:
            ln = torch.mean(image_weight * torch.sum(torch.abs(sn - rn), dim=-1))
        else:
            ln = torch.mean(1.0 - torch.sum(rn * sn, dim=-1))
        loss = loss + gate * float(extra["lambda_normal_render_depth"]) * ln
        tb["loss_normal_render_depth"] = ln

        if opt.use_env_scope and self.stage == "surfel":
            # Penalize refl_strength outside the scene sphere
            # (train_refnerf.py:1022-1027, 1335-1338; weight 0.4).
            center = torch.tensor(opt.env_scope_center, dtype=torch.float32, device=model.device)
            outside = (torch.sum((model.xyz - center) ** 2, dim=-1) > opt.env_scope_radius**2) & model.alive
            denom = torch.clamp(torch.sum(outside), min=1).to(torch.float32)
            refl_msk_loss = torch.sum(model.get_refl[:, 0] * outside) / denom
            loss = loss + 0.4 * refl_msk_loss
            tb["loss_refl_msk"] = refl_msk_loss

        if self.stage == "surfel" and "image_mask" in extra:
            # Mask entropy after the volume stage (train_refnerf.py:1211-1220).
            o = torch.clamp(pkg["rend_alpha"][..., 0], 1e-6, 1 - 1e-6)
            msk = extra["image_mask"]
            ent = -torch.mean(msk * torch.log(o) + (1 - msk) * torch.log(1 - o))
            loss = loss + 0.01 * ent
            tb["loss_mask_entropy"] = ent

        params = state.params()
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names] + [offset], allow_unused=True)
        goff = grads[-1] if grads[-1] is not None else torch.zeros_like(offset)
        lrs = param_lrs(opt, self.spatial_lr_scale, state.step, state.opacity_lr_scale)
        state.adam.step(params, dict(zip(names, grads[:-1])), lrs)
        gm.add_densification_stats(
            model, goff, pkg["radii"].detach(),
            ndc_scale=(0.5 * camera.width, 0.5 * camera.height),
        )
        state.step += 1

        metrics = {k: v.detach() for k, v in tb.items()}
        metrics["loss"] = loss.detach()
        metrics["overflow"] = pkg["overflow"]
        return metrics


def make_train_step(
    stage: str,
    opt: OptimizationParams,
    pipe: PipelineParams,
    spatial_lr_scale: float,
    raster_cfg: RasterizeConfig,
    envmap_n_samples: int = 32,
    env_min_roughness: float = 0.08,
    env_max_roughness: float = 0.5,
) -> TrainStep:
    """The step of `initial` or `surfel`: step(state, camera, gt, extra) ->
    metrics (see TrainStep)."""
    return TrainStep(stage, opt, pipe, spatial_lr_scale, raster_cfg, envmap_n_samples,
                     env_min_roughness, env_max_roughness)


class Trainer:
    """Python orchestration of the curriculum (train_refnerf.py:1093-1495),
    for the stages before `surfel2`.

    Binning overflow: the JAX Trainer polls the overflow every 10 iterations
    (reading it syncs its asynchronous dispatch) and escalates the pair
    capacity, so up to 10 truncated steps are applied. The port's eager step
    synchronizes with the host anyway, so the Trainer reads every render's
    overflow between the step's render and update halves, and a render that
    dropped pairs is redone at the escalated capacity: no truncated step is applied unless the capacity is at its
    ceiling, where the step is applied truncated with a warning, as in the
    JAX package. The ceiling is 4x the JAX package's 1<<23 pair slots: a
    compressed curriculum's opacity and scale resets can ask for over 10M
    pairs at 800x800, and the card's memory holds that."""

    MAX_PAIR_CAPACITY = 1 << 25

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
        normal_priors: list[np.ndarray] | None = None,
        ref_score_masks: list[np.ndarray] | None = None,
        with_warp: bool = False,
        envmap_min_roughness: float = 0.08,
        envmap_max_roughness: float = 0.5,
    ):
        if opt.use_perceptual_loss:
            raise _later_slice("LPIPS")
        if normal_priors is not None:
            raise _later_slice("mono-normal")
        if ref_score_masks is not None:
            raise _later_slice("ref-score")
        if with_warp:
            raise _later_slice("warp")
        self.opt = opt
        self.pipe = pipe
        self.cameras = cameras
        dev = model.device
        self.images = [torch.as_tensor(np.asarray(im, np.float32), device=dev) for im in images]
        self.masks = (
            [torch.as_tensor(np.asarray(m, np.float32), device=dev) for m in masks] if masks else None
        )
        self.cameras_extent = cameras_extent
        self.spatial_lr_scale = cameras_extent
        self.bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
        self.raster_cfg = raster_cfg
        self.envmap_min_roughness = envmap_min_roughness
        self.envmap_max_roughness = envmap_max_roughness
        self.state = init_train_state(model, envmap_res)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._steps: dict = {}
        self._reset0_at: int | None = None
        self.metrics_log: list[dict] = []
        self._order: list[int] = []

    def _step_fn(self, stage: str) -> TrainStep:
        if stage not in self._steps:
            self._steps[stage] = make_train_step(
                stage, self.opt, self.pipe, self.spatial_lr_scale, self.raster_cfg,
                env_min_roughness=self.envmap_min_roughness,
                env_max_roughness=self.envmap_max_roughness,
            )
        return self._steps[stage]

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
        }
        if self.masks is not None:
            extra["image_mask"] = self.masks[cam_id]
        return extra

    def _run_step(self, iteration: int, stage: str) -> dict:
        cam_id = self._pick_view()
        extra = self._build_extra(iteration, cam_id)
        cam = self.cameras[cam_id]
        rendered = self._step_fn(stage).render(self.state, cam, extra)
        dropped, renders = 0, 0
        while True:
            overflow = int(rendered[0]["overflow"])
            if overflow == 0 or not self._escalate_pair_capacity(overflow, iteration):
                break
            dropped, renders = dropped + overflow, renders + 1
            del rendered  # free the truncated render's graph before redoing it
            rendered =self._step_fn(stage).render(self.state, cam, extra)
        metrics = self._step_fn(stage).update(self.state, cam, self.images[cam_id], extra, rendered)
        # Renders that dropped pairs and were redone, and the pairs they dropped.
        metrics["renders_redone"] = renders
        metrics["overflow_redone"] = dropped
        return metrics

    def train(self, num_iters: int, start_iter: int = 1, log_every: int = 100):
        opt = self.opt
        self._order = []
        for iteration in range(start_iter, start_iter + num_iters):
            stage = select_stage(iteration, opt)
            if stage not in STAGES:
                raise _later_slice(stage)
            if iteration == opt.volume_render_until_iter + 1 and opt.volume_render_until_iter > opt.init_until_iter:
                raise _later_slice("volume")  # the volume -> surfel material re-init

            # SH degree ladder (train_refnerf.py:1109-1111).
            if iteration > opt.feature_rest_from_iter and iteration % opt.sh_ladder_interval == 0:
                self.state.model.oneup_sh_degree()

            metrics = self._run_step(iteration, stage)
            self._densify_and_reset(iteration, stage)

            if iteration % log_every == 0 or iteration == start_iter:
                m = {k: float(v) for k, v in metrics.items()}
                m["iteration"] = iteration
                m["stage"] = stage
                m["n_alive"] = int(self.state.model.n_alive)
                m["wall"] = time.time()
                self.metrics_log.append(m)
        return self.state

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

    def _densify(self, max_screen_size, min_opacity):
        gm.densify_and_prune(
            self.state.model, self.state.adam, self.generator,
            max_grad=self.opt.densify_grad_threshold,
            min_opacity=min_opacity,
            extent=self.cameras_extent,
            max_screen_size=max_screen_size,
        )

    def _densify_and_reset(self, iteration: int, stage: str):
        """Densification + reset block (train_refnerf.py:1414-1462)."""
        opt = self.opt
        st = self.state
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
                raise _later_slice("volume")  # dist_color after a volume stage
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
