"""Config dataclasses mirroring the reference CLI groups
(arguments/__init__.py ModelParams:60, PipelineParams:96,
OptimizationParams:110) plus the run_*.sh stage presets, the schedule
scaling, the reflection CLI and the cfg_args.json dump/load. The port keeps
its own copy of the JAX package's framework-free config so the two cannot
import each other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelParams:
    sh_degree: int = 3
    resolution: int = -1
    white_background: bool = False
    multi_view_num: int = 8
    multi_view_max_angle: float = 30.0
    multi_view_min_dis: float = 0.01
    multi_view_max_dis: float = 1.5
    ncc_scale: float = 1.0
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    eval: bool = False
    envmap_max_res: int = 128
    envmap_max_roughness: float = 0.5
    envmap_min_roughness: float = 0.08
    relight: bool = False


@dataclass(frozen=True)
class PipelineParams:
    # Inert by design: CUDA-kernel plumbing switches in the reference
    # (python-vs-CUDA SH/cov paths); no analog exists in the Pallas design.
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    use_asg: bool = False
    depth_ratio: float = 0.0
    debug: bool = False
    # arguments/config.py build flavor: FLAG="pgsr" -> unbiased depth plane.
    unbiased_depth: bool = True
    indirect_type: str = "origin"  # "origin" | "raytracing_residual"


@dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 50_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    features_lr: float = 0.0075
    indirect_lr: float = 0.0075
    asg_lr: float = 0.0075
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    ori_color_lr: float = 0.0075
    refl_strength_lr: float = 0.005
    roughness_lr: float = 0.005
    metalness_lr: float = 0.01
    # normal1/normal2 are frozen in the reference too (training_setup
    # gaussian_model.py:434 never adds them to a param group with this lr).
    normal_lr: float = 0.006
    envmap_cubemap_lr: float = 0.01

    percent_dense: float = 0.01

    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal_render_depth: float = 0.05
    lambda_normal_smooth: float = 0.0
    lambda_depth_smooth: float = 0.0
    wo_image_weight: bool = False

    init_roughness_value: float = 0.1
    init_refl_value: float = 0.1
    init_refl_value_vol: float = 0.01
    rough_msk_thr: float = 0.01
    refl_msk_thr: float = 0.02
    enlarge_scale: float = 1.5

    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 25000
    densify_grad_threshold: float = 0.0002
    prune_opacity_threshold: float = 0.05

    initial: int = 0
    init_until_iter: int = 0
    volume_render_until_iter: int = 18000
    normal_smooth_from_iter: int = 0
    normal_smooth_until_iter: int = 18000
    indirect: int = 0
    indirect_from_iter: int = 20000
    feature_rest_from_iter: int = 5_000
    normal_prop_until_iter: int = 25_000
    normal_prop_interval: int = 1000
    opac_lr0_interval: int = 200
    densification_interval_when_prop: int = 500

    normal_loss_start: int = 0
    dist_loss_start: int = 3000
    # SH-degree oneup cadence (train_refnerf.py:1109-1111 hardcodes 1000;
    # a field here so compressed schedules scale it uniformly).
    sh_ladder_interval: int = 1000

    # Declarative iteration ladders (SURVEY §7.2: curriculum as schedule
    # tables, not code forks). Each is ((iter_threshold, value), ...): the
    # value of the LAST entry whose threshold < iteration applies.
    # refnerf: get_current_normal_loss_weight train_refnerf.py:1181-1196;
    # glossy trains with a constant 0.05 (train_glossy.py:1239-1240).
    normal_weight_ladder: tuple = (
        (0, 0.015), (10000, 0.05), (15000, 0.1), (25000, 0.05)
    )
    # refnerf: normal_gamma steps train_refnerf.py:1138-1143; glossy drops
    # the prior at 7000 outright (train_glossy.py:1198-1202).
    normal_gamma_ladder: tuple = ((0, 1.0), (7000, 0.5), (12000, 0.0))
    # Mono-normal prior loss coefficient: refnerf applies 0.5x externally,
    # glossy folds 0.01x into mono_normal_loss (train_glossy.py:269).
    mono_normal_coef: float = 0.5

    use_env_scope: bool = False
    env_scope_center: tuple = (0.0, 0.0, 0.0)
    env_scope_radius: float = 0.0
    srgb: bool = False

    voxel_size: float = -1.0
    depth_trunc: float = -1.0
    # Unbounded (contracted-space) TSDF mesh extraction for real scenes
    # (train_refreal.py:1443-1444: 'refreal'/'tnt' datasets).
    unbounded_mesh: bool = False
    sdf_trunc: float = -1.0
    mesh_res: int = 512
    num_cluster: int = 1

    use_virtul_cam: bool = False
    virtul_cam_prob: float = 0.5
    use_multi_view_trim: bool = True
    multi_view_ncc_weight: float = 0.15
    multi_view_geo_weight: float = 0.03
    # The warp-loss start gate. NB the reference's config field of this name
    # is DEAD — its trainers gate on hardcoded literals instead
    # (train_refnerf.py:1253 / train_glossy.py:1317: `iteration > 25000`;
    # train_refreal.py:1211: `> 7000`). The presets set those literals here;
    # starting warp at this raw default (the reference's unused 10000) puts
    # it amid the pre-indirect reset cadence, where warp gradients on
    # just-reset garbage depth maps prevent recovery (round-3 flagship
    # collapse: 33 -> 8 PSNR within 100 iterations of warp onset).
    multi_view_weight_from_iter: int = 10000
    # Which warp terms are ACTUALLY APPLIED. The reference computes geo+NCC
    # in every trainer but refnerf/glossy DISCARD them (calc_warp_loss
    # returns `None, None, base_color_loss, ...`, train_refnerf.py:745 /
    # train_glossy.py:772 — all NCC blocks commented out); only refreal
    # returns and adds them (train_refreal.py:729, :1216-1221). Training
    # refnerf with the NCC/geo terms enabled collapses: NCC on reflective
    # pixels pushes normals/distance to explain view-dependent highlights.
    use_warp_geo_loss: bool = False
    use_warp_ncc_loss: bool = False
    # Base-color warp start (the `iteration > 10000` literal,
    # train_refnerf.py:534; schedule-scaled).
    basecolor_warp_from_iter: int = 10000
    multi_view_patch_size: int = 3
    multi_view_sample_num: int = 102400
    multi_view_pixel_noise_th: float = 1.0
    wo_use_geo_occ_aware: bool = False

    use_perceptual_loss: bool = True
    lambda_perceptual_loss: float = 0.1
    perceptual_loss_start_iter: int = 18000

    rghmtl_warp_loss_start_iter: int = 10000
    use_metallic_warp_loss: bool = True
    use_roughness_warp_loss: bool = True
    metallic_warp_weight: float = 0.05
    roughness_warp_weight: float = 0.05
    # Inert in the reference as well: the bg+edge mask is always applied
    # in the warp (train_refnerf.py:628-631 reads neither flag).
    use_backgroud_mask: bool = True
    directional_rghmtl_warp_alignment: bool = True
    dilate_size: int = 7
    edge_aware_in_warp: bool = True

    ref_score_start_iter: int = 10000
    # Env-GS maintenance cadence (update_env_gs_, env_gaussian_model3.py:
    # 482-486 hardcodes 500 / 6000 / 30000). Exposed so scale_schedule can
    # compress them with the rest of the curriculum: round-4's flagship at
    # schedule_scale 0.25 kept the ABSOLUTE 6000 reset, which landed 1000
    # iterations after the env cloud's birth; post-reset opacities (0.01)
    # could not regrow past prune_opacity_threshold (0.05) before the next
    # densify's prune and the whole env cloud died (tracer_overflow -> 0).
    env_densify_interval: int = 500
    env_reset_interval: int = 6000
    env_update_until_iter: int = 30000
    # Post-reset prune grace in ABSOLUTE steps, deliberately NOT in
    # _SCHEDULE_INT_FIELDS: after an env opacity reset (min(op, 0.01),
    # env_gaussian_model3.py:260-263) opacities must regrow past
    # prune_opacity_threshold (0.05) before the next prune or the cloud
    # dies. The reference's regrowth window is its 500-step densify
    # interval; regrowth speed is set by optimizer dynamics (opacity_lr x
    # steps), which schedule compression does NOT scale — at scale 0.25 the
    # scaled interval leaves 125 steps (4x less total gradient), and the
    # round-4 flagship's env cloud died in exactly this trap even at 500.
    # So prunes within env_prune_grace steps of a reset are skipped
    # (densify still runs), preserving the reference's absolute regrowth
    # budget under any compression.
    env_prune_grace: int = 500
    # Same absolute-regrowth principle for the MAIN model: the reference's
    # post-reset window before the next prune is its densification interval
    # (100 steps absolute); a compressed schedule shrinks it to
    # 100 x scale steps, below what opacity_lr needs to lift 0.01 past the
    # 0.05 prune threshold (at scale 0.03 the whole cloud died in the
    # round-5 verify run). Prunes within prune_grace ABSOLUTE steps of a
    # reset_opacity0 are skipped; densification still runs.
    prune_grace: int = 100
    ref_score_loss_weight: float = 0.01
    # Belongs to a commented-out ref-score variant in the reference
    # (train_refnerf.py:1279-1300); the live path uses 0.5*ref_score_loss_weight.
    ref_score_loss_inv_weight: float = 0.005

    # The live reference applies unweighted smooth_loss inside the
    # ref-score mask (train_refreal.py:1261); these weights belong to the
    # commented-out variant and are kept for CLI-surface parity only.
    use_albedo_smoothness: bool = False
    lambda_albedo_smoothness: float = 0.015
    albedo_smoothness_start_iter: int = 10000

    # Dead in the reference (only in commented ref-score code, :1286-1300).
    tel_thres: float = 0.1


def preset_refnerf() -> tuple[ModelParams, PipelineParams, OptimizationParams]:
    """run_refnerf.sh:27-48 — Shiny Blender Synthetic."""
    return (
        ModelParams(white_background=True, eval=True, ncc_scale=1.0),
        PipelineParams(),
        dataclasses.replace(
            OptimizationParams(),
            iterations=50000,
            indirect_from_iter=20000,
            volume_render_until_iter=0,
            initial=1,
            init_until_iter=3000,
            normal_loss_start=3000,
            normal_prop_until_iter=30000,
            densify_until_iter=30000,
            lambda_normal_smooth=0.0,
            # Reference literal `iteration > 25000` (train_refnerf.py:1253):
            # warp only after the surfel2/indirect stage has stabilized.
            multi_view_weight_from_iter=25000,
            ref_score_start_iter=50000,
            use_perceptual_loss=False,
            use_metallic_warp_loss=False,
            use_roughness_warp_loss=False,
        ),
    )


def preset_refreal() -> tuple[ModelParams, PipelineParams, OptimizationParams]:
    """run_refreal.sh:24-44 — Shiny Blender Real."""
    return (
        ModelParams(eval=True, ncc_scale=0.5, resolution=4),
        PipelineParams(),
        dataclasses.replace(
            OptimizationParams(),
            iterations=30000,
            indirect_from_iter=12500,
            volume_render_until_iter=0,
            initial=1,
            init_until_iter=3000,
            normal_loss_start=7000,
            densify_until_iter=20000,
            normal_prop_until_iter=18000,
            lambda_normal_smooth=0.0,
            lambda_normal_render_depth=0.05,
            multi_view_weight_from_iter=7000,
            multi_view_ncc_weight=0.15,
            lambda_dist=1000.0,
            # refreal applies the geo + reflectivity-gated NCC warp terms
            # (train_refreal.py:729 returns them; :707 get_consistency_loss2).
            use_warp_geo_loss=True,
            use_warp_ncc_loss=True,
            perceptual_loss_start_iter=16000,
            ref_score_loss_weight=0.01,
            unbounded_mesh=True,
        ),
    )


def preset_glossy() -> tuple[ModelParams, PipelineParams, OptimizationParams]:
    """run_glossy.sh:28-44 — Glossy Synthetic (NeRO)."""
    m, p, o = preset_refnerf()
    return (
        m,
        p,
        dataclasses.replace(
            o,
            use_roughness_warp_loss=True,
            lambda_perceptual_loss=0.05,
            # Glossy trains with a constant normal-consistency weight
            # (train_glossy.py:1239-1240 early-returns 0.05) ...
            normal_weight_ladder=((0, 0.05),),
            # ... drops the mono-normal prior entirely past 7000
            # (train_glossy.py:1198-1202: no 0.5 plateau) ...
            normal_gamma_ladder=((0, 1.0), (7000, 0.0)),
            # ... and weights it 0.01 (train_glossy.py:269).
            mono_normal_coef=0.01,
        ),
    )


# Schedule fields scaled by scale_schedule(). Everything iteration-valued:
# stage boundaries, loss-start gates, densify/reset cadences, LR horizon.
_SCHEDULE_INT_FIELDS = (
    "iterations",
    "position_lr_max_steps",
    "densification_interval",
    "opacity_reset_interval",
    "densify_from_iter",
    "densify_until_iter",
    "init_until_iter",
    "volume_render_until_iter",
    "normal_smooth_from_iter",
    "normal_smooth_until_iter",
    "indirect_from_iter",
    "feature_rest_from_iter",
    "normal_prop_until_iter",
    "normal_prop_interval",
    "opac_lr0_interval",
    "densification_interval_when_prop",
    "normal_loss_start",
    "dist_loss_start",
    "sh_ladder_interval",
    "multi_view_weight_from_iter",
    "basecolor_warp_from_iter",
    "perceptual_loss_start_iter",
    "rghmtl_warp_loss_start_iter",
    "ref_score_start_iter",
    "env_densify_interval",
    "env_reset_interval",
    "env_update_until_iter",
    "albedo_smoothness_start_iter",
)
_SCHEDULE_LADDER_FIELDS = ("normal_weight_ladder", "normal_gamma_ladder")


def scale_schedule(opt: "OptimizationParams", factor: float) -> "OptimizationParams":
    """Uniformly compress/stretch the training curriculum.

    Multiplies every iteration-valued hyperparameter (stage boundaries, loss
    start gates, densify/reset cadences, ladder thresholds, the position-LR
    horizon) by `factor`, preserving the reference's stage STRUCTURE
    (run_refnerf.sh:31-44) at a different total budget. Intervals are clamped
    to >=1; ladder thresholds scale; weights/LRs are untouched. factor=1 is
    the identity.
    """
    if factor == 1.0:
        return opt
    if factor <= 0:
        raise ValueError(f"schedule scale must be positive, got {factor}")
    updates: dict = {}
    for name in _SCHEDULE_INT_FIELDS:
        v = getattr(opt, name)
        scaled = int(round(v * factor))
        # Cadences of 0 would mean "every iteration" via `% interval`;
        # keep any positive cadence/boundary at >=1 after scaling.
        if v > 0:
            scaled = max(scaled, 1)
        updates[name] = scaled
    for name in _SCHEDULE_LADDER_FIELDS:
        ladder = getattr(opt, name)
        updates[name] = tuple(
            (int(round(thr * factor)), val) for thr, val in ladder
        )
    return dataclasses.replace(opt, **updates)


# ----------------------------------------------------------- reflection CLI --


def add_param_flags(ap) -> None:
    """Reflection CLI (reference ParamGroup, arguments/__init__.py:20-51):
    every field of ModelParams/PipelineParams/OptimizationParams becomes a
    `--<name>` flag (bools get a `--no-<name>` negation). All default to
    None = "keep the preset's value"; apply_param_flags folds explicit
    flags back into the dataclasses."""
    import argparse

    taken = {s for a in ap._actions for s in a.option_strings}
    for inst in (ModelParams(), PipelineParams(), OptimizationParams()):
        for f in dataclasses.fields(type(inst)):
            flag = f"--{f.name}"
            if flag in taken or f.name in ("source_path", "model_path"):
                continue
            taken.add(flag)
            d = getattr(inst, f.name)
            if isinstance(d, bool):
                ap.add_argument(
                    flag, default=None, action=argparse.BooleanOptionalAction
                )
            elif isinstance(d, (int, float, str)):
                ap.add_argument(flag, default=None, type=type(d))
            # tuple-valued ladders stay config-file-only (like the
            # reference's non-flag class attributes)


def apply_param_flags(args, model: ModelParams, pipe: PipelineParams,
                      opt: OptimizationParams):
    """Fold explicitly-passed reflection flags over the preset values
    (get_combined_args precedence: CLI > preset)."""

    def upd(inst):
        kw = {}
        for f in dataclasses.fields(type(inst)):
            v = getattr(args, f.name, None)
            if v is not None and not isinstance(getattr(inst, f.name), tuple):
                kw[f.name] = v
        return dataclasses.replace(inst, **kw) if kw else inst

    return upd(model), upd(pipe), upd(opt)


# ------------------------------------------------------------- cfg_args I/O --


def dump_config(
    model_path: str,
    model: ModelParams,
    pipe: PipelineParams,
    opt: OptimizationParams,
    extra: dict | None = None,
) -> None:
    """Persist the run's full config (reference cfg_args dump,
    train_refnerf.py:1648-1649) as JSON so eval can re-derive it without the
    user re-passing --preset/flags (get_combined_args,
    arguments/__init__.py:254-274)."""
    import json
    import os

    os.makedirs(model_path, exist_ok=True)
    payload = {
        "model": dataclasses.asdict(model),
        "pipeline": dataclasses.asdict(pipe),
        "optimization": dataclasses.asdict(opt),
        "extra": extra or {},
    }
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(payload, f, indent=1)


def load_config(
    model_path: str,
) -> tuple[ModelParams, PipelineParams, OptimizationParams, dict] | None:
    """Read cfg_args.json back; None when the run predates it. Unknown keys
    (from older/newer configs) are dropped; missing keys take defaults."""
    import json
    import os

    p = os.path.join(model_path, "cfg_args.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        payload = json.load(f)

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "env_scope_center" in kw and isinstance(kw["env_scope_center"], list):
            kw["env_scope_center"] = tuple(kw["env_scope_center"])
        return cls(**kw)

    return (
        build(ModelParams, payload.get("model", {})),
        build(PipelineParams, payload.get("pipeline", {})),
        build(OptimizationParams, payload.get("optimization", {})),
        payload.get("extra", {}),
    )
