#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (materialrefgs_torch) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. the card's name and power limit;
  2. build every kernel of the serving and training paths from csrc/ with
     nvcc (ptxas -v) and the two host sources (the JPEG entropy decoder,
     the COLMAP parser) with c++, one compiler per source, all started
     together;
  3. hold each kernel against its plain torch version on the card: the
     rasterizer on a mid-size random scene at S=1, 9 and 10 (render_surfel2's
     width), the 64 densest tiles of the full-width view and the full-width
     view itself (the backward kernel with a random cotangent); the bundle
     tracer on a mid-size random scene (multi-chunk segments, an empty
     segment, bundles that exit early) for n_sh 1 and 16 in list and exact
     order, all 16 output channels, and its backward with a cotangent from a
     seed on rgb, depth, normal and final_T;
  4. serve a full-width refnerf model (150k splats, SH degree 3, all
     materials, 128^2 env, 800x800, S=9) through scripts/eval_torch.py's path:
     the model is written with the port's save_ply, 8 ground-truth views are
     rendered into a Blender-layout scene, and the eval path reloads both.
     Kernel launch counts are zeroed just before the eval and read right
     after it;
  5. time the forward kernel (CUDA events) at the serve path's shapes, beside
     its plain version and the least time the card could take for the work;
  6. where one served view's time goes (torch.profiler);
  7. train refnerf at full width through scripts/train_torch.py's path: an
     800x800 Blender scene (8 train views with RGBA masks, 4 test views)
     rendered from phase 4's model, the reader's own 100k-point random init,
     capacity 1<<19, pair capacity 1<<20, SH degree 3, 128^2 env,
     --schedule_scale 0.01 --iterations 60 (iterations 1-30 `initial`,
     31-60 `surfel`, a checkpoint at 30); counts zeroed just before, read
     right after; the saved PLY is evaluated through scripts/eval_torch.py;
  8. learning check: 40 full-width `initial` steps from the same init with
     densification and resets off must raise the train PSNR by >= 0.5 dB;
  9. time the backward kernel at 800x800 (S=9 and S=1) beside its plain
     version and its bound (counted from the plain version's hit-test
     outcomes on the same inputs), and the Trainer's step (host clock,
     torch.profiler device-busy share and top kernels): `initial` on the
     learning check's state, `surfel` on the run's checkpoint at 30 and on
     its state after 60 (over 10M pairs after the compressed resets);
 10. serve a full-width env-GS (`surfel2`) refnerf checkpoint through
     scripts/eval_torch.py's path: phase 4's model with its splats turned to
     lie in the shell (normals radial), saved under iteration_30000, plus a
     150k-splat env cloud (SH degree 3) on a shell of radius 2.2 +- 0.2, and
     phase 4's pair capacity in cfg_args.json. Two sets of 8 views, each
     with ground truth rendered from the checkpoint: phase 4's ring of
     radius 3.2 (the whole object in view) and close-ups on a ring of radius
     1.65 (the object fills the frame); each set's demand is probed and
     printed. For each set, run (a) without a mesh (splat visibility, two
     trace launches per render) and (b) with meshes/test_030000.ply, a bumpy
     icosphere of 81,920 triangles (one launch per render, over occluded
     bundles only); the eval starts from the JAX eval's tracer budgets and
     redoes a view that overflows them at budgets that fit; counts zeroed
     just before each run, read right after;
 11. for view 0 of each set, the tracer kernel against its plain version at
     the close-ups' inputs from the eval's path (each launch kind, every
     bundle, bit for bit), its walks and ranges, its time (CUDA events), its
     plain version's (timed in the comparison run) and its bound; one
     render_surfel2 view per visibility
     mode under torch.profiler with its peak device memory, and the mesh
     tracer's device time;
 12. train the refnerf `surfel2` stage at full width through
     scripts/train_torch.py: --start_ply from phase 7's iteration_60 at
     --start_iter 200 (indirect_from_iter at --schedule_scale 0.01),
     --iterations 240: 40 steps with env-GS traced indirect light, mesh
     visibility and exact order, over the onset (env init, mesh extraction,
     the budget probe; --mesh_every 1000, no re-extraction), env densify every 5
     iterations and the env reset at 240, test marks at 220 and 240; counts
     zeroed just before, read right after; the saved directory (PLY, env PLY,
     mesh) served through scripts/eval_torch.py (the main model's densify,
     prune and reset inside surfel2 run live in phase 16);
 13. learning check: 30 `surfel2` steps from the same onset (and phase
     12's onset mesh) with densification, resets and mesh re-extraction off
     must raise the train PSNR by >= 0.3 dB;
 14. the tracer's backward and forward kernels at one training step's
     captured inputs against their plain versions on every bundle (the
     forward bit for bit), the step's walks and ranges, both kernels' times,
     their plain versions' and their bounds (counted from the plain
     versions' work); both rasterizer kernels at the same step's inputs
     (input (iii), S=10), the forward bit for bit; and the Trainer's
     `surfel2` step (host
     clock, torch.profiler device-busy share and top kernels, the mesh
     tracer's device time, peak memory);
 15. train refnerf across the warp gate through scripts/train_torch.py on a
     scene of 24 train views 15 deg apart (every view has neighbours; GT,
     masks and camera-space normal priors rendered from phase 4's model):
     (a) from phase 12's iteration_240 (main + env PLY) 20 `surfel2` steps
     (241-260) across refnerf's gate at 250 (base-colour warp, mesh
     extracted at the onset on a 128^3 grid, no re-extraction), counts zeroed just before
     and read just after, s/step on each side of
     the gate; then the warp's cost as a pair: on (a)'s final state, two
     views each step with the warp off and on, alternating, every step from
     the same snapshot of the state (host clock, peak memory), and one
     profiled step of each kind per view (busy share, top kernels, the
     rasterizer's launches); the warp sampler's gather and splat at one
     paired warp step's calls against the plain expression (the gather bit
     for bit) and its autograd gradients, with times and bounds, and its
     launches in (a) counted per warp step; (b) 10 `surfel` steps (51-60) from
     phase 7's iteration_50 PLY with every warp term, virtual cameras, the
     normal priors (--metric3d_path) and masks mined at 55
     (--ref_score_path auto): each term non-zero at least once, the mining
     time and the masks' coverage;
 16. refreal, the Shiny Blender Real preset, end to end: (a) a COLMAP scene
     written here (no Pillow): 24 JPEG photos (baseline 4:2:0, quality 90,
     chip_smoke_jpeg.py's numpy writer) at 4946x3286 rendered from phase
     4's model over black on a ring at two elevations 15 deg apart, PINHOLE
     with fx 1 % shorter than fy and the principal point off centre, 100,000
     sparse points near the surface coloured from a render; each photo's
     decode timed in its parts (host entropy decode, H2D, the JPEG kernel,
     D2H) and the kernel held to its plain version on photo 0; (b)
     scripts/train_torch.py --preset refreal -r 4 (1236x821: partial tiles,
     an odd height) --schedule_scale 0.01 --iterations 170 --ref_score_path
     auto --mesh_every 1000 (the onset's TSDF on a 128^3 grid), with LPIPS at RANDOM weights in the documented
     .npz ($MATERIALREFGS_LPIPS_WEIGHTS): initial 1-30, surfel with the warp
     from 71, masks mined at 100, surfel2 from 126 (unbounded TSDF), LPIPS
     from 161; counts zeroed just before, read just after (the record's
     launches); the loader's time per photo (JPEG decode + LANCZOS), s/step
     per stretch, the LPIPS
     network's time, mining and TSDF times, peak memory and one profiled
     surfel2 step with LPIPS (busy share, top kernels); every loss term
     finite, the distortion, warp, ref-score and perceptual terms each
     non-zero once, no step applied truncated, no lpips_disabled, the train
     PSNR up; (c) all four kernels and the warp sampler's pair at a surfel2
     step's inputs at 1236x821 against their plain versions (the forward
     kernels bit for bit), with times and bounds; (d) scripts/eval_torch.py
     serves the 3 test views;
 17. the other indirect-light flavors and the material outputs at full width
     (phase 7's scene and iteration-50 PLY): (a) scripts/train_torch.py
     --indirect_type raytracing_residual, 15 `surfel2` steps from the onset
     at 200 (no env-GS model, the mesh extracted at the onset, every pixel's
     reflected ray traced through it and shaded one bounce) with a
     checkpoint and a test render at the end, counts zeroed just before and
     read just after, s/step, one more step profiled on view 0 (busy share,
     the rasterizer kernels' and the mesh tracer's device time inside the
     step), the mesh tracer alone on view 0, peak memory, the onset TSDF,
     triangles before and after decimation; (b) scripts/train_torch.py
     --use_asg, 10 `surfel` steps, and the lobes' gradient through the
     rasterized indirect map; (c) scripts/eval_torch.py --relight on phase 4's model
     under a 512x256 RGBE sky the script writes (run-length and flat rows);
     (d) --export_material_mesh on (a)'s run; (e) 5 vertex-albedo refinement
     steps on view 0's 640k surface samples;
 18. the JPEG decoder: (a) the writer's files in every sampling mode (4:4:4,
     4:2:2, 4:2:0, 4:4:0, gray, RGB stored 4:4:4 and 4:2:0) at odd sizes, with and without a restart
     interval, the kernel against its plain version on every byte; (b) a
     textured 4946x3286 photo (band-limited noise, quality 95), its decode
     in parts, the kernel's time against its bound and its plain version's;
     (c) the native COLMAP parse against the pure one on phase 16's model;
 19. data parallelism: (a) scripts/train_torch.py --dp 1 over NCCL
     and the plain Trainer from one seed on a scripts/make_synth_scene.py
     scene at 800x800 (8 + 2 views, rendered by that script's numpy ray
     tracer, written with the port's writers; 20,000 seed points), 12
     iterations: initial 1-2, surfel 3-8 with the warp from 5 (virtual
     cameras), surfel2 9-12 (splat visibility); counts zeroed just before
     the --dp 1 run and read just after; the losses held to the plain
     Trainer's within DP_LOSS_RTOL, s/step of both, the gradient
     all_reduce's bytes and ms per step; both rasterizer kernels at a
     tile-sharded block's grid (tile rows 25-49, row0 = 25) against their
     plain versions, with times and bounds; (b) two ranks spawned on the one
     card over gloo (CUDA tensors reduced through the host): the DP
     production step on phase 4's model, each rank its own 800x800 view,
     held to the two single-view steps (gradients, the densification sums,
     denom, max radii), and rasterize_tile_sharded (two blocks of 25 tile
     rows) held to rasterize (maps at tests/test_tile_sharding.py's
     tolerances, gradients at 3e-3 x scale); time per rank, the gloo
     all_reduce's bytes and ms;
 20. the volume stage at glossy's preset: scripts/train_torch.py --preset
     glossy on phase 15's 24-view scene (masks, normal priors) from phase
     7's iteration-50 PLY, iterations 51-130 `volume` (per-gaussian shading
     against env2, the rasterizer at S = 5), the volume -> surfel re-init
     at 131, 131-150 `surfel` with the roughness and base-colour warps past
     140 (--volume_render_until_iter 130, --multi_view_weight_from_iter
     140; no surfel2; the opacity reset off, densify every 10 steps, one
     normal-propagation reset at 140 with dist_color); counts zeroed just
     before, read just after (the warp sampler's per warp step); the stage
     sequence, finite losses, no step applied truncated, the volume
     window's train PSNR up by >= 0.3 dB;
     iteration 130 served through scripts/eval_torch.py (render_volume with
     env2, equal to a direct render_set of the same PLY) and 150 (surfel);
     both rasterizer kernels at one volume step's inputs (S = 5) against
     their plain versions (the forward bit for bit), with times and bounds.

The second-to-last line is the kernels' JSON record (launches from phase 16's
run (b) and phase 19 (a)'s --dp 1 run, plus for the rasterizer phase 17's
runs (a) and (b) and phase 20's run; times and bounds from phase 16 (c), the
JPEG kernel's at phase 16's photo 0; the warp sampler's launches from phase
15 (a), phase 16 (b) and phase 20, its times and bounds at phase 15's paired
step); the last line is {"ok": true,
"device": {...}}. The script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores
# and HBM3 bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations of one (pixel, pair) hit test in csrc/rasterize_fwd.cu:
# 12 for k/l, 9 for the cross product, 2 divisions, 3 for rho3d, 2 + 4 for
# rho2d, 2 compares/selects, 4 for the splat depth, 1 power, 1 exp,
# 1 multiply + 1 min for alpha.
HIT_TEST_FLOPS = 42


def bwd_flops(S, walked, pass3d, pass2d):
    """FP32 operations the backward needs (csrc/rasterize_bwd.cu) for this
    data: the hit test again (42) for each of the `walked` (pixel, position)
    inside a pixel's contributor range; then, only for the (pixel, pair) that
    pass it, log1p, T_i and w (6), the NDC depth m (3), G = dL/dw
    (2*ACC + 15), gw and dalpha (8), dm/dd (3), the depth gradient (15), dG
    and dopacity (2), dlin (ACC) and the two carries (2), 54 + 3*ACC in all,
    plus by branch: the ray-splat chain rule to dTu/dTv/dTw (54) and one add
    into the pair's total per nonzero gradient row (10 + ACC), or the
    low-pass filter's dmean2d (7) and its rows (4 + ACC). ACC = S + 6."""
    acc = S + 6
    common = 54 + 3 * acc
    return (HIT_TEST_FLOPS * walked + (common + 54 + 10 + acc) * pass3d
            + (common + 7 + 4 + acc) * pass2d)


# Tolerance of the backward kernel against its plain version, per gradient
# value: BWD_RTOL x (the value's own magnitude + the 99th percentile of its
# row group's nonzero magnitudes, at most the group's largest magnitude) +
# BWD_ATOL. The per-pixel arithmetic is the same, and the plain version sums
# a tile's 256 pixels in the kernel's order (warp butterflies, then the warps
# in order; the linear rows by fmaf in pixel order), so what is left is the
# per-pixel functions' rounding (expf, log1pf, divisions) on the two sides.
# A wrong term at a typical magnitude (the group's median) fails.
BWD_RTOL, BWD_ATOL, BWD_PCT = 1e-4, 1e-7, 0.99
TRAIN_W = TRAIN_H = 800
TRAIN_VIEWS, TEST_VIEWS = 8, 4
TRAIN_ITERS = 60
TRAIN_TEST_MARKS = (30, 60)
# The surfel2 run starts at indirect_from_iter (20000 x 0.01) from phase 7's
# PLY of iteration 50: as at the real onset (20,000), the normal-propagation
# reset has just pulled the opacities up to 0.9. Iteration 60's PLY is taken
# right after an opacity reset to 0.01, from which the first prune (at 205)
# removes every splat.
S2_FROM = 50
S2_START, S2_END = 200, 240
S2_TEST_MARKS = (220, 240)
# The warp phase (15): WARP_VIEWS train views 15 deg apart, so every view has
# neighbours; run (a) continues phase 12's checkpoint from 240 to WARP_A_END
# across refnerf's warp gate (25000 x 0.01).
WARP_VIEWS = 24
WARP_GATE = 250
WARP_A_END = 260
# Run (a)'s onset TSDF grid: the 24 views' extraction at the Trainer's 256^3
# took 47.1 s, a twentieth of the script (cut to make room for phase 19).
WARP_MESH_RES = 128
WARP_TERMS = ("loss_warp_geo", "loss_warp_ncc", "loss_warp_bc", "loss_warp_mtl", "loss_warp_rgh")
W = H = 800
N_VIEWS = 8
P_SPLATS = 150_000
PAIR_CAPACITY = (1 << 20) + (1 << 18)
ITERATION = 7000  # a refnerf checkpoint of the `surfel` stage (deferred shading)
# The refreal phase (16): a COLMAP scene of REAL_VIEWS photos at the real
# captures' size, trained through -r 4 and served.
REAL_W, REAL_H = 4946, 3286  # a mip-NeRF 360 outdoor frame; -r 4 -> 1236x821
REAL_VIEWS = 24
REAL_ITERS = 170  # refreal x 0.01: initial 1-30, warp from 71, mining at 100, surfel2 from 126, LPIPS from 161
REAL_POINTS = 100_000
# The onset's unbounded TSDF grid: at the Trainer's 256^3 it took 41.3 s for
# a 5,776-triangle mesh (cut to make room for phase 19).
REAL_MESH_RES = 128
# The main model's capacity: the reader's 100,000 points are subsampled to
# half of it. With the default 1<<19 the compressed run reached 222k splats
# at the surfel2 onset, whose env copy asked the env trace for 73-180M pairs
# a step (234M probed), past the tracer's 67M-pair ceiling: steps were
# applied truncated and the env cloud went extinct (PERF.md §6).
REAL_CAPACITY = 1 << 16
REAL_PHOTO_PAIRS = 1 << 25  # the photos' render: ~25x the pairs of an 800x800 view
# Learning: the served PSNR over every train view at the end above that of
# the PLY saved at REAL_DEFERRED_FROM (the first deferred-shading step) by
# this much.
REAL_DEFERRED_FROM = 31
REAL_PSNR_GAIN = 1.0
# Phase 16's photos are baseline 4:2:0 JPEG at this quality (chip_smoke_jpeg,
# the numpy writer); phase 18 (b)'s textured photo at JPEG_TEX_QUALITY.
JPEG_QUALITY = 90
JPEG_TEX_QUALITY = 95
# Integer operations of the JPEG kernel: per 8x8 block the 64 dequantising
# multiplies, two IDCT passes of 8 one-dimensional transforms (~60 multiplies,
# adds and shifts each) and the 64 range limits (2 each); per output pixel
# the upsampling (up to 4 samples, ~10 operations a component) and the
# colour conversion (~10).
JPEG_OPS_PER_BLOCK = 64 + 2 * 8 * 60 + 2 * 64
JPEG_OPS_PER_PIXEL = 40
# Phase 17: the raytracing_residual flavor's steps from the surfel2 onset,
# the ASG flavor's `surfel` steps, the relight sky's size and the
# vertex-albedo refinement's steps.
RES_STEPS = 15
ASG_STEPS = 10
SKY_H, SKY_W = 256, 512
ALBEDO_STEPS = 5
# Phase 19: data parallelism. (a) scripts/train_torch.py --dp 1 (NCCL) and
# the plain Trainer from one seed on a scripts/make_synth_scene.py scene at
# DP_RES (DP_TRAIN train + DP_TEST test views, one sample a pixel): 1-2
# `initial`, 3-8 `surfel` with the warp from 5 (virtual cameras where a view
# has no neighbour), 9-12 `surfel2`; the losses agree within DP_LOSS_RTOL
# (the backward kernels' atomics make two runs differ by rounding). The seed
# cloud is DP_POINTS of the script's surface samples (its default is
# 100,000, whose env-GS copy asked the env trace for 129M pairs at the
# onset, past the tracer's 67M ceiling). (b) two ranks on the one card over
# gloo, each with its own view of phase 4's model.
DP_RES, DP_TRAIN, DP_TEST, DP_ITERS = 800, 8, 2, 12
DP_CAPACITY, DP_POINTS = 1 << 19, 20_000
DP_LOSS_RTOL = 2e-2
DP_GRAD_RTOL = 3e-3  # x the leaf's largest |value|, + 1e-5 (tests/test_data_parallel.py)
# Phase 20: the volume stage at glossy's preset on phase 15's 24-view scene,
# from phase 7's iteration-50 PLY (taken after the normal-propagation reset
# at 50; the iteration-30 one follows the opacity reset at 30, and a fresh
# run has no prune grace, so its first densify would prune every splat):
# `volume` VOL_START+1..VOL_END, the volume -> surfel re-init at
# VOL_END + 1, `surfel` to VOL_RUN_END with glossy's roughness warp (and the
# base-colour warp) past VOL_WARP_FROM; the learning check: mean train PSNR
# of the volume window's last 5 steps at least VOL_PSNR_GAIN dB above its
# first 5. The volume stage learns slowly at the reference's learning rates
# (env2 and the albedo from constants): on the card its train PSNR rose
# about 0.1 dB in 25 steps and 0.3 / 0.6 dB by 50 / 80 (PERF.md §6), so the
# window is 80 steps; the phase prints its own rise at 25, 50 and 80.
VOL_START, VOL_END, VOL_RUN_END, VOL_WARP_FROM = S2_FROM, 130, 150, 140
VOL_PSNR_GAIN = 0.3
# Tolerances per output group (the JAX package's tests/test_rasterize_pallas.py).
TOLS = {
    "color": 2e-4, "feature": 2e-4, "normal": 2e-4, "M1": 2e-4, "M2": 2e-4,
    "final_T": 2e-4, "depth": 1e-3, "median_depth": 1e-3, "distortion": 5e-4,
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


T_START = time.perf_counter()


def phase(name):
    print(f"\n=== {name} === (at {time.perf_counter() - T_START:.0f} s)", flush=True)


def bench_scene(np, P=P_SPLATS, seed=0):
    """Splats on a bumpy sphere shell (bench.py:19-33: a converged
    object-like scene), as raw model parameters."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(P, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = 1.0 + 0.1 * rng.standard_normal(P)[:, None]
    scaling = rng.normal(size=(P, 2)) * 0.3 - 4.2
    rotation = rng.normal(size=(P, 4))
    opac = rng.uniform(0.3, 0.95, size=(P, 1))
    return {
        "xyz": (u * r).astype(np.float32),
        "scaling": scaling.astype(np.float32),
        "rotation": rotation.astype(np.float32),
        "opacity": np.log(opac / (1 - opac)).astype(np.float32),  # logits
    }, rng


def compare_tiles(np, out, ref, S, lay):
    """Max abs error per output group; raises past the tolerance, on any
    contributor-index mismatch or on any value that differs (the forward is
    bit-identical to its plain version). Returns the largest error over all
    groups."""
    n_diff = int(np.sum(out != ref))
    print(f"    bit-identical to the plain version: {n_diff == 0} ({n_diff} values differ)")
    worst = 0.0
    for name, tol in TOLS.items():
        lo, hi = lay[name]
        a, b = out[..., lo:hi], ref[..., lo:hi]
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        ok = bool(np.all(np.abs(a - b) <= tol + 1e-3 * np.abs(b)))
        print(f"    {name:13s} max|err| {err:.3e}  (atol {tol:g}, rtol 1e-3)  {'ok' if ok else 'FAIL'}")
        check(ok, f"S={S} {name} outside tolerance")
        worst = max(worst, err)
    for name in ("n_contrib", "median_contrib"):
        lo, hi = lay[name]
        n_bad = int(np.sum(out[..., lo:hi] != ref[..., lo:hi]))
        print(f"    {name:13s} mismatches {n_bad}")
        check(n_bad == 0, f"S={S} {name} differs on {n_bad} pixels")
    check(bool(np.all(out[..., lay["_channels"]:] == 0.0)), "padding channels not zero")
    check(n_diff == 0, f"S={S}: the forward kernel differs from its plain version on {n_diff} values")
    return worst


def magnitude_quantile(torch, a, q):
    """The q-quantile of the nonzero |a| (0 when all are zero)."""
    v = a.abs().flatten()
    v = torch.sort(v[v != 0]).values
    return float(v[int(q * (v.numel() - 1))]) if v.numel() else 0.0


def compare_grads(np, torch, out, ref, S):
    """Max abs error per gradient row group of the backward, beside the
    group's median, 99th percentile and largest magnitude; raises where a
    value is outside the per-value tolerance (BWD_RTOL above) or on a
    non-finite value. Returns the largest error and the largest err/tol over
    all groups. The plain version sums a tile's pixels in the kernel's
    order, so a value that differs at all comes from a per-pixel term."""
    from materialrefgs_torch.ops.rasterize.layout import ROW_LIN, ROW_MEAN2D, ROW_OPACITY, ROW_TU, ROW_TV, ROW_TW

    groups = {"dTu": (ROW_TU, ROW_TV), "dTv": (ROW_TV, ROW_TW), "dTw": (ROW_TW, ROW_MEAN2D),
              "dmean2d": (ROW_MEAN2D, ROW_OPACITY), "dopacity": (ROW_OPACITY, ROW_LIN),
              "dlin": (ROW_LIN, out.shape[1])}
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(ref).all()), f"S={S}: non-finite gradients")
    n_diff = int((out != ref).sum())
    print(f"    backward vs plain: {n_diff} of {out.numel()} values differ at all")
    worst, worst_ratio = 0.0, 0.0
    for name, (lo, hi) in groups.items():
        a, b = out[:, lo:hi], ref[:, lo:hi]
        diff = (a - b).abs()
        err = float(diff.max())
        med, pct = magnitude_quantile(torch, b, 0.5), magnitude_quantile(torch, b, BWD_PCT)
        biggest = float(b.abs().max())
        tol = BWD_RTOL * torch.clamp(b.abs() + pct, max=biggest) + BWD_ATOL
        ratio = float((diff / tol).max())
        ok = ratio <= 1.0
        print(f"    {name:9s} max|err| {err:.3e}  |grad| median {med:.3e}, p99 {pct:.3e}, "
              f"max {biggest:.3e}; largest err/tol {ratio:.3e}  "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"S={S} backward {name} outside tolerance")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
    print(f"    backward: largest err/tol over all groups {worst_ratio:.3e}")
    return worst, worst_ratio


def cuda_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ring_views(np, n, radius=3.2):
    """Blender (OpenGL-axis) camera-to-world matrices on a ring around the
    origin, alternating slightly above and below the equator."""
    mats = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        eye = np.array([radius * math.sin(ang), 0.3 * (-1) ** i, -radius * math.cos(ang)])
        eye *= radius / np.linalg.norm(eye)
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
        mats.append(c2w)
    return mats


# FP32 operations the tracer needs (csrc/trace_fwd.cu): the hit test per
# (ray, pair) of a processed chunk: denominator 5, |.| and select 2, t 9,
# the hit point 9, u and v 10, rho 3, exp and alpha 4, the four tests 3;
# per hit, log1p, the prefix add and the T-stop test (3); per composited hit,
# exp and w (2), SH color 3 x (2 n_sh + 1), rgb 6, depth 2, flipped normal 8,
# final_T and n_contrib 4. Exact order adds its sort: k log2 k comparisons
# for the k hits of a ray in a chunk.
TRACE_HIT_FLOPS = 45


# FP32 operations the tracer's backward needs (csrc/trace_bwd.cu) for this
# data: the hit test (45) per (ray, pair) of a walked chunk; per hit its color
# 3 (2 n_sh + 1), G (14) and the walk's log1p, T, w, dL/dalpha and the two
# carries (12); per composited hit the chain rule to the 13 geometry rows and
# the ray (~90), the SH rows and the basis gradient 3 x 3 n_sh, and one add
# into each of the 13 + 3 n_sh row sums. Exact order adds its sort.
TRACE_BWD_CHAIN_FLOPS = 90


def trace_bwd_flops(work, n_sh, exact):
    per_hit = 3 * (2 * n_sh + 1) + 14 + 12
    per_contrib = TRACE_BWD_CHAIN_FLOPS + 9 * n_sh + 13 + 3 * n_sh
    flops = TRACE_HIT_FLOPS * work["hit_tests"] + per_hit * work["hits"] + per_contrib * work["contribs"]
    return flops + (work["sort_compares"] if exact else 0.0)


def trace_bwd_bytes(n_sh, pairs, NB):
    """Payload read and dpayload written once (13 + 3 n_sh rows per pair);
    rays, forward output and cotangent read, ray gradients written."""
    return 4 * (2 * (13 + 3 * n_sh) * pairs + NB * 256 * (8 + 16 + 16 + 8) + 3 * NB + 1)


def quantile_abs(torch, n_parts, part, q):
    """The q-quantile of the nonzero |values| of part(0..n_parts-1), exact,
    without concatenating or sorting them: a bisection on the float32 bit
    patterns (ordered like the values for x >= 0) of a count per part, as
    magnitude_quantile would take it. 0 when all are zero."""
    n = sum(int((part(i) != 0).sum()) for i in range(n_parts))
    if n == 0:
        return 0.0
    rank = int(q * (n - 1))
    lo, hi = 0, 0x7F800000  # bit patterns of 0 and +inf
    while lo < hi:
        mid = (lo + hi) // 2
        th = torch.tensor(mid, dtype=torch.int32).view(torch.float32).item()
        le = 0
        for i in range(n_parts):
            v = part(i).abs()
            le += int(((v != 0) & (v <= th)).sum())
        if le > rank:
            hi = mid
        else:
            lo = mid + 1
    return torch.tensor(lo, dtype=torch.int32).view(torch.float32).item()


def compare_trace_bwd(np, torch, dp, dr, rp, rr, n_sh, what):
    """The backward kernel's payload and ray gradients against the plain
    version's, per value within BWD_RTOL x min(|value| + the group's p99
    |value|, the group's max) + BWD_ATOL, for each payload row group and ray
    origin and direction; prints each group's median and p99 of the nonzero
    |err| and its max |err|. Works one payload row at a time (a ring view's
    rows hold 59M columns). Returns the largest error."""
    nrow = 13 + 3 * n_sh
    check(bool((dp[nrow:] == 0).all()) and bool((dr[..., 6:] == 0).all()), f"{what}: padding not zero")
    spans = {"center": (0, 3), "tu": (3, 6), "tv": (6, 9), "normal": (9, 12), "opacity": (12, 13), "sh": (13, nrow)}
    groups = {k: ([dp[i] for i in range(lo, hi)], [rp[i] for i in range(lo, hi)]) for k, (lo, hi) in spans.items()}
    groups["origin"] = ([dr[..., 0:3]], [rr[..., 0:3]])
    groups["direction"] = ([dr[..., 3:6]], [rr[..., 3:6]])
    worst, cells = 0.0, []
    for name, (outs, refs) in groups.items():
        check(all(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()) for a, b in zip(outs, refs)),
              f"{what}: non-finite {name} gradients")
        pct = quantile_abs(torch, len(refs), lambda i: refs[i], BWD_PCT)
        biggest = max(float(b.abs().max()) for b in refs)
        ratio, err = 0.0, 0.0
        for a, b in zip(outs, refs):
            diff = (a - b).abs()
            tol = BWD_RTOL * torch.clamp(b.abs() + pct, max=biggest) + BWD_ATOL
            ratio = max(ratio, float((diff / tol).max()))
            err = max(err, float(diff.max()))
            del diff, tol
        diff_of = lambda i: outs[i] - refs[i]  # noqa: E731
        med, p99 = (quantile_abs(torch, len(refs), diff_of, x) for x in (0.5, 0.99))
        cells.append(f"{name} {med:.1e}/{p99:.1e}/{err:.1e} (err/tol {ratio:.2e})")
        check(biggest > 0, f"{what}: the {name} gradient is zero everywhere")
        check(ratio <= 1.0, f"{what}: the {name} gradient is outside the per-value tolerance")
        worst = max(worst, err)
    print(f"    {what}: median/p99/max |err| per group: " + ", ".join(cells))
    return worst


def trace_flops(work, n_sh, exact):
    composite = 2 + 3 * (2 * n_sh + 1) + 6 + 2 + 8 + 4
    flops = TRACE_HIT_FLOPS * work["hit_tests"] + 3 * work["hits"] + composite * work["contribs"]
    return flops + (work["sort_compares"] if exact else 0.0)


def compare_trace(np, out, ref, what):
    """All 16 output channels of the tracer kernels against their plain
    version, bit for bit (the kernels repeat its operations in its order,
    built without FMA contraction): max and 99th-percentile |err| per
    channel; raises on any difference. Returns the largest error."""
    from materialrefgs_torch.ops.tracer import layout as tl

    names = ["r", "g", "b", "depth", "nx", "ny", "nz", "final_T", "n_contrib", "SUMLG", "NPROC"]
    names += [f"pad{c}" for c in range(len(names), tl.C_OUT)]
    check(np.isfinite(out).all() and np.isfinite(ref).all(), f"{what}: non-finite tracer output")
    worst = 0.0
    cells = []
    for c, name in enumerate(names):
        err = np.abs(out[..., c] - ref[..., c])
        n_bad = int((out[..., c] != ref[..., c]).sum())
        cells.append(f"{name} {float(err.max()):.2e}/{float(np.quantile(err, 0.99)):.2e}"
                     + (f" ({n_bad} rays differ)" if n_bad else ""))
        check(n_bad == 0, f"{what}: channel {name} differs on {n_bad} rays")
        worst = max(worst, float(err.max()))
    print(f"    {what}: max/p99 |err| per channel: " + ", ".join(cells))
    return worst


def tracer_at(np, torch, cap, what):
    """Both tracer kernels at one training step's captured backward inputs
    (payload cut to the columns its segments use, rays, segments, walk
    lengths, forward output, cotangent): each against its plain version on
    every bundle (the forward bit for bit, and equal to the step's own
    forward output), its time (CUDA events), its plain version's (timed in
    its comparison run) and its bound from the plain version's work counts.
    Returns {"fwd": ..., "bwd": ...} with ms, plain_ms, bound, by and err."""
    from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd

    sargs, skw = cap
    n_sh_s = skw["n_sh"]
    # The kernel against its plain version on every bundle of the step (the
    # silhouette bundles' walks of hundreds of chunks included), the plain
    # version timed in its comparison run, the bound from its work counts.
    dp, dr = trace_bwd.trace_bundles_bwd(*sargs, **skw)
    torch.cuda.synchronize()
    swork, sres = {}, {}
    s_plain_ms = cuda_ms(torch, lambda: sres.update(ref=trace_bwd.trace_bundles_bwd_plain(*sargs, **skw, work=swork)), 1)
    rp, rr = sres.pop("ref")
    s_bwd_err = compare_trace_bwd(np, torch, dp, dr, rp, rr, n_sh_s,
                                  f"{what} backward, every bundle (n_sh={n_sh_s}, "
                                  f"{'exact' if skw['exact_order'] else 'list'} order)")
    del dp, dr, rp, rr
    for _ in range(3):
        trace_bwd.trace_bundles_bwd(*sargs, **skw)
    s_ms = cuda_ms(torch, lambda: trace_bwd.trace_bundles_bwd(*sargs, **skw), 10)
    NBs = sargs[1].shape[0]
    s_bytes = trace_bwd_bytes(n_sh_s, swork["hit_tests"] // 256, NBs)
    s_flops = trace_bwd_flops(swork, n_sh_s, skw["exact_order"])
    tb_, to_ = s_bytes / PEAK_BYTES_PER_S * 1e3, s_flops / PEAK_FP32_FLOPS * 1e3
    s_bound, s_by = max(tb_, to_), ("bytes" if tb_ >= to_ else "operations")
    print(f"  tracer bwd at the step's inputs ({NBs} bundles, {int((sargs[3] > 0).sum())} with pairs, "
          f"{int(sargs[3].sum())} pairs, {int(sargs[4].max()) // 128} chunks in the longest walk): kernel ms "
          f"{s_ms:.4f}; plain version ms {s_plain_ms:.1f} (timed in its comparison run)")
    print(f"  tracer bwd bound ms: {s_bound:.4f} (by {s_by}: {s_bytes / 1e6:.2f} MB -> {tb_:.4f} ms, "
          f"{s_flops / 1e9:.4f} GFLOP -> {to_:.4f} ms: {swork['hit_tests']} hit tests, {swork['hits']} hits, "
          f"{swork['contribs']} composited, {swork['sort_compares']:.0f} sort compares); kernel at "
          f"{100 * s_bound / s_ms:.1f} % of it")
    print("  tracer bwd library call: none computes this function")

    # The forward kernel at the same step's inputs: against its plain version
    # on every bundle, its time, the plain version's (timed in its comparison
    # run) and its bound from the plain version's work; the step's walks.
    fargs, fkw = sargs[:4], {k: skw[k] for k in ("n_sh", "tmin", "exact_order")}
    fo = trace_fwd.trace_bundles_fwd(*fargs, **fkw)
    torch.cuda.synchronize()
    check(torch.equal(fo, sargs[5]), "the forward kernel gave the step another output on the same inputs")
    fwork, fres = {}, {}
    f_plain_ms = cuda_ms(torch, lambda: fres.update(ref=trace_fwd.trace_bundles_fwd_plain(*fargs, **fkw, work=fwork)), 1)
    f_err = compare_trace(np, fo.cpu().numpy(), fres.pop("ref").cpu().numpy(),
                          f"{what} forward, every bundle (n_sh={n_sh_s})")
    walk_histogram(torch, sargs[3], fo[:, 0, 10], sargs[0].shape[1], what)
    del fo
    for _ in range(3):
        trace_fwd.trace_bundles_fwd(*fargs, **fkw)
    f_ms = cuda_ms(torch, lambda: trace_fwd.trace_bundles_fwd(*fargs, **fkw), 10)
    f_pairs = fwork["hit_tests"] // 256
    f_bytes = 4 * ((13 + 3 * n_sh_s) * f_pairs + NBs * 256 * 8 + NBs * 256 * 16 + 2 * NBs + 1)
    f_flops = trace_flops(fwork, n_sh_s, skw["exact_order"])
    tb_, to_ = f_bytes / PEAK_BYTES_PER_S * 1e3, f_flops / PEAK_FP32_FLOPS * 1e3
    f_bound, f_by = max(tb_, to_), ("bytes" if tb_ >= to_ else "operations")
    print(f"  tracer fwd at the step's inputs: kernel ms {f_ms:.4f}; plain version ms {f_plain_ms:.1f} (timed in "
          f"its comparison run)")
    print(f"  tracer fwd bound ms: {f_bound:.4f} (by {f_by}: {f_bytes / 1e6:.2f} MB -> {tb_:.4f} ms, "
          f"{f_flops / 1e9:.4f} GFLOP -> {to_:.4f} ms: {fwork['hit_tests']} hit tests, {fwork['hits']} hits, "
          f"{fwork['contribs']} composited, {fwork['sort_compares']:.0f} sort compares); kernel at "
          f"{100 * f_bound / f_ms:.1f} % of it")
    return {"bwd": dict(ms=s_ms, plain_ms=s_plain_ms, bound=s_bound, by=s_by, err=s_bwd_err),
            "fwd": dict(ms=f_ms, plain_ms=f_plain_ms, bound=f_bound, by=f_by, err=f_err)}


def icosphere(np, sub):
    """Unit icosphere (vertices, triangles) with 20 * 4^sub faces."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
        [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1])]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
             [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
             [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(sub):
        mid, new = {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                verts.append((verts[a] + verts[b]) / 2.0)
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new
    v = np.array(verts)
    return v / np.linalg.norm(v, axis=-1, keepdims=True), np.array(faces, np.int32)


def bumpy_mesh(np):
    """The served checkpoint's mesh: an icosphere of 81,920 triangles
    displaced to r = 1.05 + 0.3 sin(8x) sin(8y + 1) sin(8z + 2). Its bumps
    reach past the splats' surface, so reflected rays leaving a valley hit the
    neighbouring bumps (a convex mesh would occlude nothing)."""
    v, f = icosphere(np, 6)
    b = np.sin(8.0 * v[:, 0]) * np.sin(8.0 * v[:, 1] + 1.0) * np.sin(8.0 * v[:, 2] + 2.0)
    return (v * (1.05 + 0.3 * b)[:, None]).astype(np.float32), f


def radial_rotations(np, xyz, rng):
    """Quaternions (w, x, y, z) whose surfel normal (the rotation's z axis)
    is the splat's radial direction, with a random spin about it: the shell's
    splats lie in the surface, as a converged model's do."""
    n = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    q = np.stack([1.0 + n[:, 2], -n[:, 1], n[:, 0], np.zeros(len(n))], -1)  # +z -> n
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    half = rng.uniform(0.0, math.pi, len(n))
    cw, sz = np.cos(half), np.sin(half)  # spin (cos, 0, 0, sin) about the local z
    return np.stack([q[:, 0] * cw, q[:, 1] * cw + q[:, 2] * sz, q[:, 2] * cw - q[:, 1] * sz,
                     q[:, 0] * sz], -1).astype(np.float32)


def env_cloud_arrays(np, PARAM_SHAPES, rgb_to_sh, torch, P=P_SPLATS, seed=1):
    """150k environment splats, SH degree 3 with nonzero higher bands, on a
    shell of radius 2.2 +- 0.2 around the object."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(P, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, size=(P, 1))
    arrays = {name: np.zeros((P,) + shape(16), np.float32) for name, shape in PARAM_SHAPES.items()}
    arrays.update(
        xyz=(u * rng.uniform(2.0, 2.4, size=(P, 1))).astype(np.float32),
        scaling=(rng.normal(size=(P, 2)) * 0.2 - 3.9).astype(np.float32),
        rotation=rng.normal(size=(P, 4)).astype(np.float32),
        opacity=np.log(opac / (1 - opac)).astype(np.float32),
        features_dc=rgb_to_sh(torch.tensor(rng.uniform(0.05, 0.95, size=(P, 1, 3)))).numpy().astype(np.float32),
        features_rest=(rng.normal(size=(P, 15, 3)) * 0.15).astype(np.float32),
    )
    return arrays


def walk_histogram(torch, seg_count, nproc, cols, what):
    """The work of one tracer launch as the range split sees it: walks
    (processed chunks per bundle), chunks, ranges of RANGE_CHUNKS chunks,
    blocks launched, and the pairs in chunks past a bundle's NPROC (launch
    (a) may test them, up to its early exit)."""
    from materialrefgs_torch.ops.tracer.ranges import RANGE_CHUNKS, max_ranges

    R = RANGE_CHUNKS
    count = seg_count.long()
    n_chunks = (count + 127) // 128
    walk = nproc.long()
    edges = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 1 << 30]
    hist = {f"{a}-{b - 1}": int(((walk >= a) & (walk < b)).sum()) for a, b in zip(edges, edges[1:])}
    past = torch.clamp(count - walk * 128, min=0)
    print(f"    {what}: walks: longest {int(walk.max())} chunks, {int(walk.sum())} processed of {int(n_chunks.sum())} "
          f"chunks ({int((count > 0).sum())} bundles with pairs); ranges of R={R}: {int(((walk + R - 1) // R).sum())} "
          f"below NPROC, {int(((n_chunks + R - 1) // R).sum())} in all, "
          f"{max_ranges(cols, count.numel(), R)} blocks launched; pairs in chunks past NPROC "
          f"{int(past.sum())}; walks by length: {hist}")


def capture_trace(torch, tracer_api, fn):
    """Run fn() under no_grad and return the (args, kwargs) of every tracer
    kernel call it makes, the payload cut to the columns its segments use."""
    captured = []
    real = tracer_api.trace_bundles_fwd

    def wrapper(payload, rays, seg_start, seg_count, **kw):
        used = payload[:, : int(seg_start[-1]) + 128].clone()
        kw_ = {k: v for k, v in kw.items() if k != "residual"}  # the autograd residual's buffer
        captured.append(((used, rays.clone(), seg_start.clone(), seg_count.clone()), kw_))
        return real(payload, rays, seg_start, seg_count, **kw)

    tracer_api.trace_bundles_fwd = wrapper
    try:
        with torch.no_grad():
            fn()
    finally:
        tracer_api.trace_bundles_fwd = real
    return captured


def capture_raster(torch, api_mod, fn):
    """Run fn() and return the (inputs, kwargs) of every rasterizer backward
    call it makes through _RenderPairs: (payload cut to the columns its
    tiles use, tile_start, tile_count, tile_active, forward output,
    cotangent), copied. The forward kernel's inputs are the first three."""
    captured = []
    real = api_mod.rasterize_tiles_bwd

    def wrapper(payload, ts, tc, ta, fo, cot, **kw):
        used = payload[:, : int(ts[-1]) + 1].clone().contiguous()
        captured.append(((used, ts.clone(), tc.clone(), ta.clone(), fo.clone(), cot.clone()), dict(kw)))
        return real(payload, ts, tc, ta, fo, cot, **kw)

    api_mod.rasterize_tiles_bwd = wrapper
    try:
        fn()
    finally:
        api_mod.rasterize_tiles_bwd = real
    return captured


def raster_at(np, torch, what, cap):
    """Both rasterizer kernels at one training step's captured inputs: the
    forward against its plain version bit for bit (and against the step's own
    output), the backward on the step's own forward output and cotangent
    against its plain version per value; each kernel's time (CUDA events),
    its plain version's (timed in its comparison run) and its bound, counted
    from the plain versions' outcomes: operations as in phases 5 and 9, and
    bytes over the payload columns this data needs (each tile's pairs up to
    its last contributor, read once) and the outputs (written once; the
    backward's holds a row for every pair). One launch of each per training
    step. Returns the numbers."""
    from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.rasterize.layout import ROW_LIN, acc_channels, out_layout

    (pp, ts, tc, ta, fo_step, cot), kw = cap
    S = kw["S"]
    lay = out_layout(S)
    fo = tiles_fwd.rasterize_tiles_fwd(pp, ts, tc, **kw)
    torch.cuda.synchronize()
    res = {}
    f_plain = cuda_ms(torch, lambda: res.update(ref=tiles_fwd.rasterize_tiles_fwd_plain(pp, ts, tc, **kw)), 1)
    ref = res.pop("ref")
    n_diff = int((fo != ref).sum())
    f_err = float((fo - ref).abs().max())
    del ref
    print(f"  rasterizer at {what}: {int(ts[-1])} pairs, S={S}; tile_count median/p99/max "
          f"{int(tc.median())}/{int(torch.quantile(tc.float(), 0.99))}/{int(tc.max())}, tile_active median/p99/max "
          f"{int(ta.median())}/{int(torch.quantile(ta.float(), 0.99))}/{int(ta.max())}")
    print(f"    forward vs plain: bit-identical {n_diff == 0} ({n_diff} values differ)")
    check(n_diff == 0, f"{what}: the forward kernel differs from its plain version on {n_diff} values")
    check(torch.equal(fo, fo_step), f"{what}: the forward kernel gave the step another output on the same inputs")
    out = tiles_bwd.rasterize_tiles_bwd(pp, ts, tc, ta, fo_step, cot, **kw)
    torch.cuda.synchronize()
    work = {}
    b_plain = cuda_ms(torch, lambda: res.update(ref=tiles_bwd.rasterize_tiles_bwd_plain(
        pp, ts, tc, ta, fo_step, cot, **kw, work=work)), 1)
    b_err, b_ratio = compare_grads(np, torch, out, res.pop("ref"), S)
    del out
    fwd_fn = lambda: tiles_fwd.rasterize_tiles_fwd(pp, ts, tc, **kw)  # noqa: E731
    bwd_fn = lambda: tiles_bwd.rasterize_tiles_bwd(pp, ts, tc, ta, fo_step, cot, **kw)  # noqa: E731
    for fn in (fwd_fn, bwd_fn, fwd_fn, bwd_fn):
        fn()
    f_ms, b_ms = cuda_ms(torch, fwd_fn, 10), cuda_ms(torch, bwd_fn, 10)
    n_p = int(ts[-1])
    T_ = kw["grid_x"] * kw["grid_y"]
    c_out = fo.shape[-1]
    walked = float(fo[..., lay["n_contrib"][0]].sum())
    cols = int(torch.minimum(ta, tc).long().sum())
    nrow = ROW_LIN + acc_channels(S)
    nums = {}
    for name, n_bytes, flops in (
        ("fwd", 4 * (cols * nrow + T_ * 256 * c_out + 2 * T_ + 1), HIT_TEST_FLOPS * walked),
        ("bwd", 4 * ((cols + n_p) * nrow + 2 * T_ * 256 * c_out + 3 * T_ + 1),
         bwd_flops(S, walked, work["pass3d"], work["pass2d"])),
    ):
        tb_, to_ = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        nums[name] = dict(bound=max(tb_, to_), by="bytes" if tb_ >= to_ else "operations", tb=tb_, to=to_,
                          bytes=n_bytes, flops=flops)
    nums["fwd"].update(ms=f_ms, plain_ms=f_plain, err=f_err)
    nums["bwd"].update(ms=b_ms, plain_ms=b_plain, err=b_err, ratio=b_ratio)
    for name in ("fwd", "bwd"):
        b = nums[name]
        print(f"    {name} kernel {b['ms']:.4f} ms, 1 launch per training step; bound {b['bound']:.4f} ms (by "
              f"{b['by']}: {b['bytes'] / 1e6:.1f} MB -> {b['tb']:.4f} ms, {b['flops'] / 1e9:.2f} GFLOP -> "
              f"{b['to']:.4f} ms), kernel at {100 * b['bound'] / b['ms']:.1f} % of it; plain version "
              f"{b['plain_ms']:.1f} ms (timed in its comparison run)")
    print(f"    {walked:.0f} (pixel, position) in contributor ranges; passing the hit test {work['pass3d']} (3D) + "
          f"{work['pass2d']} (2D); {cols} pair columns up to the tiles' last contributors")
    return nums


def warp_launches_per_step(opt):
    """The warp sampler's launches (forward, backward) in one Trainer step
    with the warp on: forward the depth sample, the NCC's four patches, the
    two base-colour patches, and with a material term the mask and each
    term's two patches; backward each sample whose map or coordinates reach
    the loss: the depth sample (geo term), the nearest view's grey patch
    (NCC), its base colour and each material term's nearest map."""
    ncc = opt.use_warp_ncc_loss and opt.multi_view_ncc_weight > 0 and opt.use_multi_view_trim
    n_mat = int(opt.use_metallic_warp_loss) + int(opt.use_roughness_warp_loss)
    return 3 + 4 * ncc + (1 + 2 * n_mat if n_mat else 0), int(opt.use_warp_geo_loss) + int(ncc) + 1 + n_mat


def capture_warp(torch, fn):
    """Run fn() and return (map, coordinates, output gradient, needs map,
    needs coordinates) for every warp-sampler backward it makes
    (WarpSample.backward): the map and the coordinates as the Function
    saved them (a channel slice keeps its strides), the gradient copied."""
    from materialrefgs_torch.ops import warp_sample as ws

    captured = []
    real = ws.WarpSample.__dict__["backward"]

    def backward(ctx, grad):
        img, coords = ctx.saved_tensors
        captured.append((img.detach(), coords.detach(), grad.detach().clone(), *ctx.needs_input_grad))
        return real.__func__(ctx, grad)

    ws.WarpSample.backward = staticmethod(backward)
    try:
        fn()
    finally:
        ws.WarpSample.backward = real
    return captured


def grad_err_ratio(torch, got, want, tol, what):
    """The largest |got - want| and |got - want| / tol over the finite
    values of want; raises where NaN or an infinity sits elsewhere in got
    or where a ratio passes 1."""
    check(torch.equal(torch.isnan(got), torch.isnan(want)), f"{what}: NaN at other entries")
    fin = torch.isfinite(want)
    check(torch.equal(got[~fin & ~torch.isnan(want)], want[~fin & ~torch.isnan(want)]), f"{what}: infinities differ")
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ratio = float((diff / tol[fin]).max()) if diff.numel() else 0.0
    check(ratio <= 1.0, f"{what}: largest err/tol {ratio:.3e}")
    return err, ratio


def warp_sample_at(np, torch, caps, what):
    """The warp sampler's kernels at one training step's captured calls
    (capture_warp): each gather against the plain expression bit for bit
    (NaN where it has NaN); each splat against the plain expression's
    autograd gradients, the map's within 2^-14 of each texel's sum of its
    terms' magnitudes (the atomics sum in no fixed order), the coordinates'
    within the warp tolerance (rtol 1e-4, atol 1e-6 x max(|grad|, 1)); each
    kernel's time (CUDA events over 20 launches), the plain versions' (timed
    in the comparison run: the forward, and the forward with its autograd
    backward) and the bound by bytes: the coordinates (8 B each), the
    output or its gradient (C floats each) and the map once, plus the
    coordinates' gradient and a second read of the map where asked for.
    Returns the numbers of the call with the most samples (coordinates x
    channels), with the largest error and err/tol over all calls."""
    from materialrefgs_torch.ops import warp_sample as ws

    rows = []
    for i, (img, coords, g, need_map, need_coords) in enumerate(caps):
        (H, W, C), M = img.shape, coords.shape[0]
        res = {}
        out = ws.warp_sample_fwd(img, coords)
        torch.cuda.synchronize()
        with torch.no_grad():
            f_plain = cuda_ms(torch, lambda: res.update(ref=ws.grid_sample_plain(img, coords)), 1)
        ref = res.pop("ref")
        n_diff = int((~((out == ref) | (torch.isnan(out) & torch.isnan(ref)))).sum())
        check(n_diff == 0, f"{what}, call {i}: the gather differs from the plain expression on {n_diff} values")
        del out, ref
        kw = dict(need_map=need_map, need_coords=need_coords)
        dm, dc = ws.warp_sample_bwd(img, coords, g, **kw)
        torch.cuda.synchronize()
        b_plain = cuda_ms(torch, lambda: res.update(ref=ws.grid_sample_plain_grads(img, coords, g, **kw)), 1)
        rm, rc = res.pop("ref")
        errs, ratios = [], []
        if need_map:
            mag, _ = ws.grid_sample_plain_grads(img, coords, g.abs(), need_map=True, need_coords=False)
            e, r = grad_err_ratio(torch, dm, rm, 2.0**-14 * mag + 1e-30, f"{what}, call {i}: map gradient")
            errs.append(e)
            ratios.append(r)
            del mag
        if need_coords:
            fin = torch.isfinite(rc)
            scale = max(float(rc[fin].abs().max()) if fin.any() else 0.0, 1.0)
            e, r = grad_err_ratio(torch, dc, rc, 1e-4 * rc.abs() + 1e-6 * scale, f"{what}, call {i}: coordinate gradient")
            errs.append(e)
            ratios.append(r)
        del dm, dc, rm, rc
        fwd_fn = lambda: ws.warp_sample_fwd(img, coords)  # noqa: E731
        bwd_fn = lambda: ws.warp_sample_bwd(img, coords, g, **kw)  # noqa: E731
        for fn in (fwd_fn, bwd_fn):
            fn()
        f_ms, b_ms = cuda_ms(torch, fwd_fn, 20), cuda_ms(torch, bwd_fn, 20)
        map_b = 4 * H * W * C
        f_bytes = 8 * M + 4 * M * C + map_b
        b_bytes = 8 * M + 4 * M * C + map_b * need_map + (8 * M + map_b) * need_coords
        row = dict(n=M * C, fwd=dict(ms=f_ms, plain_ms=f_plain, bound=f_bytes / PEAK_BYTES_PER_S * 1e3, err=0.0),
                   bwd=dict(ms=b_ms, plain_ms=b_plain, bound=b_bytes / PEAK_BYTES_PER_S * 1e3, err=max(errs),
                            ratio=max(ratios)))
        rows.append(row)
        print(f"  warp sampler at {what}, call {i}: map {H}x{W}x{C} (strides {tuple(img.stride())}), {M} coordinates, "
              f"gradient of the map {need_map}, of the coordinates {need_coords}: gather bit for bit; splat err/tol "
              f"{max(ratios):.3e} (largest err {max(errs):.3e}); kernel ms gather {f_ms:.4f} (bound {row['fwd']['bound']:.4f}"
              f", bytes), splat {b_ms:.4f} (bound {row['bwd']['bound']:.4f}, bytes); plain ms {f_plain:.2f}, with its "
              f"autograd backward {b_plain:.2f}")
    check(len(rows) > 0, f"{what}: no warp-sampler backward captured")
    top = max(rows, key=lambda r: r["n"])
    nums = {k: dict(top[k], err=max(r[k]["err"] for r in rows)) for k in ("fwd", "bwd")}
    nums["bwd"]["ratio"] = max(r["bwd"]["ratio"] for r in rows)
    return nums


def jpeg_split(torch, dev, path):
    """One photo's decode in its four parts, each timed on its own: the host
    entropy decode (markers and csrc/jpeg_entropy.cpp), the copy of the
    coefficients to the card, the kernel (CUDA events, one launch with its
    enqueue) and the copy of the pixels back. Returns the coefficients, the
    device tensors, the pixels and the times in ms."""
    from materialrefgs_torch.utils import jpeg

    t0 = time.perf_counter()
    co = jpeg.read_coefficients(path)
    entropy = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coef = torch.from_numpy(co.coef).to(dev)
    quant = torch.from_numpy(co.quant).to(dev)
    torch.cuda.synchronize()
    h2d = (time.perf_counter() - t0) * 1e3
    res = {}
    kernel = cuda_ms(torch, lambda: res.update(out=jpeg.idct_color(coef, quant, co.comps, co.height, co.width,
                                                                     co.color)), 1)
    t0 = time.perf_counter()
    host = res["out"].cpu()
    d2h = (time.perf_counter() - t0) * 1e3
    return co, coef, quant, res["out"], host, dict(entropy=entropy, h2d=h2d, kernel=kernel, d2h=d2h)


def jpeg_kernel_at(torch, co, coef, quant, out, what):
    """The JPEG kernel against its plain version on one photo's coefficients
    (every byte), its time (CUDA events over 10 launches), the plain
    version's (timed in its comparison run) and its bound: bytes (the
    coefficients and tables read once, the pixels written once) against
    operations (JPEG_OPS_PER_BLOCK, JPEG_OPS_PER_PIXEL at the FP32 rate of
    the CUDA cores, the published 32-bit rate of PEAK_FP32_FLOPS)."""
    from materialrefgs_torch.utils import jpeg

    args = (coef, quant, co.comps, co.height, co.width, co.color)
    res = {}
    plain_ms = cuda_ms(torch, lambda: res.update(ref=jpeg.idct_color_plain(*args)), 1)
    err = int((out.int() - res.pop("ref").int()).abs().max())
    check(err == 0, f"{what}: the JPEG kernel differs from its plain version (max abs diff {err})")
    fn = lambda: jpeg.idct_color(*args)  # noqa: E731
    fn()
    ms = cuda_ms(torch, fn, 10)
    n_bytes = coef.numel() * 2 + quant.numel() * 4 + out.numel()
    ops = JPEG_OPS_PER_BLOCK * coef.shape[0] + JPEG_OPS_PER_PIXEL * co.height * co.width
    tb, to = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    nums = dict(ms=ms, plain_ms=plain_ms, err=err, bound=max(tb, to), by="bytes" if tb >= to else "operations")
    print(f"    JPEG kernel at {what} ({co.width}x{co.height}, {coef.shape[0]} blocks): bit-identical to its plain "
          f"version; {ms:.4f} ms; bound {nums['bound']:.4f} ms (by {nums['by']}: {n_bytes / 1e6:.1f} MB -> "
          f"{tb:.4f} ms, {ops / 1e9:.2f} G integer ops -> {to:.4f} ms), kernel at {100 * nums['bound'] / ms:.1f} % "
          f"of it; plain version {plain_ms:.1f} ms")
    return nums


def write_colmap_bin(np, sparse, W, H, params, c2ws, names, xyz, rgb):
    """A COLMAP sparse model (cameras.bin, images.bin, points3D.bin) with
    one PINHOLE camera: c2ws are Blender (OpenGL-axis) camera-to-world
    matrices; points carry no tracks."""
    import struct

    from materialrefgs_torch.data.colmap_loader import rotmat2qvec

    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, W, H) + struct.pack("<4d", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(c2ws)))
        for i, (c2w, name) in enumerate(zip(c2ws, names)):
            # COLMAP axes: x right, y down, z forward.
            R_c2w = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0])
            R = R_c2w.T
            t = -R @ c2w[:3, 3]
            f.write(struct.pack("<idddddddi", i + 1, *rotmat2qvec(R), *t, 1) + name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rec = np.zeros(len(xyz), np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
                                       ("track", "<u8")]))
    rec["id"] = np.arange(1, len(xyz) + 1)
    rec["xyz"], rec["rgb"], rec["err"] = xyz, rgb, 0.5
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + rec.tobytes())


def random_lpips_weights(np, path, seed=0):
    """LPIPS weights in the documented .npz format (train/lpips.py), random:
    He-normal VGG16 convolutions, zero biases, uniform heads. No pretrained
    VGG16 ships with the repository; the network runs at full width all the
    same."""
    from materialrefgs_torch.train.lpips import _VGG_CHANNELS

    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, c in enumerate(_VGG_CHANNELS):
        out[f"conv{i}_w"] = (rng.normal(size=(3, 3, cin, c)) * math.sqrt(2.0 / (9 * cin))).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(c, np.float32)
        cin = c
    for j, c in enumerate((64, 128, 256, 512, 512)):
        out[f"lin{j}"] = rng.uniform(size=c).astype(np.float32)
    np.savez(path, **out)
    return path


def lpips_flops(H, W):
    """Multiply-adds x 2 of one VGG16 pass to the fifth tap at H x W (13
    3x3 convolutions, floor pooling)."""
    from materialrefgs_torch.train.lpips import _POOL_AFTER, _VGG_CHANNELS

    total, cin, h, w = 0, 3, H, W
    for i, c in enumerate(_VGG_CHANNELS):
        total += 2 * 9 * cin * c * h * w
        cin = c
        if i in _POOL_AFTER:
            h, w = h // 2, w // 2
    return total


def refreal_phase(np, torch, dev, smi_line, model, mips, work_dir, train_torch, eval_torch):
    """Phase 16: refreal end to end. (a) a COLMAP scene of REAL_VIEWS JPEG
    photos (baseline 4:2:0, quality JPEG_QUALITY) at REAL_W x REAL_H
    rendered from phase 4's model over black
    (PINHOLE, fx != fy, principal point off centre; a ring at two
    elevations 15 deg apart), REAL_POINTS sparse points near its surface
    coloured from a render; (b) scripts/train_torch.py --preset refreal -r 4
    (1236x821) for REAL_ITERS iterations at x0.01 with LPIPS at random
    weights, ref-score masks mined at 100, the unbounded TSDF at the onset;
    (c) the four kernels at a surfel2 step's inputs against their plain
    versions; (d) scripts/eval_torch.py serves the test views. Each photo's
    decode is timed in its parts, and the JPEG kernel held against its plain
    version on photo 0. Returns the numbers for the kernels' record."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke_jpeg
    from materialrefgs_torch import config as cfg
    from materialrefgs_torch.data import readers
    from materialrefgs_torch.evaluate import render_set
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models.env_light import EnvLightMips
    from materialrefgs_torch.models.scene import Scene
    from materialrefgs_torch.ops import warp_sample as ws
    from materialrefgs_torch.ops.rasterize import api, tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.tracer import api as tracer_api
    from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd
    from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
    from materialrefgs_torch.train import lpips as lpips_mod
    from materialrefgs_torch.utils import jpeg

    kernels = (tiles_fwd.rasterize_tiles_fwd, tiles_bwd.rasterize_tiles_bwd, trace_fwd.trace_bundles_fwd,
               trace_bwd.trace_bundles_bwd, jpeg.idct_color, ws.warp_sample_fwd, ws.warp_sample_bwd)
    # (a) the scene. fy sets a 0.8 rad vertical field of view; fx is 1 %
    # shorter, the principal point a few pixels off centre.
    scene_dir = os.path.join(work_dir, "refreal_scene")
    fy = REAL_H / (2 * math.tan(0.4))
    params = (fy / 1.01, fy, REAL_W / 2 + 3.7, REAL_H / 2 - 2.9)
    names = [f"frame_{i:05d}.jpg" for i in range(REAL_VIEWS)]
    c2ws = ring_views(np, REAL_VIEWS)
    rng = np.random.default_rng(16)
    t0 = time.perf_counter()
    sparse = os.path.join(scene_dir, "sparse", "0")
    write_colmap_bin(np, sparse, REAL_W, REAL_H, params, c2ws, names, np.zeros((0, 3)), np.zeros((0, 3)))
    mp = dataclasses.replace(cfg.preset_refreal()[0], source_path=scene_dir)
    full = Scene.load(mp, resolution_scale=1, device=dev)
    cams = [c for _, c in sorted(zip([ci.image_name for ci in full.info.train_cameras + full.info.test_cameras],
                                     full.train_cameras + full.test_cameras), key=lambda t: t[0])]
    opts = RenderOptions(raster=api.RasterizeConfig(pair_capacity=REAL_PHOTO_PAIRS))
    black = torch.zeros(3, device=dev)
    t_render = 0.0
    view0 = None
    os.makedirs(os.path.join(scene_dir, "images"))

    def encode(path, img):
        t1 = time.perf_counter()
        size = chip_smoke_jpeg.write_jpeg(path, img, quality=JPEG_QUALITY, sampling=(2, 2))
        return time.perf_counter() - t1, size

    # The encodes (numpy) overlap the next renders in 4 threads.
    with torch.no_grad(), ThreadPoolExecutor(max_workers=4) as pool:
        writes = []
        for i, cam in enumerate(cams):
            t1 = time.perf_counter()
            pkg = render_surfel(model, cam, black, mips, opts)
            check(int(pkg["overflow"]) == 0, f"refreal photo {i} overflows the pair capacity")
            img = (torch.clamp(pkg["render"], 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
            del pkg
            t_render += time.perf_counter() - t1
            writes.append(pool.submit(encode, os.path.join(scene_dir, "images", names[i]), img))
            if i == 0:
                view0 = img
        writes = [w.result() for w in writes]
    # The sparse points: splat centres near the surface, coloured from view
    # 0's photo where they project into it (the nearest edge pixel elsewhere).
    sel = rng.choice(model.capacity, REAL_POINTS, replace=False)
    xyz = model.xyz[sel].detach().cpu().numpy().astype(np.float64) + rng.normal(size=(REAL_POINTS, 3)) * 0.01
    clip = np.concatenate([xyz, np.ones((REAL_POINTS, 1))], 1) @ cams[0].full_proj.cpu().numpy().astype(np.float64)
    px = np.clip(((clip[:, 0] / clip[:, 3] + 1) * REAL_W - 1) / 2, 0, REAL_W - 1).astype(int)
    py = np.clip(((clip[:, 1] / clip[:, 3] + 1) * REAL_H - 1) / 2, 0, REAL_H - 1).astype(int)
    write_colmap_bin(np, sparse, REAL_W, REAL_H, params, c2ws, names, xyz, view0[py, px])
    os.remove(os.path.join(sparse, "points3D.ply"))  # the reader's cache of the empty cloud above
    write_s = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(scene_dir) for f in fs)
    print(f"  COLMAP scene: {REAL_VIEWS} JPEG photos (baseline 4:2:0, quality {JPEG_QUALITY}) at {REAL_W}x{REAL_H} "
          f"(PINHOLE fx {params[0]:.1f}, fy {params[1]:.1f}, cx {params[2]:.1f}, cy {params[3]:.1f}), {REAL_POINTS} "
          f"points; written in {write_s:.1f} s (renders {t_render:.1f} s, JPEG encodes {sum(w[0] for w in writes):.1f} "
          f"s in 4 threads); {on_disk / 1e6:.1f} MB on disk")
    # Each photo's decode in its parts; the kernel against its plain version
    # on photo 0 (the main path's shape: the record's time, bound and plain
    # time).
    splits = []
    for i, name in enumerate(names):
        co, coef, quant, out, host, t = jpeg_split(torch, dev, os.path.join(scene_dir, "images", name))
        splits.append(t)
        print(f"    photo {i:2d}: {writes[i][1] / 1e6:.2f} MB, written in {writes[i][0]:.2f} s; decode "
              f"{sum(t.values()):.1f} ms = entropy {t['entropy']:.1f} + H2D {t['h2d']:.1f} + kernel {t['kernel']:.2f} "
              f"+ D2H {t['d2h']:.1f} ms")
        if i == 0:
            diff = float((host.int() - torch.from_numpy(view0).int()).abs().float().mean())
            check(tuple(host.shape) == (REAL_H, REAL_W, 3) and diff < 3.0,
                  f"photo 0 decodes {diff:.2f} levels from its render on average")
            jpeg_nums = jpeg_kernel_at(torch, co, coef, quant, out, "phase 16's photo 0")
        del co, coef, quant, out, host
    med = {k: float(np.median([t[k] for t in splits])) for k in splits[0]}
    print(f"  photo decode, medians over {len(splits)}: entropy {med['entropy']:.1f} ms, H2D {med['h2d']:.1f} ms, "
          f"kernel {med['kernel']:.2f} ms, D2H {med['d2h']:.1f} ms ({smi_line})")

    # (b) train refreal through the CLI, the loader timed inside it.
    out_dir = os.path.join(work_dir, "refreal_run")
    wpath = random_lpips_weights(np, os.path.join(work_dir, "lpips_random.npz"))
    os.environ[lpips_mod.DEFAULT_WEIGHTS_ENV] = wpath
    print(f"  LPIPS weights: {wpath}, RANDOM (He-normal VGG16, uniform heads): no pretrained VGG16 ships with "
          "the repository")
    loader = {"decode": [], "resize": []}
    real_read, real_resize = readers.read_image, readers.resample.resize

    def timed(key, fn):
        def wrapper(*a, **kw):
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            loader[key].append(time.perf_counter() - t1)
            return out
        return wrapper

    argv = ["-s", scene_dir, "-m", out_dir, "--preset", "refreal", "-r", "4", "--schedule_scale", "0.01",
            "--iterations", str(REAL_ITERS), "--ref_score_path", "auto", "--mesh_every", "1000",
            "--capacity", str(REAL_CAPACITY), "--save_iterations", str(REAL_DEFERRED_FROM), str(REAL_ITERS),
            "--log_every", "1"]
    print("  python scripts/train_torch.py " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0  # counts of this path's run only
    readers.read_image, readers.resample.resize = timed("decode", real_read), timed("resize", real_resize)
    from materialrefgs_torch.train.trainer import Trainer

    mesh_res = Trainer.MESH_RESOLUTION
    Trainer.MESH_RESOLUTION = REAL_MESH_RES
    t0 = time.perf_counter()
    try:
        res = train_torch.main(argv)
    finally:
        readers.read_image, readers.resample.resize = real_read, real_resize
        Trainer.MESH_RESOLUTION = mesh_res
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tr = res["trainer"]
    log = tr.metrics_log
    H, W = tr.images[0].shape[:2]
    print(f"  {len(log)} steps in {run_s:.1f} s at {W}x{H}; peak device memory {peak:.2f} GiB; kernel launches "
          f"{launches}")
    dec, rsz = float(np.median(loader["decode"])), float(np.median(loader["resize"]))
    print(f"  loader per photo ({len(loader['decode'])} decoded, {len(loader['resize'])} resized): JPEG decode "
          f"{1e3 * dec:.0f} ms (entropy on the host, the kernel on the card, both copies), LANCZOS /4 to {W}x{H} "
          f"{1e3 * rsz:.0f} ms (medians): {dec + rsz:.3f} s a photo")
    check((W, H) == (REAL_W // 4, REAL_H // 4), f"trained at {W}x{H}")
    check([m["iteration"] for m in log] == list(range(1, REAL_ITERS + 1)), "refreal skipped iterations")
    opt = tr.opt
    stages = [m["stage"] for m in log]
    check(stages == ["initial"] * opt.init_until_iter + ["surfel"] * (opt.indirect_from_iter - opt.init_until_iter)
          + ["surfel2"] * (REAL_ITERS - opt.indirect_from_iter), "refreal stages out of order")
    keys = ("loss_dist", "loss_warp_geo", "loss_warp_ncc", "loss_warp_bc", "loss_ref_score", "perceptual_loss")
    for m in log:
        if m["iteration"] in (1, 30, 31, 70, 71, 100, 101, 125, 126, 160, 161, 170) or m["renders_redone"] > 0:
            print(f"    it {m['iteration']:3d} {m['stage']:8s} loss {m['loss']:.5f} psnr {m['psnr']:.3f} n_alive "
                  f"{m['n_alive']} env_n_alive {m.get('env_n_alive', 0)} redone {m['renders_redone']:.0f} "
                  + " ".join(f"{k[5:] if k.startswith('loss_') else k} {m.get(k, float('nan')):.3e}" for k in keys))
    check(all(math.isfinite(v) for m in log for v in m.values() if isinstance(v, float)), "a non-finite loss term")
    for k in keys:
        check(any(m.get(k, 0.0) != 0.0 for m in log), f"{k} was zero on every step")
    check(all(m["overflow"] == 0 and m.get("nearest_overflow", 0) == 0 and m.get("tracer_overflow", 0) == 0
              and m.get("mesh_cull_dropped", 0) == 0 for m in log), "a refreal step was applied truncated")
    check(all(n > 0 for n in launches.values()), "a kernel of the refreal path never launched")
    # The sampler: per warp step as warp_launches_per_step counts, plus the
    # mining's gathers (no backward).
    n_warp = sum(m["warp_on"] for m in log)
    ws_step = warp_launches_per_step(opt)
    check(launches["warp_sample_bwd"] == ws_step[1] * n_warp and launches["warp_sample_fwd"] >= ws_step[0] * n_warp,
          f"the warp sampler launched {launches['warp_sample_fwd']} gathers and {launches['warp_sample_bwd']} splats "
          f"in {n_warp} warp steps, expected {ws_step} a step (more gathers with the mining)")
    for name, prm in list(tr.state.params().items()) + [("env." + k, v) for k, v in tr.state.env_params().items()]:
        check(bool(torch.isfinite(prm).all()), f"non-finite parameter {name} after the refreal run")
    with open(os.path.join(out_dir, "cfg_args.json")) as f:
        dumped = json.load(f)
    check("lpips_disabled" not in dumped["extra"] and dumped["model"]["resolution"] == 4,
          "cfg_args.json records lpips_disabled or another resolution")
    # Learning. A step's PSNR is of one view, and the compressed curriculum
    # resets opacities every 30 iterations; iteration 1 renders the initial
    # stage's SH colours of points coloured from the photos, over a black
    # background that most pixels show. So the check serves every train
    # view (render_set, no maps written) from the PLY of the first
    # deferred-shading step (random materials) and from the final state.
    ps = {m["iteration"]: m["psnr"] for m in log}
    served = {}
    with torch.no_grad():
        for when in (REAL_DEFERRED_FROM, REAL_ITERS):
            if when == REAL_ITERS:
                m_, e1, env_m, mesh_ = tr.state.model, tr.state.env1, tr.state.env_gs, tr.mesh
            else:
                m_, e1, _ = gaussian_io.load_ply(os.path.join(out_dir, "point_cloud", f"iteration_{when}",
                                                              "point_cloud.ply"), device=dev)
                env_m = mesh_ = None
            mips_ = EnvLightMips.build(e1, min_roughness=mp.envmap_min_roughness, max_roughness=mp.envmap_max_roughness)
            served[when] = render_set("", "train", tr.cameras, tr.images, m_, mips_, env_m,
                                      RenderOptions(raster=tr.raster_cfg), tracer_cfg=tr.tracer_cfg,
                                      dump_maps=False, bg_color=(0.0, 0.0, 0.0), mesh=mesh_)["psnr"]
    print(f"  train PSNR: per step at 1 {ps[1]:.3f} dB (initial stage), at {REAL_ITERS} {ps[REAL_ITERS]:.3f} dB; over "
          f"all {len(tr.cameras)} train views served: at {REAL_DEFERRED_FROM} (render_surfel) "
          f"{served[REAL_DEFERRED_FROM]:.3f} dB, at {REAL_ITERS} (render_surfel2, mesh) {served[REAL_ITERS]:.3f} dB "
          f"(+{served[REAL_ITERS] - served[REAL_DEFERRED_FROM]:.3f})")
    check(served[REAL_ITERS] > served[REAL_DEFERRED_FROM] + REAL_PSNR_GAIN,
          f"training from {REAL_DEFERRED_FROM} did not raise the served train PSNR by {REAL_PSNR_GAIN} dB")
    walls = {m["iteration"]: m["wall"] for m in log}
    redo = {m["iteration"] for m in log if m["renders_redone"] > 0}
    extra_work = {opt.ref_score_start_iter + 1, opt.indirect_from_iter + 1}  # mining, the onset
    stretch = {}
    for name, lo, hi in (("initial", 2, opt.init_until_iter),
                         ("surfel, before the warp", opt.init_until_iter + 2, opt.multi_view_weight_from_iter),
                         ("surfel, with the warp", opt.multi_view_weight_from_iter + 2, opt.indirect_from_iter),
                         ("surfel2, before LPIPS", opt.indirect_from_iter + 2, opt.perceptual_loss_start_iter),
                         ("surfel2, with LPIPS", opt.perceptual_loss_start_iter + 2, REAL_ITERS)):
        w = sorted(walls[i] - walls[i - 1] for i in range(lo, hi + 1) if i not in redo | extra_work)
        stretch[name] = w[len(w) // 2] if w else float("nan")
        print(f"  host s/step, {name} (iterations {lo}-{hi}, median of {len(w)} without a redo): "
              f"{stretch[name]:.4f}")
    mine_s, coverage = tr.ref_score_log[0]
    mesh_it, mesh_tris, mesh_s = tr.mesh_log[0]
    print(f"  mine_ref_scores at {W}x{H}: {mine_s:.2f} s for {len(tr.cameras)} views (masks cover "
          f"{100 * coverage:.2f} %); unbounded TSDF at {mesh_it}: {mesh_tris} triangles in {mesh_s:.1f} s; renders "
          f"redone {sum(m['renders_redone'] for m in log)}; n_alive {log[-1]['n_alive']}, env_n_alive "
          f"{log[-1]['env_n_alive']}")

    # The LPIPS network at this size (CUDA events): forward, and forward with
    # the backward to the rendered image.
    wts = tr.lpips_weights
    gt = tr.images[0]
    x = torch.clamp(gt + 0.05 * torch.randn(gt.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(0)),
                    0, 1).requires_grad_(True)
    with torch.no_grad():
        for _ in range(2):
            lpips_mod.lpips(x, gt, wts)
        f_ms = cuda_ms(torch, lambda: lpips_mod.lpips(x, gt, wts), 5)

    def fwd_bwd():
        torch.autograd.grad(lpips_mod.lpips(x, gt, wts), x)

    fwd_bwd()
    fb_ms = cuda_ms(torch, fwd_bwd, 5)
    lp_flops = lpips_flops(H, W)
    print(f"  LPIPS at {W}x{H} (random weights, float32, TF32 off): forward {f_ms:.2f} ms, forward + backward to the "
          f"image {fb_ms:.2f} ms; {lp_flops / 1e12:.3f} TFLOP per VGG16 pass -> {lp_flops / PEAK_FP32_FLOPS * 1e3:.2f} "
          f"ms at the FP32 peak; a step runs 2 passes forward and 1 backward (~{3 * lp_flops / 1e12:.2f} TFLOP)")

    # One profiled surfel2 step with LPIPS on, then (c): the kernels at the
    # inputs of the step after it.
    it = REAL_ITERS + 1
    tr._run_step(it, "surfel2")  # warm-up; raises a budget through its redo if it must
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t1 = time.perf_counter()
        met = tr._run_step(it + 1, "surfel2")
        float(met["loss"])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    ev_ = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev_) / 1e3
    check("perceptual_loss" in met, "the profiled step ran without LPIPS")
    print(f"  profiled surfel2 step {it + 1} (LPIPS on, warp on {met['warp_on']}, {int(met['tracer_pairs'])} env-trace "
          f"pairs, renders redone {met['renders_redone']}): {prof_ms:.1f} ms with {busy:.1f} ms of device kernels "
          f"-> device busy {100 * busy / prof_ms:.1f} %")
    print("  top device kernels (ms per step, launches per step):")
    for e in sorted(ev_, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f}  {e.count:5d}  {e.key[:90]}")
    del prof, ev_

    tcap = []
    real_tbwd = tracer_api.trace_bundles_bwd

    def capturing_bwd(payload, rays, seg_start, seg_count, seg_active, fwd_out, cot, **kw):
        used = payload[:, : int(seg_start[-1]) + 128].clone()
        tcap.append(((used, rays.clone(), seg_start.clone(), seg_count.clone(), seg_active.clone(), fwd_out.clone(),
                      cot.clone()), dict(kw)))
        return real_tbwd(payload, rays, seg_start, seg_count, seg_active, fwd_out, cot, **kw)

    wcap = []
    tracer_api.trace_bundles_bwd = capturing_bwd
    try:
        rcap = capture_raster(torch, api, lambda: wcap.extend(capture_warp(torch, lambda: tr._run_step(it + 2,
                                                                                                        "surfel2"))))
    finally:
        tracer_api.trace_bundles_bwd = real_tbwd
    check(len(tcap) == 1 and len(rcap) >= 1, f"the captured step launched the tracer backward {len(tcap)} times")
    check(len(wcap) == ws_step[1] and any(c[4] for c in wcap),
          f"the captured step made {len(wcap)} warp-sampler backward calls, not {ws_step[1]} with a coordinate gradient")
    # The view's own render (S = 10) where the warp's geometry-only render of
    # its neighbour is captured beside it.
    main_cap = max(rcap, key=lambda c: c[1]["S"])
    raster = raster_at(np, torch, f"refreal surfel2 step {it + 2}, {W}x{H}", main_cap)
    del rcap, main_cap
    trace = tracer_at(np, torch, tcap[0], f"refreal surfel2 step {it + 2}, {W}x{H}")
    del tcap
    warp = warp_sample_at(np, torch, wcap, f"refreal surfel2 step {it + 2}, {W}x{H}")
    del wcap

    # (d) serve the test views through the eval CLI.
    for fn in kernels:
        fn.launches = 0
    ev = eval_torch.main(["-m", out_dir, "-s", scene_dir, "--skip_train"])["test"]
    serve_launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"  eval of the refreal checkpoint at {W}x{H}: {len(ev['per_view_psnr'])} test views, psnr {ev['psnr']:.3f} "
          f"dB, ssim {ev['ssim']:.5f}, lpips (random weights) {ev['lpips']:.4f}, {ev['fps']:.2f} views/s, tracer "
          f"overflow {ev['tracer_overflow']}, renders redone {ev['tracer_redos']}; kernel launches {serve_launches}")
    check(len(ev["per_view_psnr"]) == REAL_VIEWS - len(tr.cameras) and math.isfinite(ev["psnr"])
          and ev["tracer_overflow"] == 0 and ev["overflow"] == 0, "the refreal eval failed")
    check(serve_launches["trace_bundles_fwd"] > 0, "the refreal eval did not trace the env-GS model")
    print(f"refreal path (phase 16, {smi_line}): s/step {', '.join(f'{k} {v:.4f}' for k, v in stretch.items())}; "
          f"LPIPS fwd {f_ms:.2f} ms, fwd+bwd {fb_ms:.2f} ms; busy {100 * busy / prof_ms:.1f} %; peak {peak:.2f} GiB; "
          f"mining {mine_s:.2f} s; TSDF {mesh_s:.1f} s; serve {ev['fps']:.2f} views/s")
    return dict(launches=launches, raster=raster, trace=trace, warp=warp, jpeg=jpeg_nums, sparse=sparse,
                loader_s=dec + rsz, decode_ms=med)


def sky_latlong(np, H, W, seed=0):
    """An HDR sky in linear radiance: a gradient from the horizon up, a sun
    of radiance 40 (past the 255 clip of no channel, but far past sRGB 1),
    cloud noise, and a dark ground band of equal pixels (runs for the
    run-length encoder)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W], np.float32)[:, None, None]
    rgb = np.stack([0.35 + 0.9 * yy, 0.45 + 0.7 * yy, 1.2 - 0.4 * yy], -1)
    rgb = rgb * np.exp(rng.normal(size=(H, W, 1)) * 0.15)
    rgb = np.where((((xx - 0.3) ** 2 + (yy - 0.22) ** 2) < 4e-4)[..., None], 40.0, rgb)
    rgb[int(0.62 * H):] = [0.04, 0.035, 0.03]
    return rgb.astype(np.float32)


def mesh_shading_phase(np, torch, dev, smi_line, ctx):
    """Phase 17: the raytracing_residual and ASG flavors and the material
    outputs at full width. ctx: train_scene, tscene (phase 7's scene),
    start_dir (a point_cloud/iteration_N directory of that scene's model),
    serve_model, serve_scene (phase 4's run and scene), work_dir,
    train_torch, eval_torch. Returns the rasterizer launches of (a) and (b) and the
    numbers it printed."""
    from materialrefgs_torch import config as cfg
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models.env_light import EnvLightMips
    from materialrefgs_torch.ops import mesh_tracer as mtr
    from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd
    from materialrefgs_torch.render.renderers import RenderOptions, mesh_indirect_maps, render_surfel
    from materialrefgs_torch.render.shading import camera_rays_world
    from materialrefgs_torch.train.mesh_material import make_vertex_albedo_step, read_material_mesh_ply
    from materialrefgs_torch.utils import hdr, png
    from materialrefgs_torch.utils.transforms import normalize

    fns = (tiles_fwd.rasterize_tiles_fwd, tiles_bwd.rasterize_tiles_bwd, trace_fwd.trace_bundles_fwd,
           trace_bwd.trace_bundles_bwd)
    tscene, eval_torch = ctx["tscene"], ctx["eval_torch"]
    cams = tscene.train_cameras
    mp = cfg.preset_refnerf()[0]
    white = torch.ones(3, device=dev)
    t_phase = time.perf_counter()
    out = {}

    def run(argv):
        print("  python scripts/train_torch.py " + " ".join(argv))
        for fn in fns:
            fn.launches = 0  # counts of this path's run only
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = ctx["train_torch"].main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in fns}
        log = res["trainer"].metrics_log
        walls = sorted(b["wall"] - a["wall"] for a, b in zip(log, log[1:]))
        return res, launches, seconds, walls[len(walls) // 2], torch.cuda.max_memory_allocated() / 2**30

    def argv(run_dir, start_iter, n, *flags):
        # Phase 12's flags: the main model neither densifies, prunes nor
        # resets past the start (--densify_until_iter), no re-extraction.
        return ["-s", ctx["train_scene"], "-m", run_dir, "--schedule_scale", "0.01", "--start_ply",
                ctx["start_dir"], "--start_iter", str(start_iter), "--iterations", str(start_iter + n),
                "--capacity", str(1 << 19), "--pair_capacity", str(1 << 20), "--densify_until_iter",
                str(start_iter), "--mesh_every", "1000", "--log_every", "1", *flags]

    # (a) raytracing_residual through the train CLI, from the start PLY at
    # the surfel2 onset (indirect_from_iter x 0.01).
    a_run = os.path.join(ctx["work_dir"], "residual_run")
    a_end = S2_START + RES_STEPS
    print(f"  (a) raytracing_residual: {RES_STEPS} surfel2 steps ({S2_START + 1}-{a_end}) from "
          f"{os.path.relpath(ctx['start_dir'], ctx['work_dir'])}, mesh extracted at the onset (no re-extraction), "
          "the main model's densify and resets off past the onset (phase 12's cut)")
    a_res, a_launches, a_s, a_step, a_peak = run(argv(
        a_run, S2_START, RES_STEPS, "--indirect_type", "raytracing_residual",
        "--checkpoint_iterations", str(a_end), "--test_iterations", str(a_end)))
    tr = a_res["trainer"]
    a_log = tr.metrics_log
    onset_it, n_full, onset_s = tr.mesh_log[0]
    n_traced = int(tr.mesh.valid.sum())
    redone = sum(m["renders_redone"] for m in a_log)
    whole = sum(m["overflow"] == 0 and m["mesh_cull_dropped"] == 0 for m in a_log)
    a_test = a_res["test"][a_end]
    for m in a_log:
        print(f"    it {m['iteration']:3d} {m['stage']:8s} loss {m['loss']:.5f} psnr {m['psnr']:.3f} n_alive "
              f"{m['n_alive']} mesh cull dropped {m['mesh_cull_dropped']:.0f} renders redone {m['renders_redone']:.0f}")
    check([m["iteration"] for m in a_log] == list(range(S2_START + 1, a_end + 1)), "(a) skipped iterations")
    check(all(m["stage"] == "surfel2" for m in a_log), "(a): a step is not surfel2")
    check(tr.state.env_gs is None, "(a): the residual flavor spawned an env-GS model")
    check(cfg.load_config(a_run)[1].indirect_type == "raytracing_residual", "(a): cfg_args.json lost the flavor")
    check(not os.path.exists(os.path.join(os.path.dirname(a_res["ply"]), "env_point_cloud.ply")),
          "(a): an env PLY was saved")
    check(os.path.exists(os.path.join(a_run, f"chkpnt{a_end}.pt")), "(a): no checkpoint saved")
    check(math.isfinite(a_test["psnr"]) and a_test["overflow"] == 0, "(a): the test render failed")
    check(all(math.isfinite(m["loss"]) for m in a_log), "(a): non-finite loss")
    check(a_launches["rasterize_tiles_bwd"] == RES_STEPS and a_launches["rasterize_tiles_fwd"] >= RES_STEPS,
          f"(a): rasterizer launches {a_launches} for {RES_STEPS} steps")
    check(a_launches["trace_bundles_fwd"] == 0 == a_launches["trace_bundles_bwd"],
          "(a): the residual flavor launched the env-GS tracer")
    check(whole == RES_STEPS, "(a): a step was applied truncated")
    for name, prm in tr.state.params().items():
        check(bool(torch.isfinite(prm).all()), f"(a): non-finite parameter {name}")
    # One more step under torch.profiler, pinned to view 0, with the mesh
    # tracer (mesh_indirect_maps) inside a record_function range: the busy
    # share, and the rasterizer kernels' and the tracer's device time in the
    # step.
    from materialrefgs_torch.render import renderers as rmod

    it_p = a_end + 1
    traced_fn = rmod.mesh_indirect_maps

    def ranged(*args, **kw):
        with torch.profiler.record_function("mesh_indirect_maps"):
            return traced_fn(*args, **kw)

    tr._pick_view = lambda: 0
    rmod.mesh_indirect_maps = ranged
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            met = tr._run_step(it_p, "surfel2")
            float(met["loss"])
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        rmod.mesh_indirect_maps = traced_fn
        del tr._pick_view
    cuda_t = torch.autograd.DeviceType.CUDA
    ka = prof.key_averages()
    # The range may also show as a device-side annotation: not a kernel.
    ev_ = [e for e in ka if e.device_type == cuda_t and e.key != "mesh_indirect_maps"]
    busy = sum(e.self_device_time_total for e in ev_) / 1e3
    raster_ms = {k: sum(e.self_device_time_total for e in ev_ if k in e.key) / 1e3
                 for k in ("rasterize_fwd_kernel", "rasterize_bwd_kernel")}
    # The kernels launched inside the range (the host-side event's children);
    # the device-side annotation's span is printed beside it.
    step_mesh_ms = sum(e.device_time_total for e in ka
                       if e.key == "mesh_indirect_maps" and e.device_type != cuda_t) / 1e3
    span_ms = sum(e.self_device_time_total for e in ka
                  if e.key == "mesh_indirect_maps" and e.device_type == cuda_t) / 1e3
    if step_mesh_ms == 0:
        print("  [info] no kernels attributed to the mesh tracer's range: its device-side span stands in")
        step_mesh_ms = span_ms
    check(step_mesh_ms > 0, "(a): no device time under the mesh tracer's range in the profiled step")
    # The mesh tracer alone, no_grad, on the same view.
    rmips = tr._build_mips(tr.state.env1)
    with torch.no_grad():
        pkg = render_surfel(tr.state.model, cams[0], white, rmips, RenderOptions(raster=tr.raster_cfg), mesh=tr.mesh,
                            mesh_cull_cap=tr.tracer_cfg.mesh_cull_cap)
        alpha = pkg["rend_alpha"]
        nmap = pkg["rend_normal"] / torch.clamp(alpha, min=1e-6)
        mi_args = (tr.mesh, cams[0], nmap, pkg["surf_depth"], rmips, alpha)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as mprof:
            maps = mesh_indirect_maps(*mi_args, cull_cap=tr.tracer_cfg.mesh_cull_cap)
            torch.cuda.synchronize()
    mesh_ms = sum(e.self_device_time_total for e in mprof.key_averages() if e.device_type == cuda_t) / 1e3
    hit = (pkg["visibility"][..., 0] < 1) & (alpha[..., 0] > 0)
    n_hit = int(hit.sum())
    ind_hit = float(pkg["indirect_light"][hit].abs().mean()) if n_hit else 0.0
    check(n_hit > 0 and ind_hit > 0, f"(a): no indirect light at the {n_hit} occluded pixels of view 0")
    check(torch.equal(maps["visibility"], pkg["visibility"]), "(a): mesh_indirect_maps differs from the render's")
    print(f"  (a) {len(a_log)} steps, the checkpoint and {len(a_test['per_view_psnr'])} test views in {a_s:.1f} s: "
          f"host {a_step:.4f} s/step (median, synchronised); profiled step {it_p} (view 0): {prof_ms:.1f} ms, "
          f"{busy:.1f} ms of device kernels -> busy {100 * busy / prof_ms:.1f} %, of which the mesh tracer "
          f"(mesh_indirect_maps range) {step_mesh_ms:.1f} ms ({100 * step_mesh_ms / max(busy, 1e-9):.1f} %; the "
          f"range's device-side span {span_ms:.1f} ms), rasterizer "
          f"forward {raster_ms['rasterize_fwd_kernel']:.3f} ms, backward {raster_ms['rasterize_bwd_kernel']:.3f} ms; "
          f"mesh tracer alone (no_grad, view 0) {mesh_ms:.1f} ms of device kernels; peak {a_peak:.2f} GiB; onset "
          f"TSDF at {onset_it} {onset_s:.1f} s, {n_full} triangles -> {n_traced} traced; renders redone {redone} "
          f"(mesh_cull_cap now {tr.tracer_cfg.mesh_cull_cap}); steps applied untruncated {whole}/{len(a_log)}; "
          f"test psnr {a_test['psnr']:.3f} dB; view 0: {n_hit} occluded pixels, mean |indirect| {ind_hit:.4f}; "
          f"launches {a_launches} ({smi_line})")
    print("  top device kernels of the profiled step (ms, launches):")
    for e in sorted(ev_, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f}  {e.count:5d}  {e.key[:90]}")
    ply_a = a_res["ply"]
    out.update(a_step=a_step, a_busy=100 * busy / prof_ms, a_mesh_ms=mesh_ms, a_step_mesh_ms=step_mesh_ms,
               a_device_ms=busy, a_raster_ms=raster_ms, a_peak=a_peak, onset_s=onset_s, tris=(n_full, n_traced),
               a_launches=a_launches)

    # (b) ASG lobes through the train CLI: `surfel` steps from the same PLY
    # (no densify, prune or reset: the reset at 60 and the 20-pixel prune,
    # phase 15 (b)'s cut).
    b_res, b_launches, b_s, b_step, _ = run(argv(os.path.join(ctx["work_dir"], "asg_run"), S2_FROM, ASG_STEPS,
                                                 "--use_asg"))
    btr = b_res["trainer"]
    b_log = btr.metrics_log
    check([m["stage"] for m in b_log] == ["surfel"] * ASG_STEPS, "(b): the steps are not `surfel`")
    check(all(math.isfinite(m["loss"]) for m in b_log), "(b): non-finite loss")
    check(b_launches["rasterize_tiles_bwd"] == ASG_STEPS, f"(b): rasterizer launches {b_launches}")
    asg = btr.state.model.indirect_asg
    check(bool(torch.isfinite(asg).all()), "(b): non-finite ASG lobes")
    # In both packages' Trainer the rasterized indirect map reaches no loss
    # term: the lobes' gradient there is zero.
    trainer_g = float(btr.state.adam.mu["indirect_asg"].abs().max())
    # Through the rasterizer's backward kernel, the indirect map moves them.
    bmips = EnvLightMips.build(btr.state.env1, min_roughness=mp.envmap_min_roughness,
                               max_roughness=mp.envmap_max_roughness)
    g_pkg = render_surfel(btr.state.model, cams[0], white, bmips, RenderOptions(use_asg=True, raster=btr.raster_cfg))
    loss = torch.mean(torch.abs(g_pkg["indirect_map"] - btr.images[0]))
    (g_asg,) = torch.autograd.grad(loss, [btr.state.model.indirect_asg])
    map_g = float(g_asg.abs().max())
    check(bool(torch.isfinite(g_asg).all()) and map_g > 0,
          "(b): the ASG lobes' gradient through the rasterized indirect map is zero or non-finite")
    print(f"  (b) use_asg: {ASG_STEPS} surfel steps ({S2_FROM + 1}-{S2_FROM + ASG_STEPS}) in {b_s:.1f} s, host "
          f"{b_step:.4f} s/step (median); max |d loss / d indirect_asg| in the Trainer's steps {trainer_g:.3e} "
          f"(the indirect map is not shaded there, as in the JAX Trainer), through the rasterized indirect map "
          f"(view 0) {map_g:.3e}, finite; launches {b_launches} ({smi_line})")
    out.update(b_step=b_step, asg_grad=(trainer_g, map_g), b_launches=b_launches)
    del btr, b_res, g_asg, g_pkg

    # (c) Relight phase 4's model under an HDR sky (flat and run-length rows).
    sky_path = os.path.join(ctx["work_dir"], "sky.hdr")
    rgbe = hdr.float_to_rgbe(sky_latlong(np, SKY_H, SKY_W))
    rgbe[rgbe[:, 0, 0] == 2, 0, 0] = 3  # no flat row may start like a run-length header
    hdr.write_hdr_rgbe(sky_path, rgbe, rle=np.arange(SKY_H) < SKY_H // 2)
    decoded = hdr.read_hdr(sky_path)
    check(np.array_equal(hdr.read_hdr_rgbe(sky_path), rgbe) and np.array_equal(decoded, hdr.rgbe_to_float(rgbe)),
          "(c): the RGBE decode differs from what was written")
    rdir = os.path.join(ctx["serve_model"], f"eval_{ITERATION}", "test", "renders")
    trained = [png.read_png(os.path.join(rdir, f"{i:05d}.png")).astype(np.float32) for i in range(N_VIEWS)]
    for fn in fns:
        fn.launches = 0
    rel = eval_torch.main(["-m", ctx["serve_model"], "-s", ctx["serve_scene"], "--skip_train",
                           "--relight", sky_path])["test"]
    relit = [png.read_png(os.path.join(rdir, f"{i:05d}.png")).astype(np.float32) for i in range(N_VIEWS)]
    diff = float(np.mean([np.abs(a - b).mean() for a, b in zip(relit, trained)])) / 255
    check(tiles_fwd.rasterize_tiles_fwd.launches == N_VIEWS, "(c): the relit serve did not launch once a view")
    check(rel["overflow"] == 0, "(c): a relit view overflowed")
    check(math.isfinite(rel["psnr"]) and diff > 1e-3, f"(c): the relit renders differ by {diff:.4f} only")
    print(f"  (c) --relight {SKY_W}x{SKY_H} RGBE sky ({SKY_H // 2} run-length rows, {SKY_H - SKY_H // 2} flat; "
          f"{os.path.getsize(sky_path)} bytes; decode equals the written values): {rel['fps']:.2f} views/s over "
          f"{N_VIEWS} views; mean |relit - trained-env render| {diff:.4f} (of 1); psnr against the trained-env "
          f"ground truth {rel['psnr']:.3f} dB ({smi_line})")
    out.update(relight_fps=rel["fps"], relight_diff=diff)

    # (d) The material mesh of (a)'s run.
    t0 = time.perf_counter()
    res = eval_torch.main(["-m", a_run, "-s", ctx["train_scene"], "--skip_train", "--skip_test",
                           "--export_material_mesh"])
    d_s = time.perf_counter() - t0
    mv, mf, ma = read_material_mesh_ply(res["material_mesh"])
    from materialrefgs_torch.train.mesh_extract import read_mesh_ply

    plys = sorted(os.listdir(os.path.join(a_run, "meshes")))
    fv, ff = read_mesh_ply(os.path.join(a_run, "meshes", plys[-1]))
    t0 = time.perf_counter()
    attrs = mtr.bake_vertex_attrs(tr.state.model, fv)
    bake_s = time.perf_counter() - t0
    check(np.array_equal(mv, fv) and np.array_equal(mf, ff), "(d): the material mesh's geometry differs")
    # What the CLI baked, from the model as the saved PLY holds it.
    check(set(ma) == set(attrs), f"(d): the material mesh holds {sorted(ma)}")
    for k, v in mtr.bake_vertex_attrs(gaussian_io.load_ply(ply_a, device=dev)[0], fv).items():
        check(np.allclose(ma[k], v, rtol=0, atol=1e-6), f"(d): {k} did not read back")
    print(f"  (d) --export_material_mesh on (a)'s run: {d_s:.2f} s for the CLI, bake_vertex_attrs {bake_s:.2f} s "
          f"({len(fv)} vertices, {len(ff)} triangles, k=4 nearest of {int(tr.state.model.n_alive)} splats); "
          f"read back equal ({smi_line})")
    out.update(bake_s=bake_s, n_verts=len(fv))

    # (e) Vertex-albedo refinement on (a)'s traced mesh with baked materials,
    # at view 0's 640k surface samples.
    tv = tr.mesh.vertices.cpu().numpy()
    tf = tr.mesh.triangles[tr.mesh.valid].cpu().numpy()
    emesh = mtr.build_mesh(tv, tf, mtr.bake_vertex_attrs(tr.state.model, tv), device=dev)
    rays_d, rays_o = camera_rays_world(cams[0], unnormalized=True)
    pos = (rays_o[None, None] + pkg["surf_depth"][..., None] * rays_d).reshape(-1, 3)
    n_s = nmap.reshape(-1, 3)
    v_s = (-normalize(rays_d)).reshape(-1, 3)
    target = tr.images[0].reshape(-1, 3)
    state, step = make_vertex_albedo_step(emesh, rmips, lr=1e-2)
    e_ms, e_loss = [], []
    for _ in range(ALBEDO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, lv = step(state, pos, n_s, v_s, target)
        e_loss.append(float(lv))
        torch.cuda.synchronize()
        e_ms.append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        albedo = torch.sigmoid(state[0])
        m_ = emesh.attrs["metallic"]
        after = mtr.shade_one_bounce(dataclasses.replace(emesh, attrs=dict(emesh.attrs, albedo=albedo,
                                                                             diffuse=(1 - m_) * albedo)),
                                     rmips, pos, n_s, v_s)["indirect"]
        loss_after = float(torch.mean(torch.abs(after - target)))
    check(all(math.isfinite(x) for x in e_loss + [loss_after]), "(e): non-finite loss")
    check(loss_after < e_loss[0], "(e): the refinement did not lower the loss")
    print(f"  (e) make_vertex_albedo_step, {ALBEDO_STEPS} steps on {pos.shape[0]} samples of view 0 against "
          f"{len(tf)} triangles ({len(tv)} vertices): ms per step {[round(x, 1) for x in e_ms]} (host, "
          f"synchronised); loss {e_loss[0]:.5f} -> {loss_after:.5f} ({smi_line})")
    out.update(e_ms=e_ms, e_loss=(e_loss[0], loss_after))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 17 took {out['seconds']:.1f} s")
    return out


def jpeg_phase(np, torch, dev, smi_line, work_dir, sparse):
    """Phase 18, the decoder: (a) chip_smoke_jpeg's files in every sampling
    mode at odd sizes, with and without a restart interval, the kernel
    against its plain version (every byte); (b) one textured full-size
    photo (band-limited noise at quality JPEG_TEX_QUALITY: the bit rate of a
    real capture, which phase 16's renders over black are not), its decode
    in parts, the kernel's time and bound; (c) the native COLMAP parse
    against the pure one on phase 16's sparse model."""
    import chip_smoke_jpeg
    from materialrefgs_torch.data import colmap_loader as cl
    from materialrefgs_torch.data import native_io
    from materialrefgs_torch.utils import jpeg

    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    d = os.path.join(work_dir, "jpeg")
    os.makedirs(d, exist_ok=True)
    n_cases = 0
    modes = (("4:4:4", (1, 1), False), ("4:2:2", (2, 1), False), ("4:2:0", (2, 2), False), ("4:4:0", (1, 2), False),
             ("gray", None, False), ("RGB 4:4:4", (1, 1), True), ("RGB 4:2:0", (2, 2), True))
    for mode, sampling, rgb in modes:
        for H, W in ((1, 1), (23, 37), (331, 517)):
            for restart in (0, 7):
                img = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
                img = img[..., 0] if sampling is None else img
                path = os.path.join(d, "case.jpg")
                chip_smoke_jpeg.write_jpeg(path, img, quality=90, sampling=sampling or (1, 1),
                                           restart_interval=restart, rgb=rgb)
                co, coef, quant, out, host, _ = jpeg_split(torch, dev, path)
                check(co.color == (jpeg.GRAY if sampling is None else jpeg.RGB if rgb else jpeg.YCC),
                      f"JPEG {mode}: colour {co.color}")
                ref = jpeg.idct_color_plain(coef, quant, co.comps, co.height, co.width, co.color)
                err = int((out.int() - ref.int()).abs().max())
                check(err == 0 and tuple(host.shape) == img.shape,
                      f"JPEG kernel vs plain, {mode} {W}x{H} restart {restart}: max abs diff {err}")
                n_cases += 1
    print(f"  (a) {n_cases} files (4:4:4, 4:2:2, 4:2:0, 4:4:0, gray, RGB stored 4:4:4 and 4:2:0; 1x1, 37x23, 517x331; "
          "restart interval 0 and 7): "
          "the kernel equals its plain version on every byte (max abs diff 0)")

    # (b) band-limited noise: N(0, 1) at a sixth of the size, bicubic up.
    gen = torch.Generator(device=dev).manual_seed(18)
    lo = torch.randn((1, 3, REAL_H // 6, REAL_W // 6), device=dev, generator=gen)
    tex = torch.nn.functional.interpolate(lo, size=(REAL_H, REAL_W), mode="bicubic", align_corners=False)[0]
    img = torch.clamp(128 + 60 * tex, 0, 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
    path = os.path.join(d, "textured.jpg")
    t0 = time.perf_counter()
    size = chip_smoke_jpeg.write_jpeg(path, img, quality=JPEG_TEX_QUALITY, sampling=(2, 2))
    write_s = time.perf_counter() - t0
    co, coef, quant, out, host, t = jpeg_split(torch, dev, path)
    diff = float((host.int() - torch.from_numpy(img).int()).abs().float().mean())
    check(diff < 4.0, f"the textured photo decodes {diff:.2f} levels from its pixels on average")
    print(f"  (b) textured photo {REAL_W}x{REAL_H}, 4:2:0, quality {JPEG_TEX_QUALITY}: {size / 1e6:.2f} MB "
          f"({8 * size / (REAL_W * REAL_H):.2f} bits a pixel), written in {write_s:.1f} s; decode entropy "
          f"{t['entropy']:.1f} ms, H2D {t['h2d']:.1f} ms, kernel {t['kernel']:.2f} ms (one launch), D2H "
          f"{t['d2h']:.1f} ms; mean abs diff to the pixels {diff:.2f} ({smi_line})")
    tex_nums = jpeg_kernel_at(torch, co, coef, quant, out, "the textured photo")
    tex_nums.update(t)
    del co, coef, quant, out, host

    # (c) the native parse against the pure one.
    img_bin, pts_bin = os.path.join(sparse, "images.bin"), os.path.join(sparse, "points3D.bin")
    t0 = time.perf_counter()
    ids, qvec, tvec, camid, names = native_io.read_images(img_bin)
    xyz, rgb, err = native_io.read_points3d(pts_bin)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pure = cl.read_extrinsics_binary(img_bin)
    pxyz, prgb, perr = cl.read_points3D_binary(pts_bin)
    pure_ms = (time.perf_counter() - t0) * 1e3
    same = (list(ids) == list(pure) and all(np.array_equal(qvec[k], pure[int(i)].qvec)
                                           and np.array_equal(tvec[k], pure[int(i)].tvec)
                                           and names[k] == pure[int(i)].name and camid[k] == pure[int(i)].camera_id
                                           for k, i in enumerate(ids))
            and np.array_equal(xyz, pxyz) and np.array_equal(rgb, prgb) and np.array_equal(err, perr))
    check(same and len(xyz) == REAL_POINTS, "the native COLMAP parse differs from the pure parser")
    print(f"  (c) COLMAP parse of phase 16's model ({len(ids)} images, {len(xyz)} points): native {native_ms:.1f} ms, "
          f"pure {pure_ms:.1f} ms; equal arrays")
    print(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return dict(cases=n_cases, tex=tex_nums, native_ms=native_ms, pure_ms=pure_ms)


def synth_scene(np, path, n_train, n_test, res, seed=1, n_points=100_000):
    """A refnerf-layout scene from scripts/make_synth_scene.py's numpy ray
    tracer (its geometry, materials, light and golden-angle spiral of views)
    written with the port's PNG and PLY writers: that script's own main()
    needs Pillow, which the card machine lacks. One sample a pixel."""
    from materialrefgs_torch.utils import png
    from materialrefgs_torch.utils.ply import write_point_cloud_ply

    spec = importlib.util.spec_from_file_location("make_synth_scene", os.path.join(REPO, "scripts",
                                                                                   "make_synth_scene.py"))
    mss = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mss)
    target = np.array([0.0, 0.0, 0.35])
    golden = np.pi * (3 - np.sqrt(5))
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(path, split), exist_ok=True)
        frames = []
        for i in range(n):
            az = i * golden + (0.5 if split == "test" else 0.0)
            el = np.deg2rad(12 + 55 * ((i * 0.61803) % 1.0))
            eye = target + 3.3 * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
            c2w = mss.look_at_c2w(eye, target)
            rgb, alpha = mss.render_view(c2w, res, 0.8, 1, seed=i)
            im = np.concatenate([rgb, alpha[..., None]], axis=-1)
            png.write_png(os.path.join(path, split, f"r_{i}.png"), (im * 255).astype(np.uint8))
            frames.append({"file_path": f"{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(path, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    pts, cols = mss.sample_points(n_points, np.random.default_rng(seed))
    write_point_cloud_ply(os.path.join(path, "points3d.ply"), pts, cols)


def _dp_rank(rank, job_path):
    """One of phase 19 (b)'s two ranks on the one card over gloo: (b1) the
    data-parallel production step on its own view against the mean of the
    two single-view steps, (b2) rasterize_tile_sharded (25 tile rows each)
    against rasterize. Writes its numbers to {job_path}.{rank}.json."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from materialrefgs_torch import config as cfg
    from materialrefgs_torch.cameras import look_at_camera
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.ops.rasterize import api, tiles_bwd, tiles_fwd
    from materialrefgs_torch.parallel import tile_sharding
    from materialrefgs_torch.parallel.data_parallel import make_dp_production_step
    from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
    from materialrefgs_torch.train.trainer import init_train_state, make_train_step

    with open(job_path) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)  # both ranks share the one card
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=job["init"], world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    res = job["res"]
    out = {"backend": dist.get_backend(), "device": str(dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def cam_of(i):
        ang = 2 * math.pi * i / 2 + 0.4
        eye = np.array([3.2 * math.sin(ang), 0.3, -3.2 * math.cos(ang)])
        return look_at_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.8, 0.8, res, res, device=dev)

    # (b1) The DP production step against the two single-view steps.
    _, pipe, opt = cfg.preset_refnerf()

    def fresh_state():
        model, env1, _ = gaussian_io.load_ply(job["model_ply"], device=dev)
        st = init_train_state(model, envmap_res=env1.base.shape[1])
        st.env1.base.data.copy_(env1.base)
        return st

    cam = cam_of(rank)
    raster = api.RasterizeConfig(pair_capacity=job["pairs"])
    st = fresh_state()
    with torch.no_grad():
        pkg = render_surfel(st.model, cam, torch.zeros(3, device=dev), None, RenderOptions(raster=raster),
                            wo_render_img=True)
        gt = torch.clamp(0.1 + 0.8 * pkg["rend_alpha"].expand(-1, -1, 3), 0, 1)
    extra = {"iteration": 5000.0, "lambda_normal_render_depth": 0.05, "bg": torch.zeros(3, device=dev)}
    names = list(st.params())
    stats = ("xyz_gradient_accum", "denom", "max_radii2d")
    plain = make_train_step("surfel", opt, pipe, 3.0, raster)
    sync()
    t0 = time.perf_counter()
    plain(st, cam, gt, dict(extra))
    sync()
    out["plain_step_s"] = time.perf_counter() - t0
    # A fresh Adam's first moment is (1 - b1) g.
    single = {k: st.adam.mu[k] / 0.1 for k in names}
    single.update({k: getattr(st.model, k).clone() for k in stats})
    for k in names + ["xyz_gradient_accum", "denom"]:
        dist.all_reduce(single[k])  # the two views' sum (gloo, through the host)
    dist.all_reduce(single["max_radii2d"], op=dist.ReduceOp.MAX)
    del st
    st = fresh_state()
    step = make_dp_production_step(None, "surfel", opt, pipe, 3.0, raster)
    fwd0, bwd0 = tiles_fwd.rasterize_tiles_fwd.launches, tiles_bwd.rasterize_tiles_bwd.launches
    sync()
    t0 = time.perf_counter()
    m = step(st, cam, gt, dict(extra))
    sync()
    out["dp_step_s"] = time.perf_counter() - t0
    out["launches"] = [tiles_fwd.rasterize_tiles_fwd.launches - fwd0, tiles_bwd.rasterize_tiles_bwd.launches - bwd0]
    out["allreduce_bytes"], out["allreduce_ms"] = m["dp_allreduce_bytes"], m["dp_allreduce_ms"]
    worst = 0.0
    for k in names:
        g_dp, g_mean = st.adam.mu[k] / 0.1, single[k] / 2
        scale = max(float(g_mean.abs().max()), 1e-3)
        ratio = float((g_dp - g_mean).abs().max()) / (DP_GRAD_RTOL * scale + 1e-5)
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"rank {rank}: the DP step's gradient {k} is off the two views' mean ({ratio:.3f} x tol)")
    out["grad_err_over_tol"] = worst
    check(bool(torch.equal(st.model.denom, single["denom"])), "DP denom is not the sum of the two views'")
    check(bool(torch.equal(st.model.max_radii2d, single["max_radii2d"])), "DP max_radii2d is not the views' max")
    acc, acc_ref = st.model.xyz_gradient_accum, single["xyz_gradient_accum"]
    acc_ratio = float((acc - acc_ref).abs().max()) / (DP_GRAD_RTOL * max(float(acc_ref.abs().max()), 1e-3) + 1e-5)
    check(acc_ratio <= 1.0, f"rank {rank}: DP densification norms off the views' sum ({acc_ratio:.3f} x tol)")
    out["stats_err_over_tol"] = acc_ratio
    out["denom_seen_by_both"] = int((st.model.denom == 2).sum())
    del st, single

    # (b2) Tile-sharded rasterization of one view (two blocks of rows).
    rng = np.random.default_rng(7)
    params, _ = bench_scene(np, seed=3)
    P = len(params["xyz"])
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = [t(params["xyz"]), t(np.exp(params["scaling"])),
            t(params["rotation"] / np.linalg.norm(params["rotation"], axis=-1, keepdims=True)),
            t(1 / (1 + np.exp(-params["opacity"][:, 0]))), t(rng.uniform(size=(P, 3))),
            t(rng.uniform(size=(P, 9)))]
    args = [a.requires_grad_(True) for a in args]
    cam0 = cam_of(0)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)

    def loss_of(o):
        return torch.mean((o["render"] - 0.3) ** 2) + 0.01 * torch.mean(o["depth"])

    timings = {}
    for name, fn in (("full", lambda: api.rasterize(*args, cam0, bg, config=raster)),
                     ("sharded", lambda: tile_sharding.rasterize_tile_sharded(None, *args, cam0, bg, config=raster))):
        fn()  # warm
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        o = fn()
        g = torch.autograd.grad(loss_of(o), args)
        sync()
        timings[name] = (time.perf_counter() - t0, o, g)
    out["full_s"], out["sharded_s"] = timings["full"][0], timings["sharded"][0]
    (_, ref, gref), (_, sh, gsh) = timings["full"], timings["sharded"]
    fwd_err = 0.0
    for k in ("render", "feature", "normal", "depth", "alpha", "distortion"):
        err = float((sh[k] - ref[k]).detach().abs().max())
        fwd_err = max(fwd_err, err)
        check(bool(torch.all((sh[k] - ref[k]).detach().abs() <= 2e-4 + 1e-3 * ref[k].detach().abs())),
              f"rank {rank}: the tile-sharded {k} is off rasterize's ({err:.3e})")
    check(int(sh["overflow"]) == 0 and int(ref["overflow"]) == 0, "tile-sharded render overflowed")
    gworst = 0.0
    for name, a, b in zip(("means", "scales", "rotations", "opacities", "colors", "features"), gsh, gref):
        scale = max(float(b.abs().max()), 1e-3)
        ratio = float((a - b).abs().max()) / (DP_GRAD_RTOL * scale + 1e-5)
        gworst = max(gworst, ratio)
        check(ratio <= 1.0, f"rank {rank}: the tile-sharded gradient of {name} is off ({ratio:.3f} x tol)")
    out["tile_fwd_err"], out["tile_grad_err_over_tol"] = fwd_err, gworst
    with open(f"{job_path}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def dp_phase(np, torch, dev, smi_line, work_dir, train_torch, model_ply):
    """Phase 19 (see the module docstring). Returns the kernels' launches in
    (a)'s --dp 1 run and the rasterizer kernels' numbers at a block's grid."""
    from materialrefgs_torch.ops.rasterize import tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd
    from materialrefgs_torch.parallel import multihost

    fns = {"rasterize_tiles_fwd": tiles_fwd.rasterize_tiles_fwd, "rasterize_tiles_bwd": tiles_bwd.rasterize_tiles_bwd,
           "trace_bundles_fwd": trace_fwd.trace_bundles_fwd, "trace_bundles_bwd": trace_bwd.trace_bundles_bwd}
    # (a) --dp 1 over NCCL against the plain Trainer.
    scene = os.path.join(work_dir, "dp_scene")
    t0 = time.perf_counter()
    synth_scene(np, scene, DP_TRAIN, DP_TEST, DP_RES, n_points=DP_POINTS)
    print(f"  (a) scripts/make_synth_scene.py's scene: {DP_TRAIN} + {DP_TEST} views at {DP_RES}x{DP_RES} rendered "
          f"and written in {time.perf_counter() - t0:.1f} s")
    base = ["-s", scene, "--schedule_scale", "0.01", "--iterations", str(DP_ITERS), "--capacity", str(DP_CAPACITY),
            "--pair_capacity", str(1 << 20), "--log_every", "1", "--init_until_iter", "2",
            "--multi_view_weight_from_iter", "4", "--indirect_from_iter", "8", "--use_virtul_cam",
            "--no_mesh_visibility"]
    if dev.type == "cpu":
        base += ["--device", "cpu"]
    logs, launches = {}, {}
    for name, extra in (("dp1", ["--dp", "1"]), ("plain", [])):
        argv = base + ["-m", os.path.join(work_dir, f"dp_run_{name}")] + extra
        print("  python scripts/train_torch.py " + " ".join(argv))
        for fn in fns.values():
            fn.launches = 0  # counts of this path's run only
        t0 = time.perf_counter()
        res = train_torch.main(argv)
        logs[name] = res["trainer"].metrics_log
        launches[name] = {k: fn.launches for k, fn in fns.items()}
        print(f"    {len(logs[name])} steps in {time.perf_counter() - t0:.1f} s; launches {launches[name]}")
    dp_log, plain_log = logs["dp1"], logs["plain"]
    check([m["iteration"] for m in dp_log] == list(range(1, DP_ITERS + 1)), "--dp 1 skipped iterations")
    check([m["stage"] for m in dp_log] == ["initial"] * 2 + ["surfel"] * 6 + ["surfel2"] * 4,
          "--dp 1 stages are not 1-2 initial, 3-8 surfel, 9-12 surfel2")
    check(all(m["warp_on"] for m in dp_log[4:]), "the warp was off past its gate")
    for k, v in launches["dp1"].items():
        check(v > 0, f"{k} was not launched on the --dp 1 path")
    worst = 0.0
    for a, b in zip(dp_log, plain_log):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        worst = max(worst, rel)
        print(f"    it {a['iteration']:2d} {a['stage']:7s} loss --dp 1 {a['loss']:.6f} plain {b['loss']:.6f} "
              f"(rel {rel:.2e}); n_alive {a['n_alive']} / {b['n_alive']}; all_reduce "
              f"{a['dp_allreduce_bytes'] / 2**20:.1f} MiB in {a['dp_allreduce_ms']:.3f} ms")
        check(math.isfinite(a["loss"]), "non-finite loss under --dp 1")
    check(worst <= DP_LOSS_RTOL, f"--dp 1's losses are {worst:.3e} off the plain Trainer's (> {DP_LOSS_RTOL})")

    def median_step(log, lo, hi):
        w = sorted(b["wall"] - a["wall"] for a, b in zip(log, log[1:]) if lo <= b["iteration"] <= hi)
        return w[len(w) // 2]

    step_s = {}
    for stage, lo, hi in (("surfel+warp", 6, 8), ("surfel2", 10, 12)):
        step_s[stage] = (median_step(dp_log, lo, hi), median_step(plain_log, lo, hi))
        print(f"  (a) host s/step, {stage} (iterations {lo}-{hi}, median): --dp 1 {step_s[stage][0]:.4f}, plain "
              f"Trainer {step_s[stage][1]:.4f} ({smi_line})")
    ar = [m["dp_allreduce_ms"] for m in dp_log]
    ar_bytes = int(dp_log[-1]["dp_allreduce_bytes"])
    print(f"  (a) NCCL all_reduce of the gradients, world size 1: {ar_bytes} bytes ({ar_bytes / 2**20:.1f} MiB) "
          f"a step in surfel2, median {sorted(ar)[len(ar) // 2]:.3f} ms (min {min(ar):.3f}, max {max(ar):.3f}); "
          f"largest relative loss difference {worst:.3e} (tolerance {DP_LOSS_RTOL})")

    # The tile kernels on a block's grid (row0 = 25 of 50 tile rows): the
    # kernel change that keeps a tile-sharded block in the view's frame.
    from materialrefgs_torch.cameras import look_at_camera
    from materialrefgs_torch.ops.rasterize import api
    from materialrefgs_torch.parallel import tile_sharding

    params, _ = bench_scene(np, seed=3)
    P = len(params["xyz"])
    rng = np.random.default_rng(7)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = [t(params["xyz"]), t(np.exp(params["scaling"])),
            t(params["rotation"] / np.linalg.norm(params["rotation"], axis=-1, keepdims=True)),
            t(1 / (1 + np.exp(-params["opacity"][:, 0]))), t(rng.uniform(size=(P, 3))),
            t(rng.uniform(size=(P, 9)))]
    args = [a.requires_grad_(True) for a in args]
    eye = np.array([3.2 * math.sin(0.4), 0.3, -3.2 * math.cos(0.4)])
    cam = look_at_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.8, 0.8, DP_RES, DP_RES, device=dev)
    rows = (DP_RES + 15) // 16 // 2
    cfg_block = api.RasterizeConfig(pair_capacity=PAIR_CAPACITY)

    def block_step():
        out, _ = tile_sharding._tile_local_render(*args, cam, 1.0, cfg_block, rows, rows)
        torch.autograd.grad(out[..., :3].square().mean(), args)

    caps = capture_raster(torch, api, block_step)
    check(len(caps) == 1 and caps[0][1]["row0"] == rows, "the block's backward was not captured")
    block = raster_at(np, torch, f"tile rows {rows}-{2 * rows - 1} of a {DP_RES}x{DP_RES} view (row0 = {rows})",
                      caps[0])
    del caps

    # (b) two ranks on the one card over gloo, CUDA tensors through the host.
    import torch.multiprocessing as mp

    job_path = os.path.join(work_dir, "dp_job.json")
    with open(job_path, "w") as f:
        json.dump({"init": f"tcp://localhost:{multihost.free_port()}", "device": str(dev), "res": DP_RES,
                   "model_ply": model_ply, "pairs": PAIR_CAPACITY}, f)
    t0 = time.perf_counter()
    mp.start_processes(_dp_rank, args=(job_path,), nprocs=2, join=True, start_method="spawn")
    print(f"  (b) two ranks sharing the one card over gloo (CUDA tensors reduced through the host): done in "
          f"{time.perf_counter() - t0:.1f} s, including their start")
    ranks = []
    for r in range(2):
        with open(f"{job_path}.{r}.json") as f:
            ranks.append(json.load(f))
    for r, o in enumerate(ranks):
        check(o["backend"] == "gloo" and o["device"].startswith(dev.type), f"rank {r} ran on {o}")
        check(min(o["launches"]) > 0, f"rank {r}'s DP step launched no rasterizer kernel")
        print(f"  (b) rank {r} on {o['device']} over {o['backend']}: DP production step {o['dp_step_s']:.4f} s "
              f"(single-view step {o['plain_step_s']:.4f} s); gloo all_reduce {o['allreduce_bytes']} bytes in "
              f"{o['allreduce_ms']:.1f} ms; gradients {o['grad_err_over_tol']:.3f} x tol, densification norms "
              f"{o['stats_err_over_tol']:.3f} x tol of the two views' mean/sum ({o['denom_seen_by_both']} splats "
              f"seen by both); tile-sharded {DP_RES}x{DP_RES} in two blocks of {DP_RES // 32} tile rows: fwd+bwd "
              f"{o['sharded_s']:.4f} s "
              f"against the whole view's {o['full_s']:.4f} s, maps max|err| {o['tile_fwd_err']:.3e}, gradients "
              f"{o['tile_grad_err_over_tol']:.3f} x tol")
    print(f"  ({smi_line})")
    return launches["dp1"], block


def volume_phase(np, torch, dev, smi_line, ctx):
    """Phase 20: the volume stage at glossy's preset, trained and served at
    full width. ctx: warp_scene and priors_dir (phase 15's 24-view scene and
    its normal priors), start_dir (phase 7's point_cloud/iteration_50),
    work_dir, train_torch, eval_torch. Returns the rasterizer launches of the
    run and the numbers of the kernels at a captured volume step (S = 5)."""
    from materialrefgs_torch import config as cfg
    from materialrefgs_torch import evaluate
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models.env_light import EnvLightMips
    from materialrefgs_torch.models.scene import Scene
    from materialrefgs_torch.ops import warp_sample as ws
    from materialrefgs_torch.ops.rasterize import api, tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.render.renderers import RenderOptions
    from materialrefgs_torch.train.trainer import init_train_state

    t_phase = time.perf_counter()
    fns = (tiles_fwd.rasterize_tiles_fwd, tiles_bwd.rasterize_tiles_bwd, ws.warp_sample_fwd, ws.warp_sample_bwd)
    scene_dir, run_dir = ctx["warp_scene"], os.path.join(ctx["work_dir"], "volume_run")
    # Glossy as users run it, with the stage boundaries moved by the CLI's
    # own flags. Cuts: depth (100 steps), no surfel2 (indirect_from_iter past
    # the end), the opacity reset (every 30 at x 0.01) off, densify every 10
    # steps and one normal-propagation reset (at 140, past the volume stage:
    # dist_color runs in it).
    argv = ["-s", scene_dir, "-m", run_dir, "--preset", "glossy", "--schedule_scale", "0.01",
            "--start_ply", ctx["start_dir"], "--start_iter", str(VOL_START), "--iterations", str(VOL_RUN_END),
            "--capacity", str(1 << 19), "--pair_capacity", str(1 << 20),
            "--volume_render_until_iter", str(VOL_END), "--indirect_from_iter", "1000",
            "--multi_view_weight_from_iter", str(VOL_WARP_FROM), "--rghmtl_warp_loss_start_iter",
            str(VOL_WARP_FROM), "--basecolor_warp_from_iter", str(VOL_WARP_FROM),
            "--opacity_reset_interval", "1000", "--densification_interval_when_prop", "10",
            "--normal_prop_interval", str(VOL_WARP_FROM), "--mask_dir", os.path.join(scene_dir, "train"),
            "--metric3d_path", ctx["priors_dir"], "--save_iterations", str(VOL_END), str(VOL_RUN_END),
            "--log_every", "1"]
    print("  python scripts/train_torch.py " + " ".join(argv))
    for fn in fns:
        fn.launches = 0  # counts of this path's run only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ctx["train_torch"].main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fns}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tr = res["trainer"]
    log = tr.metrics_log
    for prev, m in zip([None] + log[:-1], log):
        step_s = m["wall"] - prev["wall"] if prev else float("nan")
        print(f"    it {m['iteration']:3d} {m['stage']:7s} warp_on {m['warp_on']} loss {m['loss']:.5f} "
              f"psnr {m['psnr']:.3f} n_alive {m['n_alive']} rgh warp {m.get('loss_warp_rgh', float('nan')):.3e} "
              f"renders redone {m['renders_redone']:.0f} s/step {step_s:.4f}")
    n = VOL_RUN_END - VOL_START
    n_vol = VOL_END - VOL_START
    check([m["iteration"] for m in log] == list(range(VOL_START + 1, VOL_RUN_END + 1)), "phase 20 skipped iterations")
    check([m["stage"] for m in log] == ["volume"] * n_vol + ["surfel"] * (n - n_vol),
          f"stages are not {VOL_START + 1}-{VOL_END} volume, {VOL_END + 1}-{VOL_RUN_END} surfel")
    check(all(math.isfinite(m["loss"]) for m in log), "phase 20: non-finite loss")
    check(all(m["overflow"] == 0 and m.get("nearest_overflow", 0) == 0 for m in log),
          "phase 20: a step was applied truncated")
    check(all(m["warp_on"] == int(m["iteration"] > VOL_WARP_FROM) for m in log),
          f"phase 20: the warp did not run on exactly the steps past {VOL_WARP_FROM}")
    check(any(m.get("loss_warp_rgh", 0.0) != 0.0 for m in log), "phase 20: the roughness warp was zero on every step")
    for name, prm in tr.state.params().items():
        check(bool(torch.isfinite(prm).all()), f"non-finite parameter {name} after phase 20")
    n_warp = sum(m["warp_on"] for m in log)
    want_fwd = sum((1 + m["warp_on"]) * (1 + m["renders_redone"]) for m in log)
    check(launches["rasterize_tiles_bwd"] == n + n_warp,
          f"rasterizer backward launched {launches['rasterize_tiles_bwd']} times for {n} steps, {n_warp} with a "
          "nearest render")
    check(launches["rasterize_tiles_fwd"] == want_fwd,
          f"rasterizer forward launched {launches['rasterize_tiles_fwd']} times, expected {want_fwd}")
    ws_step = warp_launches_per_step(tr.opt)
    check((launches["warp_sample_fwd"], launches["warp_sample_bwd"]) == (ws_step[0] * n_warp, ws_step[1] * n_warp),
          f"the warp sampler launched {launches['warp_sample_fwd']} gathers and {launches['warp_sample_bwd']} "
          f"splats in {n_warp} warp steps, expected {ws_step} a step")
    psnr = [m["psnr"] for m in log[:n_vol]]
    first, last = float(np.mean(psnr[:5])), float(np.mean(psnr[-5:]))
    print("  volume window train PSNR rise (mean of the 5 steps ending at step k minus the first 5): " + ", ".join(
        f"k={k} +{float(np.mean(psnr[k - 5:k])) - first:.3f} dB" for k in (25, 50, n_vol) if 5 <= k <= n_vol))
    print(f"  {n} steps in {run_s:.1f} s, peak device memory {peak:.2f} GiB; kernel launches {launches}; volume "
          f"window train PSNR, mean of the first 5 steps {first:.3f} dB, of the last 5 {last:.3f} dB "
          f"(+{last - first:.3f}; needs >= {VOL_PSNR_GAIN})")
    check(last - first >= VOL_PSNR_GAIN, f"phase 20: the volume stage's train PSNR rose {last - first:.3f} dB "
          f"(< {VOL_PSNR_GAIN})")
    walls = {}
    for a, b in zip(log, log[1:]):
        if b["renders_redone"] == 0 and b["iteration"] != VOL_END + 1:
            key = "volume" if b["stage"] == "volume" else ("surfel, warp" if b["warp_on"] else "surfel")
            walls.setdefault(key, []).append(b["wall"] - a["wall"])
    step_s = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    print("  host s/step (median, steps without a redo): " + ", ".join(f"{k} {v:.4f} ({len(walls[k])} steps)"
                                                                       for k, v in step_s.items()))

    # Serve the last volume iteration (render_volume with env2) and the end
    # (surfel) through scripts/eval_torch.py; the first against a direct
    # render_set of the same PLY.
    served = []
    real_rv = evaluate.render_volume
    evaluate.render_volume = lambda *a, **k: served.append(1) or real_rv(*a, **k)
    try:
        ev_vol = ctx["eval_torch"].main(["-m", run_dir, "-s", scene_dir, "--iteration", str(VOL_END),
                                         "--skip_train"])["test"]
    finally:
        evaluate.render_volume = real_rv
    ev_end = ctx["eval_torch"].main(["-m", run_dir, "-s", scene_dir, "--skip_train"])["test"]
    mp, pipe, opt, extra = cfg.load_config(run_dir)
    mp = dataclasses.replace(mp, source_path=scene_dir, model_path=run_dir)
    scene = Scene.load(mp, device=dev)
    ply = os.path.join(run_dir, "point_cloud", f"iteration_{VOL_END}", "point_cloud.ply")
    model, _, env2 = gaussian_io.load_ply(ply, max_sh_degree=mp.sh_degree, device=dev)
    check(env2 is not None, "phase 20: the volume-stage PLY has no env2")
    with torch.no_grad():
        mips = EnvLightMips.build(env2, min_roughness=mp.envmap_min_roughness, max_roughness=mp.envmap_max_roughness)
    opts = RenderOptions(srgb=opt.srgb, unbiased_depth=pipe.unbiased_depth, use_asg=pipe.use_asg,
                         depth_ratio=pipe.depth_ratio,
                         raster=RasterizeConfig(pair_capacity=int(extra.get("pair_capacity", 1 << 20))))
    direct = evaluate.render_set(os.path.join(ctx["work_dir"], "volume_direct"), "test", scene.test_cameras,
                                 [scene.test_image(i) for i in range(len(scene.test_cameras))], model, mips, None,
                                 opts, dump_maps=False, bg_color=(1.0, 1.0, 1.0), stage="volume")
    print(f"  served through scripts/eval_torch.py: iteration {VOL_END} (volume, env2) psnr {ev_vol['psnr']:.4f} dB, "
          f"ssim {ev_vol['ssim']:.5f} (a direct render_set: {direct['psnr']:.4f} dB); iteration {VOL_RUN_END} "
          f"(surfel) psnr {ev_end['psnr']:.4f} dB, ssim {ev_end['ssim']:.5f}")
    check(len(served) == len(scene.test_cameras) and ev_vol["overflow"] == 0,
          "the volume-stage checkpoint was not served through render_volume")
    check(ev_vol["psnr"] == direct["psnr"], "the served volume checkpoint's PSNR differs from a direct render_set")
    check(all(math.isfinite(e["psnr"]) for e in (ev_vol, ev_end)), "phase 20: non-finite served PSNR")

    # Both rasterizer kernels at one volume step's inputs (S = 5): the PLY
    # saved at the last volume iteration in a fresh state, one Trainer step.
    model, _, env2 = gaussian_io.load_ply(ply, capacity=1 << 19, max_sh_degree=mp.sh_degree, device=dev)
    tr.state = init_train_state(model, mp.envmap_max_res)
    tr.state.env2.base.data.copy_(env2.base)
    caps = capture_raster(torch, api, lambda: tr._run_step(VOL_END, "volume"))
    check(len(caps) == 1 and caps[0][1]["S"] == 5, f"phase 20: captured {len(caps)} backward calls, not one at S=5")
    raster = raster_at(np, torch, f"a volume step (glossy, iteration {VOL_END}, {TRAIN_W}x{TRAIN_H})", caps[0])
    del caps
    print(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s ({smi_line})")
    return {"launches": launches, "raster": raster, "step_s": step_s, "psnr": (first, last),
            "served": (ev_vol["psnr"], ev_end["psnr"]), "run_s": run_s, "peak": peak}


def pow2_at_least(n):
    return 1 << max(int(math.ceil(n)) - 1, 1).bit_length()


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "materialrefgs_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(materialrefgs_torch/ not found next to it)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible: the port's smoke test runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from materialrefgs_torch import config as cfg
    from materialrefgs_torch.evaluate import save_png
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models.env_light import EnvLightMips, EnvLightParams
    from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES, GaussianModel
    from materialrefgs_torch.models.scene import Scene
    from materialrefgs_torch.ops import nvcc
    from materialrefgs_torch.ops import warp_sample as ws
    from materialrefgs_torch.ops.rasterize import api, tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.rasterize.layout import ROW_LIN, acc_channels, out_layout
    from materialrefgs_torch.ops.tracer import api as tracer_api
    from materialrefgs_torch.ops.tracer import trace_bwd, trace_fwd
    from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
    from materialrefgs_torch.utils import png
    from materialrefgs_torch.utils.sh import rgb_to_sh

    dev = torch.device("cuda")
    kernel_fn = tiles_fwd.rasterize_tiles_fwd
    bwd_fn = tiles_bwd.rasterize_tiles_bwd
    trace_fn = trace_fwd.trace_bundles_fwd
    trace_bwd_fn = trace_bwd.trace_bundles_bwd

    # ------------------------------------------------------------------ 1 --
    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi unavailable"
    print(smi_line)
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ------------------------------------------------------------------ 2 --
    phase("2. build kernels (nvcc, sm_90a) and the host sources (c++)")
    from concurrent.futures import ThreadPoolExecutor

    from materialrefgs_torch.data import native_io
    from materialrefgs_torch.utils import jpeg

    sources = (tiles_fwd.SOURCE, tiles_bwd.SOURCE, trace_fwd.SOURCE, trace_bwd.SOURCE, jpeg.SOURCE, ws.SOURCE,
               jpeg.ENTROPY_SOURCE, native_io.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(nvcc.build, sources))
    print(f"6 kernel sources (nvcc; the warp sampler's holds its gather and its splat) and 2 host sources (c++) built "
          f"in {time.perf_counter() - t0:.1f} s (one compiler per source, in parallel)")
    for lib_path, log in builds:
        print(f"{os.path.relpath(lib_path, REPO)}:")
        print(log.strip() or "(already built)")

    # ------------------------------------------------------------------ 3 --
    phase("3. kernel vs plain version on the card")
    rng = np.random.default_rng(1)

    def mid_scene(S, P=20_000):
        arrays = (
            rng.normal(size=(P, 3)) * 0.6, np.exp(rng.normal(size=(P, 2)) * 0.5 - 2.3),
            rng.normal(size=(P, 4)), rng.uniform(0.2, 0.95, size=(P,)),
            rng.uniform(size=(P, 3)), rng.uniform(size=(P, S)),
        )
        return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]

    def run_both(ti, counts=None):
        counts = ti.bins.tile_count if counts is None else counts
        args = (ti.payload, ti.bins.tile_start, counts)
        kw = dict(S=ti.S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=ti.W, H=ti.H)
        out = kernel_fn(*args, **kw)
        torch.cuda.synchronize()
        ref = tiles_fwd.rasterize_tiles_fwd_plain(*args, **kw)
        torch.cuda.synchronize()
        return out.cpu().numpy(), ref.cpu().numpy(), (args, kw)

    def run_bwd(ti, counts=None, seed=0):
        """The backward kernel and its plain version on the forward's output
        and a random cotangent; returns (max error, largest err/tol, the
        kernel's inputs)."""
        counts = ti.bins.tile_count if counts is None else counts
        kw = dict(S=ti.S, grid_x=ti.grid_x, grid_y=ti.grid_y, W=ti.W, H=ti.H)
        fwd = kernel_fn(ti.payload, ti.bins.tile_start, counts, **kw)
        lay = out_layout(ti.S)
        active = torch.amax(fwd[..., lay["n_contrib"][0]], dim=1).to(torch.int32)
        cot = torch.randn(fwd.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        cot[..., lay["_channels"]:] = 0.0
        bargs = (ti.payload, ti.bins.tile_start, counts, active, fwd, cot)
        out = bwd_fn(*bargs, **kw)
        torch.cuda.synchronize()
        work = {}
        ref = tiles_bwd.rasterize_tiles_bwd_plain(*bargs, **kw, work=work)
        torch.cuda.synchronize()
        work["walked"] = float(fwd[..., lay["n_contrib"][0]].sum())
        print(f"    backward, random cotangent: {int(active.max())} positions in the longest walk; "
              f"(pixel, pair) in contributor ranges {work['walked']:.0f}, passing the hit test "
              f"{work['pass3d']} (3D) + {work['pass2d']} (2D)")
        print(f"    tolerance per value: {BWD_RTOL:g} x min(|grad| + the group's p99 |grad|, "
              f"the group's max |grad|) + {BWD_ATOL:g}")
        return (*compare_grads(np, torch, out, ref, ti.S), (bargs, kw, work))

    from materialrefgs_torch.cameras import look_at_camera

    for S in (1, 9, 10):
        cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
                             0.9, 0.7, 384, 288, device=dev)
        ti = api.tile_inputs(*mid_scene(S), cam, config=api.RasterizeConfig(pair_capacity=1 << 20))
        check(int(ti.bins.overflow) == 0, "mid scene overflows")
        out, ref, _ = run_both(ti)
        print(f"  mid scene 384x288, S={S}: {int(ti.bins.num_pairs)} pairs, "
              f"densest tile {int(ti.bins.tile_count.max())} pairs")
        compare_tiles(np, out, ref, S, out_layout(S))
        run_bwd(ti, seed=S)

    # The full-width scene at the main path's shapes (S=9 features).
    params, srng = bench_scene(np)
    full_cam = look_at_camera(np.array([0.0, 0.0, -3.2]), np.zeros(3), np.array([0.0, 1.0, 0.0]),
                              0.8, 0.8, W, H, device=dev)
    t = {k: torch.tensor(v, device=dev) for k, v in params.items()}
    feats9 = torch.rand((P_SPLATS, 9), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    colors = torch.rand((P_SPLATS, 3), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    with torch.no_grad():
        full = api.tile_inputs(
            t["xyz"], torch.exp(t["scaling"]), t["rotation"], torch.sigmoid(t["opacity"][:, 0]),
            colors, feats9, full_cam, config=api.RasterizeConfig(pair_capacity=PAIR_CAPACITY),
        )
    check(int(full.bins.overflow) == 0, "full-width view overflows the pair capacity")
    lay9 = out_layout(9)
    counts = full.bins.tile_count
    dense = torch.topk(counts, 64).indices
    only_dense = torch.zeros_like(counts)
    only_dense[dense] = counts[dense]
    out, ref, _ = run_both(full, only_dense)
    print(f"  64 densest tiles of the 800x800 view: {int(only_dense.sum())} pairs, "
          f"{int(counts[dense].min())}..{int(counts[dense].max())} per tile")
    compare_tiles(np, out, ref, 9, lay9)
    run_bwd(full, only_dense, seed=64)
    out, ref, (full_args, full_kw) = run_both(full)
    print(f"  whole 800x800 view: {int(full.bins.num_pairs)} pairs")
    full_err = compare_tiles(np, out, ref, 9, lay9)
    bwd_err, bwd_ratio, bwd9 = run_bwd(full, seed=800)
    n_contrib_sum = float(out[..., lay9["n_contrib"][0]].sum())
    plain_ms = cuda_ms(torch, lambda: tiles_fwd.rasterize_tiles_fwd_plain(*full_args, **full_kw), 2)

    # The bundle tracer on a mid-size random scene: 64 bundles of coherent
    # rays looking into a slab of surfels; bundle 5 masked (an empty
    # segment), bundles 48-63 aimed at an opaque core (they exit early).
    trng = np.random.default_rng(4)
    NBm, Pm = 64, 40_000
    means = np.concatenate([trng.uniform(-2.0, 2.0, (Pm, 3)), trng.normal(size=(Pm // 8, 3)) * 0.2])
    means[:, 2] = np.abs(means[:, 2])
    nm = len(means)
    opac_m = np.concatenate([trng.uniform(0.2, 0.9, Pm), np.full(Pm // 8, 0.98)])
    ro = np.zeros((NBm, 256, 3))
    ro[..., :2] = trng.uniform(-0.15, 0.15, (NBm, 256, 2)) + trng.uniform(-1.6, 1.6, (NBm, 1, 2))
    ro[48:, :, :2] *= 0.05
    ro[..., 2] = -3.0
    rdir = np.zeros((NBm, 256, 3))
    rdir[..., :2] = trng.uniform(-0.08, 0.08, (NBm, 256, 2))
    rdir[..., 2] = 1.0
    mid_inputs = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        ro.reshape(-1, 3), rdir.reshape(-1, 3), means, np.exp(trng.normal(size=(nm, 2)) * 0.3 - 2.8),
        trng.normal(size=(nm, 4)), opac_m, trng.normal(size=(nm, 16, 3)) * 0.3)]
    bmask = torch.ones(NBm, dtype=torch.bool, device=dev)
    bmask[5] = False
    tbwd_errs = []
    print(f"  tracer backward tolerance per value: {BWD_RTOL:g} x min(|grad| + the group's p99 |grad|, "
          f"the group's max |grad|) + {BWD_ATOL:g}")
    for n_sh in (1, 16):
        for exact in (False, True):
            captured = capture_trace(torch, tracer_api, lambda: tracer_api.trace(
                *mid_inputs, tracer_api.TracerConfig(pair_capacity=1 << 20, exact_order=exact),
                sh_degree=3 if n_sh == 16 else 0, bundle_mask=bmask))
            (targs, tkw), = captured
            out_t = trace_fn(*targs, **tkw)
            torch.cuda.synchronize()
            ref_t = trace_fwd.trace_bundles_fwd_plain(*targs, **tkw).cpu().numpy()
            cnt = targs[3].cpu().numpy()
            nproc = ref_t[:, 0, 10]
            chunks = (cnt + 127) // 128
            check(cnt[5] == 0 and cnt.max() > 3 * 128, "mid trace scene lacks an empty or a multi-chunk segment")
            check(bool((nproc[48:] < chunks[48:]).any()), "no bundle of the mid trace scene exits early")
            compare_trace(np, out_t.cpu().numpy(), ref_t,
                          f"mid scene, n_sh={n_sh}, {'exact' if exact else 'list'} order, "
                          f"{int(cnt.sum())} pairs, {int(chunks.max())} chunks in the longest segment, "
                          f"{int((nproc < chunks).sum())} bundles exit early")
            # The backward on the forward kernel's output, with a cotangent
            # from a seed on rgb, depth, normal and final_T.
            if exact:
                active = torch.amax(out_t[..., 10], dim=1).to(torch.int32) * 128
            else:
                active = torch.amax(out_t[..., 8], dim=1).to(torch.int32)
            cot = torch.zeros_like(out_t)
            cot[..., :8] = torch.randn(out_t.shape[:2] + (8,), device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(10 * n_sh + exact))
            bargs = (*targs, active, out_t, cot)
            dp, dr = trace_bwd_fn(*bargs, **tkw)
            torch.cuda.synchronize()
            rp, rr = trace_bwd.trace_bundles_bwd_plain(*bargs, **tkw)
            tbwd_errs.append(compare_trace_bwd(
                np, torch, dp, dr, rp, rr, n_sh,
                f"mid scene backward, n_sh={n_sh}, {'exact' if exact else 'list'} order, "
                f"{int(active.max())} positions in the longest walk"))
            del dp, dr, rp, rr

    # ------------------------------------------------------------------ 4 --
    phase("4. serve a full-width refnerf model through scripts/eval_torch.py")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    model_path, scene_path = os.path.join(work, "model"), os.path.join(work, "scene")
    arrays = dict(params)
    for name in ("refl_strength", "metalness", "roughness", "ori_color", "diffuse_color"):
        arrays[name] = srng.normal(size=(P_SPLATS,) + PARAM_SHAPES[name](16)).astype(np.float32)
    arrays["features_dc"] = rgb_to_sh(torch.tensor(srng.uniform(0.05, 0.95, size=(P_SPLATS, 1, 3)))).numpy()
    arrays["features_rest"] = (srng.normal(size=(P_SPLATS, 15, 3)) * 0.1).astype(np.float32)
    arrays["indirect_dc"] = (srng.normal(size=(P_SPLATS, 1, 3)) * 0.5).astype(np.float32)
    arrays["indirect_rest"] = (srng.normal(size=(P_SPLATS, 15, 3)) * 0.1).astype(np.float32)
    for name in ("indirect_asg", "normal1", "normal2"):
        arrays[name] = np.zeros((P_SPLATS,) + PARAM_SHAPES[name](16), np.float32)
    model = GaussianModel.from_arrays(arrays, np.ones(P_SPLATS, bool), 3, 3, dev)
    env = EnvLightParams(torch.tensor(srng.normal(size=(6, 128, 128, 3)), dtype=torch.float32, device=dev))
    ply = os.path.join(model_path, "point_cloud", f"iteration_{ITERATION}", "point_cloud.ply")
    gaussian_io.save_ply(model, ply, env1=env)
    mp, pipe, opt = cfg.preset_refnerf()
    cfg.dump_config(model_path, mp, pipe, opt, extra={"pair_capacity": PAIR_CAPACITY})

    # Blender-layout scene: write the cameras (and size-only placeholder
    # PNGs), load them with the port's reader, then render the ground truth.
    os.makedirs(os.path.join(scene_path, "test"))
    frames = [{"file_path": f"./test/r_{i}", "transform_matrix": m.tolist()}
              for i, m in enumerate(ring_views(np, N_VIEWS))]
    for split, fr in (("train", frames[:1]), ("test", frames)):
        with open(os.path.join(scene_path, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": fr}, f)
    for i in range(N_VIEWS):
        png.write_png(os.path.join(scene_path, "test", f"r_{i}.png"), np.zeros((H, W, 3), np.uint8))
    scene = Scene.load(dataclasses.replace(mp, source_path=scene_path), device=dev)
    check(len(scene.test_cameras) == N_VIEWS, "scene reader lost test views")
    opts = RenderOptions(raster=api.RasterizeConfig(pair_capacity=PAIR_CAPACITY))
    white = torch.ones(3, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        mips = EnvLightMips.build(env, min_roughness=mp.envmap_min_roughness,
                                  max_roughness=mp.envmap_max_roughness)
        before = kernel_fn.launches
        for i, cam in enumerate(scene.test_cameras):
            pkg = render_surfel(model, cam, white, mips, opts)
            check(int(pkg["overflow"]) == 0, f"GT view {i} overflows the pair capacity")
            for k, v in pkg.items():
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    check(bool(torch.isfinite(v).all()), f"GT view {i}: non-finite {k}")
            save_png(os.path.join(scene_path, "test", f"r_{i}.png"), torch.clamp(pkg["render"], 0, 1))
    check(kernel_fn.launches - before == N_VIEWS, "GT rendering did not launch the kernel once per view")
    print(f"  {N_VIEWS} ground-truth views rendered and written in {time.perf_counter() - t0:.1f} s")

    spec = importlib.util.spec_from_file_location("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    eval_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_torch)
    kernel_fn.launches = 0  # counts of the main path's run only
    metrics = eval_torch.main(["-m", model_path, "-s", scene_path, "--skip_train"])["test"]
    launches = kernel_fn.launches
    print(f"  eval: psnr {metrics['psnr']:.3f} dB, ssim {metrics['ssim']:.6f}, "
          f"{metrics['fps']:.2f} views/s end to end, overflow {metrics['overflow']}, "
          f"kernel launches {launches}")
    check(launches == N_VIEWS, f"main path launched the kernel {launches} times for {N_VIEWS} views")
    check(metrics["overflow"] == 0, "eval views overflow the pair capacity")
    check(len(metrics["per_view_psnr"]) == N_VIEWS, "eval skipped views")
    check(all(math.isfinite(v) for v in metrics["per_view_psnr"]), "non-finite PSNR")
    check(math.isfinite(metrics["ssim"]), "non-finite SSIM")
    check(metrics["psnr"] >= 45.0, f"PSNR {metrics['psnr']:.2f} dB < 45 dB: a round trip is broken")
    for i in range(N_VIEWS):
        check(os.path.exists(os.path.join(model_path, f"eval_{ITERATION}", "test", "renders",
                                          f"{i:05d}.png")), f"render {i} not written")

    # ------------------------------------------------------------------ 5 --
    phase("5. kernel time at the main path's shapes")
    for _ in range(3):
        kernel_fn(*full_args, **full_kw)
    ms = cuda_ms(torch, lambda: kernel_fn(*full_args, **full_kw), 20)
    n_pairs = int(full.bins.num_pairs)
    T = full.grid_x * full.grid_y
    c_out = out.shape[-1]
    bytes_moved = 4 * (n_pairs * (ROW_LIN + acc_channels(9)) + T * 256 * c_out + 2 * T + 1)
    flops = HIT_TEST_FLOPS * n_contrib_sum
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"kernel ms per 800x800 view: {ms:.4f}")
    print(f"pairs per view: {n_pairs}")
    print(f"bound ms: {bound_ms:.4f} (by {bound_by}: {bytes_moved / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
          f"{flops / 1e9:.2f} GFLOP over {n_contrib_sum:.0f} needed hit tests -> {t_ops:.4f} ms)")
    print(f"plain version ms: {plain_ms:.2f}")
    print("library call: none computes this function")

    # ------------------------------------------------------------------ 6 --
    phase("6. where one served view's time goes (torch.profiler)")
    cam = scene.test_cameras[0]
    with torch.no_grad():
        render_surfel(model, cam, white, mips, opts)
        torch.cuda.synchronize()
        reps = 3
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                render_surfel(model, cam, white, mips, opts)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    print(f"render_surfel, 800x800: {wall_ms:.2f} ms per view on the host clock (profiled), "
          f"{busy_ms:.2f} ms of device kernels -> device busy {100 * busy_ms / wall_ms:.1f} %")
    print("  top device kernels (ms per view, launches per view):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / reps:9.3f}  {e.count // reps:5d}  {e.key[:90]}")

    # ------------------------------------------------------------------ 7 --
    phase("7. train refnerf at full width through scripts/train_torch.py")
    train_scene = os.path.join(work, "train_scene")
    run_path = os.path.join(work, "train_run")
    views = ring_views(np, TRAIN_VIEWS + TEST_VIEWS, radius=3.4)
    splits = {"train": views[:TRAIN_VIEWS], "test": views[TRAIN_VIEWS:]}
    t0 = time.perf_counter()
    for split, mats in splits.items():
        os.makedirs(os.path.join(train_scene, split))
        frames = [{"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()} for i, m in enumerate(mats)]
        with open(os.path.join(train_scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
        for i in range(len(mats)):
            png.write_png(os.path.join(train_scene, split, f"r_{i}.png"),
                          np.zeros((TRAIN_H, TRAIN_W, 4), np.uint8))
    tscene = Scene.load(dataclasses.replace(mp, source_path=train_scene), device=dev)
    with torch.no_grad():
        for split, cams in (("train", tscene.train_cameras), ("test", tscene.test_cameras)):
            for i, cam in enumerate(cams):
                pkg = render_surfel(model, cam, white, mips, opts)
                check(int(pkg["overflow"]) == 0, f"training GT {split} view {i} overflows")
                rgba = torch.cat([pkg["render"], pkg["rend_alpha"]], dim=-1)
                arr = (np.clip(rgba.cpu().numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
                png.write_png(os.path.join(train_scene, split, f"r_{i}.png"), arr)
    print(f"  {TRAIN_VIEWS} train + {TEST_VIEWS} test views at {TRAIN_W}x{TRAIN_H} (RGBA, alpha = rend_alpha) "
          f"written in {time.perf_counter() - t0:.1f} s")

    spec = importlib.util.spec_from_file_location("train_torch", os.path.join(REPO, "scripts", "train_torch.py"))
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    train_argv = ["-s", train_scene, "-m", run_path, "--schedule_scale", "0.01",
                  "--iterations", str(TRAIN_ITERS), "--capacity", str(1 << 19),
                  "--pair_capacity", str(1 << 20), "--log_every", "1",
                  "--checkpoint_iterations", str(TRAIN_ITERS // 2),
                  "--save_iterations", str(S2_FROM), str(TRAIN_ITERS),
                  "--test_iterations", *map(str, TRAIN_TEST_MARKS)]
    print("  python scripts/train_torch.py " + " ".join(train_argv))
    torch.cuda.reset_peak_memory_stats()
    kernel_fn.launches = 0  # counts of this slice's main path only
    bwd_fn.launches = 0
    t0 = time.perf_counter()
    res = train_torch.main(train_argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"  peak device memory of the training run: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    train_fwd, train_bwd = kernel_fn.launches, bwd_fn.launches
    trainer = res["trainer"]
    log = trainer.metrics_log
    print(f"  {len(log)} steps in {train_s:.1f} s; kernel launches: forward {train_fwd}, backward {train_bwd}")
    for m in log:
        if m["iteration"] in (1, 5, 6, 10, 30, 31, 40, 41, 50, 51, 60) or m["overflow_redone"] > 0:
            print(f"    it {m['iteration']:3d} {m['stage']:7s} loss {m['loss']:.5f} psnr {m['psnr']:.3f} "
                  f"n_alive {m['n_alive']} overflow {m['overflow']:.0f} (redone: {m['overflow_redone']:.0f})")
    check([m["iteration"] for m in log] == list(range(1, TRAIN_ITERS + 1)), "training skipped iterations")
    check([m["stage"] for m in log] == ["initial"] * 30 + ["surfel"] * 30, "stages are not 1-30 initial, 31-60 surfel")
    check(all(math.isfinite(v) for m in log for k, v in m.items() if isinstance(v, float)), "non-finite loss or metric")
    for name, prm in trainer.state.params().items():
        check(bool(torch.isfinite(prm).all()), f"non-finite parameter {name} after training")
    n_test = TEST_VIEWS * len(TRAIN_TEST_MARKS)
    n_redo = sum(m["renders_redone"] for m in log)
    check(train_bwd == TRAIN_ITERS, f"backward kernel launched {train_bwd} times in {TRAIN_ITERS} steps")
    check(train_fwd == TRAIN_ITERS + n_redo + n_test,
          f"forward kernel launched {train_fwd} times for {TRAIN_ITERS} steps + {n_redo} redone "
          f"renders + {n_test} test renders")
    alive = [m["n_alive"] for m in log]
    check(len(set(alive)) > 1, "densify/prune never changed n_alive")
    ovf = [m["overflow"] for m in log]
    redone = [m["overflow_redone"] for m in log]
    check(all(v == 0 for v in ovf[-10:]), "binning overflow in the last 10 steps")
    if any(v > 0 for v in ovf + redone):
        check(trainer.raster_cfg.pair_capacity > (1 << 20), "an overflow was not escalated")
    print(f"  n_alive {alive[0]} -> {alive[-1]} (min {min(alive)}, max {max(alive)}); "
          f"steps applied truncated {sum(v > 0 for v in ovf)}, steps redone after an escalation "
          f"{sum(v > 0 for v in redone)}, pair capacity now {trainer.raster_cfg.pair_capacity}")
    for mark, mt in res["test"].items():
        print(f"  test psnr at {mark}: {mt['psnr']:.3f} dB over {len(mt['per_view_psnr'])} views")
        check(math.isfinite(mt["psnr"]), f"non-finite test PSNR at {mark}")
    check(res["ply"] is not None and os.path.exists(res["ply"]), "no PLY saved")
    ev = eval_torch.main(["-m", run_path, "-s", train_scene, "--skip_train"])["test"]
    print(f"  saved PLY through scripts/eval_torch.py: psnr {ev['psnr']:.3f} dB, ssim {ev['ssim']:.5f}, "
          f"{len(ev['per_view_psnr'])} views")
    check(math.isfinite(ev["psnr"]) and len(ev["per_view_psnr"]) == TEST_VIEWS, "eval of the trained PLY failed")
    step_wall = [b["wall"] - a["wall"] for a, b in zip(log, log[1:])]
    for stage, lo, hi in (("initial", 10, 29), ("surfel", 40, 59)):
        w = sorted(step_wall[lo:hi])
        print(f"  host s/step during the run, {stage} (iterations {lo + 2}-{hi + 1}, median): {w[len(w) // 2]:.4f}")

    # ------------------------------------------------------------------ 8 --
    phase("8. learning check: 40 full-width initial steps, densification off")
    from materialrefgs_torch.models import gaussian_model as gm
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.train.trainer import Trainer

    # The reader's init as the training run read it (points3d.ply on disk).
    pcd = Scene.load(dataclasses.replace(mp, source_path=train_scene), device=dev).info.point_cloud
    _, lpipe, lopt = cfg.preset_refnerf()
    lopt = dataclasses.replace(cfg.scale_schedule(lopt, 0.01), init_until_iter=10**6,
                               densify_from_iter=10**9, opacity_reset_interval=10**9)
    lmodel = gm.create_from_points(pcd.points, pcd.colors, capacity=1 << 19,
                                   rng=np.random.default_rng(3407), device=dev)
    ltrainer = Trainer(lmodel, tscene.train_cameras,
                       [tscene.train_image(i) for i in range(TRAIN_VIEWS)], lopt, lpipe,
                       cameras_extent=tscene.cameras_extent, bg_color=(1.0, 1.0, 1.0),
                       raster_cfg=RasterizeConfig(pair_capacity=1 << 20))
    ltrainer.train(40, log_every=1)
    psnrs = [m["psnr"] for m in ltrainer.metrics_log]
    first5, last5 = float(np.mean(psnrs[:5])), float(np.mean(psnrs[-5:]))
    print(f"  train PSNR: first 5 steps {first5:.3f} dB, last 5 steps {last5:.3f} dB "
          f"(+{last5 - first5:.3f} dB); n_alive {ltrainer.metrics_log[-1]['n_alive']}")
    check(last5 >= first5 + 0.5, "training did not raise the train PSNR by 0.5 dB")

    # ------------------------------------------------------------------ 9 --
    phase("9. backward kernel time at 800x800, and a training step")
    bargs9, bkw9, _ = bwd9
    with torch.no_grad():
        full1 = api.tile_inputs(
            t["xyz"], torch.exp(t["scaling"]), t["rotation"], torch.sigmoid(t["opacity"][:, 0]),
            colors, feats9[:, :1], full_cam, config=api.RasterizeConfig(pair_capacity=PAIR_CAPACITY),
        )
    _, _, bwd1 = run_bwd(full1, seed=801)
    bwd_times = {}
    for S, (bargs, bkw, work) in ((9, bwd9), (1, bwd1)):
        for _ in range(3):
            bwd_fn(*bargs, **bkw)
        ms_b = cuda_ms(torch, lambda: bwd_fn(*bargs, **bkw), 20)
        n_p = int(bargs[1][-1])
        nrow = ROW_LIN + acc_channels(S)
        T_ = bkw["grid_x"] * bkw["grid_y"]
        c_out = bargs[4].shape[-1]
        b_bytes = 4 * (2 * n_p * nrow + 2 * T_ * 256 * c_out + 3 * T_ + 1)
        b_flops = bwd_flops(S, work["walked"], work["pass3d"], work["pass2d"])
        tb_, to_ = b_bytes / PEAK_BYTES_PER_S * 1e3, b_flops / PEAK_FP32_FLOPS * 1e3
        bwd_times[S] = dict(ms=ms_b, bound=max(tb_, to_), by="bytes" if tb_ >= to_ else "operations",
                            pairs=n_p, bytes=b_bytes, flops=b_flops, tb=tb_, to=to_, **work)
    plain_bwd_ms = cuda_ms(torch, lambda: tiles_bwd.rasterize_tiles_bwd_plain(*bargs9, **bkw9), 1)
    for S in (9, 1):
        b = bwd_times[S]
        print(f"bwd kernel ms per 800x800 view, S={S}: {b['ms']:.4f} ({b['pairs']} pairs)")
        print(f"bwd bound ms, S={S}: {b['bound']:.4f} (by {b['by']}: {b['bytes'] / 1e6:.1f} MB -> {b['tb']:.4f} ms, "
              f"{b['flops'] / 1e9:.2f} GFLOP: {b['walked']:.0f} hit tests, of which {b['pass3d']} (3D) + "
              f"{b['pass2d']} (2D) pass and carry the chain rule -> {b['to']:.4f} ms); "
              f"kernel at {100 * b['bound'] / b['ms']:.1f} % of it")
    print(f"bwd launches per training step: {train_bwd / TRAIN_ITERS:.0f}")
    print(f"bwd plain version ms, S=9: {plain_bwd_ms:.2f}")
    print("bwd library call: none computes this function")

    def pair_demand(tr):
        """Pairs the trainer's current model asks for on train view 0."""
        m = tr.state.model
        z = torch.zeros((m.capacity, 3), device=dev)
        with torch.no_grad():
            ti = api.tile_inputs(m.xyz, m.get_scaling, m.get_rotation, m.get_opacity[:, 0], z, z[:, :1],
                                 tr.cameras[0], config=api.RasterizeConfig(pair_capacity=1 << 25))
        return int(ti.bins.num_pairs) + int(ti.bins.overflow)

    def time_steps(tr, stage, first_it, n):
        """n of the Trainer's own steps (render, overflow check, update) on
        the host clock, synchronized; none may redo a render."""
        walls = []
        for it in range(first_it, first_it + n):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            met = tr._run_step(it, stage)
            float(met["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            check(met["renders_redone"] == 0 and float(met["overflow"]) == 0,
                  f"a timed {stage} step overflowed")
        return walls

    # The `surfel` step at the state the run reached after iteration 30 (its
    # checkpoint: the stage switch, right after the opacity reset, as a real
    # schedule has it at 3000), and at the state after iteration 60, which
    # the compressed curriculum's resets every 10 steps have driven to a pair
    # demand of over 10M.
    from materialrefgs_torch.train.checkpoint import load_checkpoint

    _, cpipe, copt = cfg.preset_refnerf()
    copt = dataclasses.replace(cfg.scale_schedule(copt, 0.01), iterations=TRAIN_ITERS)
    cstate, cit = load_checkpoint(run_path, TRAIN_ITERS // 2, device=dev)
    ctrainer = Trainer(cstate.model, tscene.train_cameras,
                       [tscene.train_image(i) for i in range(TRAIN_VIEWS)], copt, cpipe,
                       cameras_extent=tscene.cameras_extent, bg_color=(1.0, 1.0, 1.0),
                       raster_cfg=RasterizeConfig(pair_capacity=1 << 20), envmap_res=mp.envmap_max_res,
                       masks=train_torch.load_masks(os.path.join(train_scene, "train"),
                                                    tscene.info.train_cameras, (TRAIN_H, TRAIN_W)),
                       envmap_min_roughness=mp.envmap_min_roughness,
                       envmap_max_roughness=mp.envmap_max_roughness)
    ctrainer.state = cstate
    cases = (("initial", "after 40 steps of the learning check", ltrainer, 41),
             ("surfel", f"after iteration {cit} of the run (checkpoint)", ctrainer, cit + 1),
             ("surfel", f"after iteration {TRAIN_ITERS} of the run (compressed resets)", trainer,
              TRAIN_ITERS + 1))
    for stage, where, tr, it0 in cases:
        demand = pair_demand(tr)
        tr._run_step(it0, stage)  # warm-up; escalates the capacity if the state needs it
        walls = time_steps(tr, stage, it0 + 1, 5)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t1 = time.perf_counter()
            time_steps(tr, stage, it0 + 6, 3)
            prof_ms = (time.perf_counter() - t1) * 1e3 / 3
        ev_ = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev_) / 1e3 / 3
        print(f"training step, {stage}, state {where}, 800x800, {int(tr.state.model.n_alive)} splats, "
              f"{demand} pairs on train view 0, pair capacity {tr.raster_cfg.pair_capacity}: "
              f"{float(np.median(walls)):.4f} s/step (median of 5, host clock, synchronized); "
              f"profiled {prof_ms:.2f} ms/step with {busy:.2f} ms of device kernels "
              f"-> device busy {100 * busy / prof_ms:.1f} %")
        print("  top device kernels (ms per step, launches per step):")
        for e in sorted(ev_, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3 / 3:9.3f}  {e.count // 3:5d}  {e.key[:90]}")

    # ----------------------------------------------------------------- 10 --
    phase("10. serve a full-width env-GS (surfel2) refnerf checkpoint through scripts/eval_torch.py")
    from materialrefgs_torch.ops import mesh_tracer as mtr
    from materialrefgs_torch.render import envgs
    from materialrefgs_torch.render.renderers import mesh_visibility_map
    from materialrefgs_torch.train.mesh_extract import write_mesh_ply
    from materialrefgs_torch import evaluate as evaluate_mod

    s2_arrays = dict(arrays)
    s2_arrays["rotation"] = radial_rotations(np, arrays["xyz"], np.random.default_rng(5))
    s2_model = GaussianModel.from_arrays(s2_arrays, np.ones(P_SPLATS, bool), 3, 3, dev)
    env_arrays = env_cloud_arrays(np, PARAM_SHAPES, rgb_to_sh, torch)
    env_model = GaussianModel.from_arrays(env_arrays, np.ones(P_SPLATS, bool), 3, 3, dev)
    work_dir = os.path.dirname(model_path)  # phase 4's scratch directory
    s2_path = os.path.join(work_dir, "envgs_model")
    s2_dir = os.path.join(s2_path, "point_cloud", "iteration_30000")
    gaussian_io.save_ply(s2_model, os.path.join(s2_dir, "point_cloud.ply"), env1=env)
    gaussian_io.save_ply(env_model, os.path.join(s2_dir, "env_point_cloud.ply"))
    check(cfg.preset_refnerf()[2].indirect_from_iter < 30000, "iteration 30000 is not a surfel2 checkpoint")
    # The run's budgets as phase 4's: the tracer starts from them and the JAX
    # eval's 16384 cluster pairs; render_set raises both where a view needs it.
    cfg.dump_config(s2_path, mp, pipe, opt, extra={"pair_capacity": PAIR_CAPACITY})

    def probe(cams):
        """Worst view's demand: rasterizer pairs, and for each trace stage-1
        cluster pairs and gaussian pairs (through the tracer's own cull, no
        cluster budget), with the share of the pairs that falls on
        silhouette bundles (a pixel with alpha <= 0.5)."""
        big = tracer_api.TracerConfig(cluster_pair_capacity=1 << 40)
        worst = {"raster": 0, "env": [0, 0, 0.0], "vis": [0, 0, 0.0]}
        z = torch.zeros((P_SPLATS, 3), device=dev)
        with torch.no_grad():
            for cam in cams:
                ti = api.tile_inputs(s2_model.xyz, s2_model.get_scaling, s2_model.get_rotation,
                                     s2_model.get_opacity[:, 0], z, z[:, :1], cam,
                                     config=api.RasterizeConfig(pair_capacity=1 << 25))
                worst["raster"] = max(worst["raster"], int(ti.bins.num_pairs) + int(ti.bins.overflow))
                pkg = render_surfel(s2_model, cam, white, mips, RenderOptions(raster=api.RasterizeConfig(
                    pair_capacity=pow2_at_least(1.25 * worst["raster"]))))
                alpha = pkg["rend_alpha"]
                nmap = pkg["rend_normal"] / torch.clamp(alpha, min=1e-6)
                active = envgs.bundle_alpha_mask(alpha, H, W)
                sil = active & (torch.amin(envgs.rays_to_bundles(alpha, H, W).reshape(-1, 256), dim=1) <= 0.5)
                for name, cloud, offset in (("env", env_model, 1e-3), ("vis", s2_model, 3e-2)):
                    ro_, rd_ = envgs._reflected_rays(cam, nmap, pkg["surf_depth"], offset)
                    nb = ro_.shape[0] // 256
                    _, b_of, _, okg, _ = tracer_api._cull(
                        ro_.reshape(nb, 256, 3), rd_.reshape(nb, 256, 3), cloud.xyz, cloud.get_scaling,
                        cloud.get_opacity[:, 0], big, active)
                    n_pairs = int(okg.sum())
                    if n_pairs >= worst[name][1]:
                        on_sil = int((okg & sil[b_of]).sum())
                        worst[name] = [max(worst[name][0], okg.shape[0]), n_pairs, on_sil / max(n_pairs, 1)]
                    worst[name][0] = max(worst[name][0], okg.shape[0])
                    del okg, b_of
        return worst

    def envgs_scene(name, mats):
        """A Blender-layout scene with these 8 test views; the ground truth
        is rendered with render_surfel from the checkpoint's main cloud."""
        root = os.path.join(work_dir, name)
        os.makedirs(os.path.join(root, "test"))
        frames = [{"file_path": f"./test/r_{i}", "transform_matrix": m_.tolist()} for i, m_ in enumerate(mats)]
        for split, fr in (("train", frames[:1]), ("test", frames)):
            with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
                json.dump({"camera_angle_x": 0.8, "frames": fr}, f)
        for i in range(N_VIEWS):
            png.write_png(os.path.join(root, "test", f"r_{i}.png"), np.zeros((H, W, 3), np.uint8))
        cams = Scene.load(dataclasses.replace(mp, source_path=root), device=dev).test_cameras
        with torch.no_grad():
            for i, cam in enumerate(cams):
                pkg = render_surfel(s2_model, cam, white, mips, opts)
                check(int(pkg["overflow"]) == 0, f"{name}: GT view {i} overflows")
                save_png(os.path.join(root, "test", f"r_{i}.png"), torch.clamp(pkg["render"], 0, 1))
        return root, cams

    # Two view sets. "ring": phase 4's 8 views (radius 3.2), which see the
    # whole object as a refnerf test set does; their silhouette bundles mix
    # rays from the camera centre with rays from the surface, and their
    # cones take in most of both clouds. "close": 8 views on a ring of
    # radius 1.65 that the object fills, with no silhouette.
    t0 = time.perf_counter()
    view_sets = {"ring": envgs_scene("envgs_ring", ring_views(np, N_VIEWS)),
                 "close": envgs_scene("envgs_close", ring_views(np, N_VIEWS, radius=1.65))}
    for vset, (_, cams) in view_sets.items():
        worst = probe(cams)
        print(f"  demand of the {vset} views (worst view): rasterizer {worst['raster']} pairs; env trace "
              f"{worst['env'][0]} cluster pairs / {worst['env'][1]} pairs ({100 * worst['env'][2]:.1f} % on "
              f"silhouette bundles); visibility trace {worst['vis'][0]} / {worst['vis'][1]} "
              f"({100 * worst['vis'][2]:.1f} %); the JAX eval's 16384 cluster pairs would drop up to "
              f"{256 * max(max(worst['env'][0], worst['vis'][0]) - (1 << 14), 0)} pairs at stage 1")
    print(f"  ground truth and probes of both view sets in {time.perf_counter() - t0:.1f} s")

    # Read what each render reports, during the eval itself (redone renders
    # included: they are the ones whose traces overflowed).
    seen = []
    real_surfel2 = evaluate_mod.render_surfel2

    def recording_surfel2(*a, **kw):
        pkg = real_surfel2(*a, **kw)
        seen.append({"tracer_overflow": int(pkg["tracer_overflow"]), "tracer_pairs": int(pkg["tracer_pairs"]),
                     "mesh_cull_dropped": int(pkg["mesh_cull_dropped"]),
                     "visibility": pkg["visibility"].detach(), "alpha": pkg["rend_alpha"].detach()})
        return pkg

    evaluate_mod.render_surfel2 = recording_surfel2
    served = {}
    verts, faces = bumpy_mesh(np)
    mesh_file = os.path.join(s2_path, "meshes", "test_030000.ply")
    try:
        for vset, (root, _) in view_sets.items():
            for run, with_mesh in (("a", False), ("b", True)):
                if with_mesh:
                    write_mesh_ply(mesh_file, verts, faces)
                elif os.path.exists(mesh_file):
                    os.remove(mesh_file)
                what = f"{vset} views, run ({run})"
                seen.clear()
                kernel_fn.launches = 0  # counts of this run of the main path only
                trace_fn.launches = 0
                t0 = time.perf_counter()
                m = eval_torch.main(["-m", s2_path, "-s", root, "--skip_train"])["test"]
                wall = time.perf_counter() - t0
                r_launch, t_launch = kernel_fn.launches, trace_fn.launches
                final = [v for v in seen if v["tracer_overflow"] == 0]
                occl = []
                for v in final:
                    act = envgs.bundle_alpha_mask(v["alpha"], H, W)
                    vb = envgs.rays_to_bundles(v["visibility"], H, W).reshape(-1, 256)
                    occ = act & (torch.amin(vb, dim=1) < 0.5)
                    occl.append(float(occ.sum()) / max(float(act.sum()), 1.0))
                served[vset, run] = dict(metrics=m, trace=t_launch, occluded=occl,
                                         pairs=[v["tracer_pairs"] for v in final],
                                         dropped=[v["mesh_cull_dropped"] for v in final])
                kinds_per_render = 1 if with_mesh else 2
                print(f"  {what}, {'with meshes/test_030000.ply (' + str(len(faces)) + ' triangles)' if with_mesh else 'without a mesh (splat visibility)'}: "
                      f"{wall:.1f} s for the eval call")
                print(f"    env-trace pairs per view: {served[vset, run]['pairs']}")
                print(f"    tracer overflow, worst served view: {m['tracer_overflow']}; renders redone at raised "
                      f"budgets: {m['tracer_redos']}; budgets at the end (cluster pairs, pairs): "
                      f"{m['tracer_budgets']}; mesh_cull_dropped per view: {served[vset, run]['dropped']}")
                print(f"    occluded share of the active bundles per view: {[round(x, 4) for x in occl]}")
                print(f"    trace launches: {t_launch} for {len(seen)} renders ({kinds_per_render} per render); "
                      f"rasterizer launches {r_launch}")
                print(f"    eval: {m['fps']:.3f} views/s end to end, psnr {m['psnr']:.3f} dB, ssim {m['ssim']:.5f}, "
                      f"rasterizer overflow {m['overflow']}")
                check(len(final) == N_VIEWS and len(m["per_view_psnr"]) == N_VIEWS, f"{what}: skipped views")
                check(len(seen) == N_VIEWS + m["tracer_redos"], f"{what}: renders and redos disagree")
                check(m["tracer_overflow"] == 0, f"{what}: tracer overflow")
                check(m["overflow"] == 0, f"{what}: rasterizer overflow")
                check(all(v == 0 for v in served[vset, run]["dropped"]), f"{what}: mesh pre-cull dropped clusters")
                check(all(v > 0 for v in served[vset, run]["pairs"]), f"{what}: a view traced no env pair")
                check(r_launch == len(seen), f"{what}: rasterizer launched {r_launch} times for {len(seen)} renders")
                check(t_launch == kinds_per_render * len(seen),
                      f"{what}: tracer launched {t_launch} times for {len(seen)} renders")
                check(math.isfinite(m["psnr"]) and math.isfinite(m["ssim"]), f"{what}: non-finite metrics")
                check(os.path.exists(os.path.join(s2_path, "eval_30000", "test", "visibility", "00000.png")),
                      f"{what}: visibility map not written")
                if with_mesh:
                    check(min(occl) > 0, f"{what}: no bundle is occluded by the mesh")
    finally:
        evaluate_mod.render_surfel2 = real_surfel2
    trace_launches = sum(s["trace"] for s in served.values())

    # ----------------------------------------------------------------- 11 --
    phase("11. tracer kernel at the served shapes; where a served env-GS view's time goes")
    mesh = mtr.build_mesh(verts, faces, device=dev)
    s2_opts = RenderOptions(raster=api.RasterizeConfig(pair_capacity=PAIR_CAPACITY))
    trace_times = {}

    def time_trace(what, targs, tkw):
        """The kernel against its plain version on one launch's inputs (every
        bundle), both times, and the bound counted from the plain version's
        outcomes."""
        n_sh = tkw["n_sh"]
        out_t = trace_fn(*targs, **tkw)
        torch.cuda.synchronize()
        work_t = {}
        # The plain version is timed in its comparison run (~40-75 s at a
        # ring view: it walks the longest segment's positions one at a time).
        res_t = {}
        p_ms = cuda_ms(torch, lambda: res_t.update(
            ref=trace_fwd.trace_bundles_fwd_plain(*targs, **tkw, work=work_t)), 1)
        err = compare_trace(np, out_t.cpu().numpy(), res_t.pop("ref").cpu().numpy(), what)
        walk_histogram(torch, targs[3], out_t[:, 0, 10], targs[0].shape[1], what)
        for _ in range(3):
            trace_fn(*targs, **tkw)
        k_ms = cuda_ms(torch, lambda: trace_fn(*targs, **tkw), 10)
        del out_t
        NBt = targs[1].shape[0]
        print(f"  {what}: {NBt} bundles, {int(targs[3].sum())} pairs in segments, "
              f"{int((targs[3] > 0).sum())} bundles with pairs, {int(targs[3].max() + 127) // 128} "
              f"chunks in the longest segment")
        pairs_read = work_t["hit_tests"] // 256
        b_bytes = 4 * ((13 + 3 * n_sh) * pairs_read + NBt * 256 * 8 + NBt * 256 * 16 + 2 * NBt + 1)
        b_flops = trace_flops(work_t, n_sh, tkw["exact_order"])
        tb_, to_ = b_bytes / PEAK_BYTES_PER_S * 1e3, b_flops / PEAK_FP32_FLOPS * 1e3
        trace_times[what] = dict(ms=k_ms, plain_ms=p_ms, bound=max(tb_, to_), err=err,
                                 by="bytes" if tb_ >= to_ else "operations")
        print(f"    {pairs_read} pairs in processed chunks; kernel ms per view: {k_ms:.4f}; plain version ms "
              f"(timed in its comparison run): {p_ms:.1f}")
        print(f"    bound ms: {max(tb_, to_):.4f} (by {trace_times[what]['by']}: {b_bytes / 1e6:.1f} MB -> {tb_:.4f} ms, "
              f"{b_flops / 1e9:.3f} GFLOP -> {to_:.4f} ms: {work_t['hit_tests']} hit tests, {work_t['hits']} hits, "
              f"{work_t['contribs']} composited, {work_t['sort_compares']:.0f} sort compares); "
              f"kernel at {100 * max(tb_, to_) / k_ms:.1f} % of it")

    # The close-up view holds each launch kind to its plain version (at a
    # ring view the plain walks take 10-19 s a launch kind).
    for vset in ("close",):
        cams = view_sets[vset][1]
        # The budgets the eval ended at for this view set.
        c_pairs, pairs_ = (max(served[vset, r]["metrics"]["tracer_budgets"][i] for r in "ab") for i in (0, 1))
        tr_cfg = tracer_api.TracerConfig(exact_order=True, pair_capacity=pairs_, cluster_pair_capacity=c_pairs)
        cam0 = cams[0]
        for run, kw, names in (("a", {}, ("env, no mesh (n_sh=16)", "visibility (n_sh=1)")),
                               ("b", {"mesh": mesh}, ("env, mesh-occluded bundles (n_sh=16)",))):
            cap = capture_trace(torch, tracer_api, lambda: envgs.render_surfel2(
                s2_model, env_model, cam0, white, mips, s2_opts, tr_cfg, **kw))
            check(len(cap) == len(names), f"{vset} view 0, run ({run}): {len(cap)} tracer launches")
            for name in names:
                targs, tkw = cap.pop(0)
                time_trace(f"{vset} view 0, {name}", targs, tkw)
                del targs
    print("  library call: none computes this function")

    for vset, (_, cams) in view_sets.items():
        c_pairs, pairs_ = (max(served[vset, r]["metrics"]["tracer_budgets"][i] for r in "ab") for i in (0, 1))
        tr_cfg = tracer_api.TracerConfig(exact_order=True, pair_capacity=pairs_, cluster_pair_capacity=c_pairs)
        cam0 = cams[0]
        for what, kw in (("splat visibility", {}), ("mesh visibility", {"mesh": mesh})):
            with torch.no_grad():
                envgs.render_surfel2(s2_model, env_model, cam0, white, mips, s2_opts, tr_cfg, **kw)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                walls = []
                for _ in range(3):
                    t1 = time.perf_counter()
                    pkg = envgs.render_surfel2(s2_model, env_model, cam0, white, mips, s2_opts, tr_cfg, **kw)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t1)
                check(pkg["tracer_overflow"] == 0, f"{vset} view 0, {what}: tracer overflow at the eval's budgets")
                del pkg
                peak = torch.cuda.max_memory_allocated() / 2**30
                with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                ) as prof:
                    t1 = time.perf_counter()
                    envgs.render_surfel2(s2_model, env_model, cam0, white, mips, s2_opts, tr_cfg, **kw)
                    torch.cuda.synchronize()
                    prof_ms = (time.perf_counter() - t1) * 1e3
            ev_ = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in ev_) / 1e3
            print(f"render_surfel2, {vset} view 0, {what}, 800x800, budgets ({c_pairs}, {pairs_}): "
                  f"{1e3 * float(np.median(walls)):.1f} ms per view (median of 3, host clock, synchronized); "
                  f"profiled {prof_ms:.1f} ms with {busy:.1f} ms of device kernels -> device busy "
                  f"{100 * busy / prof_ms:.1f} %; peak device memory {peak:.2f} GiB")
            print("  top device kernels (ms per view, launches per view):")
            for e in sorted(ev_, key=lambda e: -e.self_device_time_total)[:12]:
                print(f"  {e.self_device_time_total / 1e3:9.3f}  {e.count:5d}  {e.key[:90]}")
        with torch.no_grad():
            pkg = render_surfel(s2_model, cam0, white, mips, s2_opts)
            nmap = pkg["rend_normal"] / torch.clamp(pkg["rend_alpha"], min=1e-6)
            mv_args = (mesh, cam0, nmap, pkg["surf_depth"], pkg["rend_alpha"])
            mesh_visibility_map(*mv_args, cull_cap=tr_cfg.mesh_cull_cap)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                mesh_visibility_map(*mv_args, cull_cap=tr_cfg.mesh_cull_cap)
                torch.cuda.synchronize()
        mesh_dev = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"mesh tracer (mesh_visibility_map, {len(faces)} triangles, {vset} view 0): "
              f"{mesh_dev:.2f} ms of device kernels")

    # ----------------------------------------------------------------- 12 --
    phase("12. train refnerf surfel2 at full width through scripts/train_torch.py")
    from materialrefgs_torch.ops.tracer.api import TracerConfig

    start_dir = os.path.join(run_path, "point_cloud", f"iteration_{S2_FROM}")
    s2_run = os.path.join(work_dir, "surfel2_run")
    # --densify_until_iter 200: the main model neither densifies nor resets
    # past the onset here. The 50-step model's splats are wider than the
    # 20-pixel screen-size prune allows (phase 7 never met that prune: its
    # post-reset grace covered 31-60), so the prune at 205 removes 98 % of
    # them and the run then traces a near-empty model; the opacity reset at
    # 210 leaves nothing for the TSDF at 220. The env model's upkeep (densify
    # every 5, reset at 240) runs before that cut-off and is unaffected. The
    # main model's densify, prune and reset inside surfel2 are held on the
    # CPU (tests/test_torch_train_surfel2.py).
    s2_argv = ["-s", train_scene, "-m", s2_run, "--schedule_scale", "0.01", "--start_ply", start_dir,
               "--start_iter", str(S2_START), "--iterations", str(S2_END), "--capacity", str(1 << 19),
               "--pair_capacity", str(1 << 20), "--densify_until_iter", str(S2_START), "--mesh_every", "1000",
               "--log_every", "1", "--test_iterations", *map(str, S2_TEST_MARKS)]
    print("  python scripts/train_torch.py " + " ".join(s2_argv))
    torch.cuda.reset_peak_memory_stats()
    for fn in (kernel_fn, bwd_fn, trace_fn, trace_bwd_fn):
        fn.launches = 0  # counts of this path's run only
    t0 = time.perf_counter()
    s2_res = train_torch.main(s2_argv)
    torch.cuda.synchronize()
    s2_s = time.perf_counter() - t0
    s2_launches = {fn.__name__: fn.launches for fn in (kernel_fn, bwd_fn, trace_fn, trace_bwd_fn)}
    s2_peak = torch.cuda.max_memory_allocated() / 2**30
    s2_tr = s2_res["trainer"]
    s2_log = s2_tr.metrics_log
    n_s2 = S2_END - S2_START
    print(f"  {len(s2_log)} steps in {s2_s:.1f} s; peak device memory {s2_peak:.2f} GiB; kernel launches {s2_launches}")
    for it, n_tris, secs in s2_tr.mesh_log:
        print(f"  mesh extraction at iteration {it}: {n_tris} triangles, {secs:.2f} s")
    print("  env-trace pairs per step: " + " ".join(str(int(m["tracer_pairs"])) for m in s2_log))
    for m in s2_log:
        if m["iteration"] in (201, 202, 205, 206, 210, 220, 221, 230, 240) or m["renders_redone"] > 0:
            print(f"    it {m['iteration']:3d} {m['stage']:8s} loss {m['loss']:.5f} psnr {m['psnr']:.3f} n_alive "
                  f"{m['n_alive']} env_n_alive {m['env_n_alive']} tracer pairs {m['tracer_pairs']:.0f} "
                  f"(overflow redone {m['tracer_overflow_redone']:.0f}) renders redone {m['renders_redone']:.0f} "
                  f"|g_env| xyz {m['env_grad_xyz']:.2e} opacity {m['env_grad_opacity']:.2e} sh {m['env_grad_sh']:.2e}")
    s2_redo = sum(m["renders_redone"] for m in s2_log)
    s2_test = sum(TEST_VIEWS + s2_res["test"][k]["tracer_redos"] for k in S2_TEST_MARKS)
    print(f"  tracer budgets at the end: {s2_tr.tracer_cfg.cluster_pair_capacity} cluster pairs, "
          f"{s2_tr.tracer_cfg.pair_capacity} pairs, mesh_cull_cap {s2_tr.tracer_cfg.mesh_cull_cap}; "
          f"renders redone {s2_redo}; test renders {s2_test}")
    check([m["iteration"] for m in s2_log] == list(range(S2_START + 1, S2_END + 1)), "surfel2 run skipped iterations")
    check(all(m["stage"] == "surfel2" for m in s2_log), "a step of the surfel2 run is not surfel2")
    check(s2_launches["trace_bundles_bwd"] == n_s2,
          f"tracer backward launched {s2_launches['trace_bundles_bwd']} times in {n_s2} steps")
    check(s2_launches["trace_bundles_fwd"] == n_s2 + s2_redo + s2_test,
          f"tracer forward launched {s2_launches['trace_bundles_fwd']} times for {n_s2} steps + {s2_redo} redone "
          f"renders + {s2_test} test renders")
    check(all(n > 0 for n in s2_launches.values()), "a kernel of the surfel2 path never launched")
    check(all(m["overflow"] == 0 and m["tracer_overflow"] == 0 and m["mesh_cull_dropped"] == 0 for m in s2_log),
          "a surfel2 step was applied truncated")
    check(s2_log[-1]["env_n_alive"] > 0, "the env-GS cloud is empty at the end")
    for name, prm in list(s2_tr.state.params().items()) + [("env." + k, v) for k, v in s2_tr.state.env_params().items()]:
        check(bool(torch.isfinite(prm).all()), f"non-finite parameter {name} after the surfel2 run")
    check(all(m["env_grad_xyz"] > 0 and m["env_grad_opacity"] > 0 and m["env_grad_sh"] > 0 for m in s2_log),
          "an env-GS xyz, opacity or SH gradient was zero in a step")
    check(all(math.isfinite(m["loss"]) for m in s2_log), "non-finite surfel2 loss")
    for mark in S2_TEST_MARKS:
        mt = s2_res["test"][mark]
        print(f"  test psnr at {mark}: {mt['psnr']:.3f} dB over {len(mt['per_view_psnr'])} views "
              f"(tracer renders redone {mt['tracer_redos']})")
        check(math.isfinite(mt["psnr"]) and mt["tracer_overflow"] == 0, f"surfel2 test render at {mark} failed")
    s2_dir = os.path.dirname(s2_res["ply"])
    check(os.path.exists(os.path.join(s2_dir, "env_point_cloud.ply")), "no env_point_cloud.ply saved")
    check(len(os.listdir(os.path.join(s2_run, "meshes"))) == len(s2_tr.mesh_log), "mesh PLYs missing")
    ev2 = eval_torch.main(["-m", s2_run, "-s", train_scene, "--skip_train"])["test"]
    print(f"  saved surfel2 checkpoint through scripts/eval_torch.py: psnr {ev2['psnr']:.3f} dB, ssim "
          f"{ev2['ssim']:.5f}, {ev2['fps']:.2f} views/s, tracer overflow {ev2['tracer_overflow']}, "
          f"renders redone {ev2['tracer_redos']}")
    check(math.isfinite(ev2["psnr"]) and len(ev2["per_view_psnr"]) == TEST_VIEWS and ev2["tracer_overflow"] == 0,
          "eval of the surfel2 checkpoint failed")
    s2_wall = sorted(b["wall"] - a["wall"] for a, b in zip(s2_log, s2_log[1:]) if b["renders_redone"] == 0)
    print(f"  host s/step during the run (median of the steps without a redo): {s2_wall[len(s2_wall) // 2]:.3f}")

    # ----------------------------------------------------------------- 13 --
    phase("13. learning check: 30 full-width surfel2 steps, densification, resets and re-extraction off")
    _, s2pipe, s2opt = cfg.preset_refnerf()
    s2opt = dataclasses.replace(cfg.scale_schedule(s2opt, 0.01), densify_from_iter=10**9,
                                opacity_reset_interval=10**9, normal_prop_interval=10**9,
                                env_densify_interval=10**9, env_reset_interval=10**9)
    lmodel2, le1, le2 = gaussian_io.load_ply(os.path.join(start_dir, "point_cloud.ply"), capacity=1 << 19,
                                             max_sh_degree=3, device=dev)
    ltr2 = Trainer(lmodel2, tscene.train_cameras, [tscene.train_image(i) for i in range(TRAIN_VIEWS)], s2opt,
                   s2pipe, cameras_extent=tscene.cameras_extent, bg_color=(1.0, 1.0, 1.0),
                   raster_cfg=RasterizeConfig(pair_capacity=1 << 20), envmap_res=mp.envmap_max_res,
                   masks=train_torch.load_masks(os.path.join(train_scene, "train"), tscene.info.train_cameras,
                                                (TRAIN_H, TRAIN_W)),
                   envmap_min_roughness=mp.envmap_min_roughness, envmap_max_roughness=mp.envmap_max_roughness,
                   tracer_cfg=TracerConfig(pair_capacity=1 << 20, cluster_pair_capacity=1 << 13, mesh_cull_cap=512,
                                           exact_order=True),
                   mesh_every=10**9)
    with torch.no_grad():
        ltr2.state.env1.base.copy_(le1.base)
        ltr2.state.env2.base.copy_(le2.base)
    ltr2.state.step = S2_START
    # The onset mesh is phase 12's (the same PLY, views and renders give the
    # same TSDF): read and decimated as the Trainer does, not extracted again.
    from materialrefgs_torch.train.mesh_extract import decimate_vertex_clustering, read_mesh_ply

    mv, mf = read_mesh_ply(os.path.join(s2_run, "meshes", f"test_{S2_START + 1:06d}.ply"))
    if len(mf) > Trainer.MESH_TRI_CAPACITY:
        mv, mf = decimate_vertex_clustering(mv, mf, Trainer.MESH_TRI_CAPACITY)
    ltr2.mesh = mtr.build_mesh(mv, mf, device=dev)
    t0 = time.perf_counter()
    ltr2.train(30, start_iter=S2_START + 1, log_every=1)
    psnrs2 = [m["psnr"] for m in ltr2.metrics_log]
    first5, last5 = float(np.mean(psnrs2[:5])), float(np.mean(psnrs2[-5:]))
    print(f"  train PSNR: first 5 steps {first5:.3f} dB, last 5 steps {last5:.3f} dB (+{last5 - first5:.3f} dB) "
          f"in {time.perf_counter() - t0:.1f} s; env_n_alive {ltr2.metrics_log[-1]['env_n_alive']}")
    check(last5 >= first5 + 0.3, "surfel2 training did not raise the train PSNR by 0.3 dB")

    # ----------------------------------------------------------------- 14 --
    phase("14. tracer backward kernel at a training step's inputs; a surfel2 training step")
    from materialrefgs_torch.ops.tracer import api as tapi_mod

    step_cap = []
    real_bwd = tapi_mod.trace_bundles_bwd

    def capturing_bwd(payload, rays, seg_start, seg_count, seg_active, fwd_out, cot, **kw):
        used = payload[:, : int(seg_start[-1]) + 128].clone()
        step_cap.append(((used, rays.clone(), seg_start.clone(), seg_count.clone(), seg_active.clone(),
                          fwd_out.clone(), cot.clone()), dict(kw)))
        return real_bwd(payload, rays, seg_start, seg_count, seg_active, fwd_out, cot, **kw)

    # One more Trainer step, under torch.profiler, whose tracer backward
    # inputs are captured (the capture's copies of them are inside the
    # profiled step).
    it_next = S2_START + 31
    tapi_mod.trace_bundles_bwd = capturing_bwd
    torch.cuda.reset_peak_memory_stats()
    step_walls = []
    try:
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            cap_iii = capture_raster(torch, api, lambda: step_walls.extend(time_steps(ltr2, "surfel2", it_next, 1)))
        prof_ms = 1e3 * step_walls[0]
    finally:
        tapi_mod.trace_bundles_bwd = real_bwd
    peak2 = torch.cuda.max_memory_allocated() / 2**30
    check(len(step_cap) == 1, f"one training step launched the tracer backward {len(step_cap)} times")
    tr_iii = tracer_at(np, torch, step_cap[0], f"training step {it_next}")
    s_ms, s_plain_ms, s_bound, s_by, s_bwd_err = (tr_iii["bwd"][k] for k in ("ms", "plain_ms", "bound", "by", "err"))
    f_ms, f_plain_ms, f_bound, f_by, f_err = (tr_iii["fwd"][k] for k in ("ms", "plain_ms", "bound", "by", "err"))
    del step_cap
    check(len(cap_iii) == 1, f"one surfel2 step launched the rasterizer backward {len(cap_iii)} times")
    raster_iii = raster_at(np, torch, f"input (iii), surfel2 training step {it_next}", cap_iii[0])
    del cap_iii

    # Host time per step: the learning check's steps (the Trainer's log
    # stamps each step's end), without its first.
    walls2 = sorted(b["wall"] - a["wall"] for a, b in zip(ltr2.metrics_log[1:], ltr2.metrics_log[2:]))
    ev_ = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev_) / 1e3
    print(f"training step, surfel2, 800x800, {int(ltr2.state.model.n_alive)} splats + "
          f"{int(ltr2.state.env_gs.n_alive)} env splats, tracer budgets ({ltr2.tracer_cfg.cluster_pair_capacity}, "
          f"{ltr2.tracer_cfg.pair_capacity}): {walls2[len(walls2) // 2]:.4f} s/step (median of the learning "
          f"check's steps 203-230, host clock; min {walls2[0]:.4f}, max {walls2[-1]:.4f}); profiled {prof_ms:.2f} "
          f"ms for step {it_next} with {busy:.2f} ms of device kernels -> device busy {100 * busy / prof_ms:.1f} %; "
          f"peak device memory {peak2:.2f} GiB")
    print("  top device kernels (ms per step, launches per step):")
    for e in sorted(ev_, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f}  {e.count:5d}  {e.key[:90]}")
    with torch.no_grad():
        mips2 = EnvLightMips.build(ltr2.state.env1, min_roughness=mp.envmap_min_roughness,
                                   max_roughness=mp.envmap_max_roughness)
        pkg = render_surfel(ltr2.state.model, ltr2.cameras[0], white, mips2, opts)
        nmap = pkg["rend_normal"] / torch.clamp(pkg["rend_alpha"], min=1e-6)
        mv_args = (ltr2.mesh, ltr2.cameras[0], nmap, pkg["surf_depth"], pkg["rend_alpha"])
        mesh_visibility_map(*mv_args, cull_cap=ltr2.tracer_cfg.mesh_cull_cap)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mesh_visibility_map(*mv_args, cull_cap=ltr2.tracer_cfg.mesh_cull_cap)
            torch.cuda.synchronize()
    mesh_dev2 = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"mesh tracer in the surfel2 step (mesh_visibility_map, {int(ltr2.mesh.valid.sum())} triangles, train "
          f"view 0): {mesh_dev2:.2f} ms of device kernels")

    # ----------------------------------------------------------------- 15 --
    phase("15. train refnerf across the warp gate at full width through scripts/train_torch.py")
    # Phase 7's 8 views are 1.76 apart, past multi_view_max_dis (1.5): no
    # view there has a neighbour. This scene puts WARP_VIEWS views 15 deg
    # apart on the same ring (0.89-1.07 apart), with ground truth and masks
    # rendered from phase 4's model as phase 7's are, and camera-space
    # normal priors from the same renders (Metric3D's layout: v/255*2-1).
    warp_scene = os.path.join(work_dir, "warp_scene")
    priors_dir = os.path.join(work_dir, "warp_normals")
    os.makedirs(os.path.join(warp_scene, "train"))
    os.makedirs(priors_dir)
    wviews = ring_views(np, WARP_VIEWS, radius=3.4)
    for split, mats in (("train", wviews), ("test", wviews[:1])):
        frames = [{"file_path": f"./train/r_{i}", "transform_matrix": m.tolist()} for i, m in enumerate(mats)]
        with open(os.path.join(warp_scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    for i in range(WARP_VIEWS):
        png.write_png(os.path.join(warp_scene, "train", f"r_{i}.png"), np.zeros((TRAIN_H, TRAIN_W, 4), np.uint8))
    wscene = Scene.load(dataclasses.replace(mp, source_path=warp_scene), device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i, cam in enumerate(wscene.train_cameras):
            pkg = render_surfel(model, cam, white, mips, opts)
            check(int(pkg["overflow"]) == 0, f"warp scene GT view {i} overflows")
            rgba = torch.cat([pkg["render"], pkg["rend_alpha"]], dim=-1)
            png.write_png(os.path.join(warp_scene, "train", f"r_{i}.png"),
                          (np.clip(rgba.cpu().numpy(), 0, 1) * 255 + 0.5).astype(np.uint8))
            n_cam = pkg["rend_normal"] @ cam.world_view[:3, :3]
            n_cam = n_cam / torch.clamp(n_cam.norm(dim=-1, keepdim=True), min=1e-6)
            n_cam = torch.where(pkg["rend_alpha"] > 0.5, n_cam, n_cam.new_tensor([0.0, 0.0, -1.0]))
            png.write_png(os.path.join(priors_dir, f"r_{i}.png"),
                          (np.clip((n_cam.cpu().numpy() + 1) / 2, 0, 1) * 255 + 0.5).astype(np.uint8))
    n_nbr = [len(n) for n in wscene.nearest_ids]
    print(f"  {WARP_VIEWS} train views 15 deg apart at {TRAIN_W}x{TRAIN_H} (RGBA) and their normal priors written in "
          f"{time.perf_counter() - t0:.1f} s; neighbours per view: {n_nbr}")
    check(all(n > 0 for n in n_nbr), "a train view of the warp scene has no neighbour")

    # (a) refnerf as users run it, across the gate (25000 x 0.01 = 250):
    # phase 12's checkpoint (main + env PLY) on this scene, the onset's env
    # init skipped (the env PLY), mesh extracted at 241, 20 surfel2 steps.
    # Cuts: phase 12's (the main model's densify and resets off past 240),
    # and --mesh_every 1000: no re-extraction in the run (each TSDF over the
    # 24 views costs about as much as 30 steps); the onset's TSDF at
    # WARP_MESH_RES^3.
    a_run = os.path.join(work_dir, "warp_run_a")
    a_start = os.path.dirname(s2_res["ply"])  # phase 12's iteration_240: point_cloud.ply + env_point_cloud.ply
    a_argv = ["-s", warp_scene, "-m", a_run, "--schedule_scale", "0.01", "--start_ply", a_start,
              "--start_iter", str(S2_END), "--iterations", str(WARP_A_END), "--capacity", str(1 << 19),
              "--pair_capacity", str(1 << 20), "--densify_until_iter", str(S2_END), "--mesh_every", "1000",
              "--log_every", "1"]
    print("  (a) python scripts/train_torch.py " + " ".join(a_argv))
    torch.cuda.reset_peak_memory_stats()
    warp_fns = (kernel_fn, bwd_fn, trace_fn, trace_bwd_fn, ws.warp_sample_fwd, ws.warp_sample_bwd)
    for fn in warp_fns:
        fn.launches = 0  # counts of this path's run only
    mesh_res = Trainer.MESH_RESOLUTION
    Trainer.MESH_RESOLUTION = WARP_MESH_RES
    t0 = time.perf_counter()
    try:
        a_res = train_torch.main(a_argv)
    finally:
        Trainer.MESH_RESOLUTION = mesh_res
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    a_launches = {fn.__name__: fn.launches for fn in warp_fns}
    a_peak = torch.cuda.max_memory_allocated() / 2**30
    a_tr = a_res["trainer"]
    a_log = a_tr.metrics_log
    gate = WARP_GATE
    for prev, m in zip([None] + a_log[:-1], a_log):
        step_s = m["wall"] - prev["wall"] if prev else float("nan")  # the first includes the onset
        print(f"    it {m['iteration']:3d} {m['stage']:8s} warp_on {m['warp_on']} neighbour {int(m['warp_near']):3d} "
              f"loss_warp_bc {m.get('loss_warp_bc', float('nan')):.6f} loss {m['loss']:.5f} psnr {m['psnr']:.3f} "
              f"tracer pairs {m['tracer_pairs']:.0f} renders redone {m['renders_redone']:.0f} s/step {step_s:.4f}")
    n_a = WARP_A_END - S2_END
    n_warp = sum(m["warp_on"] for m in a_log)
    a_redo = sum(m["renders_redone"] for m in a_log)
    print(f"  (a) {len(a_log)} steps in {a_s:.1f} s; peak device memory {a_peak:.2f} GiB; kernel launches {a_launches}; "
          f"mesh extractions {[(it, n, round(s, 1)) for it, n, s in a_tr.mesh_log]}")
    check([m["iteration"] for m in a_log] == list(range(S2_END + 1, WARP_A_END + 1)), "(a) skipped iterations")
    check(all(m["stage"] == "surfel2" for m in a_log), "a step of (a) is not surfel2")
    check(all(m["warp_on"] == int(m["iteration"] > gate) for m in a_log),
          f"(a): the warp did not run on exactly the steps past {gate}")
    check(all(m["warp_near"] >= 0 and math.isfinite(m["loss_warp_bc"]) and m["loss_warp_bc"] > 0
              for m in a_log if m["iteration"] > gate), "(a): a step past the gate had no finite, non-zero loss_warp_bc")
    check(all(m["overflow"] == 0 and m.get("nearest_overflow", 0) == 0 and m["tracer_overflow"] == 0
              and m["mesh_cull_dropped"] == 0 for m in a_log), "(a): a step was applied truncated")
    check(all(math.isfinite(m["loss"]) for m in a_log), "(a): non-finite loss")
    for name, prm in list(a_tr.state.params().items()) + [("env." + k, v) for k, v in a_tr.state.env_params().items()]:
        check(bool(torch.isfinite(prm).all()), f"non-finite parameter {name} after (a)")
    check(a_launches["rasterize_tiles_bwd"] == n_a + n_warp,
          f"rasterizer backward launched {a_launches['rasterize_tiles_bwd']} times for {n_a} steps, {n_warp} with a "
          "nearest render")
    check(a_launches["trace_bundles_bwd"] == n_a, f"tracer backward launched {a_launches['trace_bundles_bwd']} times")
    check(a_launches["trace_bundles_fwd"] == n_a + a_redo, f"tracer forward launched {a_launches['trace_bundles_fwd']} "
          f"times for {n_a} steps + {a_redo} redone renders")
    check(all(n > 0 for n in a_launches.values()), "a kernel of the warp path never launched")
    ws_step = warp_launches_per_step(a_tr.opt)
    check((a_launches["warp_sample_fwd"], a_launches["warp_sample_bwd"]) == (ws_step[0] * n_warp, ws_step[1] * n_warp),
          f"the warp sampler launched {a_launches['warp_sample_fwd']} gathers and {a_launches['warp_sample_bwd']} "
          f"splats in {n_warp} warp steps, expected {ws_step} a step")
    a_wall = [(b["iteration"], b["wall"] - a["wall"]) for a, b in zip(a_log, a_log[1:]) if b["renders_redone"] == 0]
    before = sorted(w for it, w in a_wall if it <= gate)
    after = sorted(w for it, w in a_wall if it > gate + 1)
    a_before, a_after = before[len(before) // 2], after[len(after) // 2]
    print(f"  (a) host s/step, median of the steps without a redo: before the gate {a_before:.4f} "
          f"({len(before)} steps), past it {a_after:.4f} ({len(after)} steps): the warp adds {a_after - a_before:.4f}")

    # The warp's cost as a pair. (a)'s steps run on different views, whose
    # env-trace demand moves a step by more than the warp does, so here each
    # of two views takes a `surfel2` step past the gate with the warp off and
    # on, alternating, against the same neighbour and pixel scores, each from
    # the same snapshot of (a)'s final state (restored outside the timing):
    # host s/step and peak memory per step; then one profiled step of each
    # kind per view (device-busy share, top kernels, the rasterizer's
    # launches).
    snap = copy.deepcopy(a_tr.state)
    pair_it = WARP_A_END + 1
    pair_rounds = 2

    def paired_step(cam_id, near_id, warp_on, profile=False):
        a_tr.state = copy.deepcopy(snap)
        extra = a_tr._build_extra(pair_it, cam_id)
        cam = a_tr.cameras[cam_id]
        if warp_on:
            extra.update(nearest_camera=a_tr.cameras[near_id], nearest_gt=a_tr.images[near_id],
                         warp_photo_weight=1.0,
                         warp_uniforms=torch.rand(cam.height * cam.width, device=dev,
                                                  generator=torch.Generator(device=dev).manual_seed(cam_id)))
        step = a_tr._step_fn("surfel2", warp_on)
        l0 = (kernel_fn.launches, bwd_fn.launches)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) if profile else contextlib.nullcontext()
        with ctx as prof:
            t1 = time.perf_counter()
            rendered = step.render(a_tr.state, cam, extra, a_tr.mesh)
            pkg = rendered[0]
            over = int(pkg["overflow"]) + int(pkg["nearest_pkg"]["overflow"] if warp_on else 0)
            over += int(pkg["tracer_overflow"]) + int(pkg["mesh_cull_dropped"])
            met = step.update(a_tr.state, cam, a_tr.images[cam_id], extra, rendered)
            float(met["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        check(over == 0, f"a paired step (view {cam_id}, warp {warp_on}) overflowed")
        check(math.isfinite(float(met["loss"])) and (not warp_on or float(met["loss_warp_bc"]) > 0),
              f"a paired step (view {cam_id}, warp {warp_on}) has no finite loss or base-colour term")
        out = dict(wall_ms=1e3 * wall, peak=torch.cuda.max_memory_allocated() / 2**30, resident=resident,
                   fwd=kernel_fn.launches - l0[0], bwd=bwd_fn.launches - l0[1], pairs=int(met["tracer_pairs"]))
        if profile:
            ev_ = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            out["busy_ms"] = sum(e.self_device_time_total for e in ev_) / 1e3
            out["top"] = [(e.self_device_time_total / 1e3, e.count, e.key[:90])
                          for e in sorted(ev_, key=lambda e: -e.self_device_time_total)[:10]]
        return out

    pair_views = (0, WARP_VIEWS // 2)
    pairs = {}
    for cam_id in pair_views:
        near_id = int(a_tr.nearest_ids[cam_id][0])
        # Warm-up: the Trainer's own steps on the view and on its neighbour
        # raise, through their redo path, any budget the two renders need.
        a_tr._order = [near_id, cam_id]
        for _ in range(2):
            a_tr._run_step(pair_it, "surfel2")
        for w in (False, True):
            paired_step(cam_id, near_id, w)
        rounds = [[paired_step(cam_id, near_id, w) for w in (False, True)] for _ in range(pair_rounds)]
        prof_off, prof_on = (paired_step(cam_id, near_id, w, profile=True) for w in (False, True))
        off = sorted(r[0]["wall_ms"] for r in rounds)
        on = sorted(r[1]["wall_ms"] for r in rounds)
        diffs = sorted(r[1]["wall_ms"] - r[0]["wall_ms"] for r in rounds)
        pk_off = max(r[0]["peak"] for r in rounds)
        pk_on = max(r[1]["peak"] for r in rounds)
        pairs[cam_id] = dict(near=near_id, off=off, on=on, diffs=diffs, pk_off=pk_off, pk_on=pk_on,
                             resident=rounds[0][0]["resident"], prof_off=prof_off, prof_on=prof_on,
                             pairs=rounds[0][0]["pairs"])
        print(f"  paired surfel2 steps (iteration {pair_it}) on view {cam_id}, neighbour {near_id}, "
              f"{rounds[0][0]['pairs']} env-trace pairs; host ms per step, off/on alternating, "
              f"{pair_rounds} rounds: off {[round(x, 2) for x in off]}, on {[round(x, 2) for x in on]}; "
              f"on - off per round {[round(x, 2) for x in diffs]} (median {diffs[len(diffs) // 2]:.2f}); "
              f"peak device memory off {pk_off:.3f} GiB, on {pk_on:.3f} GiB (+{pk_on - pk_off:.3f}) over "
              f"{rounds[0][0]['resident']:.3f} GiB resident")
        for label, w in (("warp off", prof_off), ("warp on", prof_on)):
            print(f"    profiled ({label}): {w['wall_ms']:.2f} ms with {w['busy_ms']:.2f} ms of device kernels -> "
                  f"device busy {100 * w['busy_ms'] / w['wall_ms']:.1f} %; rasterizer launches forward {w['fwd']}, "
                  f"backward {w['bwd']}")
            print("    top device kernels (ms per step, launches per step):")
            for t, n, key in w["top"]:
                print(f"    {t:9.3f}  {n:5d}  {key}")
        check((prof_on["fwd"], prof_on["bwd"]) == (2, 2) and (prof_off["fwd"], prof_off["bwd"]) == (1, 1),
              f"rasterizer launches per paired step: off {prof_off['fwd']}+{prof_off['bwd']}, "
              f"on {prof_on['fwd']}+{prof_on['bwd']}")
    # The warp sampler's kernels at a paired warp step's calls (view 0).
    wcap = capture_warp(torch, lambda: paired_step(pair_views[0], pairs[pair_views[0]]["near"], True))
    check(len(wcap) == ws_step[1], f"the captured warp step made {len(wcap)} sampler backward calls, not {ws_step[1]}")
    warp_a = warp_sample_at(np, torch, wcap, f"phase 15's paired warp step (view {pair_views[0]})")
    del wcap
    a_tr.state = snap
    del snap
    pair_host = sorted(d for v in pairs.values() for d in v["diffs"])
    pair_dev = [v["prof_on"]["busy_ms"] - v["prof_off"]["busy_ms"] for v in pairs.values()]
    pair_peak = [v["pk_on"] - v["pk_off"] for v in pairs.values()]
    pair_busy = {cid: (100 * v["prof_off"]["busy_ms"] / v["prof_off"]["wall_ms"],
                       100 * v["prof_on"]["busy_ms"] / v["prof_on"]["wall_ms"]) for cid, v in pairs.items()}

    # (b) every term, briefly: 10 `surfel` steps from phase 7's iteration-50
    # PLY with the geo and NCC terms, the metallic/roughness warps and
    # virtual cameras, the normal priors (normal_gamma 1 at 51-60), and the
    # masks mined at 55 at full width (the ref-score loss then runs 56-60).
    # Cut: --opacity_reset_interval 1000, so no opacity reset and no
    # 20-pixel screen-size prune (phase 12's reason: this model's splats are
    # wider); densify keeps running (densify_until_iter stays 300, which
    # keeps normal_gamma at 1).
    b_run = os.path.join(work_dir, "warp_run_b")
    b_argv = ["-s", warp_scene, "-m", b_run, "--schedule_scale", "0.01", "--start_ply", start_dir,
              "--start_iter", str(S2_FROM), "--iterations", str(S2_FROM + 10), "--capacity", str(1 << 19),
              "--pair_capacity", str(1 << 20), "--opacity_reset_interval", "1000", "--log_every", "1",
              "--use_warp_geo_loss", "--use_warp_ncc_loss",
              "--use_metallic_warp_loss", "--use_roughness_warp_loss", "--use_virtul_cam",
              "--multi_view_weight_from_iter", str(S2_FROM), "--basecolor_warp_from_iter", str(S2_FROM),
              "--rghmtl_warp_loss_start_iter", str(S2_FROM), "--metric3d_path", priors_dir,
              "--ref_score_path", "auto", "--ref_score_start_iter", str(S2_FROM + 5)]
    print("  (b) python scripts/train_torch.py " + " ".join(b_argv))
    t0 = time.perf_counter()
    b_res = train_torch.main(b_argv)
    torch.cuda.synchronize()
    b_s = time.perf_counter() - t0
    b_tr = b_res["trainer"]
    b_log = b_tr.metrics_log
    b_keys = WARP_TERMS + ("loss_mono_normal", "loss_ref_score")
    for m in b_log:
        print(f"    it {m['iteration']:3d} {m['stage']:7s} neighbour {int(m['warp_near']):3d} "
              + " ".join(f"{k[5:]} {m.get(k, float('nan')):.3e}" for k in b_keys) + f" loss {m['loss']:.5f}")
    n_virtual = sum(m["warp_on"] and m["warp_near"] < 0 for m in b_log)
    print(f"  (b) {len(b_log)} steps in {b_s:.1f} s; virtual-camera steps {n_virtual}"
          + ("" if n_virtual else " (the rng drew none)"))
    check([m["iteration"] for m in b_log] == list(range(S2_FROM + 1, S2_FROM + 11)), "(b) skipped iterations")
    check(all(m["warp_on"] == 1 for m in b_log), "(b): a step did not run the warp")
    for k in b_keys:
        check(all(math.isfinite(m[k]) for m in b_log if k in m), f"(b): non-finite {k}")
        check(any(m.get(k, 0.0) != 0.0 for m in b_log), f"(b): {k} was zero on every step")
    check(all(m["overflow"] == 0 and m["nearest_overflow"] == 0 for m in b_log), "(b): a step was applied truncated")
    check(len(b_tr.ref_score_log) == 1, "(b): the masks were not mined once")
    mine_s, coverage = b_tr.ref_score_log[0]
    print(f"  mine_ref_scores at full width: {mine_s:.2f} s for {WARP_VIEWS} views; the masks cover "
          f"{100 * coverage:.2f} % of the pixels")
    print(f"warp path (phase 15, {smi_line}): (a) host s/step before the gate {a_before:.4f}, past it {a_after:.4f} "
          f"(different views); paired on views {list(pairs)}: the warp adds host ms per step "
          f"{[round(x, 2) for x in pair_host]} (median {pair_host[len(pair_host) // 2]:.2f}), device ms "
          f"{[round(x, 2) for x in pair_dev]}, peak GiB {[round(x, 3) for x in pair_peak]}; busy % off/on "
          f"{ {k: (round(a, 1), round(b, 1)) for k, (a, b) in pair_busy.items()} }; rasterizer launches per warp step "
          f"forward 2, backward 2; mine_ref_scores {mine_s:.2f} s")

    # ----------------------------------------------------------------- 16 --
    phase("16. train and serve refreal (COLMAP, -r 4, LPIPS) at full width through scripts/train_torch.py")
    real = refreal_phase(np, torch, dev, smi_line, model, mips, work_dir, train_torch, eval_torch)
    rr_, rt_ = real["raster"], real["trace"]

    # ----------------------------------------------------------------- 17 --
    phase("17. mesh-shaded indirect, ASG and the material outputs at full width")
    p17 = mesh_shading_phase(np, torch, dev, smi_line, {
        "train_scene": train_scene, "tscene": tscene, "start_dir": start_dir, "serve_model": model_path,
        "serve_scene": scene_path, "work_dir": work_dir, "eval_torch": eval_torch, "train_torch": train_torch,
    })
    # ----------------------------------------------------------------- 18 --
    phase("18. the JPEG decoder and the native COLMAP parse")
    p18 = jpeg_phase(np, torch, dev, smi_line, work_dir, real["sparse"])
    jp = real["jpeg"]
    # ----------------------------------------------------------------- 19 --
    phase("19. data parallelism: --dp 1 over NCCL, two ranks on the card over gloo, tile-sharded rendering")
    dp_launches, dp_block = dp_phase(np, torch, dev, smi_line, work_dir, train_torch, ply)
    # ----------------------------------------------------------------- 20 --
    phase("20. the volume stage at glossy's preset: train and serve at full width")
    p20 = volume_phase(np, torch, dev, smi_line, {
        "warp_scene": warp_scene, "priors_dir": priors_dir, "work_dir": work_dir, "train_torch": train_torch,
        "eval_torch": eval_torch, "start_dir": start_dir,
    })
    rv_ = p20["raster"]

    # The rasterizer rows count the main paths' launches: refreal's run
    # (phase 16 (b)), phase 17's residual and ASG runs, phase 19 (a)'s --dp 1
    # run and phase 20's volume run; the tracer rows refreal's and --dp 1's.
    raster_launches = {k: real["launches"][k] + p17["a_launches"][k] + p17["b_launches"][k] + dp_launches[k]
                       + p20["launches"][k] for k in ("rasterize_tiles_fwd", "rasterize_tiles_bwd")}
    # The warp sampler's rows: the launches of the three warp runs whose
    # counts are checked (phase 15 (a), phase 16 (b), phase 20), times and
    # bounds at phase 15's paired step (refnerf's base colour, 800x800x3).
    rw_ = real["warp"]
    warp_launches = {k: a_launches[k] + real["launches"][k] + p20["launches"][k]
                     for k in ("warp_sample_fwd", "warp_sample_bwd")}

    record = {"kernels": [
        {
            "name": "rasterize_tiles_fwd",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/rasterize_fwd.cu",
            "replaces": "materialrefgs_tpu/ops/rasterize/pallas_fwd.py:363",
            "launches": raster_launches["rasterize_tiles_fwd"],
            "max_abs_err": max(full_err, raster_iii["fwd"]["err"], rr_["fwd"]["err"], dp_block["fwd"]["err"],
                               rv_["fwd"]["err"]),
            "ms": rr_["fwd"]["ms"],
            "plain_ms": rr_["fwd"]["plain_ms"],
            "bound_ms": rr_["fwd"]["bound"],
            "bound_by": rr_["fwd"]["by"],
            "library_ms": None,
        },
        {
            "name": "rasterize_tiles_bwd",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/rasterize_bwd.cu",
            "replaces": "materialrefgs_tpu/ops/rasterize/pallas_bwd.py:385",
            "launches": raster_launches["rasterize_tiles_bwd"],
            "max_abs_err": max(bwd_err, raster_iii["bwd"]["err"], rr_["bwd"]["err"], dp_block["bwd"]["err"],
                               rv_["bwd"]["err"]),
            "ms": rr_["bwd"]["ms"],
            "plain_ms": rr_["bwd"]["plain_ms"],
            "bound_ms": rr_["bwd"]["bound"],
            "bound_by": rr_["bwd"]["by"],
            "library_ms": None,
        },
        {
            "name": "trace_bundles_fwd",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/trace_fwd.cu",
            "replaces": "materialrefgs_tpu/ops/tracer/pallas_kernels.py:348",
            "launches": real["launches"]["trace_bundles_fwd"] + dp_launches["trace_bundles_fwd"],
            "max_abs_err": max([t["err"] for t in trace_times.values()] + [f_err, rt_["fwd"]["err"]]),
            "ms": rt_["fwd"]["ms"],
            "plain_ms": rt_["fwd"]["plain_ms"],
            "bound_ms": rt_["fwd"]["bound"],
            "bound_by": rt_["fwd"]["by"],
            "library_ms": None,
        },
        {
            "name": "trace_bundles_bwd",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/trace_bwd.cu",
            "replaces": "materialrefgs_tpu/ops/tracer/pallas_kernels.py:586",
            "launches": real["launches"]["trace_bundles_bwd"] + dp_launches["trace_bundles_bwd"],
            "max_abs_err": max(tbwd_errs + [s_bwd_err, rt_["bwd"]["err"]]),
            "ms": rt_["bwd"]["ms"],
            "plain_ms": rt_["bwd"]["plain_ms"],
            "bound_ms": rt_["bwd"]["bound"],
            "bound_by": rt_["bwd"]["by"],
            "library_ms": None,
        },
        {
            "name": "idct_color",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/jpeg_idct.cu",
            "replaces": "materialrefgs_tpu/data/readers.py:52",
            "launches": real["launches"]["idct_color"],
            "max_abs_err": max(jp["err"], p18["tex"]["err"]),
            "ms": jp["ms"],
            "plain_ms": jp["plain_ms"],
            "bound_ms": jp["bound"],
            "bound_by": jp["by"],
            "library_ms": None,
        },
    ] + [
        {
            "name": f"warp_sample_{k}",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/warp_sample.cu",
            "replaces": "materialrefgs_tpu/train/warp.py:24",
            "launches": warp_launches[f"warp_sample_{k}"],
            "max_abs_err": max(warp_a[k]["err"], rw_[k]["err"]),
            "ms": warp_a[k]["ms"],
            "plain_ms": warp_a[k]["plain_ms"],
            "bound_ms": warp_a[k]["bound"],
            "bound_by": "bytes",
            "library_ms": None,
        } for k in ("fwd", "bwd")
    ]}
    print(f"serve path launches: forward {launches}; training path launches: forward {train_fwd}, "
          f"backward {train_bwd}; env-GS serve path launches: tracer {trace_launches} ("
          + ", ".join(f"{v} views run ({r}): {s['trace']}" for (v, r), s in served.items())
          + f"); surfel2 training path launches: {s2_launches}; warp path (phase 15 (a)) launches: {a_launches}; "
          f"refreal path (phase 16 (b)) launches: {real['launches']}; residual path (phase 17 (a)) launches: "
          f"{p17['a_launches']}; ASG path (phase 17 (b)) launches: {p17['b_launches']}; --dp 1 path (phase 19 (a)) "
          f"launches: {dp_launches}; volume path (phase 20) launches: {p20['launches']}")
    print(f"rasterizer forward: input (i) {ms:.4f} ms (bound {bound_ms:.4f}, plain {plain_ms:.1f}); (iii) "
          f"{raster_iii['fwd']['ms']:.4f} ms (bound {raster_iii['fwd']['bound']:.4f}, plain "
          f"{raster_iii['fwd']['plain_ms']:.1f}); bit-identical at both")
    print(f"rasterizer backward: input (i) {bwd_times[9]['ms']:.4f} ms (bound {bwd_times[9]['bound']:.4f}, plain "
          f"{plain_bwd_ms:.1f}, largest err/tol {bwd_ratio:.3e}); (iii) {raster_iii['bwd']['ms']:.4f} ms (bound "
          f"{raster_iii['bwd']['bound']:.4f}, plain {raster_iii['bwd']['plain_ms']:.1f}, largest err/tol "
          f"{raster_iii['bwd']['ratio']:.3e})")
    print(f"rasterizer at a volume step (phase 20, S=5): forward {rv_['fwd']['ms']:.4f} ms (bound "
          f"{rv_['fwd']['bound']:.4f}, plain {rv_['fwd']['plain_ms']:.1f}), backward {rv_['bwd']['ms']:.4f} ms (bound "
          f"{rv_['bwd']['bound']:.4f}, plain {rv_['bwd']['plain_ms']:.1f}, largest err/tol {rv_['bwd']['ratio']:.3e}); "
          f"host s/step {p20['step_s']}; volume-window train PSNR {p20['psnr'][0]:.3f} -> {p20['psnr'][1]:.3f} dB; "
          f"served {p20['served'][0]:.3f} (volume) / {p20['served'][1]:.3f} (surfel) dB")
    print(f"warp sampler at phase 15's paired step (refnerf, the largest call): gather {warp_a['fwd']['ms']:.4f} ms "
          f"(bound {warp_a['fwd']['bound']:.4f}, plain {warp_a['fwd']['plain_ms']:.2f}), splat "
          f"{warp_a['bwd']['ms']:.4f} ms (bound {warp_a['bwd']['bound']:.4f}, plain with its autograd backward "
          f"{warp_a['bwd']['plain_ms']:.2f}, largest err/tol {warp_a['bwd']['ratio']:.3e}); at refreal's surfel2 step "
          f"(phase 16 (c), the largest call): gather {rw_['fwd']['ms']:.4f} ms (bound {rw_['fwd']['bound']:.4f}, plain "
          f"{rw_['fwd']['plain_ms']:.2f}), splat {rw_['bwd']['ms']:.4f} ms (bound {rw_['bwd']['bound']:.4f}, plain "
          f"{rw_['bwd']['plain_ms']:.2f}, largest err/tol {rw_['bwd']['ratio']:.3e}); launches {warp_launches}")
    print(f"tracer at the surfel2 step (phase 14): forward {f_ms:.4f} ms, bound {f_bound:.4f} ms, plain "
          f"{f_plain_ms:.1f} ms; backward {s_ms:.4f} ms, bound {s_bound:.4f} ms, plain {s_plain_ms:.1f} ms")
    print(f"refreal at 1236x821 (phase 16 (c)): rasterizer forward {rr_['fwd']['ms']:.4f} ms (bound "
          f"{rr_['fwd']['bound']:.4f}, plain {rr_['fwd']['plain_ms']:.1f}), backward {rr_['bwd']['ms']:.4f} ms (bound "
          f"{rr_['bwd']['bound']:.4f}, plain {rr_['bwd']['plain_ms']:.1f}, largest err/tol {rr_['bwd']['ratio']:.3e}); "
          f"tracer forward {rt_['fwd']['ms']:.4f} ms (bound {rt_['fwd']['bound']:.4f}, plain "
          f"{rt_['fwd']['plain_ms']:.1f}), "
          f"backward {rt_['bwd']['ms']:.4f} ms (bound {rt_['bwd']['bound']:.4f}, plain {rt_['bwd']['plain_ms']:.1f})")
    print(f"JPEG kernel at phase 16's photo 0 ({REAL_W}x{REAL_H}, 4:2:0): {jp['ms']:.4f} ms (bound {jp['bound']:.4f} by "
          f"{jp['by']}, plain {jp['plain_ms']:.1f}); at phase 18 (b)'s textured photo {p18['tex']['ms']:.4f} ms; photo "
          f"decode medians (phase 16): entropy {real['decode_ms']['entropy']:.1f} ms, H2D {real['decode_ms']['h2d']:.1f} "
          f"ms, kernel {real['decode_ms']['kernel']:.2f} ms, D2H {real['decode_ms']['d2h']:.1f} ms; loader "
          f"{real['loader_s']:.3f} s a photo; COLMAP parse native {p18['native_ms']:.1f} "
          f"ms, pure {p18['pure_ms']:.1f} ms")
    print(smi_line)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
