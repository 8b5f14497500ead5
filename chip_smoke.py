#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (materialrefgs_torch) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. the card's name and power limit;
  2. build every kernel of the serving and training paths from csrc/ with
     nvcc (ptxas -v), one nvcc per source, all started together;
  3. hold each kernel against its plain torch version on the card: a
     mid-size random scene at S=1 and S=9, the 64 densest tiles of the
     full-width view, and the full-width view itself (the backward kernel
     with a random cotangent);
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
     its state after 60.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""
from __future__ import annotations

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
# BWD_ATOL. The per-pixel arithmetic is the
# same; the sum over a tile's 256 pixels is taken in another order (warp
# butterflies + 8 warp partials vs torch.sum), whose rounding scales with
# the summands, so a pair whose sum cancels may differ by more than BWD_RTOL
# of itself. A wrong term at a typical magnitude (the group's median) fails.
BWD_RTOL, BWD_ATOL, BWD_PCT = 1e-4, 1e-7, 0.99
TRAIN_W = TRAIN_H = 800
TRAIN_VIEWS, TEST_VIEWS = 8, 4
TRAIN_ITERS = 60
TRAIN_TEST_MARKS = (30, 60)
W = H = 800
N_VIEWS = 8
P_SPLATS = 150_000
PAIR_CAPACITY = (1 << 20) + (1 << 18)
ITERATION = 7000  # a refnerf checkpoint of the `surfel` stage (deferred shading)
# Tolerances per output group (the JAX package's tests/test_rasterize_pallas.py).
TOLS = {
    "color": 2e-4, "feature": 2e-4, "normal": 2e-4, "M1": 2e-4, "M2": 2e-4,
    "final_T": 2e-4, "depth": 1e-3, "median_depth": 1e-3, "distortion": 5e-4,
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def phase(name):
    print(f"\n=== {name} ===", flush=True)


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
    """Max abs error per output group; raises past the tolerance or on any
    contributor-index mismatch. Returns the largest error over all groups."""
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
    non-finite value. Returns the largest error over all groups."""
    from materialrefgs_torch.ops.rasterize.layout import ROW_LIN, ROW_MEAN2D, ROW_OPACITY, ROW_TU, ROW_TV, ROW_TW

    groups = {"dTu": (ROW_TU, ROW_TV), "dTv": (ROW_TV, ROW_TW), "dTw": (ROW_TW, ROW_MEAN2D),
              "dmean2d": (ROW_MEAN2D, ROW_OPACITY), "dopacity": (ROW_OPACITY, ROW_LIN),
              "dlin": (ROW_LIN, out.shape[1])}
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(ref).all()), f"S={S}: non-finite gradients")
    worst = 0.0
    for name, (lo, hi) in groups.items():
        a, b = out[:, lo:hi], ref[:, lo:hi]
        diff = (a - b).abs()
        err = float(diff.max())
        med, pct = magnitude_quantile(torch, b, 0.5), magnitude_quantile(torch, b, BWD_PCT)
        biggest = float(b.abs().max())
        tol = BWD_RTOL * torch.clamp(b.abs() + pct, max=biggest) + BWD_ATOL
        worst_ratio = float((diff / tol).max())
        ok = worst_ratio <= 1.0
        print(f"    {name:9s} max|err| {err:.3e}  |grad| median {med:.3e}, p99 {pct:.3e}, "
              f"max {biggest:.3e}; largest err/tol {worst_ratio:.3e}  "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"S={S} backward {name} outside tolerance")
        worst = max(worst, err)
    return worst


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
    from materialrefgs_torch.ops.rasterize import api, tiles_bwd, tiles_fwd
    from materialrefgs_torch.ops.rasterize.layout import ROW_LIN, acc_channels, out_layout
    from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
    from materialrefgs_torch.utils import png
    from materialrefgs_torch.utils.sh import rgb_to_sh

    dev = torch.device("cuda")
    kernel_fn = tiles_fwd.rasterize_tiles_fwd
    bwd_fn = tiles_bwd.rasterize_tiles_bwd

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
    phase("2. build kernels (nvcc, sm_90a)")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = list(pool.map(lambda m: nvcc.build(m.SOURCE), (tiles_fwd, tiles_bwd)))
    print(f"both kernels built in {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
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
        and a random cotangent; returns (max error, the kernel's inputs)."""
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
        return compare_grads(np, torch, out, ref, ti.S), (bargs, kw, work)

    from materialrefgs_torch.cameras import look_at_camera

    for S in (1, 9):
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
    bwd_err, bwd9 = run_bwd(full, seed=800)
    n_contrib_sum = float(out[..., lay9["n_contrib"][0]].sum())
    plain_ms = cuda_ms(torch, lambda: tiles_fwd.rasterize_tiles_fwd_plain(*full_args, **full_kw), 2)

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
    _, bwd1 = run_bwd(full1, seed=801)
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

    record = {"kernels": [
        {
            "name": "rasterize_tiles_fwd",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/rasterize_fwd.cu",
            "replaces": "materialrefgs_tpu/ops/rasterize/pallas_fwd.py:363",
            "launches": train_fwd,
            "max_abs_err": full_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
        {
            "name": "rasterize_tiles_bwd",
            "route": "cuda",
            "source": "materialrefgs_torch/csrc/rasterize_bwd.cu",
            "replaces": "materialrefgs_tpu/ops/rasterize/pallas_bwd.py:385",
            "launches": train_bwd,
            "max_abs_err": bwd_err,
            "ms": bwd_times[9]["ms"],
            "plain_ms": plain_bwd_ms,
            "bound_ms": bwd_times[9]["bound"],
            "bound_by": bwd_times[9]["by"],
            "library_ms": None,
        },
    ]}
    print(f"serve path launches: forward {launches}; training path launches: forward {train_fwd}, "
          f"backward {train_bwd}")
    print(smi_line)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
