#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (materialrefgs_torch) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):
  1. the card's name and power limit;
  2. build every kernel of the serving path from csrc/ with nvcc (ptxas -v);
  3. hold each kernel against its plain torch version on the card: a
     mid-size random scene at S=1 and S=9, the 64 densest tiles of the
     full-width view, and the full-width view itself;
  4. serve a full-width refnerf model (150k splats, SH degree 3, all
     materials, 128^2 env, 800x800, S=9) through scripts/eval_torch.py's path:
     the model is written with the port's save_ply, 8 ground-truth views are
     rendered into a Blender-layout scene, and the eval path reloads both.
     Kernel launch counts are zeroed just before the eval and read right
     after it;
  5. time the kernel (CUDA events) at the main path's shapes, beside its plain
     version and the least time the card could take for the same work.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""
from __future__ import annotations

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
    from materialrefgs_torch.ops.rasterize import api, tiles_fwd
    from materialrefgs_torch.ops.rasterize.layout import ROW_LIN, acc_channels, out_layout
    from materialrefgs_torch.render.renderers import RenderOptions, render_surfel
    from materialrefgs_torch.utils import png
    from materialrefgs_torch.utils.sh import rgb_to_sh

    dev = torch.device("cuda")
    kernel_fn = tiles_fwd.rasterize_tiles_fwd

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
    t0 = time.perf_counter()
    lib_path, log = tiles_fwd.build_library()
    print(f"{os.path.relpath(lib_path, REPO)} built in {time.perf_counter() - t0:.1f} s")
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
    out, ref, (full_args, full_kw) = run_both(full)
    print(f"  whole 800x800 view: {int(full.bins.num_pairs)} pairs")
    full_err = compare_tiles(np, out, ref, 9, lay9)
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
    import dataclasses

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

    import importlib.util

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

    record = {"kernels": [{
        "name": "rasterize_tiles_fwd",
        "route": "cuda",
        "source": "materialrefgs_torch/csrc/rasterize_fwd.cu",
        "replaces": "materialrefgs_tpu/ops/rasterize/pallas_fwd.py:363",
        "launches": launches,
        "max_abs_err": full_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(smi_line)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
