"""The work a view or a step needs, counted by the benchmark's own plain code.

The counts are what these inputs need, so they read the same whatever
implements them: the contributing (pixel, gaussian) hits of the rasterizer
(alpha >= 1/255 before the pixel's transmittance stops) and the composited
(ray, gaussian) hits of the tracer, counted by the reference's plain
versions (`perfbench.reference.plain`, whose forward functions add them to
their module's WORK dict). Each hit is multiplied by its operation count:
chip_smoke's arithmetic, copied below with its comments. Bytes count each
gaussian's parameters read once and each output map written once. Nothing
here reads a counter or an output of the program.
"""
from __future__ import annotations

import math

import torch

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


def trace_flops(work, n_sh, exact):
    composite = 2 + 3 * (2 * n_sh + 1) + 6 + 2 + 8 + 4
    flops = TRACE_HIT_FLOPS * work["hit_tests"] + 3 * work["hits"] + composite * work["contribs"]
    return flops + (work["sort_compares"] if exact else 0.0)


def trace_bwd_flops(work, n_sh, exact):
    per_hit = 3 * (2 * n_sh + 1) + 14 + 12
    per_contrib = TRACE_BWD_CHAIN_FLOPS + 9 * n_sh + 13 + 3 * n_sh
    flops = TRACE_HIT_FLOPS * work["hit_tests"] + per_hit * work["hits"] + per_contrib * work["contribs"]
    return flops + (work["sort_compares"] if exact else 0.0)


# Layout widths (the rasterizer's payload and output rows, the tracer's
# payload rows and ray/output columns), frozen with the reference's layout.
RASTER_GEOM_ROWS = 12  # Tu, Tv, Tw, mean2d, opacity and spare: rows before the linear features


def raster_rows(S: int) -> int:
    """Payload rows a gaussian carries into the rasterizer: geometry, then
    RGB, S features and the 3 normal rows (ROW_LIN + ACC)."""
    return RASTER_GEOM_ROWS + S + 6


def raster_out_channels(S: int) -> int:
    """Output channels a pixel writes: ACC, depth, M1, M2, distortion,
    median depth, final T, n_contrib, median contributor."""
    return S + 6 + 8


TRACE_RAY_FLOATS = 8  # origin, direction, tmax, pad
TRACE_OUT_FLOATS = 16


# Per-pixel FP32 operations outside the kernels, counted from the resolution
# (a lower count: only the arithmetic each pixel needs).
# Deferred shading of a surfel view: normal normalisation (9), the view and
# reflected directions (15), two cubemap lookups with bilinear and mip blend
# (2 x 40), the split-sum BRDF LUT fetch and fresnel (20), diffuse + specular
# composite (12), sRGB (3 x 6): 154. The volume stage does this arithmetic
# once per alive gaussian instead, and `initial` not at all (core/cell.py).
SHADE_FLOPS_PER_PIXEL = 154
# The photometric loss: L1 (3 x 3), SSIM's five 11x11 separable Gaussian
# moments per channel (5 x 2 x 11 x 2 x 3 = 660) and its per-pixel formula
# (3 x 20); the depth-normal and distortion terms (30): 759.
LOSS_FLOPS_PER_PIXEL = 759
# A backward takes about twice its forward's operations.
BACKWARD_FACTOR = 2


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the chip could take: the larger of the operations over
    the FP32 peak and the bytes over the HBM bandwidth."""
    return max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S)


def raster_launch(S: int, hits3d: int, hits2d: int, n_gauss: int, H: int, W: int) -> dict:
    """Operations and bytes of one forward and one backward launch at a view
    with these contributing hits and `n_gauss` gaussians in the view."""
    hits = hits3d + hits2d
    rows, out_c = raster_rows(S), raster_out_channels(S)
    pix = H * W
    return {
        "fwd_flops": HIT_TEST_FLOPS * hits,
        "fwd_bytes": 4 * (n_gauss * rows + pix * out_c),
        "bwd_flops": bwd_flops(S, hits, hits3d, hits2d),
        # parameters and fwd outputs and cotangent read; gradients written
        "bwd_bytes": 4 * (n_gauss * (rows + rows) + 2 * pix * out_c),
    }


def trace_launch(n_sh: int, contribs: int, n_gauss: int, n_rays: int) -> dict:
    work = {"hit_tests": contribs, "hits": contribs, "contribs": contribs, "sort_compares": 0.0}
    rows = 13 + 3 * n_sh
    return {
        "fwd_flops": trace_flops(work, n_sh, False),
        "fwd_bytes": 4 * (n_gauss * rows + n_rays * (TRACE_RAY_FLOATS + TRACE_OUT_FLOATS)),
        "bwd_flops": trace_bwd_flops(work, n_sh, False),
        "bwd_bytes": 4 * (2 * n_gauss * rows + n_rays * (TRACE_RAY_FLOATS * 2 + 2 * TRACE_OUT_FLOATS)),
    }


def gaussians_in_view(xyz: torch.Tensor, alive: torch.Tensor, cam_center, R_w2c, fx, fy, cx, cy,
                      W: int, H: int) -> int:
    """Alive gaussians whose centre projects into the image in front of the
    camera (what a view reads)."""
    c = torch.as_tensor(cam_center, dtype=torch.float32, device=xyz.device)
    R = torch.as_tensor(R_w2c, dtype=torch.float32, device=xyz.device)
    p = (xyz - c) @ R.T
    z = p[:, 2]
    u = fx * p[:, 0] / z.clamp(min=1e-6) + cx
    v = fy * p[:, 1] / z.clamp(min=1e-6) + cy
    ok = alive & (z > 0.2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return int(ok.sum())


def intrinsics(spec) -> tuple:
    if spec.K is not None:
        return spec.K[0, 0], spec.K[1, 1], spec.K[0, 2], spec.K[1, 2]
    fx = spec.width / (2 * math.tan(spec.fovx / 2))
    fy = spec.height / (2 * math.tan(spec.fovy / 2))
    return fx, fy, spec.width / 2, spec.height / 2
