"""Shared payload/output layout constants for the tile rasterizer kernels
(the same layout as the JAX package, so payloads and outputs compare 1:1)."""
from __future__ import annotations

TILE = 16
# Single-source numerical contract constants (forward.cu:378-404,
# auxiliary.h:39-41); preprocess, binning and the kernel import from here.
# csrc/rasterize_fwd.cu repeats them as literals.
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
NEAR_N = 0.2
FAR_N = 100.0
FILTER_INV_SQUARE = 2.0
CUTOFF = 3.0
PIX = TILE * TILE  # 256 pixels per tile
K_CHUNK = 128  # pair-chunk width of binning's chunk_base windows

# Payload rows (payload is (C_PAD, B) in HBM, one column per (tile, gaussian)
# pair, sorted by (tile, depth)):
ROW_TU = 0  # 0:3   Tu
ROW_TV = 3  # 3:6   Tv
ROW_TW = 6  # 6:9   Tw
ROW_MEAN2D = 9  # 9:11  screen-space center
ROW_OPACITY = 11
ROW_LIN = 12  # 12:12+ACC  linearly-composited channels: color(3)+feat(S)+normal(3)

LOG_T_STOP = -9.210340371976182  # log(1e-4), forward.cu:400
LOG_HALF = -0.6931471805599453  # log(0.5), median depth threshold
DEAD = -1e9


def acc_channels(S: int) -> int:
    """color(3) + features(S) + normal(3)."""
    return S + 6


def payload_channels(S: int) -> int:
    return ROW_LIN + acc_channels(S)


def row_gid(S: int) -> int:
    """Payload row carrying (owning gaussian id + 1) as f32, exact for
    P < 2^24; 0 marks an invalid lane. The forward kernel ignores it; the
    backward kernel (training slice) keys its per-gaussian reduction on it."""
    return payload_channels(S)


def payload_channels_padded(S: int) -> int:
    c = payload_channels(S) + 1  # +1: the row_gid channel
    return ((c + 7) // 8) * 8


# Output channel offsets within the (num_tiles, 256, C_OUT) forward output.
def out_layout(S: int) -> dict:
    o = {}
    o["color"] = (0, 3)
    o["feature"] = (3, 3 + S)
    o["normal"] = (3 + S, 6 + S)
    base = 6 + S
    for i, name in enumerate(
        ["depth", "M1", "M2", "distortion", "median_depth", "final_T", "n_contrib", "median_contrib"]
    ):
        o[name] = (base + i, base + i + 1)
    o["_channels"] = base + 8
    return o


def out_channels_padded(S: int) -> int:
    c = out_layout(S)["_channels"]
    return ((c + 7) // 8) * 8
