"""Payload and output layout of the bundle splat tracer (the JAX package's
materialrefgs_tpu/ops/tracer/pallas_kernels.py constants, so payloads and
outputs compare 1:1). csrc/trace_fwd.cu repeats them as literals."""
from __future__ import annotations

NRAY = 256  # rays per bundle (one 16x16 pixel tile of the reflected-ray map)
K_CHUNK = 128  # pairs per chunk; segments start at multiples of it
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
RHO_CUTOFF = 9.0  # 3 sigma
LOG_T_STOP = -9.210340371976182  # log(1e-4)

# Payload rows (geometry block; SH rows follow from ROW_SH)
ROW_P = 0  # 0:3 center
ROW_TU = 3  # 3:6 tu / su
ROW_TV = 6  # 6:9 tv / sv
ROW_N = 9  # 9:12 unit normal
ROW_OPA = 12
ROW_SH = 13  # 13:13+3*n_sh raw SH coefficients, channel-major (c*n_sh + k)


def pay_rows(n_sh: int) -> int:
    """Padded payload row count for a given SH basis size."""
    return ((ROW_SH + 3 * n_sh + 7) // 8) * 8


# Forward output channels
OUT_RGB = 0  # 0:3
OUT_DEPTH = 3
OUT_NORMAL = 4  # 4:7
OUT_FINAL_T = 7
OUT_NCONTRIB = 8
OUT_SUMLG = 9  # per-ray total log-T over processed chunks (backward residual)
OUT_NPROC = 10  # chunks processed before the bundle's early exit
C_OUT = 16  # padded
