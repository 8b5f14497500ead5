"""Mean squared distance to the 3 nearest neighbors (simple-knn replacement).

The JAX package's Morton-window approximation (materialrefgs_tpu/ops/knn.py),
not an exact KNN: Morton-sort the points, then search a +-window neighborhood
in Morton order. It only seeds per-gaussian scales (gaussian_model.py:367).
"""
from __future__ import annotations

import torch


def _morton3d(q: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit coords (P, 3) int32 -> (P,) int32 Morton codes."""

    def expand(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    return expand(q[:, 0]) | (expand(q[:, 1]) << 1) | (expand(q[:, 2]) << 2)


def mean_knn_dist2(points: torch.Tensor, k: int = 3, window: int = 64) -> torch.Tensor:
    """(P, 3) float32 -> (P,) mean squared distance to the k nearest
    neighbors among the +-window Morton-order candidates."""
    P = points.shape[0]
    dev = points.device
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    q = ((points - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).to(torch.int32)
    order = torch.argsort(_morton3d(q), stable=True)
    pts = points[order]

    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    raw_idx = torch.arange(P, device=dev)[:, None] + offs[None, :]
    in_range = (raw_idx >= 0) & (raw_idx < P)
    cand = pts[torch.clamp(raw_idx, 0, P - 1)]  # (P, 2W, 3)
    d2 = torch.sum((cand - pts[:, None, :]) ** 2, dim=-1)
    # Out-of-range offsets would duplicate the boundary point; mask them.
    d2 = torch.where(in_range, d2, torch.full_like(d2, float("inf")))
    knn = torch.topk(d2, min(k, d2.shape[1]), dim=-1, largest=False).values
    mean_d2 = torch.mean(torch.where(torch.isfinite(knn), knn, torch.zeros_like(knn)), dim=-1)
    return mean_d2[torch.argsort(order)]
