"""Curriculum stage selection (reference select_render_method,
train_refnerf.py:1495-1506)."""
from __future__ import annotations

from perfbench.reference.plain.config import OptimizationParams


def select_stage(iteration: int, opt: OptimizationParams) -> str:
    if opt.initial and iteration <= opt.init_until_iter:
        return "initial"
    if iteration <= opt.volume_render_until_iter:
        return "volume"
    if iteration <= opt.indirect_from_iter:
        return "surfel"
    return "surfel2"
