"""The whole view's share of the chip's FP32 peak: the operations a view
needs (perfbench/cost: the rasterizer's and tracer's hits times their
operation counts, and the per-pixel shading counted from the
resolution) times the views completed, over the window's time times 67
TFLOP/s."""
from perfbench.cost import PEAK_FP32_FLOPS


def read(t):
    if "flops" not in t.cost or t.window_s <= 0:
        return None
    return 100.0 * t.cost["flops"] * t.units / (t.window_s * PEAK_FP32_FLOPS)
