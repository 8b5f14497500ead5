"""The tracer kernels' share of their roofline over the window: the bound of
the window's trace_bundles_fwd and _bwd launches (csrc/trace_fwd.cu's and
trace_bwd.cu's kernels; the work of a step counted by perfbench/cost) over
those kernels' device time."""
KERNELS = r"^void (\(anonymous namespace\)::)?(totals|carry|composite|reduce|gw|grad|ray_reduce)_kernel[<(]"


def read(t):
    seconds = t.kernel_s(KERNELS)
    if seconds <= 0 or "trace_fwd_s" not in t.cost or t.cost["trace_fwd_s"] <= 0:
        return None
    return 100.0 * t.units * (t.cost["trace_fwd_s"] + t.cost["trace_bwd_s"]) / seconds
