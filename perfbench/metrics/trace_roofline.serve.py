"""The tracer forward kernels' share of their roofline over the window: the
bound of the window's trace_bundles_fwd launches (csrc/trace_fwd.cu's four
kernels; the work of a view counted by perfbench/cost) over their device
time."""
KERNELS = r"^void (\(anonymous namespace\)::)?(totals|carry|composite|reduce)_kernel[<(]"


def read(t):
    seconds = t.kernel_s(KERNELS)
    if seconds <= 0 or "trace_fwd_s" not in t.cost or t.cost["trace_fwd_s"] <= 0:
        return None
    return 100.0 * t.units * t.cost["trace_fwd_s"] / seconds
