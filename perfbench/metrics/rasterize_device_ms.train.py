"""Device milliseconds a step spends in the rasterizer (`ops.rasterize.api`:
preprocess, depth sort and binning, the pair gather and both tile kernels,
the unpack) and its backward: the program's `rasterize` span and its
`rasterize.bwd` twin, over every rasterization of the step (the nearest
view's too)."""


def read(t):
    if not t.has_span("rasterize"):
        return None
    return 1e3 * (t.span_device_s("rasterize") + t.span_device_s("rasterize.bwd")) / t.units
