"""Device milliseconds a served view spends in the rasterizer
(`ops.rasterize.api`: preprocess, depth sort and binning, the pair gather
and the forward tile kernel, the unpack): the program's `rasterize` span."""


def read(t):
    if not t.has_span("rasterize"):
        return None
    return 1e3 * t.span_device_s("rasterize") / t.units
