"""Device milliseconds a step spends in the warp's backward (`train.warp`):
the kernels of the autograd nodes created in the nearest view's render and
in calc_warp_loss, which run inside the program's `warp.nearest_render.bwd`
and `warp.calc_warp_loss.bwd` spans (the nearest view's rasterizer backward
counts here and in `rasterize_device_ms.train`)."""


def read(t):
    names = ("warp.nearest_render.bwd", "warp.calc_warp_loss.bwd")
    if not any(t.has_span(n) for n in names):
        return None
    return 1e3 * sum(t.span_device_s(n) for n in names) / t.units
